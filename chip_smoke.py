"""Smoke test of the engine's main paths on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-6 on one card
    python chip_smoke.py --multi    # the sharded paths across every visible card

One process, one card. Phases run in order and any failure ends the run with
a non-zero exit code:

1. device   — the default device is a GPU (no CPU fallback);
2. nn       — brute-force NN (the Triton kernel behind backend="auto") on the
              29,310-point fachada scan against a float64 numpy oracle, timed
              against the plain XLA scan;
3. icp      — registration.icp on fachada with a shuffled target, recovering
              a known transform; the solve timed with either NN path;
4. ba       — ba.solve_ba(engine="auto") at O=500k, C=200, L=50k, routed to
              the dense engine, against the same solve at full f32 matmul
              precision and (after every f32 phase) in float64;
5. slam     — odometry.scan_slam over 16 scans of 32,768 points, hash-grid NN,
              ATE against the pinned bounds of tests/test_slam_sequence.py;
6. battery  — device numerics checks (grid query modes, fixed-capacity grid
              build, curve fit, mixed precision, the denormal probe).

Each check prints its gap, its tolerance and the reason for the tolerance;
each time is printed beside the card's name and power limit. The last line is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FACHADA = ROOT / "tests" / "data" / "fachada.txt"
BA_SHAPE = (500_000, 200, 50_000)  # observations, cameras, landmarks
SLAM_SHAPE = (16, 32_768)  # scans, points per scan
CARD = "unknown card"


class SmokeFailure(Exception):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def gap_line(phase, what, gap, tol, reason):
    """Print one measured gap beside its tolerance; fail when it exceeds it."""
    ok = bool(np.isfinite(gap)) and gap <= tol
    print(f"[{phase}] {what}: gap {gap:.3e} <= tol {tol:.1e} "
          f"{'PASS' if ok else 'FAIL'} ({reason})", flush=True)
    require(ok, f"{phase}: {what} gap {gap:.3e} exceeds {tol:.1e}")


def time_line(phase, what, seconds):
    print(f"[{phase}] {what}: {seconds * 1e3:.3f} ms on {CARD}", flush=True)


def median_seconds(fn, *args, reps=10):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def fachada(dtype=np.float32):
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    return load_txt_cloud(FACHADA).astype(dtype)


def rigid(x):
    """4×4 transform of params6 x = [t, ω] in float64 (numpy)."""
    import jax.numpy as jnp

    from moptimizer_jax.lie import se3

    return np.asarray(se3.transform_from_params6(jnp.asarray(x, jnp.float32)), np.float64)


def nn_oracle(q, p, rows=256):
    """float64 first-argmin and min squared distance, by direct differences."""
    q = q.astype(np.float64)
    p = p.astype(np.float64)
    idx = np.empty(len(q), np.int64)
    dist = np.empty(len(q))
    for s in range(0, len(q), rows):
        d2 = ((q[s:s + rows, None, :] - p[None, :, :]) ** 2).sum(-1)
        idx[s:s + rows] = d2.argmin(1)
        dist[s:s + rows] = d2.min(1)
    return idx, dist


# --------------------------------------------------------------------------
# phases


def phase_device(multi):
    import jax

    from moptimizer_jax.utils.cache import enable_persistent_cache

    devs = jax.devices()
    d = devs[0]
    require(d.platform == "gpu",
            f"no GPU found: JAX's default device is {d.platform!r} ({d.device_kind})")
    if multi:
        require(len(devs) > 1, f"--multi needs several GPUs; JAX sees {len(devs)}")
    cache = enable_persistent_cache()
    print(f"[device] kind {d.device_kind!r}, count {len(devs)}, jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache}, "
          f"bytes_limit {d.memory_stats()['bytes_limit']}", flush=True)
    return d


def phase_nn():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax.ops.nn_search import _nn_xla, nearest_neighbors

    p = fachada()
    T = rigid([0.05, -0.03, 0.02, 0.01, -0.02, 0.015])
    q = (p.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    qd, pd = jnp.asarray(q), jnp.asarray(p)

    nn_auto = jax.jit(lambda a, b: nearest_neighbors(a, b, backend="auto"))
    idx, dist = map(np.asarray, nn_auto(qd, pd))
    rows = np.random.default_rng(0).choice(len(q), 4096, replace=False)
    oi, od = nn_oracle(q[rows], p)
    ki, kd = idx[rows], dist[rows].astype(np.float64)

    mism = ki != oi
    alt = ((q[rows][mism].astype(np.float64) - p[ki[mism]]) ** 2).sum(-1)
    tie_gap = float(np.max(np.abs(alt - od[mism]) / od[mism])) if mism.any() else 0.0
    print(f"[nn] {int(mism.sum())} of 4096 sampled indices differ from the oracle",
          flush=True)
    gap_line("nn", "index mismatches, f64 distance of the chosen point vs the minimum",
             tie_gap, 1e-6, "a mismatch is allowed only at an exact tie")
    pos = od > 0
    require(np.all(kd[~pos] == 0), "nn: nonzero distance where the oracle has 0")
    gap_line("nn", "squared distance, relative", float(np.max(np.abs(kd - od)[pos] / od[pos])),
             1e-5, "exact f32 differences: a few f32 roundings of (q-p)^2")

    t_kernel = median_seconds(nn_auto, qd, pd)
    t_xla = median_seconds(_nn_xla, qd, pd)
    time_line("nn", f"kernel (backend=auto) median, Q=M={len(p)}", t_kernel)
    time_line("nn", f"plain XLA scan (_nn_xla) median, Q=M={len(p)}", t_xla)


def phase_icp():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax.core.residual import problem
    from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt
    from moptimizer_jax.registration import icp, icp_block

    src = fachada()
    x_true = np.array([0.3, -0.2, 0.4, 0.05, -0.04, 0.08])
    T = rigid(x_true)
    tgt = (src.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = tgt[np.random.default_rng(1).permutation(len(tgt))]
    src_d, tgt_d = jnp.asarray(src), jnp.asarray(tgt)
    max_corr = 2.0

    res = icp(src_d, tgt_d, max_corr_dist=max_corr)
    err = float(np.max(np.abs(np.asarray(res.x, np.float64) - x_true)))
    print(f"[icp] {int(res.iterations)} LM iterations, final cost {float(res.cost):.3e}",
          flush=True)
    gap_line("icp", "max |x - x_true|", err, 1e-3,
             "f32 registration of a 30 m scan; the known f32 bound of this solve")

    # the same solve, compiled once per NN path and timed end to end
    cfg = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    x0 = jnp.zeros(6, jnp.float32).at[:3].set(
        jnp.median(tgt_d, axis=0) - jnp.median(src_d, axis=0))
    solve = jax.jit(lambda prob, x0: levenberg_marquardt(prob, x0, cfg))
    for backend in ("pallas", "xla"):
        prob = problem(icp_block(src_d, tgt_d, max_corr_dist=max_corr, nn_backend=backend))
        r = solve(prob, x0)
        t = median_seconds(solve, prob, x0, reps=5)
        time_line("icp", f"icp solve, nn_backend={backend!r} "
                         f"({int(r.iterations)} LM iterations)", t)


def ba_instance():
    import jax.numpy as jnp

    import bench

    return bench._make_ba_problem(*BA_SHAPE, jnp)


def rel_trace_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isfinite(a) & np.isfinite(b)
    require(both.any() and np.array_equal(np.isfinite(a), np.isfinite(b)),
            "ba: cost traces ran different numbers of iterations")
    return float(np.max(np.abs(a[both] - b[both]) / np.abs(b[both])))


def phase_ba(dev):
    import jax

    from moptimizer_jax import ba, ba_dense

    prob = ba_instance()
    engine = ba.select_engine(prob)
    require(engine == "dense", f"ba: engine='auto' routed to {engine!r}, not 'dense'")
    print(f"[ba] engine=auto routes to {engine!r} "
          f"(estimated {ba_dense.dense_memory_bytes(prob) / 1e9:.2f} GB)", flush=True)

    t0 = time.perf_counter()
    res = ba.solve_ba(prob, ba.BAConfig(max_iterations=5), engine="auto")
    trace = np.asarray(res.trace["cost"], np.float64)
    time_line("ba", "first solve_ba(max_iterations=5), compile included",
              time.perf_counter() - t0)
    hi = ba_dense.solve_ba_dense(prob, ba_dense.DenseBAConfig(
        max_iterations=5, schur_precision="highest", gn_precision="highest"))
    print(f"[ba] cost trace default {trace.tolist()}", flush=True)
    print(f"[ba] cost trace highest {np.asarray(hi.trace['cost']).tolist()}", flush=True)
    gap_line("ba", "per-iteration cost, default vs highest matmul precision",
             rel_trace_gap(trace, hi.trace["cost"]), 1e-4,
             "TF32 panels perturb the Gauss-Newton step only; costs are f32")
    gap_line("ba", "final cost, default vs highest",
             rel_trace_gap([res.cost], [hi.cost]), 1e-3, "same as above, after 5 steps")
    t = median_seconds(
        lambda: ba.solve_ba(prob, ba.BAConfig(max_iterations=5), engine="auto"), reps=3)
    time_line("ba", "solve_ba(max_iterations=5) median", t)
    print(f"[ba] peak_bytes_in_use {dev.memory_stats()['peak_bytes_in_use']}", flush=True)
    return jax.tree.map(np.asarray, prob), trace, float(res.cost)


def phase_ba_f64(host, trace32, cost32):
    """The ba phase's instance (host copy) solved again in float64."""
    import jax
    import jax.numpy as jnp

    from moptimizer_jax import ba

    prob = jax.tree.map(
        lambda v: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f" else v.dtype), host)
    require(prob.points.dtype == jnp.float64, "ba:f64: x64 is not on")
    res = ba.solve_ba(prob, ba.BAConfig(max_iterations=5), engine="auto")
    print(f"[ba:f64] cost trace {np.asarray(res.trace['cost']).tolist()}", flush=True)
    gap_line("ba:f64", "per-iteration cost, f32 default vs float64",
             rel_trace_gap(trace32, res.trace["cost"]), 1e-4,
             "f32 sums over 500k residuals plus TF32 steps")
    gap_line("ba:f64", "final cost, f32 default vs float64",
             rel_trace_gap([cost32], [res.cost]), 1e-3, "same as above, after 5 steps")


def phase_slam():
    from benchmarks.slam_sequence_bench import make_sequence
    from moptimizer_jax.core.solver import LMConfig
    from moptimizer_jax.evaluation import ate_rmse
    from moptimizer_jax.odometry import scan_slam

    K, N = SLAM_SHAPE
    scans, gt = make_sequence(K, N, seed=42)
    cfg = LMConfig(diff_mode="auto", max_iterations=40, linear_solver="cholesky",
                   rel_cost_tol=1e-6)
    t0 = time.perf_counter()
    result, poses_odo = scan_slam(
        scans, method="icp", loop_closures=[(0, K - 1), (0, K - 2)], config=cfg,
        nn_backend="grid", max_corr_dist=0.5,
    )
    ate_odo = float(ate_rmse(poses_odo, gt, align=False))
    ate_slam = float(ate_rmse(result.poses, gt, align=False))
    time_line("slam", f"scan_slam over {K} scans of {N} points, compile included",
              time.perf_counter() - t0)
    gap_line("slam", "odometry ATE (m)", ate_odo, 0.05,
             "pinned odometry bound of tests/test_slam_sequence.py")
    gap_line("slam", "SLAM ATE (m)", ate_slam, 0.01,
             "pinned SLAM bound of tests/test_slam_sequence.py")
    print(f"[slam] pose-graph solve: {int(result.iterations)} iterations, "
          f"ATE {ate_odo:.3e} m -> {ate_slam:.3e} m", flush=True)


def phase_battery():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax import LMConfig, levenberg_marquardt
    from moptimizer_jax.core.residual import problem
    from moptimizer_jax.models.curve_fitting import exponential_curve_block
    from moptimizer_jax.ops.grid_nn import (
        build_hash_grid,
        build_hash_grid_fixed,
        grid_nearest_neighbors,
    )

    # denormal probe: do small-int bit patterns survive an f32 transport?
    k = jnp.arange(0, 64, dtype=jnp.int32)

    @jax.jit
    def roundtrip(f):
        buf = jnp.zeros((128, 2), jnp.float32).at[jnp.arange(64)].set(jnp.stack([f, f], -1))
        sl = jax.lax.dynamic_slice(buf, (jnp.int32(0), jnp.int32(0)), (64, 2))
        return jax.lax.bitcast_convert_type(sl[:, 0], jnp.int32)

    kept = bool(jnp.all(roundtrip(jax.lax.bitcast_convert_type(k, jnp.float32)) == k))
    print(f"[battery] info: int32 -> f32 bitcast transport of small ints is "
          f"{'preserved' if kept else 'FLUSHED to zero'} on this device", flush=True)

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 40, (60_000, 2))
    z = np.sin(xy[:, 0] * 0.6) * np.cos(xy[:, 1] * 0.4) + 0.05 * rng.normal(size=60_000)
    pts = np.column_stack([xy, z]).astype(np.float32)
    q = jnp.asarray((pts[:40_000] + 0.04 * rng.normal(size=(40_000, 3))).astype(np.float32))
    grid = build_hash_grid(pts, 0.5)
    qi, qd = grid_nearest_neighbors(q, grid, mode="query")
    ci, cd = grid_nearest_neighbors(q, grid, mode="auto")
    n_idx = int(jnp.sum(qi != ci))
    n_dist = int(jnp.sum(jnp.where(jnp.isfinite(qd), qd != cd, ~jnp.isinf(cd))))
    gap_line("battery", "grid cell-major vs query-major, differing indices + distances",
             float(n_idx + n_dist), 0.0, "the two query orders must agree bitwise")

    g_fix, ovf = build_hash_grid_fixed(
        pts, 0.5, grid.n_slots, grid.bucket_size, grid.max_cell_occupancy)
    fi, _ = grid_nearest_neighbors(q, g_fix, mode="auto")
    require(not bool(ovf), "battery: fixed-capacity build overflowed at learned capacities")
    gap_line("battery", "fixed-capacity vs adaptive grid build, differing indices",
             float(jnp.sum(fi != ci)), 0.0, "same capacities must give the same grid")
    _, ovf2 = build_hash_grid_fixed(pts, 0.5, grid.n_slots, 1, 16)
    require(bool(ovf2), "battery: fixed-capacity overflow flag did not fire")
    print("[battery] fixed-capacity overflow flag fires at a too-small capacity: PASS",
          flush=True)

    res = levenberg_marquardt(
        problem(exponential_curve_block(dtype=jnp.float32)), jnp.zeros(2, jnp.float32),
        LMConfig(diff_mode="auto", linear_solver="cholesky"))
    gap_line("battery", "f32 curve fit vs reference (0.291861, 0.131439)",
             float(np.max(np.abs(np.asarray(res.x) - [0.291861, 0.131439]))), 5e-5,
             "the reference test's own tolerance")


def phase_battery_x64():
    import jax.numpy as jnp

    from moptimizer_jax import LMConfig, levenberg_marquardt
    from moptimizer_jax.core.residual import problem
    from moptimizer_jax.models.powell import powell_block

    res = levenberg_marquardt(
        problem(powell_block(analytic=True)),
        jnp.asarray([3.0, -1.0, 0.0, 4.0], jnp.float32),
        LMConfig(diff_mode="auto", linear_solver="cholesky", accum_dtype=jnp.float64,
                 max_iterations=25))
    gap_line("battery:x64", "mixed precision (f64 accumulation) Powell, max |x|",
             float(jnp.max(jnp.abs(res.x))), 5e-5, "the reference test's own tolerance")


# --------------------------------------------------------------------------
# --multi: the sharded paths against their one-card runs


def spread(what, arrays):
    for name, a in arrays.items():
        shards = [(s.device.id, tuple(s.data.shape)) for s in a.addressable_shards]
        print(f"[multi] {what}: {name} shards (device, shape) {shards}", flush=True)


def bytes_in_use(what):
    import jax

    used = [d.memory_stats()["bytes_in_use"] for d in jax.devices()]
    print(f"[multi] {what}: bytes_in_use per device {used}", flush=True)


def phase_multi():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax import ba_dense
    from moptimizer_jax.core.residual import problem
    from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt
    from moptimizer_jax.models.point2point import point2point_block
    from moptimizer_jax.parallel import (
        distributed_levenberg_marquardt,
        make_mesh,
        pad_block_to,
        shard_block_data,
    )
    from moptimizer_jax.registration import icp_batched

    n = len(jax.devices())
    mesh = make_mesh(n)
    print(f"[multi] 1-D mesh over {n} devices", flush=True)

    # dense BA, landmark axis sharded
    prob = ba_instance()
    cfg = ba_dense.DenseBAConfig(max_iterations=5)
    one = ba_dense.solve_ba_dense(prob, cfg)
    t0 = time.perf_counter()
    shd = ba_dense.solve_ba_dense_sharded(prob, mesh, cfg)
    jax.block_until_ready(shd)
    time_line("multi", "solve_ba_dense_sharded(max_iterations=5), compile included",
              time.perf_counter() - t0)
    spread("ba", {"points": shd.points})
    bytes_in_use("ba")
    print(f"[multi] ba cost trace one card {np.asarray(one.trace['cost']).tolist()}", flush=True)
    print(f"[multi] ba cost trace sharded  {np.asarray(shd.trace['cost']).tolist()}", flush=True)
    gap_line("multi", "ba per-iteration cost, sharded vs one card",
             rel_trace_gap(shd.trace["cost"], one.trace["cost"]), 1e-4,
             "psum order and TF32 steps differ; costs are f32 over 500k residuals")
    t = median_seconds(lambda: ba_dense.solve_ba_dense_sharded(prob, mesh, cfg), reps=3)
    time_line("multi", "solve_ba_dense_sharded(max_iterations=5) median", t)
    t = median_seconds(lambda: ba_dense.solve_ba_dense(prob, cfg), reps=3)
    time_line("multi", "solve_ba_dense(max_iterations=5) one card median", t)

    # GSPMD LM on fachada, residual axis sharded
    src = fachada()
    x_true = np.array([0.5, 0.2, 0.1, 0.03, 0.04, 0.05])
    T = rigid(x_true)
    tgt = (src.astype(np.float64) @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    prob = problem(point2point_block(jnp.asarray(src), jnp.asarray(tgt)))
    lm_cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", max_iterations=15)
    x0 = jnp.zeros(6, jnp.float32)
    ref = levenberg_marquardt(prob, x0, lm_cfg)
    dist = distributed_levenberg_marquardt(prob, x0, mesh, lm_cfg)
    # the placement distributed_levenberg_marquardt gives the residual data
    blk = shard_block_data(pad_block_to(prob.blocks[0], n), mesh)
    spread("distributed LM", {"src": jax.tree_util.tree_leaves(blk.data)[0]})
    bytes_in_use("distributed LM")
    gap_line("multi", "distributed LM vs one card, max |dx|",
             float(np.max(np.abs(np.asarray(dist.x) - np.asarray(ref.x)))), 1e-4,
             "psum order of the f32 Gauss-Newton sums")
    gap_line("multi", "distributed LM vs x_true, max |dx|",
             float(np.max(np.abs(np.asarray(dist.x, np.float64) - x_true))), 1e-3,
             "f32 registration bound of the icp phase")

    # fleet ICP, batch axis sharded
    B, npts = 4 * n, 4096
    rng = np.random.default_rng(3)
    srcs, tgts = [], []
    for b in range(B):
        s = src[rng.choice(len(src), npts, replace=False)]
        Tb = rigid(np.concatenate([0.3 * rng.normal(size=3), 0.03 * rng.normal(size=3)]))
        t = (s.astype(np.float64) @ Tb[:3, :3].T + Tb[:3, 3]).astype(np.float32)
        srcs.append(s)
        tgts.append(t[rng.permutation(npts)])
    srcs, tgts = jnp.asarray(np.stack(srcs)), jnp.asarray(np.stack(tgts))
    r1 = icp_batched(srcs, tgts)
    rm = icp_batched(srcs, tgts, mesh=mesh)
    spread("icp_batched", {"x": rm.x})
    bytes_in_use("icp_batched")
    gap_line("multi", f"icp_batched over the mesh vs no mesh (B={B}), max |dx|",
             float(np.max(np.abs(np.asarray(rm.x) - np.asarray(r1.x)))), 1e-4,
             "independent lanes; only XLA's per-program f32 rounding differs")


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, across every visible GPU")
    args = ap.parse_args()
    if not (ROOT / "moptimizer_jax").is_dir() or not FACHADA.is_file():
        print("chip_smoke: run it from a checkout of the repository "
              "(moptimizer_jax/ and tests/data/fachada.txt not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    try:
        dev = phase_device(args.multi)
        cards = nvidia_smi()
        for line in cards:
            print(f"card: {line}", flush=True)
        CARD = cards[0]
        if args.multi:
            phase_multi()
        else:
            phase_nn()
            phase_icp()
            host, trace32, cost32 = phase_ba(dev)
            phase_slam()
            phase_battery()
            import jax

            # every f32 phase has run: only now turn on float64
            jax.config.update("jax_enable_x64", True)
            phase_ba_f64(host, trace32, cost32)
            phase_battery_x64()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
