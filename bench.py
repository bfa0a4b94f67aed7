"""Benchmark: dense-Schur BA outer-iterations/s (headline) + ICP legs.

    python bench.py        # needs a GPU; fails without one

HEADLINE: per-outer-iteration throughput of the dense-Schur bundle-
adjustment engine at O=500k, C=200, L=50k (BASELINE.md north star) on one
card — tens of ms of device work per step. The ICP legs (one LM solve on
the reference's 29,310-point scan, tst/point2point.cpp, and a vmapped batch
of 64) go to extra_metrics.

The reference publishes no benchmark numbers (BASELINE.md); its execution
environment is single-process CPU. `vs_baseline` therefore reports the
speedup of the GPU path over the same engine on this machine's CPU backend
(the reference's hardware class), measured fresh in the same run. The ICP
CPU leg enables x64 so its baseline is genuine f64 + the reference's
finite-difference scheme (its only implemented path); the GPU legs are the
f32 production default.

Prints the card's name and power limit, then ONE JSON line: {"metric",
"value", "unit", "vs_baseline", "extra_metrics", "device"}. Any failed leg
fails the run.
"""

import json
import pathlib
import time
import sys

import numpy as np


def _make_problem(dtype, jnp):
    from moptimizer_jax.lie import se3
    from moptimizer_jax.models.point2point import point2point_block
    from moptimizer_jax.core.residual import Problem
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    data_path = pathlib.Path(__file__).parent / "tests" / "data" / "fachada.txt"
    if data_path.exists():
        src = load_txt_cloud(data_path).astype(dtype)
    else:
        src = np.random.default_rng(0).uniform(0, 30, size=(29310, 3)).astype(dtype)
    src = jnp.asarray(src)
    x_true = jnp.asarray([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], dtype=dtype)
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return Problem(blocks=(point2point_block(src, tgt),))


def _time_solve(problem, x0, config, devices, jax, reps=4):
    """Median per-solve wall time, dispatch-overhead-corrected.

    (a) K solves are chained inside ONE jitted lax.scan dispatch
    (production pipelining); (b) the result is materialized on the host
    (np.asarray) before the timer stops; (c) per-solve time is the
    two-point slope (t(K2)-t(K1))/(K2-K1), canceling the fixed dispatch
    cost.
    """
    import jax.numpy as jnp

    from moptimizer_jax.core.solver import levenberg_marquardt

    x0 = jax.device_put(x0, devices[0])
    problem = jax.device_put(problem, devices[0])

    def make(K):
        @jax.jit
        def run_k(problem, x0):
            def body(carry, _):
                # carry-perturbed start prevents cross-iteration CSE while
                # staying in the convergence basin
                res = levenberg_marquardt(problem, x0 + 1e-6 * carry, config)
                return res.x, (res.cost, res.iterations)

            xs, (costs, iters) = jax.lax.scan(
                body, jnp.zeros_like(x0), None, length=K
            )
            return xs[-1], costs, iters

        return run_k

    k1, k2 = 2, 12
    f1, f2 = make(k1), make(k2)
    np.asarray(f1(problem, x0)[0])  # warm-up compile + execute
    out2 = f2(problem, x0)
    np.asarray(out2[0])
    # executed outer LM iterations of every timed solve: the while_loop can
    # exit early on convergence, so alignments/s is only interpretable with
    # this number attached
    iters = np.asarray(out2[2])
    t1 = t2 = float("inf")
    for _ in range(reps):  # interleaved so drift cancels in the slope
        t0 = time.perf_counter()
        np.asarray(f1(problem, x0)[0])
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(f2(problem, x0)[0])
        t2 = min(t2, time.perf_counter() - t0)
    return max((t2 - t1) / (k2 - k1), 1e-9), iters


def _time_batched_solve(problem, x0, config, devices, jax, B=64, reps=3):
    """Per-alignment seconds with B solves vmapped into one program.

    The single-solve path is latency-bound (a 29k-pt cloud leaves the card
    mostly idle per LM iteration); levenberg_marquardt_batched turns the
    accept/reject control flow into masking and runs B instances wide.
    Same slope methodology as _time_solve."""
    import jax.numpy as jnp

    from moptimizer_jax.core.solver import levenberg_marquardt_batched

    x0 = jax.device_put(x0, devices[0])
    problem = jax.device_put(problem, devices[0])
    # per-instance start offsets (within the basin) so the B lanes are
    # genuinely distinct solves
    x0s = jnp.tile(x0, (B, 1)) + 1e-5 * jnp.arange(B, dtype=x0.dtype)[:, None]

    def make(K):
        @jax.jit
        def run_k(problem, x0s):
            def body(carry, _):
                # batch_data=False: all B instances share the one cloud in
                # HBM; per-instance x0 perturbations keep the solves distinct
                res = levenberg_marquardt_batched(
                    problem, x0s + 1e-6 * carry, config, batch_data=False
                )
                return res.x, res.iterations

            xs, its = jax.lax.scan(body, jnp.zeros_like(x0s), None, length=K)
            return xs[-1], its

        return run_k

    k1, k2 = 1, 5
    f1, f2 = make(k1), make(k2)
    np.asarray(f1(problem, x0s)[0])
    out2 = f2(problem, x0s)
    np.asarray(out2[0])
    iters = np.asarray(out2[1])
    t1 = t2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(f1(problem, x0s)[0])
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(f2(problem, x0s)[0])
        t2 = min(t2, time.perf_counter() - t0)
    per_batch = max((t2 - t1) / (k2 - k1), 1e-9)
    return per_batch / B, iters


def _make_ba_problem(O, C, L, jnp, dtype=np.float32, seed=0):
    """Synthetic BA instance at the north-star scale (BASELINE.md)."""
    import dataclasses

    import jax

    from moptimizer_jax import ba

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, size=(L, 3)) + np.array([0.0, 0.0, 30.0])
    cams = np.stack(
        [
            np.concatenate(
                [[0.08 * i - 0.04 * C, 0.5 * rng.normal(), 0.0], 0.02 * rng.normal(size=3)]
            )
            for i in range(C)
        ]
    )
    pt_idx = np.sort(rng.integers(0, L, size=O))
    cam_idx = rng.integers(0, C, size=O)
    prob = ba.BAProblem(
        camera_params=jnp.asarray(cams, dtype),
        points=jnp.asarray(pts, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        pixels=jnp.zeros((O, 2), dtype),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0], dtype),
        n_fixed_cameras=2,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(
        prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics
    )
    pixels = np.asarray(pixels) + 0.5 * rng.normal(size=pixels.shape)
    return dataclasses.replace(
        prob,
        pixels=jnp.asarray(pixels, dtype),
        camera_params=prob.camera_params
        + 0.01
        * jnp.asarray(rng.normal(size=cams.shape), dtype)
        * (jnp.arange(C) >= 2)[:, None].astype(dtype),
        points=prob.points + 0.05 * jnp.asarray(rng.normal(size=pts.shape), dtype),
    )


def _time_ba_outer_iter(jax, jnp, O=500_000, C=200, L=50_000, k1=1, k2=5):
    """Per-outer-iteration seconds of the dense-Schur BA engine.

    K chained ba_step_dense calls inside one jitted scan; two-point slope
    cancels the fixed dispatch latency (same methodology as _time_solve)."""
    import dataclasses

    from moptimizer_jax import ba_dense

    prob = _make_ba_problem(O, C, L, jnp)
    grouped = ba_dense.group_by_landmark(prob, segments="auto")
    config = ba_dense.DenseBAConfig()

    def make(K):
        @jax.jit
        def run_k(prob, grouped):
            # landmark state stays in grid-row order across the chained
            # steps (sorted once here, like _solve_dense_device) so the
            # valence-segmented grid costs zero per-iteration gathers
            def body(carry, _):
                cams, pts, lam = carry
                cams, pts, lam, _, _, rec = ba_dense._dense_outer_step(
                    cams, pts, prob.intrinsics, grouped, prob.loss,
                    prob.n_fixed_cameras, lam, config,
                )
                return (cams, pts, lam), rec["cost"]

            (cams, _, _), costs = jax.lax.scan(
                body,
                (
                    prob.camera_params,
                    grouped.sort_points(prob.points),
                    jnp.asarray(-1.0, prob.points.dtype),
                ),
                None,
                length=K,
            )
            return cams, costs

        return run_k

    f1, f2 = make(k1), make(k2)
    np.asarray(f1(prob, grouped)[0])  # warm-up compile + execute
    np.asarray(f2(prob, grouped)[0])
    t1 = t2 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.asarray(f1(prob, grouped)[0])
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(f2(prob, grouped)[0])
        t2 = min(t2, time.perf_counter() - t0)
    return max((t2 - t1) / (k2 - k1), 1e-9)


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.splitlines()[0].strip()


def main():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax.core.solver import LMConfig
    from moptimizer_jax.utils.cache import enable_persistent_cache

    accel = jax.devices()
    if accel[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is {accel[0].platform!r}")
    enable_persistent_cache()  # process restarts reuse the big executables
    card = _card()

    cfg_gpu = LMConfig(diff_mode="auto", linear_solver="cholesky", max_iterations=15)

    # HEADLINE: dense-Schur BA outer iterations/s at O=500k (tens of ms of
    # device work per step). A failed leg fails the run.
    t_ba = _time_ba_outer_iter(jax, jnp)
    value = 1.0 / t_ba

    prob = _make_problem(np.float32, jnp)
    x0 = jnp.zeros(6, dtype=jnp.float32)
    t_accel, iters_accel = _time_solve(prob, x0, cfg_gpu, accel, jax)
    icp_single = 1.0 / t_accel
    it_lo, it_hi = int(iters_accel.min()), int(iters_accel.max())

    # Batched-serving throughput: B=64 solves vmapped into one program
    # (levenberg_marquardt_batched) — the single-solve path leaves the card
    # mostly idle per LM iteration at 29k points.
    t_b, iters_b = _time_batched_solve(prob, x0, cfg_gpu, accel, jax)
    extra = [
        {
            "metric": "icp_alignments_per_sec_batch64",
            "value": round(1.0 / t_b, 3),
            "unit": (
                "alignments/s (29310-pt cloud, B=64 vmapped solves, "
                f"executed {int(iters_b.min())}-{int(iters_b.max())} iters)"
            ),
        }
    ]

    # BA headline baseline: the same dense-Schur step on the CPU backend at
    # a reduced instance (the 500k-obs instance takes minutes per step on
    # CPU), measured fresh in this run beside the GPU leg at the same size.
    t_ba_gpu_small = _time_ba_outer_iter(jax, jnp, O=50_000, C=50, L=5_000)
    cpu = jax.devices("cpu")
    with jax.default_device(cpu[0]):
        t_ba_cpu_small = _time_ba_outer_iter(jax, jnp, O=50_000, C=50, L=5_000)
    ba_vs_baseline = t_ba_cpu_small / t_ba_gpu_small
    print(
        f"# ba O=50k step: gpu {t_ba_gpu_small * 1e3:.3f} ms, "
        f"cpu {t_ba_cpu_small * 1e3:.3f} ms",
        file=sys.stderr,
    )

    # CPU reference-class baseline of the ICP solve: same engine, CPU
    # backend, genuine f64 + the reference's finite-difference scheme (its
    # only implemented path). x64 is flipped on only now — after every f32
    # GPU leg has run — so the baseline really computes in double precision.
    jax.config.update("jax_enable_x64", True)
    with jax.default_device(cpu[0]):
        prob_cpu = _make_problem(np.float64, jnp)
        assert prob_cpu.blocks[0].data["src"].dtype == jnp.float64
        cfg_cpu = LMConfig(diff_mode="fd", max_iterations=15)
        t_cpu, _ = _time_solve(
            prob_cpu, jnp.zeros(6, dtype=jnp.float64), cfg_cpu, cpu, jax, reps=2
        )
    vs_baseline = t_cpu / t_accel

    extra.append(
        {
            "metric": "icp_alignments_per_sec",
            "value": round(icp_single, 3),
            "unit": (
                "alignments/s (29310-pt cloud, LM max 15 outer iters, "
                f"executed {it_lo}" + (f"-{it_hi}" if it_hi != it_lo else "")
                + " per solve; vs_baseline = same engine on the CPU in f64)"
            ),
            "vs_baseline": round(vs_baseline, 3),
        }
    )
    d = accel[0]
    print(f"card: {card}")
    print(
        json.dumps(
            {
                "metric": "ba_outer_iters_per_sec",
                "value": round(value, 3),
                "unit": (
                    "outer LM iters/s (dense-Schur BA, O=500k C=200 L=50k, f32; "
                    "vs_baseline = same engine on the CPU at O=50k, this run)"
                ),
                "vs_baseline": round(ba_vs_baseline, 3),
                "extra_metrics": extra,
                "device": {
                    "platform": d.platform,
                    "kind": d.device_kind,
                    "count": len(accel),
                    "card": card,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
