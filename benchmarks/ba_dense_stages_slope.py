"""Slope-measured stage budget of the dense-Schur BA outer iteration.

benchmarks/ba_dense_stages.py times one dispatch per stage, which carries
the dispatch latency plus result-transfer time. This driver uses the same two-point-slope methodology as the headline
(bench._time_ba_outer_iter): each stage runs K times CHAINED inside one
jitted lax.scan (a negligible epsilon feedback keeps XLA from collapsing
the chain), and (t_K2 − t_K1)/(K2 − K1) cancels the fixed costs.

Measures the valence-segmented layout (group_by_landmark(segments=
"auto") — the headline path). Pass --flat to budget the historical
single-K grid instead.

Run on a GPU: python -m benchmarks.ba_dense_stages_slope
"""

import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from moptimizer_jax import ba, ba_dense


def slope(name, make_body, init_carry, reps=3, k1=1, k2=5):
    """Per-iteration seconds of body chained K times in one jitted scan."""

    def make(K):
        @jax.jit
        def run(carry):
            def step(c, _):
                c2, probe = make_body(c)
                return c2, probe

            c, probes = jax.lax.scan(step, carry, None, length=K)
            return probes[-1]

        return run

    f1, f2 = make(k1), make(k2)
    np.asarray(f1(init_carry))  # compile + execute
    np.asarray(f2(init_carry))
    t1 = t2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(f1(init_carry))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(f2(init_carry))
        t2 = min(t2, time.perf_counter() - t0)
    dt = (t2 - t1) / (k2 - k1)
    print(f"{name:45s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def main():
    import bench as top_bench  # repo-root bench.py problem factory

    O, C, L = 500_000, 200, 50_000
    segments = 1 if "--flat" in sys.argv else "auto"
    print(f"devices: {jax.devices()}  O={O} C={C} L={L}", flush=True)
    prob = top_bench._make_ba_problem(O, C, L, jnp)
    grouped = ba_dense.group_by_landmark(prob, segments=segments)
    K = grouped.cam_ids.shape[1]
    slot_work = sum(
        (e - s) * k
        for (s, _), (e, k) in zip(
            [(0, 0)] + list(grouped.seg_bounds), grouped.seg_bounds
        )
    ) if grouped.seg_bounds else L * K
    print(
        f"grid: L={L} K={K} segs={grouped.seg_bounds or '(single)'} "
        f"slot-work={slot_work} ({slot_work/(L*K):.2f}x of single-K, "
        f"{slot_work/O:.2f}x of O)",
        flush=True,
    )
    config = ba_dense.DenseBAConfig()

    cams, intr = prob.camera_params, prob.intrinsics
    pts = grouped.sort_points(prob.points)
    dtype = cams.dtype
    lam = jnp.asarray(1e-6, dtype)
    fixed = (jnp.arange(C) >= prob.n_fixed_cameras).astype(dtype)
    eps = jnp.asarray(1e-30, dtype)
    segs = ba_dense._seg_views(grouped)

    U, V, W, g, h, _ = jax.jit(
        lambda c, p: ba_dense._linearize_and_blocks(c, p, intr, grouped, None)
    )(cams, pts)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
    Linv = jax.jit(
        lambda V: ba_dense._tri_inv_lower(ba_dense._chol3x3(V))
    )(V_d)
    S = jax.jit(
        lambda U, Linv, W: ba_dense._build_schur(
            ba._damp_blocks(U, lam), Linv, W, grouped, fixed,
            chunk=config.schur_chunk, precision=config.schur_precision,
        )
    )(U, Linv, W)
    # per-segment (r, A, B) for the gn-blocks-only stage
    rab = [
        jax.jit(
            lambda c, p, seg=seg, sl=sl: ba_dense._linearize_grouped(
                c, p[sl], intr, seg
            )
        )(cams, pts)
        for sl, seg in segs
    ]

    total = {}

    def lin_body(c):
        cams_c, pts_c = c
        probe = eps * 0.0
        for sl, seg in segs:
            r, A, B = ba_dense._linearize_grouped(cams_c, pts_c[sl], intr, seg)
            probe = probe + jnp.sum(r[0]) + jnp.sum(A[0, 0]) + jnp.sum(B[0, 0])
        return (cams_c + eps * probe, pts_c), probe

    total["linearize"] = slope("linearize_grouped (r, A, B)", lin_body, (cams, pts))

    def gn_body(c):
        scale = c
        probe = eps * 0.0
        for (sl, seg), (r, A, B) in zip(segs, rab):
            U, V, W, g, h = ba_dense._gn_blocks_grouped(
                seg, r * scale, A, B, C, None
            )
            probe = probe + jnp.sum(g) + jnp.sum(h) + jnp.sum(U[0]) + jnp.sum(W[0, 0])
        return scale + eps * probe, probe

    total["gn_blocks"] = slope(
        "gn_blocks (U, V, W, g, h)", gn_body, jnp.ones((), dtype)
    )

    def vinv_body(c):
        V_c = c
        Vd = ba._damp_blocks(V_c, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
        Li = ba_dense._tri_inv_lower(ba_dense._chol3x3(Vd))
        probe = jnp.sum(Li[0])
        return V_c + eps * probe, probe

    total["vinv"] = slope("V damp + chol3x3 + tri_inv (closed form)", vinv_body, V)

    def schur_body(c):
        U_c = c
        S = ba_dense._build_schur(
            ba._damp_blocks(U_c, lam), Linv, W, grouped, fixed,
            chunk=config.schur_chunk, precision=config.schur_precision,
        )
        probe = jnp.sum(S[0])
        return U_c + eps * probe, probe

    total["schur"] = slope(
        f"build_schur S (6C)^2 [{config.schur_precision}]", schur_body, U
    )

    def cam_solve_body(c):
        g_c = c
        d = ba_dense.block_cholesky.spd_solve(S, g_c.reshape(-1), "xla")
        probe = jnp.sum(d)
        return g_c + eps * probe, probe

    total["cam_solve"] = slope("camera solve (XLA expander)", cam_solve_body, g)

    def backsub_body(c):
        g_c = c
        # back-substitution alone: recover δl from δc (the tail of
        # _solve_delta_dense after the camera solve)
        d_cam = ba_dense.block_cholesky.spd_solve(S, g_c.reshape(-1), "xla").reshape(C, 6)
        Vinv = jnp.einsum("lji,ljk->lik", Linv, Linv)
        Wtd_l = []
        for (sl, seg), W_s in zip(segs, W):
            oh = jax.nn.one_hot(seg.cam_ids, C, dtype=dtype)
            dc_g = jnp.einsum("lkc,ci->lki", oh, d_cam)
            Wtd_l.append(jnp.sum(W_s * dc_g[..., :, None], axis=(1, 2)))
        Wtd = jnp.concatenate(Wtd_l, axis=0) if len(Wtd_l) > 1 else Wtd_l[0]
        d_pt = jnp.sum(Vinv * (-h - Wtd)[:, None, :], axis=-1)
        probe = jnp.sum(d_pt)
        return g_c + eps * probe, probe

    t_backsub_plus = slope("cam solve + back-substitute", backsub_body, g)
    total["backsub"] = t_backsub_plus - total["cam_solve"]
    print(f"{'  -> back-substitution alone':45s} {total['backsub']*1e3:9.2f} ms")

    def cost_body(c):
        cams_c = c
        y = ba_dense._cost_grouped(cams_c, pts, intr, grouped)
        return cams_c + eps * y, y

    total["cost"] = slope("cost_grouped", cost_body, cams)

    def step_body(c):
        cams_c, pts_c, lam_c = c
        cams2, pts2, lam2, _, _, rec = ba_dense._dense_outer_step(
            cams_c, pts_c, intr, grouped, prob.loss, prob.n_fixed_cameras,
            lam_c, config,
        )
        return (cams2, pts2, lam2), rec["cost"]

    t_step = slope(
        "FULL outer step (1 lin + <=3 trials)", step_body,
        (cams, pts, jnp.asarray(-1.0, dtype)),
    )

    print("\nstage budget vs full step:")
    acc = 0.0
    # one outer step = linearize + gn_blocks + (vinv + schur + cam_solve +
    # backsub) per executed inner trial (typically 1 once converged-ish;
    # the scan-measured step executes its accept on trial 1) + 1-2 cost evals
    one_trial = total["vinv"] + total["schur"] + total["cam_solve"] + total["backsub"]
    for k, v in total.items():
        print(f"  {k:12s} {v*1e3:7.2f} ms")
        acc += v
    print(f"  {'sum(1 trial)':12s} {(total['linearize']+total['gn_blocks']+one_trial+total['cost'])*1e3:7.2f} ms")
    print(f"  {'full step':12s} {t_step*1e3:7.2f} ms")


if __name__ == "__main__":
    main()
