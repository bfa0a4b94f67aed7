"""End-to-end A/B: matrix-free Schur-CG engine vs dense-Schur engine on a
production-scale BA problem, measured honestly (host-read sync, interleaved,
min over reps) on the device.

Usage: python -m benchmarks.ba_engines_ab [O C L]
"""

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba, ba_dense


def make_problem(O, C, L, dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, size=(L, 3)) + np.array([0.0, 0.0, 30.0])
    cams = np.stack(
        [
            np.concatenate(
                [
                    [0.08 * i - 0.04 * C, 0.5 * rng.normal(), 0.0],
                    0.02 * rng.normal(size=3),
                ]
            )
            for i in range(C)
        ]
    )
    # each landmark observed by a random subset of cameras, sorted by landmark
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
    pixels = pixels + 0.5 * rng.normal(size=pixels.shape)
    prob = dataclasses.replace(prob, pixels=jnp.asarray(pixels, dtype))
    # perturb the state so LM has real work
    start = dataclasses.replace(
        prob,
        camera_params=prob.camera_params
        + 0.01
        * jnp.asarray(rng.normal(size=cams.shape), dtype)
        * (jnp.arange(C) >= 2)[:, None].astype(dtype),
        points=prob.points + 0.05 * jnp.asarray(rng.normal(size=pts.shape), dtype),
    )
    return start


def slope_steps_dense(prob, grouped, config, k1=1, k2=5, reps=3):
    """Marginal seconds per chained ba_step_dense (bench.py methodology)."""

    def make(K):
        @jax.jit
        def run_k(prob, grouped):
            def body(carry, _):
                cams, pts, lam = carry
                p = dataclasses.replace(prob, camera_params=cams, points=pts)
                cams, pts, lam, _, _, rec = ba_dense.ba_step_dense.__wrapped__(
                    p, grouped, lam, config
                )
                return (cams, pts, lam), rec["cost"]

            (cams, _, _), costs = jax.lax.scan(
                body,
                (prob.camera_params, prob.points, jnp.asarray(-1.0, jnp.float32)),
                None,
                length=K,
            )
            return cams, costs

        return run_k

    f1, f2 = make(k1), make(k2)
    np.asarray(f1(prob, grouped)[0])
    np.asarray(f2(prob, grouped)[0])
    t1 = t2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(f1(prob, grouped)[0])
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(f2(prob, grouped)[0])
        t2 = min(t2, time.perf_counter() - t0)
    return (t2 - t1) / (k2 - k1)


def main():
    O, C, L = (int(a) for a in sys.argv[1:4]) if len(sys.argv) > 3 else (500_000, 200, 50_000)
    iters = 10
    prob = make_problem(O, C, L)
    grouped = ba_dense.group_by_landmark(prob)
    K = grouped.pixels.shape[1]
    print(f"# O={O} C={C} L={L} K={K} padding factor {L*K/O:.2f}")

    cfg_cg = ba.BAConfig(max_iterations=iters, cg_iterations=50)
    cfg_d = ba_dense.DenseBAConfig(max_iterations=iters, schur_chunk=1024)

    def run_cg():
        res = ba.solve_ba(prob, cfg_cg)
        return np.asarray(res.camera_params), np.asarray(res.trace["cost_new"])

    def run_dense():
        res = ba_dense.solve_ba_dense(prob, cfg_d, grouped=grouped)
        return np.asarray(res.camera_params), np.asarray(res.trace["cost_new"])

    # warm-up (compile + one run each)
    t0 = time.perf_counter(); cams_cg, cost_cg = run_cg(); print(f"# cg warm {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter(); cams_d, cost_d = run_dense(); print(f"# dense warm {time.perf_counter()-t0:.1f}s")
    # EXECUTED iterations (the while_loop exits early on convergence —
    # dividing wall time by max_iterations would dilute ms/outer-iter)
    it_cg = int(np.sum(~np.isnan(cost_cg)))
    it_d = int(np.sum(~np.isnan(cost_d)))
    print(f"# executed outer iterations: cg={it_cg} dense={it_d} (max {iters})")
    print(f"# final cost cg={cost_cg[~np.isnan(cost_cg)][-1]:.6g} dense={cost_d[~np.isnan(cost_d)][-1]:.6g}")
    print(f"# cam agreement max|Δ| = {np.max(np.abs(cams_cg - cams_d)):.3g}")

    best = {"cg": float("inf"), "dense": float("inf")}
    for _ in range(3):
        t0 = time.perf_counter(); run_cg(); best["cg"] = min(best["cg"], time.perf_counter() - t0)
        t0 = time.perf_counter(); run_dense(); best["dense"] = min(best["dense"], time.perf_counter() - t0)
    for k, v, n in (("cg", best["cg"], it_cg), ("dense", best["dense"], it_d)):
        print(f"{k:<6} {v:8.3f}s  ({v/n*1e3:7.1f} ms/executed-outer-iter)")
    print(f"speedup dense vs cg (whole solve): {best['cg']/best['dense']:.2f}x")

    # Reconciliation leg: the same outer iteration
    # timed as chained ba_step_dense calls (bench.py's slope methodology).
    dt = slope_steps_dense(prob, grouped, ba_dense.DenseBAConfig())
    print(
        f"dense ba_step slope: {dt*1e3:.1f} ms/outer-iter "
        "(chained scan, marginal — the steady-state pipelined rate; the "
        "whole-solve figure above includes non-overlapped warm-up/cool-down "
        "and any inner-retry-heavy early iterations)"
    )


if __name__ == "__main__":
    main()
