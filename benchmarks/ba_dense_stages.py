"""Stage-by-stage timing of the dense-Schur BA outer iteration.

Jits each stage separately at bench.py's BA shapes (O=500k, C=200, L=50k)
and times one dispatch per stage, so each number includes the dispatch
cost; benchmarks/ba_dense_stages_slope.py cancels it.
Run: python -m benchmarks.ba_dense_stages
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from moptimizer_jax import ba, ba_dense


def bench(name, fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    print(f"{name:45s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def main():
    import bench as top_bench  # repo-root bench.py problem factory

    O, C, L = 500_000, 200, 50_000
    print(f"devices: {jax.devices()}  O={O} C={C} L={L}", flush=True)
    prob = top_bench._make_ba_problem(O, C, L, jnp)
    grouped = ba_dense.group_by_landmark(prob)
    K = grouped.cam_ids.shape[1]
    print(f"grid: L={L} K={K} padding={L*K/O:.2f}", flush=True)

    cams, pts, intr = prob.camera_params, prob.points, prob.intrinsics
    dtype = cams.dtype
    lam = jnp.asarray(1e-6, dtype)
    fixed = (jnp.arange(C) >= prob.n_fixed_cameras).astype(dtype)

    lin = jax.jit(lambda c, p: ba_dense._linearize_grouped(c, p, intr, grouped))
    r, A, B = lin(cams, pts)

    gn = jax.jit(lambda r, A, B: ba_dense._gn_blocks_grouped(grouped, r, A, B, C, None))
    U, V, W, g, h = gn(r, A, B)

    def vinv_stage(V):
        V_d = ba._damp_blocks(V, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
        Lv = jnp.linalg.cholesky(V_d)
        Linv = ba_dense._tri_inv_lower(Lv)
        return Linv

    Linv = jax.jit(vinv_stage)(V)

    schur = jax.jit(
        lambda U, Linv, W: ba_dense._build_schur(
            ba._damp_blocks(U, lam), Linv, W, grouped, fixed, chunk=512
        )
    )
    S = schur(U, Linv, W)

    solve_x = jax.jit(lambda S, g: ba_dense.block_cholesky.spd_solve(S, g.reshape(-1), "xla"))
    solve_b = jax.jit(lambda S, g: ba_dense.block_cholesky.spd_solve(S, g.reshape(-1), "blocked"))

    full_solve = jax.jit(
        lambda lam_k: ba_dense._solve_delta_dense(
            grouped, C, U, V, W, g, h, lam_k, fixed, 512
        )
    )
    cost = jax.jit(lambda c, p: ba_dense._cost_grouped(c, p, intr, grouped))
    step = jax.jit(
        lambda c, p, lam: ba_dense._dense_outer_step(
            c, p, intr, grouped, None, prob.n_fixed_cameras, lam,
            ba_dense.DenseBAConfig(),
        )[2]
    )

    bench("linearize_grouped (r, A, B)", lin, cams, pts)
    bench("gn_blocks (U, V, W, g, h)", gn, r, A, B)
    bench("V damp + chol + tri_inv", jax.jit(vinv_stage), V)
    bench("build_schur S (6C)^2", schur, U, Linv, W)
    bench("camera solve (XLA expander, n=1200)", solve_x, S, g)
    bench("camera solve (blocked, n=1200)", solve_b, S, g)
    bench("solve_delta_dense (full inner trial)", full_solve, lam)
    bench("cost_grouped", cost, cams, pts)
    bench("FULL outer step (1 lin + 3 trials)", step, cams, pts, lam)


if __name__ == "__main__":
    main()
