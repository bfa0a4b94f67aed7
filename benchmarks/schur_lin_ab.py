"""A/B: Schur-build panel casts/chunking + linearize gather precision.

  * build_schur: bf16 G/A2 panels (halves the A2 materialization) and a
    larger scan chunk (fewer (6C)² carry round-trips).
  * linearize: the per-observation camera-cache "gather" is a one-hot
    matmul at the library-wide 'highest'; a lower precision is safe only
    if it keeps residual VALUES (costs) exact enough.

Run on a GPU: python -m benchmarks.schur_lin_ab
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from moptimizer_jax import ba, ba_dense


def slope(name, body, init, reps=3, k1=1, k2=5):
    def make(K):
        @jax.jit
        def run(c):
            def step(c, _):
                c2, probe = body(c)
                return c2, probe

            c, probes = jax.lax.scan(step, c, None, length=K)
            return probes[-1]

        return run

    f1, f2 = make(k1), make(k2)
    np.asarray(f1(init)); np.asarray(f2(init))
    t1 = t2 = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter(); np.asarray(f1(init)); t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter(); np.asarray(f2(init)); t2 = min(t2, time.perf_counter() - t0)
    dt = (t2 - t1) / (k2 - k1)
    print(f"{name:58s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def build_schur_var(U_d, Linv, W, grouped, fixed_mask, C, chunk, cast):
    """_build_schur with optional bf16 G/A2 panels."""
    L, K = grouped.cam_ids.shape
    dtype = U_d.dtype
    G = jnp.sum(W[:, :, :, None, :] * Linv[:, None, None, :, :], axis=-1)
    if cast:
        G = G.astype(jnp.bfloat16)
    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L
    if pad:
        G = jnp.pad(G, ((0, pad), (0, 0), (0, 0), (0, 0)))
        cam_ids = jnp.pad(grouped.cam_ids, ((0, pad), (0, 0)))
        mask = jnp.pad(grouped.mask, ((0, pad), (0, 0)))
    else:
        cam_ids, mask = grouped.cam_ids, grouped.mask
    Gc = G.reshape(n_chunks, chunk, K, 6, 3)
    cc = cam_ids.reshape(n_chunks, chunk, K)
    mc = mask.reshape(n_chunks, chunk, K)

    def body(S, args):
        Gk, ck, mk = args
        oh = (ck[..., None] == jnp.arange(C, dtype=ck.dtype)).astype(Gk.dtype)
        oh = oh * mk[..., None].astype(Gk.dtype)
        with jax.default_matmul_precision("default"):
            A2 = jnp.einsum("qkim,qkc->qmic", Gk, oh).reshape(chunk * 3, 6 * C)
            S2 = jnp.matmul(A2.T, A2, preferred_element_type=jnp.float32)
        return S + S2, None

    S0 = jnp.zeros((C * 6, C * 6), jnp.float32)
    S_corr, _ = jax.lax.scan(body, S0, (Gc, cc, mc))
    S = -S_corr.astype(dtype)
    cidx = jnp.arange(C, dtype=jnp.int32)
    i6 = C * jnp.arange(6, dtype=jnp.int32)
    rows = (cidx[:, None, None] + i6[None, :, None] + jnp.zeros((1, 1, 6), jnp.int32)).reshape(-1)
    cols = (cidx[:, None, None] + jnp.zeros((1, 6, 1), jnp.int32) + i6[None, None, :]).reshape(-1)
    S = S.at[rows, cols].add(U_d.reshape(-1))
    free = jnp.tile(fixed_mask, 6)
    S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    return S


def main():
    import bench as top_bench

    O, C, L = 500_000, 200, 50_000
    print(f"devices: {jax.devices()}  O={O} C={C} L={L}", flush=True)
    prob = top_bench._make_ba_problem(O, C, L, jnp)
    grouped = ba_dense.group_by_landmark(prob)
    cams, pts, intr = prob.camera_params, prob.points, prob.intrinsics
    dtype = cams.dtype
    lam = jnp.asarray(1e-6, dtype)
    fixed = (jnp.arange(C) >= prob.n_fixed_cameras).astype(dtype)
    eps = jnp.asarray(1e-30, dtype)

    r, A, B = jax.jit(
        lambda c, p: ba_dense._linearize_grouped(c, p, intr, grouped)
    )(cams, pts)
    U, V, W, g, h = jax.jit(
        lambda r: ba_dense._gn_blocks_grouped(grouped, r, A, B, C, None)
    )(r)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
    Linv = jax.jit(lambda V: ba_dense._tri_inv_lower(ba_dense._chol3x3(V)))(V_d)

    def s_base(c):
        S = ba_dense._build_schur(
            ba._damp_blocks(c, lam), Linv, W, grouped, fixed,
            chunk=512, precision="default",
        )
        p = jnp.sum(S[0])
        return c + eps * p, p

    slope("schur v0: current (chunk 512, f32 panels)", s_base, U)

    for chunk in (512, 2048):
        for cast in (False, True):
            def s_var(c, chunk=chunk, cast=cast):
                S = build_schur_var(
                    ba._damp_blocks(c, lam), Linv, W, grouped, fixed, C,
                    chunk, cast,
                )
                p = jnp.sum(S[0])
                return c + eps * p, p

            slope(f"schur chunk={chunk} bf16_panels={cast}", s_var, U)

    # numerics of the bf16-panel S vs baseline
    S0 = jax.jit(
        lambda U: ba_dense._build_schur(
            ba._damp_blocks(U, lam), Linv, W, grouped, fixed, chunk=512,
            precision="default",
        )
    )(U)
    S1 = jax.jit(
        lambda U: build_schur_var(
            ba._damp_blocks(U, lam), Linv, W, grouped, fixed, C, 2048, True
        )
    )(U)
    ds = float(jnp.max(jnp.abs(S1 - S0)) / jnp.max(jnp.abs(S0)))
    print(f"bf16-panel S agreement vs current default: max rel {ds:.2e}")

    # --- linearize gather precision
    def lin_var(c, precision):
        cams_c, pts_c = c
        cache = ba_dense._camera_cache(cams_c)
        with jax.default_matmul_precision(precision):
            g21 = ba_dense._gather_cache(cache, grouped, C)
        p = jnp.sum(g21[0])
        return (cams_c + eps * p, pts_c), p

    for prec in ("highest", "high", "default"):
        slope(f"camera-cache gather einsum [{prec}]",
              lambda c, prec=prec: lin_var(c, prec), (cams, pts))

    # end-to-end linearize with the gather at 'high'
    def lin_full(c, precision):
        cams_c, pts_c = c
        with jax.default_matmul_precision(precision):
            r, A, B = ba_dense._linearize_grouped(cams_c, pts_c, intr, grouped)
        p = jnp.sum(r[0]) + jnp.sum(A[0, 0]) + jnp.sum(B[0, 0])
        return (cams_c + eps * p, pts_c), p

    for prec in ("highest", "high"):
        slope(f"linearize_grouped end-to-end [{prec}]",
              lambda c, prec=prec: lin_full(c, prec), (cams, pts))

    r0, A0, B0 = jax.jit(
        lambda c, p: ba_dense._linearize_grouped(c, p, intr, grouped)
    )(cams, pts)
    with jax.default_matmul_precision("high"):
        r1, A1, B1 = jax.jit(
            lambda c, p: ba_dense._linearize_grouped(c, p, intr, grouped)
        )(cams, pts)
    dr = float(jnp.max(jnp.abs(r1 - r0)))
    print(f"gather 'high' residual agreement: max abs dr {dr:.2e} "
          f"(r scale {float(jnp.max(jnp.abs(r0))):.1f})")


if __name__ == "__main__":
    main()
