"""A/B microbench: _gn_blocks_grouped variants at the headline BA shape.

Candidates: matmul precision on the one-hot U/g contractions (library
default is 'highest'), bf16 panel casts (halves the AtA/one-hot traffic,
f32 accumulation — the schur_precision='default' trade applied to the U
panel), and a chunked scan (bounds the live one-hot). Slope-measured.

Run on a GPU: python -m benchmarks.gn_blocks_ab
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
    print(f"{name:55s} {dt*1e3:9.2f} ms", flush=True)
    return dt


def main():
    import bench as top_bench

    O, C, L = 500_000, 200, 50_000
    print(f"devices: {jax.devices()}  O={O} C={C} L={L}", flush=True)
    prob = top_bench._make_ba_problem(O, C, L, jnp)
    grouped = ba_dense.group_by_landmark(prob)
    cams, pts, intr = prob.camera_params, prob.points, prob.intrinsics
    r, A, B = jax.jit(
        lambda c, p: ba_dense._linearize_grouped(c, p, intr, grouped)
    )(cams, pts)
    eps = jnp.asarray(1e-30, r.dtype)

    def probe_of(U, V, W, g, h):
        return jnp.sum(g) + jnp.sum(h) + jnp.sum(U[0]) + jnp.sum(W[0, 0])

    # --- baseline: current production path
    def v0(c):
        out = ba_dense._gn_blocks_grouped(grouped, c, A, B, C, None)
        p = probe_of(*out)
        return c + eps * p, p

    base = slope("v0 current (highest precision, f32 panels)", v0, r)

    # --- v1: default matmul precision on the U/g one-hot contractions
    def gn_var(r_c, precision, cast):
        Aw, Bw, rw = A, B, r_c
        AtA = ba._outer_rows(Aw, A)
        V = jnp.sum(ba._outer_rows(Bw, B), axis=1)
        W = ba._outer_rows(Aw, B)
        Ar = A[..., 0, :] * rw[..., 0, None] + A[..., 1, :] * rw[..., 1, None]
        h = jnp.sum(
            B[..., 0, :] * rw[..., 0, None] + B[..., 1, :] * rw[..., 1, None], axis=1
        )
        oh = ba_dense._cam_onehot(grouped.cam_ids, grouped.mask, C, r.dtype)
        if cast:
            oh = oh.astype(jnp.bfloat16)
            AtA = AtA.astype(jnp.bfloat16)
            Ar = Ar.astype(jnp.bfloat16)
        with jax.default_matmul_precision(precision):
            U = jnp.einsum(
                "lkc,lkjm->cjm", oh, AtA, preferred_element_type=jnp.float32
            )
            g = jnp.einsum(
                "lkc,lkj->cj", oh, Ar, preferred_element_type=jnp.float32
            )
        return U.astype(r.dtype), V, W, g.astype(r.dtype), h

    def v1(c):
        out = gn_var(c, "default", False)
        p = probe_of(*out)
        return c + eps * p, p

    slope("v1 default precision, f32 panels", v1, r)

    def v2(c):
        out = gn_var(c, "default", True)
        p = probe_of(*out)
        return c + eps * p, p

    slope("v2 default precision, bf16 one-hot+AtA panels", v2, r)

    # --- v3: chunked scan for U/g (live one-hot bounded), f32
    def v3_body(r_c, cast):
        K = grouped.cam_ids.shape[1]
        chunk = 5000  # divides L=50k exactly
        n_chunks = L // chunk
        AtA = ba._outer_rows(A, A)
        Ar = A[..., 0, :] * r_c[..., 0, None] + A[..., 1, :] * r_c[..., 1, None]
        if cast:
            AtA = AtA.astype(jnp.bfloat16)
            Ar = Ar.astype(jnp.bfloat16)
        AtAc = AtA.reshape(n_chunks, chunk, K, 36)
        Arc = Ar.reshape(n_chunks, chunk, K, 6)
        cc = grouped.cam_ids.reshape(n_chunks, chunk, K)
        mc = grouped.mask.reshape(n_chunks, chunk, K)

        def bd(carry, args):
            Uc, gc = carry
            AtAk, Ark, ck, mk = args
            oh = (ck[..., None] == jnp.arange(C, dtype=ck.dtype)).astype(
                AtAk.dtype
            ) * mk[..., None].astype(AtAk.dtype)
            with jax.default_matmul_precision("default"):
                Uc = Uc + jnp.einsum(
                    "qkc,qkm->cm", oh, AtAk, preferred_element_type=jnp.float32
                )
                gc = gc + jnp.einsum(
                    "qkc,qkj->cj", oh, Ark, preferred_element_type=jnp.float32
                )
            return (Uc, gc), None

        (U, g), _ = jax.lax.scan(
            bd,
            (jnp.zeros((C, 36), jnp.float32), jnp.zeros((C, 6), jnp.float32)),
            (AtAc, Arc, cc, mc),
        )
        V = jnp.sum(ba._outer_rows(B, B), axis=1)
        W = ba._outer_rows(A, B)
        h = jnp.sum(
            B[..., 0, :] * r_c[..., 0, None] + B[..., 1, :] * r_c[..., 1, None],
            axis=1,
        )
        return U.reshape(C, 6, 6).astype(r.dtype), V, W, g.astype(r.dtype), h

    def v3(c):
        out = v3_body(c, False)
        p = probe_of(*out)
        return c + eps * p, p

    slope("v3 chunked scan U/g, f32", v3, r)

    def v4(c):
        out = v3_body(c, True)
        p = probe_of(*out)
        return c + eps * p, p

    slope("v4 chunked scan U/g, bf16 panels", v4, r)

    # numerics: U/g agreement of the bf16 variant vs baseline
    U0, V0, W0, g0, h0 = jax.jit(
        lambda r_c: ba_dense._gn_blocks_grouped(grouped, r_c, A, B, C, None)
    )(r)
    U2, _, _, g2, _ = jax.jit(lambda r_c: gn_var(r_c, "default", True))(r)
    du = float(jnp.max(jnp.abs(U2 - U0)) / jnp.max(jnp.abs(U0)))
    dg = float(jnp.max(jnp.abs(g2 - g0)) / jnp.max(jnp.abs(g0)))
    print(f"\nbf16 panel agreement: max rel dU {du:.2e}, dg {dg:.2e}")


if __name__ == "__main__":
    main()
