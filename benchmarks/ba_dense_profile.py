"""Component-level timing of the dense-Schur outer iteration at scale.

Each component runs K1/K2 times inside one jitted fori_loop with a value
perturbation + host-read sync; the two-point slope is the per-call device
time (benchmarks/segment_ops_ab.py methodology).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba, ba_dense

try:
    from benchmarks.ba_engines_ab import make_problem  # repo root: -m benchmarks.*
except ImportError:
    from ba_engines_ab import make_problem  # run from benchmarks/

K1, K2 = 2, 10


def slope(fn, *args):
    """fn(scalar_carry, *args) -> scalar; returns per-call seconds."""

    def make(K):
        @jax.jit
        def loop(*a):
            def body(_, s):
                return fn(s, *a)

            return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

        return loop

    f1, f2 = make(K1), make(K2)
    float(f1(*args))
    float(f2(*args))
    t1 = t2 = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        float(f1(*args))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(f2(*args))
        t2 = min(t2, time.perf_counter() - t0)
    return (t2 - t1) / (K2 - K1)


def main():
    O, C, L = 500_000, 200, 50_000
    prob = make_problem(O, C, L)
    grouped = ba_dense.group_by_landmark(prob)
    dtype = prob.camera_params.dtype
    cams, pts, intr = prob.camera_params, prob.points, prob.intrinsics
    lam = jnp.asarray(1e-4, dtype)
    fixed = (jnp.arange(C) >= 2).astype(dtype)

    r, A, B = ba_dense._linearize_grouped(cams, pts, intr, grouped)
    U, V, W, g, h = ba_dense._gn_blocks_grouped(grouped, r, A, B, C, None)
    U_d = ba._damp_blocks(U, lam)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
    Lv = jnp.linalg.cholesky(V_d)
    Linv = ba_dense._tri_inv_lower(Lv)
    S = ba_dense._build_schur(U_d, Linv, W, grouped, fixed, chunk=1024)
    print("# shapes ready")

    def t_linearize(s, cams):
        r, A, B = ba_dense._linearize_grouped(cams + s * 1e-12, pts, intr, grouped)
        return r.reshape(-1)[0] + A.reshape(-1)[0] + B.reshape(-1)[0]

    def t_gn(s, r, A, B):
        U, V, W, g, h = ba_dense._gn_blocks_grouped(
            grouped, r + s * 1e-12, A, B, C, None
        )
        return U.reshape(-1)[0] + V.reshape(-1)[0] + W.reshape(-1)[0] + g.reshape(-1)[0]

    def t_schur(s, U_d, Linv, W):
        S = ba_dense._build_schur(U_d + s * 1e-12, Linv, W, grouped, fixed, chunk=1024)
        return S.reshape(-1)[0]

    def t_chol(s, S, g):
        cf = jax.scipy.linalg.cho_factor(S + s * 1e-12)
        return jax.scipy.linalg.cho_solve(cf, g.reshape(-1))[0]

    def t_cost(s, cams):
        return ba_dense._cost_grouped(cams + s * 1e-12, pts, intr, grouped) * 1e-12

    def t_vinv(s, V_d):
        Lv = jnp.linalg.cholesky(V_d + s * 1e-12 * jnp.eye(3, dtype=dtype))
        return ba_dense._tri_inv_lower(Lv).reshape(-1)[0]

    for name, fn, args in [
        ("linearize (L,K grid)", t_linearize, (cams,)),
        ("gn_blocks", t_gn, (r, A, B)),
        ("V chol+inv", t_vinv, (V_d,)),
        ("schur build", t_schur, (U_d, Linv, W)),
        ("chol solve 6Cx6C", t_chol, (S, g)),
        ("cost eval", t_cost, (cams,)),
    ]:
        print(f"{name:<22}{slope(fn, *args)*1e3:9.2f} ms")


if __name__ == "__main__":
    main()
