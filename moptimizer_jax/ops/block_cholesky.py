"""Blocked Cholesky factorization built from matmuls.

Hypothesis this module tests: XLA's Cholesky factorizes in fixed panels
whose triangular solves might serialize poorly at N = 10k–20k, so a
matmul-dominant recursion could win. On the accelerator the engine was
first built for, the A/B (benchmarks/cholesky_ab.py) refuted it, so
`spd_solve`'s "auto" routes to XLA's solve; the blocked form remains as an
explicit option because it also produces L⁻¹ (amortizable across repeated
solves). PERF.md has the GPU A/B. The recursion is the classic
divide-and-conquer

    A = [[A11, A21ᵀ],  →  L = [[L11,  0 ],   with  L11 = chol(A11)
         [A21, A22]]         [L21, L22]]          L21 = A21·L11⁻ᵀ
                                                  L22 = chol(A22 − L21·L21ᵀ)

co-recursing on the triangular inverse

    L⁻¹ = [[L11⁻¹, 0], [−L22⁻¹·L21·L11⁻¹, L22⁻¹]]

so the off-diagonal panel is a pure matmul (A21 @ iL11ᵀ) instead of a
triangular solve. The recursion is Python-unrolled (depth ~log₂(N/base),
all shapes static), every non-base op is an (n/2)³-scale matmul, and
base-case blocks (≤ `base`) use XLA's Cholesky where it is cheap. Total work stays the textbook N³/3 (+N³/3 for
the inverse factor, which the caller's solve then gets for free: two
matvecs replace two triangular solves).

This is the large-C camera solve of the dense-Schur BA engine
(ba_dense.py) — the reference solves its (P×P) system with Eigen LDLT
(/root/reference/src/levenberg_marquadt_dyn.cpp:78).
"""

from functools import partial

import jax
import jax.numpy as jnp


def _split_point(n, base):
    """First-block size: half of n, rounded up to a multiple of base.

    For n > base this is always in [base, n-1], keeping both halves
    tile-aligned (multiples of `base`, itself a multiple of 128) except the
    final remainder block.
    """
    half = -(-n // 2)
    return base * (-(-half // base))


def _chol_inv_rec(A, base):
    """Returns (L, L⁻¹) for SPD A — the co-recursion described above."""
    n = A.shape[0]
    if n <= base:
        L = jnp.linalg.cholesky(A)
        iL = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(n, dtype=A.dtype), lower=True
        )
        return L, iL
    n1 = _split_point(n, base)
    A11 = A[:n1, :n1]
    A21 = A[n1:, :n1]
    A22 = A[n1:, n1:]
    L11, iL11 = _chol_inv_rec(A11, base)
    L21 = A21 @ iL11.T
    L22, iL22 = _chol_inv_rec(A22 - L21 @ L21.T, base)
    iL21 = -(iL22 @ (L21 @ iL11))
    z = jnp.zeros((n1, n - n1), dtype=A.dtype)
    L = jnp.block([[L11, z], [L21, L22]])
    iL = jnp.block([[iL11, z], [iL21, iL22]])
    return L, iL


@partial(jax.jit, static_argnames=("base",))
def blocked_cholesky_and_inverse(A, base=256):
    """(L, L⁻¹) of SPD A by matmul-dominant recursion. jit-cached per shape."""
    return _chol_inv_rec(A, base)


def blocked_cholesky(A, base=256):
    """Lower Cholesky factor of SPD A (see module docstring)."""
    return blocked_cholesky_and_inverse(A, base)[0]


def spd_solve_blocked(A, b, base=256):
    """Solve A x = b (A SPD) via the blocked factorization.

    With L⁻¹ in hand the solve is x = L⁻ᵀ(L⁻¹ b) — two matvecs (matmuls for
    matrix b), no sequential triangular substitution on device.
    """
    _, iL = blocked_cholesky_and_inverse(A, base)
    return iL.T @ (iL @ b)


def spd_solve(A, b, method="auto", base=256):
    """Dense SPD solve.

    method:
      "xla"     — jax.scipy cho_factor/cho_solve (XLA's Cholesky).
      "blocked" — matmul-dominant blocked factorization (this module).
      "auto"    — "xla" at every size. The recursion pays an extra N³/3
                  for the inverse factor plus jnp.block relayouts;
                  benchmarks/cholesky_ab.py times both (PERF.md). "blocked"
                  is kept as an explicit option (it also yields L⁻¹, useful
                  when many solves share one factorization).

    Called inside jit with static shapes, so the routing is trace-time.
    """
    if method == "auto":
        method = "xla"
    if method == "xla":
        return jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(A), b)
    if method == "blocked":
        return spd_solve_blocked(A, b, base=base)
    raise ValueError(f"unknown SPD solve method {method!r}")
