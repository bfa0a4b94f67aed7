"""Blocked matmul Cholesky (ops/block_cholesky.py) vs XLA's Cholesky.

The blocked factorization must be numerically interchangeable with
jnp.linalg.cholesky — same factor (Cholesky is unique for SPD), same
solves — including at sizes that exercise the recursion's uneven splits
and the base case. It is the large-C camera solve of the dense-Schur BA
engine (reference dense solve: Eigen LDLT,
/root/reference/src/levenberg_marquadt_dyn.cpp:78).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import ba_dense
from moptimizer_jax.ops import block_cholesky

from test_ba import make_synthetic_ba


def make_spd(n, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T / n + np.eye(n)  # well-conditioned SPD
    return jnp.asarray(A, dtype)


@pytest.mark.parametrize("n", [16, 64, 300, 700])
def test_blocked_matches_xla_factor(n):
    """Same lower factor as jnp.linalg.cholesky (base case, uneven split,
    multi-level recursion)."""
    A = make_spd(n, seed=n)
    L_ref = jnp.linalg.cholesky(A)
    L, iL = block_cholesky.blocked_cholesky_and_inverse(A, base=128)
    np.testing.assert_allclose(np.asarray(L), np.asarray(L_ref), rtol=0, atol=1e-10)
    # iL really is the inverse factor
    np.testing.assert_allclose(
        np.asarray(iL @ L), np.eye(n), rtol=0, atol=1e-10
    )
    # strictly lower output above the diagonal is exactly zero
    assert np.all(np.triu(np.asarray(L), 1) == 0)
    assert np.all(np.triu(np.asarray(iL), 1) == 0)


@pytest.mark.parametrize("n", [64, 300])
def test_spd_solve_paths_agree(n):
    A = make_spd(n, seed=n + 1)
    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    x_ref = jnp.linalg.solve(A, b)
    for method in ("xla", "blocked", "auto"):
        x = block_cholesky.spd_solve(A, b, method=method, base=128)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), atol=1e-10)
    with pytest.raises(ValueError):
        block_cholesky.spd_solve(A, b, method="nope")


def test_split_point_alignment():
    """Both recursion halves stay base-aligned except the final remainder."""
    for n in range(129, 4096, 257):
        n1 = block_cholesky._split_point(n, 128)
        assert 128 <= n1 < n
        assert n1 % 128 == 0


def test_dense_ba_blocked_solver_matches_xla():
    """The dense-Schur engine produces the same trajectory with either
    camera-system solver — the blocked path is numerically interchangeable
    with the expander, not a different algorithm."""
    start, _ = make_synthetic_ba(C=8, L=60, noise=0.5, seed=11)
    res_x = ba_dense.solve_ba_dense(
        start, ba_dense.DenseBAConfig(schur_solver="xla")
    )
    res_b = ba_dense.solve_ba_dense(
        start, ba_dense.DenseBAConfig(schur_solver="blocked")
    )
    np.testing.assert_allclose(
        np.asarray(res_b.camera_params), np.asarray(res_x.camera_params),
        atol=1e-8,
    )
    # FP-level divergence in the solve may shift the SMALL_DELTA stop by an
    # iteration or two; the trajectory over the common prefix and the final
    # cost must agree.
    n = min(int(res_x.iterations), int(res_b.iterations))
    np.testing.assert_allclose(
        np.asarray(res_b.trace["cost"])[:n], np.asarray(res_x.trace["cost"])[:n],
        rtol=1e-9,
    )
    np.testing.assert_allclose(float(res_b.cost), float(res_x.cost), rtol=1e-10)
