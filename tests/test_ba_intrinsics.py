"""Self-calibrating BA: Schur solve vs dense oracle + intrinsics recovery."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba, ba_intrinsics
from tests.test_ba import make_synthetic_ba
import pytest


@pytest.mark.slow
def test_selfcal_schur_matches_dense_oracle():
    """One damped (cams, pts, θ) solve ≡ dense (6C+3L+4) damped solve."""
    prob, _ = make_synthetic_ba(C=3, L=14, n_fixed=1)
    r, A, B, K = ba_intrinsics._linearize_full(prob)
    blocks = ba_intrinsics._gn_blocks_full(prob, r, A, B, K)
    lam = 1e-4
    cfg = ba.BAConfig(cg_iterations=400, cg_tol=1e-14)
    d_cam, d_pt, d_t = ba_intrinsics._solve_delta_full(prob, blocks, lam, cfg)

    C, L, O = 3, 14, len(prob.cam_idx)
    n = 6 * C + 3 * L + 4
    J = np.zeros((2 * O, n))
    rr = np.asarray(r).reshape(-1)
    for o in range(O):
        c, l = int(prob.cam_idx[o]), int(prob.pt_idx[o])
        J[2 * o : 2 * o + 2, 6 * c : 6 * c + 6] = np.asarray(A[o])
        J[2 * o : 2 * o + 2, 6 * C + 3 * l : 6 * C + 3 * l + 3] = np.asarray(B[o])
        J[2 * o : 2 * o + 2, 6 * C + 3 * L :] = np.asarray(K[o])
    H = J.T @ J
    b = J.T @ rr
    Hd = H + lam * np.diag(np.diag(H))
    free = np.ones(n, bool)
    free[:6] = False
    delta = np.zeros(n)
    delta[free] = np.linalg.solve(Hd[np.ix_(free, free)], -b[free])

    np.testing.assert_allclose(np.asarray(d_cam).reshape(-1), delta[: 6 * C], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d_pt).reshape(-1), delta[6 * C : 6 * C + 3 * L], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(d_t), delta[6 * C + 3 * L :], rtol=1e-5, atol=1e-9)


def test_selfcal_recovers_perturbed_intrinsics():
    """Start with wrong focal lengths/principal point: self-cal BA recovers
    the true intrinsics and geometry (noise-free observations)."""
    start, gt = make_synthetic_ba(C=6, L=60, n_fixed=2, seed=13)
    wrong_intr = gt.intrinsics + jnp.asarray([8.0, -6.0, 3.0, -2.0])
    start = dataclasses.replace(start, intrinsics=wrong_intr)

    res, intr = ba_intrinsics.solve_ba_selfcal(start, ba.BAConfig(max_iterations=40))
    assert float(res.cost) < 1e-9
    np.testing.assert_allclose(intr, gt.intrinsics, atol=1e-2)
    np.testing.assert_allclose(res.points, gt.points, atol=1e-4)


def test_selfcal_fixed_intrinsics_consistency():
    """With intrinsics already exact, self-cal matches plain BA's solution."""
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=14)
    res_plain = ba.solve_ba(start, ba.BAConfig(max_iterations=30))
    res_cal, intr = ba_intrinsics.solve_ba_selfcal(start, ba.BAConfig(max_iterations=30))
    assert float(res_cal.cost) < 1e-10
    np.testing.assert_allclose(intr, gt.intrinsics, atol=1e-4)
    np.testing.assert_allclose(res_cal.points, res_plain.points, atol=1e-5)
