"""Linearization unit tests: derivative cross-checks, covariance scaling,
loss semantics, validity masking.

Mirrors reference tst/differentiation.cpp, tst/covariance.cpp and the loss
asymmetry pinned by linearization.h:108-115.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import GemanMcClure, LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import compute_cost, linearize
from moptimizer_jax.core.residual import make_block, problem
from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_jax.models.powell import powell_block
from moptimizer_jax.models.accelerometer import accelerometer_block

# differentiation.cpp uses a 9-point extension of the simple dataset (:48-49)
DIFF_X = [0.038, 0.194, 0.425, 0.626, 1.253, 2.5, 3.70, 5, 0]
DIFF_Y = [0.05, 0.127, 0.094, 0.2122, 0.2729, 0.2665, 0.3317, 0.2, 0]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_analytic_vs_numerical_simple(dtype):
    """Analytical ≈ numerical cost & Hessian (reference tst/differentiation.cpp:47-77)."""
    blk = rational_block(DIFF_X, DIFF_Y, analytic=True, dtype=dtype)
    x0 = jnp.array([0.9, 0.2], dtype=dtype)
    c_ana, H_ana, b_ana = linearize(blk, x0, mode="analytic")
    c_num, H_num, b_num = linearize(blk, x0, mode="fd")
    c_ad, H_ad, b_ad = linearize(blk, x0, mode="auto")
    np.testing.assert_allclose(c_ana, c_num, atol=1e-4)
    np.testing.assert_allclose(H_ana, H_num, atol=5e-3)
    np.testing.assert_allclose(b_ana, b_num, atol=5e-3)
    # AD agrees with analytic to near machine precision
    tol = 1e-5 if dtype == jnp.float32 else 1e-12
    np.testing.assert_allclose(H_ana, H_ad, rtol=tol, atol=tol)


def test_analytic_vs_ad_powell():
    blk = powell_block(analytic=True)
    x0 = jnp.array([3.0, -1.0, 0.0, 4.0])
    _, H_ana, b_ana = linearize(blk, x0, mode="analytic")
    _, H_ad, b_ad = linearize(blk, x0, mode="auto")
    np.testing.assert_allclose(H_ana, H_ad, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(b_ana, b_ad, rtol=1e-12, atol=1e-12)


def test_analytic_vs_ad_accelerometer():
    """reference tst/differentiation.cpp:163-188 — with the full left
    Jacobian, analytic == AD to machine precision."""
    m = np.array([0.1, 9.7, 0.3])
    blk_a = accelerometer_block(m, analytic=True)
    x0 = jnp.array([0.3, -0.1, 0.2])
    c_a, H_a, b_a = linearize(blk_a, x0, mode="analytic")
    c_d, H_d, b_d = linearize(blk_a, x0, mode="auto")
    np.testing.assert_allclose(c_a, c_d, rtol=1e-12)
    np.testing.assert_allclose(H_a, H_d, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(b_a, b_d, rtol=1e-10, atol=1e-12)


def test_identity_covariance_is_noop():
    """Σ = I leaves H, b unchanged (reference tst/covariance.cpp:26-43)."""
    blk_no = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float32)
    blk_id = rational_block(
        SIMPLE_X, SIMPLE_Y, weight_matrix=jnp.eye(1, dtype=jnp.float32), dtype=jnp.float32
    )
    x0 = jnp.array([1.9, 1.5], dtype=jnp.float32)
    _, H0, b0 = linearize(blk_no, x0, mode="fd")
    _, H1, b1 = linearize(blk_id, x0, mode="fd")
    np.testing.assert_allclose(H0, H1, atol=1e-5)
    np.testing.assert_allclose(b0, b1, atol=1e-5)


def test_scaled_covariance_scales_h_and_b():
    """Σ = c·I scales H and b by c (reference tst/covariance.cpp:45-63)."""
    c = 0.5
    blk_no = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float32)
    blk_c = rational_block(
        SIMPLE_X, SIMPLE_Y, weight_matrix=c * jnp.eye(1, dtype=jnp.float32), dtype=jnp.float32
    )
    x0 = jnp.array([1.9, 1.5], dtype=jnp.float32)
    _, H0, b0 = linearize(blk_no, x0, mode="fd")
    _, H1, b1 = linearize(blk_c, x0, mode="fd")
    np.testing.assert_allclose(H1, H0 * c, atol=1e-5)
    np.testing.assert_allclose(b1, b0 * c, atol=1e-5)


def test_loss_weights_h_b_but_not_cost():
    """Reference asymmetry (linearization.h:108-115): loss multiplies H,b,
    never the returned cost."""
    loss = GemanMcClure(tau=jnp.asarray(2.0))
    blk_plain = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    blk_loss = rational_block(SIMPLE_X, SIMPLE_Y, loss=loss, dtype=jnp.float64)
    x0 = jnp.array([1.9, 1.5])
    c0, H0, b0 = linearize(blk_plain, x0, mode="auto")
    c1, H1, b1 = linearize(blk_loss, x0, mode="auto")
    np.testing.assert_allclose(c0, c1, rtol=1e-14)  # cost unweighted
    assert not np.allclose(H0, H1)  # H is weighted
    np.testing.assert_allclose(compute_cost(blk_loss, x0), c0, rtol=1e-14)


def test_geman_mcclure_convergence():
    """GM(τ=100) leaves the well-posed minimum unchanged
    (reference tst/loss_function.cpp:45-60), float32."""
    loss = GemanMcClure(tau=jnp.asarray(100.0, jnp.float32))
    for x0 in [(0.9, 0.2), (1.9, 1.5)]:
        blk = rational_block(SIMPLE_X, SIMPLE_Y, loss=loss, dtype=jnp.float32)
        res = levenberg_marquardt(
            problem(blk), jnp.array(x0, jnp.float32), LMConfig(diff_mode="fd")
        )
        np.testing.assert_allclose(res.x[0], 0.362, atol=0.01)
        np.testing.assert_allclose(res.x[1], 0.556, atol=0.01)


def test_validity_mask():
    """residual_fn returning (r, valid) masks residuals out of cost and H,b
    (reference model.h:33 bool return)."""

    def residual(x, d):
        r = jnp.array([d[1] - x[0] * d[0]])
        return r, d[0] > 0.5  # only "far" points are valid

    data = jnp.array([[0.1, 1.0], [1.0, 2.0], [2.0, 4.0]])
    blk = make_block(residual, data=data)
    x0 = jnp.array([1.0])
    c, H, b = linearize(blk, x0, mode="auto")
    # manually: only rows 1,2 contribute
    r_valid = np.array([2.0 - 1.0, 4.0 - 2.0])
    J_valid = np.array([[-1.0], [-2.0]])
    np.testing.assert_allclose(c, np.sum(r_valid**2), rtol=1e-14)
    np.testing.assert_allclose(H, J_valid.T @ J_valid, rtol=1e-14)
    np.testing.assert_allclose(b, J_valid.T @ r_valid, rtol=1e-14)


def test_fd_matches_reference_step_rule():
    """FD Jacobian uses h_j = √ε·|x_j| floored at √ε (linearization.h:78-93):
    check against a hand-rolled implementation."""
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    x0 = np.array([0.9, 0.0])  # second coord exactly 0 → floor kicks in
    eps = np.finfo(np.float64).eps
    h = np.sqrt(eps) * np.abs(x0)
    h[h == 0.0] = np.sqrt(eps)

    def r(x):
        x_arr, y_arr = np.asarray(SIMPLE_X), np.asarray(SIMPLE_Y)
        return y_arr - (x[0] * x_arr) / (x[1] + x_arr)

    J_manual = np.stack(
        [(r(x0 + h[j] * np.eye(2)[j]) - r(x0)) / h[j] for j in range(2)], axis=-1
    )[:, None, :]
    from moptimizer_jax.core.linearize import _batched_residuals, _jacobian_fd

    r0, _ = _batched_residuals(blk, jnp.asarray(x0))
    J = _jacobian_fd(blk, jnp.asarray(x0), r0)
    np.testing.assert_allclose(J, J_manual, rtol=1e-12)


def test_per_residual_weight_matrices():
    """(N,O,O) weight matrices: block-diagonal Σ sandwich per residual
    (GICP-style heteroscedastic information; extends reference covariance)."""
    import numpy as _np

    rng = _np.random.default_rng(12)
    from moptimizer_jax.models.point2point import point2point_block

    src = jnp.asarray(rng.uniform(0, 5, (50, 3)))
    tgt = jnp.asarray(rng.uniform(0, 5, (50, 3)))
    # random SPD per-point 3x3 informations
    A = rng.normal(size=(50, 3, 3))
    Sigmas = jnp.asarray(A @ A.transpose(0, 2, 1) + 3 * _np.eye(3))
    x0 = jnp.array([0.1, -0.2, 0.05, 0.02, 0.01, -0.03])

    blk = point2point_block(src, tgt, fused=False, weight_matrix=Sigmas)
    c, H, b = linearize(blk, x0, mode="auto")

    # oracle: loop accumulation
    from moptimizer_jax.core.linearize import _batched_residuals, _jacobian_auto

    r, _ = _batched_residuals(blk, x0)
    J = _jacobian_auto(blk, x0)
    H_ref = sum(_np.asarray(J[i]).T @ _np.asarray(Sigmas[i]) @ _np.asarray(J[i]) for i in range(50))
    b_ref = sum(_np.asarray(J[i]).T @ _np.asarray(Sigmas[i]) @ _np.asarray(r[i]) for i in range(50))
    np.testing.assert_allclose(H, H_ref, rtol=1e-10)
    np.testing.assert_allclose(b, b_ref, rtol=1e-10)
    np.testing.assert_allclose(c, _np.sum(_np.asarray(r) ** 2), rtol=1e-12)
