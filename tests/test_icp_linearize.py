"""Fused moment-based ICP linearization ≡ generic AD path."""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import GemanMcClure, LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import linearize
from moptimizer_jax.core.residual import problem
from moptimizer_jax.lie import se3
from moptimizer_jax.models.point2point import point2point_block
from moptimizer_jax.ops.icp_linearize import icp_linearize


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(0, 10, (5000, 3)))
    x_true = jnp.asarray([1.0, 2.0, 3.0, 0.2, 0.2, 0.2])
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return src, tgt, x_true


@pytest.mark.parametrize("loss", [None, "gm"])
def test_fused_equals_ad(clouds, loss):
    src, tgt, _ = clouds
    loss_obj = GemanMcClure(tau=jnp.asarray(2.0)) if loss else None
    x = jnp.asarray([0.5, 0.0, 0.2, 0.1, -0.05, 0.0])
    blk_f = point2point_block(src, tgt, fused=True, loss=loss_obj)
    blk_g = point2point_block(src, tgt, fused=False, loss=loss_obj)
    c1, H1, b1 = linearize(blk_f, x, mode="auto")
    c0, H0, b0 = linearize(blk_g, x, mode="auto")
    np.testing.assert_allclose(c1, c0, rtol=1e-13)
    np.testing.assert_allclose(H1, H0, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(b1, b0, rtol=1e-9, atol=1e-8)


def test_fused_with_validity_mask(clouds):
    src, tgt, _ = clouds
    x = jnp.asarray([0.1, 0.0, 0.0, 0.02, 0.0, 0.0])
    valid = jnp.arange(src.shape[0]) % 3 != 0

    c_f, H_f, b_f = icp_linearize(src, tgt, x, __import__("moptimizer_jax").TrivialLoss(), valid=valid)

    # generic path with the same mask via tuple-return residual
    from moptimizer_jax.core.residual import make_block
    from moptimizer_jax.models.point2point import _prepare

    def residual(T, d):
        return T[:3, :3] @ d["src"] + T[:3, 3] - d["tgt"], d["valid"]

    blk = make_block(residual, data=dict(src=src, tgt=tgt, valid=valid), prepare_fn=_prepare)
    c_g, H_g, b_g = linearize(blk, x, mode="auto")
    np.testing.assert_allclose(c_f, c_g, rtol=1e-13)
    np.testing.assert_allclose(H_f, H_g, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(b_f, b_g, rtol=1e-9, atol=1e-8)


def test_fused_solver_trajectory_matches_generic(clouds):
    src, tgt, x_true = clouds
    cfg = LMConfig(diff_mode="auto", max_iterations=30)
    res_f = levenberg_marquardt(problem(point2point_block(src, tgt, fused=True)), jnp.zeros(6), cfg)
    res_g = levenberg_marquardt(problem(point2point_block(src, tgt, fused=False)), jnp.zeros(6), cfg)
    np.testing.assert_allclose(res_f.x, res_g.x, atol=1e-9)
    np.testing.assert_allclose(res_f.x, x_true, atol=1e-8)
