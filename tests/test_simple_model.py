"""Rational-model convergence parity, float32 (reference tst/simple_model.cpp)."""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block


@pytest.mark.parametrize("x0", [(0.9, 0.2), (1.9, 1.5)])
def test_converges_f32(x0):
    """→ (0.362, 0.556) ± 0.01 from both starts, float32 like the reference
    (tst/simple_model.cpp:9,33-34)."""
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float32)
    res = levenberg_marquardt(
        problem(blk), jnp.array(x0, dtype=jnp.float32), LMConfig(diff_mode="fd")
    )
    assert res.x.dtype == jnp.float32
    np.testing.assert_allclose(res.x[0], 0.362, atol=0.01)
    np.testing.assert_allclose(res.x[1], 0.556, atol=0.01)


@pytest.mark.parametrize("x0", [(0.9, 0.2), (1.9, 1.5)])
def test_converges_f64(x0):
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    res = levenberg_marquardt(
        problem(blk), jnp.array(x0, dtype=jnp.float64), LMConfig(diff_mode="fd")
    )
    np.testing.assert_allclose(res.x[0], 0.362, atol=0.01)
    np.testing.assert_allclose(res.x[1], 0.556, atol=0.01)


def test_block_reuse_across_solves():
    """The same cost object drives two optimizers (reference
    tst/simple_model.cpp:44-67): blocks are immutable pytrees, so reuse is
    trivially safe."""
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    r1 = levenberg_marquardt(problem(blk), jnp.array([0.9, 0.2]), LMConfig(diff_mode="fd"))
    r2 = levenberg_marquardt(problem(blk), jnp.array([1.9, 1.5]), LMConfig(diff_mode="fd"))
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-3)
