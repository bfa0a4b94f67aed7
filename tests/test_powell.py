"""Powell singular-function parity (reference tst/powell.cpp:62-136)."""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models.powell import powell_block

X0 = jnp.array([3.0, -1.0, 0.0, 4.0])
CFG = dict(max_iterations=25)


@pytest.mark.parametrize("mode", ["fd", "auto"])
def test_converges_to_zero(mode):
    """25 iterations → all params 0 ± 5e-5 (reference :79-81)."""
    res = levenberg_marquardt(
        problem(powell_block()), X0, LMConfig(diff_mode=mode, **CFG)
    )
    np.testing.assert_allclose(res.x, np.zeros(4), atol=5e-5)


def test_analytic_jacobian():
    res = levenberg_marquardt(
        problem(powell_block(analytic=True)), X0, LMConfig(diff_mode="analytic", **CFG)
    )
    np.testing.assert_allclose(res.x, np.zeros(4), atol=5e-5)


def test_scaled_covariance_still_converges():
    """Σ = 0.01·I "still works" (reference :107-136)."""
    blk = powell_block(weight_matrix=0.01 * jnp.eye(4))
    res = levenberg_marquardt(problem(blk), X0, LMConfig(diff_mode="fd", **CFG))
    np.testing.assert_allclose(res.x, np.zeros(4), atol=5e-5)
