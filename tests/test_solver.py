"""Practical stopping rules (LMConfig.rel_cost_tol / grad_tol, r4).

The reference's convergence surface (optimizer.h:26-29, delta.h:12-16) is
matched exactly by the default config; these opt-in rules terminate
noise-floor solves early.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import problem
from moptimizer_jax.core.solver import LMConfig, Status, levenberg_marquardt
def test_rel_cost_tol_stops_at_noise_floor():
    """rel_cost_tol: an accepted step improving cost by < tol·y0 terminates
    with CONVERGED, in fewer iterations than the parity run — and the
    default (0.0) leaves the parity trace untouched."""
    import numpy as np

    from moptimizer_jax.models import exponential_curve_block

    blk = exponential_curve_block()
    x0 = jnp.zeros(2, dtype=jnp.float64)
    base = levenberg_marquardt(
        problem(blk), x0, LMConfig(max_iterations=50, diff_mode="auto")
    )
    stopped = levenberg_marquardt(
        problem(blk),
        x0,
        LMConfig(max_iterations=50, diff_mode="auto", rel_cost_tol=1e-8),
    )
    assert int(stopped.iterations) < int(base.iterations)
    assert int(stopped.status) == int(Status.CONVERGED)
    # the minimum reached is the same (curve-fit oracle tolerance)
    np.testing.assert_allclose(
        np.asarray(stopped.x), np.asarray(base.x), atol=5e-5
    )
    # default-off config reproduces the parity iterate sequence exactly
    again = levenberg_marquardt(
        problem(blk), x0, LMConfig(max_iterations=50, diff_mode="auto")
    )
    np.testing.assert_array_equal(np.asarray(again.trace["cost"]), np.asarray(base.trace["cost"]))


def test_grad_tol_stops_converged():
    """grad_tol: starting AT the optimum with a gradient tolerance set
    terminates immediately with CONVERGED."""
    import numpy as np

    from moptimizer_jax.models import exponential_curve_block

    blk = exponential_curve_block()
    x0 = jnp.zeros(2, dtype=jnp.float64)
    base = levenberg_marquardt(
        problem(blk), x0, LMConfig(max_iterations=50, diff_mode="auto")
    )
    res = levenberg_marquardt(
        problem(blk),
        jnp.asarray(base.x),
        LMConfig(max_iterations=50, diff_mode="auto", grad_tol=1e-6),
    )
    assert int(res.iterations) == 0
    assert int(res.status) == int(Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(base.x))


def test_stopping_config_validation():
    import pytest

    with pytest.raises(ValueError):
        LMConfig(rel_cost_tol=-1.0)
    with pytest.raises(ValueError):
        LMConfig(grad_tol=-0.5)
