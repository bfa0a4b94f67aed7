"""Curve-fitting convergence parity (reference tst/curve_fitting.cpp:101-147)."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models import exponential_curve_block


def test_initial_condition_1():
    """From (0,0): → (0.291861, 0.131439) ± 5e-5 (reference :116-117)."""
    blk = exponential_curve_block()
    res = levenberg_marquardt(problem(blk), jnp.array([0.0, 0.0]), LMConfig(diff_mode="fd"))
    np.testing.assert_allclose(res.x[0], 0.291861, atol=5e-5)
    np.testing.assert_allclose(res.x[1], 0.131439, atol=5e-5)


def test_initial_condition_2():
    """From (1.2, 2.0), 50 iterations: ± 1e-4 (reference :123-147)."""
    blk = exponential_curve_block()
    res = levenberg_marquardt(
        problem(blk),
        jnp.array([1.2, 2.0]),
        LMConfig(diff_mode="fd", max_iterations=50),
    )
    np.testing.assert_allclose(res.x[0], 0.291861, atol=1e-4)
    np.testing.assert_allclose(res.x[1], 0.131439, atol=1e-4)


def test_auto_diff_matches_fd():
    """jacfwd and the reference FD scheme land on the same minimum."""
    blk = exponential_curve_block()
    x0 = jnp.array([0.0, 0.0])
    res_fd = levenberg_marquardt(problem(blk), x0, LMConfig(diff_mode="fd"))
    res_ad = levenberg_marquardt(problem(blk), x0, LMConfig(diff_mode="auto"))
    np.testing.assert_allclose(res_fd.x, res_ad.x, atol=1e-6)


def test_trace_is_monotone_while_accepting():
    blk = exponential_curve_block()
    res = levenberg_marquardt(problem(blk), jnp.array([0.0, 0.0]), LMConfig(diff_mode="fd"))
    costs = np.asarray(res.trace["cost"])
    valid = np.isfinite(costs)
    accepted = np.asarray(res.trace["accepted"])[valid]
    c = costs[valid]
    # cost recorded at each outer iteration never increases across accepted steps
    assert np.all(np.diff(c[: accepted.sum() + 1]) <= 1e-12)
