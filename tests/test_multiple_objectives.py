"""Split-cost invariance (reference tst/multiple_objectives.cpp:102-132):
splitting 67 residuals into 30+37 blocks yields the same trajectory to 1e-8."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import linearize
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA, exponential_curve_block


def test_split_cost_same_minimum():
    single = problem(exponential_curve_block(CERES_CURVE_DATA))
    multi = problem(
        exponential_curve_block(CERES_CURVE_DATA[:30]),
        exponential_curve_block(CERES_CURVE_DATA[30:]),
    )
    x0 = jnp.array([0.0, 0.0])
    cfg = LMConfig(diff_mode="fd")
    res_single = levenberg_marquardt(single, x0, cfg)
    res_multi = levenberg_marquardt(multi, x0, cfg)

    np.testing.assert_allclose(res_multi.x, res_single.x, atol=1e-8)
    np.testing.assert_allclose(res_multi.x[0], 0.291861, atol=5e-5)
    np.testing.assert_allclose(res_multi.x[1], 0.131439, atol=5e-5)


def test_split_cost_same_linearization():
    """H, b and cost of the split must equal the single block exactly."""
    single = problem(exponential_curve_block(CERES_CURVE_DATA))
    multi = problem(
        exponential_curve_block(CERES_CURVE_DATA[:30]),
        exponential_curve_block(CERES_CURVE_DATA[30:]),
    )
    x0 = jnp.array([0.1, 0.2])
    c1, H1, b1 = linearize(single, x0, mode="auto")
    c2, H2, b2 = linearize(multi, x0, mode="auto")
    np.testing.assert_allclose(c1, c2, rtol=1e-14)
    np.testing.assert_allclose(H1, H2, rtol=1e-13)
    np.testing.assert_allclose(b1, b2, rtol=1e-13)


def test_trace_block_costs():
    """LMConfig.trace_block_costs records each block's pre-step cost per
    outer iteration (reference per-cost logger line,
    src/levenberg_marquadt_dyn.cpp:41-42): rows sum to the total cost and
    the iterate sequence is unchanged."""
    multi = problem(
        exponential_curve_block(CERES_CURVE_DATA[:30]),
        exponential_curve_block(CERES_CURVE_DATA[30:]),
    )
    x0 = jnp.array([0.0, 0.0])
    res_plain = levenberg_marquardt(multi, x0, LMConfig(diff_mode="fd"))
    res = levenberg_marquardt(
        multi, x0, LMConfig(diff_mode="fd", trace_block_costs=True)
    )
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(res_plain.x))
    bc = np.asarray(res.trace["block_costs"])
    assert bc.shape == (15, 2)
    n = int(res.iterations) + 1
    total = np.asarray(res.trace["cost"])
    np.testing.assert_allclose(bc[:n].sum(axis=1), total[:n], rtol=1e-12)
    assert np.all(bc[:n] > 0)
    # the rendered trace carries the per-block column
    from moptimizer_jax.utils.logging import format_trace

    txt = format_trace(res)
    assert "block_costs" in txt.splitlines()[0]
