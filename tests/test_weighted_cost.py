"""Pin the GICP `weighted_cost` deviation (residual.py:81-86).

Reference semantics: robust-loss/Σ weights affect H,b only; the cost used by
the LM ρ acceptance test is the raw Σ‖r‖² (reference linearization.h:108-115,
src/levenberg_marquadt_dyn.cpp:86,93). With a strongly anisotropic
information matrix Ω, the Gauss-Newton step descends the WEIGHTED objective
rᵀΩr — from the raw-cost minimum, every such step strictly increases the raw
cost, so under reference semantics LM rejects every trial and stalls. That is
the failure mode `weighted_cost=True` exists to fix (GICP's Ω is exactly this
kind of anisotropic). This test constructs the stall analytically and shows
the weighted-ρ mode converges to the weighted optimum.

Residuals (linear, so GN is exact):  r_i(x) = (a_i − x, b_i + g·x),
Ω = diag(w, 1) with w ≫ 1. Closed-form minima:
  raw:      x_raw = (Σa − gΣb) / (n(1+g²))
  weighted: x_w   = (wΣa − gΣb) / (n(w+g²))
"""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, Status, levenberg_marquardt
from moptimizer_jax.core.residual import make_block, problem

W, G = 400.0, 10.0


def _setup(dtype):
    rng = np.random.default_rng(7)
    a = rng.normal(2.0, 1.0, 32)
    b = rng.normal(-1.0, 1.0, 32)
    x_raw = (a.sum() - G * b.sum()) / (len(a) * (1 + G * G))
    x_w = (W * a.sum() - G * b.sum()) / (len(a) * (W + G * G))
    data = jnp.asarray(np.column_stack([a, b]), dtype)
    omega = jnp.asarray(np.diag([W, 1.0]), dtype)

    def residual(x, d):
        return jnp.stack([d[0] - x[0], d[1] + G * x[0]])

    def block(weighted_cost):
        return make_block(
            residual, data=data, weight_matrix=omega, weighted_cost=weighted_cost
        )

    return block, x_raw, x_w


def test_anisotropic_omega_stalls_under_raw_rho():
    """Reference (unweighted-ρ) semantics: every weighted-descent step is
    rejected from the raw minimum — the solver cannot leave x_raw."""
    block, x_raw, x_w = _setup(jnp.float64)
    assert abs(x_w - x_raw) > 0.1  # the two optima are far apart

    x0 = jnp.asarray([x_raw], jnp.float64)
    res = levenberg_marquardt(
        problem(block(False)), x0, LMConfig(max_iterations=30)
    )
    # stalled: still at the raw minimum, nowhere near the weighted one
    assert abs(float(res.x[0]) - x_raw) < 1e-6
    assert abs(float(res.x[0]) - x_w) > 0.1
    # and it stopped via the small-delta path, not by converging the objective
    assert int(res.status) in (
        int(Status.SMALL_DELTA),
        int(Status.CONVERGED),
        int(Status.MAXIMUM_ITERATIONS_REACHED),
    )
    assert int(res.status) != int(Status.NUMERIC_ERROR)


def test_weighted_rho_reaches_weighted_optimum():
    """weighted_cost=True: ρ is computed on rᵀΩr, the step is accepted, and
    the solver reaches the weighted optimum from the same start."""
    block, x_raw, x_w = _setup(jnp.float64)
    x0 = jnp.asarray([x_raw], jnp.float64)
    res = levenberg_marquardt(
        problem(block(True)), x0, LMConfig(max_iterations=30)
    )
    assert abs(float(res.x[0]) - x_w) < 1e-8


@pytest.mark.parametrize("weighted", [False, True])
def test_isotropic_omega_same_minimum(weighted):
    """Sanity: with isotropic Ω = c·I both cost conventions find the same
    minimizer (scaling H,b and cost together changes nothing) — the deviation
    only matters when Ω is anisotropic."""
    rng = np.random.default_rng(3)
    a = rng.normal(1.0, 0.5, 16)
    data = jnp.asarray(a[:, None], jnp.float64)
    omega = jnp.asarray(4.0 * np.eye(1), jnp.float64)

    blk = make_block(
        lambda x, d: jnp.stack([d[0] - x[0]]),
        data=data,
        weight_matrix=omega,
        weighted_cost=weighted,
    )
    res = levenberg_marquardt(
        problem(blk), jnp.zeros(1, jnp.float64), LMConfig(max_iterations=20)
    )
    assert abs(float(res.x[0]) - a.mean()) < 1e-10
