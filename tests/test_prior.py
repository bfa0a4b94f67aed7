"""Prior factors + square-root marginalization (core/prior.py).

Exactness contract: for a LINEAR least-squares problem, solving the
marginalized system (kept states + the prior block carrying the eliminated
states' information) must give the SAME kept-state solution as solving the
full joint problem — marginalization of a Gaussian is exact. For nonlinear
problems the prior is the standard linearized approximation; pinned here
on a sliding-window refinement staying near the full-window solution.
"""

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import linearize
from moptimizer_jax.core.prior import marginalize, prior_block
from moptimizer_jax.core.residual import Problem, make_block, problem


def _linear_problem(A, y):
    A = jnp.asarray(A)
    y = jnp.asarray(y)

    def residual(x, d):
        return jnp.stack([d[: A.shape[1]] @ x - d[A.shape[1]]])

    data = jnp.concatenate([A, y[:, None]], axis=1)
    return make_block(residual, data=data)


def test_gaussian_prior_block_pulls_to_reference():
    """A pure prior (no data): LM converges to x_ref exactly."""
    rng = np.random.default_rng(0)
    S = jnp.asarray(np.triu(rng.normal(size=(3, 3))) + 3 * np.eye(3))
    x_ref = jnp.asarray([1.0, -2.0, 0.5])
    blk = prior_block(x_ref, S)
    res = levenberg_marquardt(problem(blk), jnp.zeros(3, jnp.float64), LMConfig())
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_ref), atol=1e-10)


def test_marginalization_exact_on_linear_problem():
    """Joint linear LS over (xk, xm) ≡ marginalized LS over xk + prior."""
    rng = np.random.default_rng(1)
    P, N = 6, 40
    A = rng.normal(size=(N, P))
    x_true = rng.normal(size=P)
    y = A @ x_true + 0.1 * rng.normal(size=N)

    # full joint solve
    blk = _linear_problem(A, y)
    cfg = LMConfig(max_iterations=30)
    res_full = levenberg_marquardt(problem(blk), jnp.zeros(P, jnp.float64), cfg)

    # marginalize entries [3, 4, 5] at an arbitrary linearization point
    # (linear problem → the point does not matter)
    x_bar = jnp.asarray(rng.normal(size=P))
    _, H, b = linearize(problem(blk), x_bar, mode="auto")
    keep = jnp.asarray([0, 1, 2])
    x_ref, S, off = marginalize(H, b, x_bar, keep)

    # kept-state problem: ONLY the prior (all data information was folded
    # into it) — its minimum must equal the full solve's kept entries
    pb = prior_block(x_ref, S, off)
    res_marg = levenberg_marquardt(problem(pb), jnp.zeros(3, jnp.float64), cfg)
    np.testing.assert_allclose(
        np.asarray(res_marg.x), np.asarray(res_full.x[:3]), atol=1e-8
    )


def test_marginalization_with_new_measurements():
    """Sliding-window pattern: marginal prior + NEW measurements on the
    kept states ≡ full joint solve with all measurements (linear case)."""
    rng = np.random.default_rng(2)
    P, N1, N2 = 5, 30, 20
    A1 = rng.normal(size=(N1, P))  # old window: touches all states
    y1 = A1 @ rng.normal(size=P) + 0.05 * rng.normal(size=N1)
    A2k = rng.normal(size=(N2, 3))  # new data: touches kept states only
    y2 = A2k @ rng.normal(size=3) + 0.05 * rng.normal(size=N2)

    cfg = LMConfig(max_iterations=40)
    # full joint: stack A2 into the P-dim system (zeros on marginalized cols)
    A2 = np.concatenate([A2k, np.zeros((N2, P - 3))], axis=1)
    blk_full = _linear_problem(np.concatenate([A1, A2]), np.concatenate([y1, y2]))
    res_full = levenberg_marquardt(
        problem(blk_full), jnp.zeros(P, jnp.float64), cfg
    )

    # marginalized: prior from the old window + the new block
    blk_old = _linear_problem(A1, y1)
    x_bar = jnp.zeros(P, jnp.float64)
    _, H, b = linearize(problem(blk_old), x_bar, mode="auto")
    x_ref, S, off = marginalize(H, b, x_bar, jnp.asarray([0, 1, 2]))
    pb = prior_block(x_ref, S, off)
    blk_new = _linear_problem(A2k, y2)
    res_marg = levenberg_marquardt(
        Problem(blocks=(pb, blk_new)), jnp.zeros(3, jnp.float64), cfg
    )
    np.testing.assert_allclose(
        np.asarray(res_marg.x), np.asarray(res_full.x[:3]), atol=1e-8
    )


def test_prior_with_indices_subset():
    """indices= restricts the prior to a slice of a larger state."""
    S = jnp.eye(2, dtype=jnp.float64) * 10.0
    pb = prior_block(jnp.asarray([2.0, -1.0]), S, indices=jnp.asarray([1, 3]))

    def other(x, _):
        return jnp.stack([x[0] - 5.0, x[2] + 1.0])

    blk = make_block(other, data=None)
    res = levenberg_marquardt(
        Problem(blocks=(pb, blk)), jnp.zeros(4, jnp.float64), LMConfig()
    )
    np.testing.assert_allclose(
        np.asarray(res.x), [5.0, 2.0, -1.0, -1.0], atol=1e-8
    )
