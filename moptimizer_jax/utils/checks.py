"""In-jit numeric error checking via jax.experimental.checkify.

The reference's failure surface is: throw std::invalid_argument /
moptimizer::Exception on misuse (reference optimizer.h:34-35,50-51;
exception.h:7-19) and return OptimizationStatus::NUMERIC_ERROR when the
trial cost goes NaN (src/levenberg_marquadt_dyn.cpp:88-91). The solver here
reproduces both (ValueError on misuse, Status.NUMERIC_ERROR in-loop).

This module adds the debugging layer the reference lacks: a checkified
linearization that pinpoints *which* quantity went non-finite (residuals,
Jacobian-propagated H, or gradient b) and raises a Python exception with
that message — JAX's equivalent of an in-kernel assert, usable under jit.
Intended for development/triage, not the hot path (checkify adds error
plumbing to the compiled graph).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from moptimizer_jax.core.linearize import linearize


@partial(jax.jit, static_argnames=("mode",))
def _checked_linearize(problem, x, mode):
    def body(problem, x):
        cost, H, b = linearize(problem, x, mode=mode)
        checkify.check(
            jnp.isfinite(cost), "non-finite cost {c} in linearize", c=cost
        )
        checkify.check(
            jnp.all(jnp.isfinite(H)),
            "non-finite Hessian entries (max |H| = {m})",
            m=jnp.max(jnp.abs(H)),
        )
        checkify.check(
            jnp.all(jnp.isfinite(b)),
            "non-finite gradient entries (max |b| = {m})",
            m=jnp.max(jnp.abs(b)),
        )
        return cost, H, b

    return checkify.checkify(body)(problem, x)


def checked_linearize(problem, x, mode="auto"):
    """linearize() that raises ValueError naming the first non-finite output.

    Example::

        cost, H, b = checked_linearize(problem, x)   # raises if NaN/Inf

    The production solver never needs this — NaN trial costs map to
    Status.NUMERIC_ERROR inside the jitted loop, matching the reference —
    but when a model produces NaN at iteration 0 this says so directly
    instead of returning a NUMERIC_ERROR result to decode.
    """
    from moptimizer_jax.core.residual import Problem

    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    err, out = _checked_linearize(problem, jnp.asarray(x), mode)
    err.throw()  # raises JaxRuntimeError (a ValueError) with the message
    return out
