"""Powell's singular function (reference tst/powell.cpp:21-60).

    f1 = x1 + 10 x2
    f2 = √5 (x3 − x4)
    f3 = (x2 − 2 x3)²
    f4 = √10 (x1 − x4)²

One 4-dim residual over the whole 4-dim state (data=None, N=1); minimum 0 at
the origin. The analytic Jacobian reproduces the reference's row-major fill
(tst/powell.cpp:32-58) — including its sign slips in ∂f3 (the reference
writes 2(x2 + 2x3)·(∓2) where the true derivative uses (x2 − 2x3); kept
faithful in `_jacobian_reference`, with the correct version as default).
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block


def _residual(x, _):
    return jnp.array(
        [
            x[0] + 10.0 * x[1],
            jnp.sqrt(5.0) * (x[2] - x[3]),
            (x[1] - 2.0 * x[2]) ** 2,
            jnp.sqrt(10.0) * (x[0] - x[3]) ** 2,
        ]
    )


def _jacobian(x, _):
    s5, s10 = jnp.sqrt(5.0), jnp.sqrt(10.0)
    z = jnp.zeros_like(x[0])
    return jnp.array(
        [
            [1.0 + z, 10.0 + z, z, z],
            [z, z, s5 + z, -s5 + z],
            [z, 2.0 * (x[1] - 2.0 * x[2]), -4.0 * (x[1] - 2.0 * x[2]), z],
            [s10 * 2.0 * (x[0] - x[3]), z, z, -s10 * 2.0 * (x[0] - x[3])],
        ]
    )


def _jacobian_reference(x, _):
    """The reference's exact fill (tst/powell.cpp:32-58), x2+2x3 included."""
    s5, s10 = jnp.sqrt(5.0), jnp.sqrt(10.0)
    z = jnp.zeros_like(x[0])
    return jnp.array(
        [
            [1.0 + z, 10.0 + z, z, z],
            [z, z, s5 + z, -s5 + z],
            [z, 2.0 * (x[1] + 2.0 * x[2]), -4.0 * (x[1] + 2.0 * x[2]), z],
            [s10 * 2.0 * (x[0] - x[3]), z, z, -s10 * 2.0 * (x[0] - x[3])],
        ]
    )


def powell_block(*, analytic=False, weight_matrix=None):
    return make_block(
        _residual,
        data=None,
        jacobian_fn=_jacobian if analytic else None,
        weight_matrix=weight_matrix,
        name="powell",
    )
