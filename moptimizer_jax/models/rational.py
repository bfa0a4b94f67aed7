"""Rational "simple model": r_i = y_i − (a·x_i)/(b + x_i).

Reference tst/test_models.h:8-21 (converged minimum (0.362, 0.556) from the
7-point dataset of tst/simple_model.cpp). Analytic Jacobian matches the
reference tst/differentiation.cpp:26-37 row-major convention.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block


def _residual(x, data_i):
    xd, yd = data_i[0], data_i[1]
    return jnp.array([yd - (x[0] * xd) / (x[1] + xd)])


def _jacobian(x, data_i):
    xd = data_i[0]
    denom = x[1] + xd
    return jnp.array([[-xd / denom, (x[0] * xd) / (denom * denom)]])


def rational_block(x_data, y_data, *, analytic=False, loss=None, weight_matrix=None, dtype=None):
    data = jnp.stack(
        [jnp.asarray(x_data, dtype=dtype), jnp.asarray(y_data, dtype=dtype)], axis=-1
    )
    return make_block(
        _residual,
        data=data,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        weight_matrix=weight_matrix,
        name="rational",
    )


# The 7-point dataset shared by reference tst/simple_model.cpp:24-25,
# tst/covariance.cpp:9-10 and tst/loss_function.cpp:42-43.
SIMPLE_X = [0.038, 0.194, 0.425, 0.626, 1.253, 2.5, 3.70]
SIMPLE_Y = [0.05, 0.127, 0.094, 0.2122, 0.2729, 0.2665, 0.3317]
