"""Accelerometer gravity-alignment residual.

Reference include/moptimizer/models/accelerometer.h:9-74: state x ∈ R³
(rotation vector), r = m − R(x)·g with g = (0, 0, 9.81); analytic Jacobian
−[R·g]ₓ·J_l(x). We use the *full* SO(3) left Jacobian (lie.so3.left_jacobian)
so the analytic path agrees with AD to machine precision — the reference's
truncated leftJacobian (so3.cpp:146-155) only agrees to O(θ²).
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import so3

GRAVITY = (0.0, 0.0, 9.81)


def _prepare(x):
    return dict(x=x, R=so3.exp(x))


def _make_residual(measurement, gravity):
    def residual(state, _):
        return jnp.asarray(measurement, state["R"].dtype) - state["R"] @ jnp.asarray(
            gravity, state["R"].dtype
        )

    return residual


def _make_jacobian(gravity):
    def jacobian(state, _):
        # dr/dx = −d(R·g)/dx = +[R·g]ₓ·J_l(x)  (using d(exp(x)v)/dx = −[exp(x)v]ₓ·J_l).
        # The reference fills −[R·g]ₓ·J_l (accelerometer.h:60-62) — that is
        # d(Rg)/dx, the NEGATIVE of the residual Jacobian; the sign slip is
        # invisible in its differentiation test, which only compares H = JᵀΣJ.
        g = jnp.asarray(gravity, state["R"].dtype)
        rotated = state["R"] @ g
        return so3.hat(rotated) @ so3.left_jacobian(state["x"])

    return jacobian


def accelerometer_block(measurement, *, gravity=GRAVITY, analytic=False):
    return make_block(
        _make_residual(measurement, gravity),
        data=None,
        prepare_fn=_prepare,
        jacobian_fn=_make_jacobian(gravity) if analytic else None,
        name="accelerometer",
    )
