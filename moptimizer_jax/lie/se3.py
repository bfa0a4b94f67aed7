"""SE(3) helpers and the reference's 6-DoF parameterization.

The reference parameterizes rigid transforms as x ∈ R⁶ with translation
stored directly and rotation via so3 exp — i.e. the product manifold
R³ × SO(3), NOT the true SE(3) exponential (reference
so3::convert6DOFParameterToMatrix, src/so3.cpp:7-19). We keep that
convention for parity (`transform_from_params6`) and additionally provide
the true SE(3) exp/log.
"""

import jax.numpy as jnp

from moptimizer_jax.lie import so3


def _assemble_rt(R, t):
    """[[R, t], [0, 0, 0, 1]] without scatter ops (Pallas-lowerable)."""
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    one = jnp.ones_like(t[..., :1])
    zero = jnp.zeros_like(t)
    bottom = jnp.concatenate([zero, one], axis=-1)[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def transform_from_params6(x):
    """x = [tx ty tz wx wy wz] → 4×4 homogeneous transform.

    Parity with reference so3::convert6DOFParameterToMatrix (src/so3.cpp:7-19):
    translation is x[:3] verbatim, rotation is so3_exp(x[3:6]).
    """
    R = so3.exp(x[..., 3:6])
    t = x[..., 0:3]
    return _assemble_rt(R, t)


def rotation_from_params3(x):
    """x = [wx wy wz] → 3×3 rotation (reference convert3DOFParameterToMatrix3, src/so3.cpp:33-40)."""
    return so3.exp(x[..., 0:3])


def apply_transform(T, points):
    """Apply a 4×4 transform to (..., N, 3) points: R·p + t, one matmul."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def se3_exp(xi):
    """True SE(3) exponential. xi = [rho(3), w(3)] → 4×4 transform, t = J_l(w)·rho."""
    rho, w = xi[..., 0:3], xi[..., 3:6]
    R = so3.exp(w)
    t = jnp.einsum("...ij,...j->...i", so3.left_jacobian(w), rho)
    return _assemble_rt(R, t)


def se3_log(T):
    """True SE(3) logarithm: inverse of `se3_exp`."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3.log(R)
    rho = jnp.einsum("...ij,...j->...i", so3.inverse_left_jacobian(w), t)
    return jnp.concatenate([rho, w], axis=-1)
