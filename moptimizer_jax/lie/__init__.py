"""Differentiable Lie-group utilities (SO(3), SE(3)) for f32/f64.

JAX equivalent of the reference's `so3` namespace
(/root/reference/include/moptimizer/so3.h, src/so3.cpp): Rodrigues exp/log,
left/right Jacobians and their inverses, and the 6-DoF / 3-DoF
parameter→matrix conversions the reference models use in `setup()`.

All functions are pure jnp, fully differentiable (small-angle branches are
`jnp.where`-guarded Taylor series, safe for forward- and reverse-mode AD),
and batch via `jax.vmap`.
"""

from moptimizer_jax.lie.so3 import (
    hat,
    vee,
    exp as so3_exp,
    log as so3_log,
    left_jacobian,
    right_jacobian,
    inverse_left_jacobian,
    inverse_right_jacobian,
)
from moptimizer_jax.lie.se3 import (
    transform_from_params6,
    rotation_from_params3,
    se3_exp,
    se3_log,
    apply_transform,
)
