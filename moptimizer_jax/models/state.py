"""15-DoF composite-state residual: SO(3) × R¹² boxminus against an anchor.

Reference tst/state_model.cpp:16-112: state x ∈ R¹⁵ with x[:3] a rotation
vector and x[3:] linear; residual r = x ⊟ x₀ where the rotation part is
Log(R₀ᵀ·R(x)) and the linear part is plain difference. Exercises a product
manifold through the LM loop.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import so3


def _make_residual(anchor_rot, anchor_lin):
    def residual(x, _):
        R = so3.exp(x[:3])
        d_rot = so3.log(jnp.asarray(anchor_rot, x.dtype).T @ R)
        d_lin = x[3:] - jnp.asarray(anchor_lin, x.dtype)
        return jnp.concatenate([d_rot, d_lin])

    return residual


def product_state_block(anchor_rotvec, anchor_lin):
    """anchor_rotvec: (3,) rotation vector of the anchor; anchor_lin: (12,)."""
    anchor_rot = so3.exp(jnp.asarray(anchor_rotvec))
    return make_block(
        _make_residual(anchor_rot, jnp.asarray(anchor_lin)),
        data=None,
        name="product_state",
    )
