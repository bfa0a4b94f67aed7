"""Point-to-plane registration residual.

Natural extension of the point-to-point model (reference tst/point2point.cpp;
the reference's roadmap stops at point-to-point): r_i = nᵢ·(T·sᵢ − qᵢ) with
target normal nᵢ — the standard high-accuracy ICP variant. Scalar residual
per correspondence (O=1), analytic Jacobian J = [nᵀ | (s × n)ᵀ] at identity.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import se3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    return jnp.array([jnp.dot(d["normal"], warped - d["tgt"])])


def _jacobian(T, d):
    s, nrm = d["src"], d["normal"]
    return jnp.concatenate([nrm, jnp.cross(s, nrm)])[None, :]


def point2plane_block(src, tgt, normals, *, analytic=False, loss=None, update_fn=None):
    data = dict(
        src=jnp.asarray(src), tgt=jnp.asarray(tgt), normal=jnp.asarray(normals)
    )
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        update_fn=update_fn,
        name="point2plane",
    )
