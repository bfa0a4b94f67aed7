"""Point-to-point registration residual (ICP core).

Reference tst/point2point.cpp:25-86: state x ∈ R⁶ ([t, ω], reference
params6 convention), prepared into a 4×4 transform (`setup`,
:31 → so3::convert6DOFParameterToMatrix), residual r_i = (T·src_i) − tgt_i,
analytic Jacobian J_i = [I₃ | −[src_i]ₓ] (:53-78).

The whole cloud is warped in a single matmul; the analytic Jacobian is
assembled per point by vmap.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import se3, so3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, data_i):
    src, tgt = data_i["src"], data_i["tgt"]
    warped = T[:3, :3] @ src + T[:3, 3]
    return warped - tgt


def _jacobian(T, data_i):
    """J = [I₃ | −[src]ₓ] — the reference's linearization at the source point
    (tst/point2point.cpp:72-76; exact for the warped-source derivative at
    x = 0 with the parameterize-then-Exp convention)."""
    src = data_i["src"]
    eye = jnp.eye(3, dtype=src.dtype)
    return jnp.concatenate([eye, -so3.hat(src)], axis=-1)


def point2point_block(
    src, tgt, *, analytic=False, fused=True, loss=None, weight_matrix=None, update_fn=None
):
    """Block over N index-aligned correspondences src[i] ↔ tgt[i].

    ``update_fn`` slots in correspondence search (the reference reserves its
    `update()` hook for exactly this, docs/Cost.puml) — see
    moptimizer_jax.registration for the NN-search driver.

    ``fused=True`` (default, identity Σ only) linearizes through the
    closed-form moment path (ops/icp_linearize.py) — no (N,3,6) Jacobian
    tensor, one HBM pass — used automatically for mode="auto".
    """
    linearize_fn = None
    if fused and weight_matrix is None:
        from moptimizer_jax.ops.icp_linearize import fused_point2point_linearizer

        linearize_fn = fused_point2point_linearizer
    data = dict(src=jnp.asarray(src), tgt=jnp.asarray(tgt))
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        jacobian_fn=_jacobian if analytic else None,
        loss=loss,
        weight_matrix=weight_matrix,
        update_fn=update_fn,
        linearize_fn=linearize_fn,
        name="point2point",
    )
