"""Generalized ICP (plane-to-plane) registration block.

Segal et al.'s GICP: each correspondence is weighted by the information
matrix of the combined local surface models,

    Ω_i = (C_qᵢ + R C_sᵢ Rᵀ)⁻¹,

computed from per-point covariances (ops.surface.gicp_covariances). The
state-dependent Ω is a `weight_fn` hook — re-evaluated at every
linearization with the current rotation, vmapped over correspondences.
Extends the reference's single shared covariance (covariance/covariance.h)
to the full per-residual, state-dependent case.
"""

import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import se3


def _prepare(x):
    return se3.transform_from_params6(x)


def _residual(T, d):
    warped = T[:3, :3] @ d["src"] + T[:3, 3]
    r = warped - d["matched"]
    if "valid" in d:
        return r, d["valid"]
    return r


def _weight(T, d):
    R = T[:3, :3]
    C = d["matched_cov"] + R @ d["src_cov"] @ R.T
    return jnp.linalg.inv(C + 1e-9 * jnp.eye(3, dtype=C.dtype))


def gicp_block(src, matched, src_cov, matched_cov, *, loss=None, update_fn=None, valid=None):
    """GICP block over matched pairs src[i] ↔ matched[i] with per-point
    covariances (N,3,3). Use registration.gicp for NN-driven matching."""
    data = dict(
        src=jnp.asarray(src),
        matched=jnp.asarray(matched),
        src_cov=jnp.asarray(src_cov),
        matched_cov=jnp.asarray(matched_cov),
    )
    if valid is not None:
        data["valid"] = jnp.asarray(valid)
    return make_block(
        _residual,
        data=data,
        prepare_fn=_prepare,
        weight_fn=_weight,
        loss=loss,
        update_fn=update_fn,
        weighted_cost=True,
        name="gicp",
    )
