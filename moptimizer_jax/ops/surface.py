"""Local surface statistics: normals and GICP-style covariances.

For each point, PCA over its k nearest neighbors gives the local surface
frame; the normal is the smallest-eigenvalue direction and the GICP
covariance replaces the eigenvalues with (ε, 1, 1) — confident along the
surface, uncertain only along the normal (Segal et al.'s plane-to-plane
model). Everything is one batched eigendecomposition — device-friendly, no
per-point host loops.
"""

import jax.numpy as jnp

from moptimizer_jax.ops.nn_search import knn


def neighborhood_pca(cloud, k=10):
    """(eigvals (N,3) ascending, eigvecs (N,3,3) columns) of the k-NN scatter."""
    idx, _ = knn(cloud, cloud, k)
    neigh = cloud[idx]  # (N, k, 3)
    mean = jnp.mean(neigh, axis=1, keepdims=True)
    centered = neigh - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / k
    eigvals, eigvecs = jnp.linalg.eigh(cov)  # ascending
    return eigvals, eigvecs


def estimate_normals(cloud, k=10, orient_to=None):
    """Unit normals from k-NN PCA. ``orient_to``: optional viewpoint (3,) the
    normals should face (flips sign)."""
    _, eigvecs = neighborhood_pca(cloud, k)
    normals = eigvecs[:, :, 0]  # smallest-eigenvalue direction
    if orient_to is not None:
        to_vp = jnp.asarray(orient_to, cloud.dtype)[None, :] - cloud
        sign = jnp.sign(jnp.sum(normals * to_vp, axis=-1, keepdims=True))
        normals = normals * jnp.where(sign == 0, 1.0, sign)
    return normals


def gicp_covariances(cloud, k=10, epsilon=1e-3):
    """Per-point GICP covariance C = U diag(ε,1,1) Uᵀ (N,3,3)."""
    _, eigvecs = neighborhood_pca(cloud, k)
    d = jnp.asarray([epsilon, 1.0, 1.0], cloud.dtype)
    return jnp.einsum("nij,j,nkj->nik", eigvecs, d, eigvecs)
