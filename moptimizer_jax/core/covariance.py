"""Parameter-covariance recovery from the converged Gauss-Newton system.

The reference bundles a `covariance` *weight* concept (its Σ is an
information/weight matrix on residuals, covariance/covariance.h) but offers
no posterior covariance of the estimate; the BASELINE configs call for
"camera calibration reprojection BA with covariance recovery". This module
supplies it: Cov(x) ≈ H⁻¹ = (Σᵢ JᵢᵀΣJᵢ)⁻¹ at the solution.
"""

import jax
import jax.numpy as jnp

from moptimizer_jax.core.linearize import linearize


def estimate_covariance(problem, x, mode="auto", scale_by_residual=False):
    """Posterior covariance of the parameters at x.

    scale_by_residual: multiply by the unbiased residual variance
    s² = cost / (n_residuals − n_params) (the classic NLS estimator) —
    requires the problem's total residual count to exceed the state dim.
    """
    from moptimizer_jax.core.linearize import _batched_residuals

    cost, H, _ = linearize(problem, x, mode=mode)
    P = x.shape[0]
    cov = jnp.linalg.inv(H)
    if scale_by_residual:
        blocks = getattr(problem, "blocks", None) or (problem,)
        n_res = 0
        for blk in blocks:
            r_shape = jax.eval_shape(lambda xx, b=blk: _batched_residuals(b, xx)[0], x)
            n_res += r_shape.shape[0] * r_shape.shape[1]
        dof = max(n_res - P, 1)
        cov = cov * (cost / dof)
    return cov
