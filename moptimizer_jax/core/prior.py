"""Gaussian prior factors + square-root marginalization.

The missing piece for fixed-lag / sliding-window estimation: when old
states leave the window, their information must not be discarded — it is
Schur-complemented onto the surviving states and carried forward as a
Gaussian prior factor. (Pattern: square-root marginalization for
sliding-window bundle adjustment, arXiv:2109.02182 — re-derived here in
the engine's own Gauss-Newton terms; the reference C++ library has no
prior/marginalization machinery at all.)

Math. At linearization point x̄ the window's Gauss-Newton system is
½ δᵀHδ + bᵀδ (δ = x − x̄). Split δ = (δk, δm) (keep / marginalize):

    H' = Hkk − Hkm Hmm⁻¹ Hmk        b' = bk − Hkm Hmm⁻¹ bm

The marginal cost ½ δkᵀH'δk + b'ᵀδk is represented EXACTLY as one least-
squares residual via the square root H' = SᵀS (Cholesky):

    r(xk) = S (xk − x̄k) + S⁻ᵀ b'      (so ½‖r‖² reproduces it + const)

which is just another residual block — the LM engine consumes it like any
other, and the whole pipeline stays jittable.
"""

import jax
import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block


def prior_block(x_ref, sqrt_info, offset=None, *, indices=None, name="prior"):
    """Residual block r = S·(x[idx] − x_ref) + offset.

    x_ref: (P',) reference value; sqrt_info: (P', P') square-root
    information S (any matrix with SᵀS = Λ — from marginalize() or e.g.
    jnp.linalg.cholesky(Λ).T); offset: (P',) constant term (S⁻ᵀ b' from
    marginalization; None = zero → a plain Gaussian prior centred at
    x_ref); indices: which entries of the state the prior touches (None =
    the whole state).
    """
    x_ref = jnp.asarray(x_ref)
    sqrt_info = jnp.asarray(sqrt_info)
    off = None if offset is None else jnp.asarray(offset)
    idx = None if indices is None else jnp.asarray(indices)

    def residual(x, _):
        xs = x if idx is None else x[idx]
        r = sqrt_info @ (xs - x_ref)
        return r if off is None else r + off

    return make_block(residual, data=None, name=name)


def marginalize(H, b, x_bar, keep, *, reg=0.0):
    """Schur-marginalize a Gauss-Newton system onto the kept indices.

    H (P, P), b (P,): the window system at linearization point x_bar (P,).
    keep: index array of surviving entries (its complement is eliminated).
    reg: small diagonal added to the eliminated block before its solve
    (rank-deficient marginalized states, e.g. gauge directions).

    Returns (x_ref, sqrt_info, offset) for prior_block(x_ref, sqrt_info,
    offset, indices=keep): the EXACT marginal of the quadratic model.
    """
    H = jnp.asarray(H)
    b = jnp.asarray(b)
    x_bar = jnp.asarray(x_bar)
    keep = jnp.asarray(keep)
    P = H.shape[0]
    mask = jnp.zeros((P,), bool).at[keep].set(True)
    marg = jnp.where(~mask, size=P - keep.shape[0])[0]

    Hkk = H[jnp.ix_(keep, keep)]
    Hkm = H[jnp.ix_(keep, marg)]
    Hmm = H[jnp.ix_(marg, marg)] + reg * jnp.eye(marg.shape[0], dtype=H.dtype)
    bk = b[keep]
    bm = b[marg]

    # Hmm is SPD (Gauss-Newton + reg): eliminate via its Cholesky
    c = jax.scipy.linalg.cho_factor(Hmm)
    Hmm_inv_Hmk = jax.scipy.linalg.cho_solve(c, Hkm.T)
    Hmm_inv_bm = jax.scipy.linalg.cho_solve(c, bm)
    H_marg = Hkk - Hkm @ Hmm_inv_Hmk
    b_marg = bk - Hkm @ Hmm_inv_bm

    # square root: H' = SᵀS with S upper-triangular (chol(H') = L, S = Lᵀ)
    L = jnp.linalg.cholesky(H_marg)
    S = L.T
    # offset = S⁻ᵀ b' = L⁻¹ b'
    offset = jax.scipy.linalg.solve_triangular(L, b_marg, lower=True)
    return x_bar[keep], S, offset
