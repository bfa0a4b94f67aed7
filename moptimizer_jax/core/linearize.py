"""Linearization: residual/Jacobian evaluation and Gauss-Newton accumulation.

Replacement for the reference's hot loops (linearization.h:36-158). The
per-index residual loop becomes a `vmap`; the H,b accumulation becomes one
large matmul:

    H = Aᵀ B   with A = J reshaped (N·O, P), B = (w ⊙ ΣJ) reshaped (N·O, P)
    b = Aᵀ (w ⊙ Σr)

Derivative modes:
* ``auto``     — true forward-mode AD (jax.jacfwd) through prepare_fn+residual_fn;
* ``analytic`` — user-supplied jacobian_fn (reference f_df path,
                 linearization.h:126-158);
* ``fd``       — bit-faithful emulation of the reference's forward-difference
                 scheme: per-coordinate step h_j = √ε·|x_j| (floor √ε),
                 J[:, j] = (r(x + h_j e_j) − r(x)) / h_j
                 (reference linearization.h:78-106).

Reference semantics preserved exactly (SURVEY.md §2.4.2): the robust-loss
weight and Σ affect only H,b; the returned cost is the unweighted
Σ_valid ‖r‖², and compute_cost applies neither loss nor Σ
(linearization.h:49-63).
"""

import jax
import jax.numpy as jnp


def _eval_residuals(block, state):
    """Evaluate all residuals. Returns (r, valid): (N, O) and (N,)."""
    if block.data is None:
        out = block.residual_fn(state, None)
        r, valid = _split_valid(out)
        return r[None, :], valid[None]
    out = jax.vmap(lambda d: _split_valid(block.residual_fn(state, d)))(block.data)
    return out


def _split_valid(out):
    if isinstance(out, tuple):
        r, valid = out
        return jnp.atleast_1d(r), jnp.asarray(valid)
    return jnp.atleast_1d(out), jnp.asarray(True)


def _batched_residuals(block, x):
    """r(x): full chain prepare_fn → residual_fn, batched. (N, O), (N,)."""
    state = block.prepare_fn(x)
    return _eval_residuals(block, state)


def compute_cost(block_or_problem, x, accum_dtype=None):
    """Unweighted Σ_valid ‖r_i‖² (reference parallelComputeCost, linearization.h:49-63).

    accum_dtype: optional wider dtype for the reduction — residuals are
    still EVALUATED in x's dtype; only the squared-norm accumulation (and
    any Σ sandwich) runs wider (the r4 mixed-precision path, LMConfig)."""
    blocks = getattr(block_or_problem, "blocks", None)
    if blocks is None:
        blocks = (block_or_problem,)
    adt = jnp.dtype(accum_dtype) if accum_dtype is not None else x.dtype
    total = jnp.zeros((), dtype=adt)
    for block in blocks:
        r, valid = _batched_residuals(block, x)
        r = r.astype(adt)
        if block.weighted_cost:
            if block.weight_fn is not None:
                state = block.prepare_fn(x)
                Sigma = jax.vmap(lambda d: block.weight_fn(state, d))(
                    block.data
                ).astype(adt)
                per = jnp.einsum("no,noq,nq->n", r, Sigma, r)
            elif block.weight_matrix is not None:
                Sg = jnp.asarray(block.weight_matrix, adt)
                if Sg.ndim == 3:
                    per = jnp.einsum("no,noq,nq->n", r, Sg, r)
                else:
                    per = jnp.einsum("no,oq,nq->n", r, Sg, r)
            else:
                per = jnp.sum(r * r, axis=-1)
            total = total + jnp.sum(valid.astype(adt) * per)
        else:
            total = total + jnp.sum(
                valid.astype(adt) * jnp.sum(r * r, axis=-1)
            )
    return total


def compute_block_costs(block_or_problem, x, accum_dtype=None):
    """Per-cost-block unweighted Σ‖r‖², stacked to (n_blocks,).

    The reference logs every cost's value separately each outer iteration
    (src/levenberg_marquadt_dyn.cpp:41-42, the per-cost duna::Logger line) —
    this is that multi-block debugging affordance; LMConfig.trace_block_costs
    records it into the solver trace."""
    blocks = getattr(block_or_problem, "blocks", None)
    if blocks is None:
        blocks = (block_or_problem,)
    return jnp.stack([compute_cost(b, x, accum_dtype) for b in blocks])


def _jacobian_fd(block, x, r0):
    """Reference forward-difference Jacobian (linearization.h:78-106).

    h_j = √ε·|x_j|, floored at √ε; each column from a full re-evaluation at
    x + h_j e_j (the reference clones the model and re-runs setup — here the
    whole prepare_fn+residual_fn chain re-traces, which is identical).
    """
    eps = jnp.finfo(x.dtype).eps
    min_step = jnp.sqrt(eps)
    h = min_step * jnp.abs(x)
    h = jnp.where(h == 0.0, min_step, h)

    def column(j):
        x_plus = x.at[j].add(h[j])
        r_plus, _ = _batched_residuals(block, x_plus)
        return (r_plus - r0) / h[j]

    # P is small and static: unrolled columns keep shapes static and let XLA
    # batch the P+1 evaluations.
    cols = [column(j) for j in range(x.shape[0])]
    return jnp.stack(cols, axis=-1)  # (N, O, P)


def _jacobian_auto(block, x):
    """Forward-mode AD through the full chain; returns (N, O, P)."""
    return jax.jacfwd(lambda xx: _batched_residuals(block, xx)[0])(x)


def _jacobian_analytic(block, state):
    if block.data is None:
        return block.jacobian_fn(state, None)[None, ...]
    return jax.vmap(lambda d: block.jacobian_fn(state, d))(block.data)


def linearize(block_or_problem, x, mode="auto", accum_dtype=None):
    """Accumulate the Gauss-Newton system over one block or a whole problem.

    Returns (cost, H, b) with H = Σᵢ wᵢ JᵢᵀΣJᵢ, b = Σᵢ wᵢ JᵢᵀΣrᵢ and
    cost = Σᵢ(valid) ‖rᵢ‖² (reference computeHessian[Numerical],
    linearization.h:65-158). ``mode`` may be a string applied to all blocks
    or a tuple of per-block strings.

    accum_dtype: optional wider dtype for the H,b accumulation and cost
    reduction. Residuals and Jacobians are evaluated in x's dtype (the fast
    path); the JᵀΣJ / JᵀΣr contractions and sums run wider — H,b are
    (P,P)/(P,), so the extra cost is the widened matmul over (N·O, P),
    small next to the evaluation itself (the r4 mixed-precision path that
    recovers the reference's f64 oracle tolerances from f32 models,
    tests/test_f32_envelope.py).
    """
    blocks = getattr(block_or_problem, "blocks", None)
    if blocks is None:
        blocks = (block_or_problem,)
    if isinstance(mode, str):
        modes = (mode,) * len(blocks)
    else:
        modes = tuple(mode)

    adt = jnp.dtype(accum_dtype) if accum_dtype is not None else x.dtype
    P = x.shape[0]
    H = jnp.zeros((P, P), dtype=adt)
    b = jnp.zeros((P,), dtype=adt)
    cost = jnp.zeros((), dtype=adt)
    for block, m in zip(blocks, modes):
        c_i, H_i, b_i = _linearize_block(block, x, m, accum_dtype)
        cost, H, b = cost + c_i, H + H_i, b + b_i
    return cost, H, b


def _linearize_block(block, x, mode, accum_dtype=None):
    if mode == "auto" and block.linearize_fn is not None and accum_dtype is None:
        return block.linearize_fn(block, x)
    state = block.prepare_fn(x)
    r, valid = _eval_residuals(block, state)  # (N, O), (N,)

    if mode == "analytic":
        if block.jacobian_fn is None:
            raise ValueError(f"block {block.name!r} has no jacobian_fn")
        J = _jacobian_analytic(block, state)
    elif mode == "fd":
        J = _jacobian_fd(block, x, r)
    elif mode == "auto":
        J = _jacobian_auto(block, x)
    else:
        raise ValueError(f"unknown diff mode {mode!r}")

    return _accumulate(block, x, r, valid, J, accum_dtype=accum_dtype)


def _accumulate(block, x, r, valid, J, P=None, accum_dtype=None):
    """Fused H,b accumulation — one matmul over the flattened (N·O) axis.
    P defaults to x's dim; pass the tangent dim for manifold linearization.
    accum_dtype: widen r, J and every contraction (see linearize)."""
    N, O = r.shape
    if P is None:
        P = x.shape[0]
    if accum_dtype is not None:
        r = r.astype(accum_dtype)
        J = J.astype(accum_dtype)
    sq_norm = jnp.sum(r * r, axis=-1)  # (N,)
    w = block.loss.weight(sq_norm).astype(r.dtype) * valid.astype(r.dtype)  # (N,)

    if block.weight_fn is not None:
        # state-dependent per-residual information (GICP et al.)
        state = block.prepare_fn(x)
        Sigma = jax.vmap(lambda d: block.weight_fn(state, d))(
            block.data
        ).astype(r.dtype)
        SJ = jnp.einsum("noq,nqp->nop", Sigma, J)
        Sr = jnp.einsum("noq,nq->no", Sigma, r)
    elif block.weight_matrix is None:
        SJ = J
        Sr = r
    else:
        Sigma = jnp.asarray(block.weight_matrix, dtype=r.dtype)
        if Sigma.ndim == 3:
            # per-residual information matrices (N,O,O) — the GICP /
            # heteroscedastic case (beyond the reference's single shared Σ,
            # covariance/covariance.h)
            SJ = jnp.einsum("noq,nqp->nop", Sigma, J)
            Sr = jnp.einsum("noq,nq->no", Sigma, r)
        else:
            SJ = jnp.einsum("oq,nqp->nop", Sigma, J)
            Sr = r @ Sigma.T

    A = J.reshape(N * O, P)
    Bm = (w[:, None, None] * SJ).reshape(N * O, P)
    H = A.T @ Bm
    b = A.T @ (w[:, None] * Sr).reshape(N * O)
    if block.weighted_cost:
        cost = jnp.sum(valid.astype(r.dtype) * jnp.einsum("no,no->n", r, Sr))
    else:
        cost = jnp.sum(valid.astype(r.dtype) * sq_norm)
    return cost, H, b


def linearize_tangent(block_or_problem, x, retract_fn, mode="auto", accum_dtype=None):
    """Linearize in the tangent space of a manifold: J wrt δ at δ = 0 of
    r(retract(x, δ)). This is the manifold-aware path the reference left as
    `// TODO Manifold operation` (src/levenberg_marquadt_dyn.cpp:82-83).

    ``fd`` mode is not supported here (the reference's h = √ε·|x_j| scheme is
    tied to direct Euclidean perturbation); use ``auto`` or ``analytic``.
    """
    blocks = getattr(block_or_problem, "blocks", None)
    if blocks is None:
        blocks = (block_or_problem,)
    if isinstance(mode, str):
        modes = (mode,) * len(blocks)
    else:
        modes = tuple(mode)

    tangent_dim = retract_fn.tangent_dim if hasattr(retract_fn, "tangent_dim") else x.shape[0]
    zero = jnp.zeros((tangent_dim,), dtype=x.dtype)

    adt = jnp.dtype(accum_dtype) if accum_dtype is not None else x.dtype
    H = jnp.zeros((tangent_dim, tangent_dim), dtype=adt)
    b = jnp.zeros((tangent_dim,), dtype=adt)
    cost = jnp.zeros((), dtype=adt)
    for block, m in zip(blocks, modes):
        state = block.prepare_fn(x)
        r, valid = _eval_residuals(block, state)
        if m == "analytic":
            J = _jacobian_analytic(block, state)
        else:
            J = jax.jacfwd(
                lambda d: _batched_residuals(block, retract_fn(x, d))[0]
            )(zero)
        c_i, H_i, b_i = _accumulate(
            block, x, r, valid, J, P=tangent_dim, accum_dtype=accum_dtype
        )
        cost, H, b = cost + c_i, H + H_i, b + b_i
    return cost, H, b
