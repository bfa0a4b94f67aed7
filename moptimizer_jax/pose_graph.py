"""Pose-graph optimization (PGO): LM over a graph of relative-pose constraints.

The SLAM back-end counterpart to ba.py — optimizes N absolute poses
(params6 convention, reference src/so3.cpp:7-19) from E relative-pose edges
with per-edge 6×6 information matrices. Not present in the reference (whose
only multi-state problem is the 15-DoF boxminus test, tst/state_model.cpp);
required by the BASELINE north star.

Structure:
* per-edge residual r_e = log(Z_e⁻¹ · T_i⁻¹ · T_j) — one vmapped evaluation;
* per-edge Jacobians (∂r/∂x_i, ∂r/∂x_j), both (6,6), via vmapped jacfwd;
* the sparse 6N×6N Gauss-Newton system assembled **densely by scatter-add**
  of the four (6,6) blocks per edge (N ≤ ~10³ keeps the dense H small; beyond that the matrix-free CG of ba.py applies);
* same LM λ/ν/ρ schedule as the reference (src/levenberg_marquadt_dyn.cpp).

Gauge: the first `n_fixed` poses are held fixed by masking their deltas.
"""

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from moptimizer_jax.core.solver import Status
from moptimizer_jax.lie import se3, so3


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PGOPrior:
    """Gaussian prior factor over a subset of the flat 6N state.

    r = sqrt_info · (x_flat[idx] − x_ref) + offset — the carrier of
    marginalized information in fixed-lag smoothing (marginalize_oldest)
    and, with n_fixed = 0, of the gauge. Same square-root convention as
    core/prior.py."""

    x_ref: jax.Array  # (P',)
    sqrt_info: jax.Array  # (P', P')
    offset: jax.Array  # (P',)
    idx: jax.Array  # (P',) int32 indices into the flat 6N state


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PoseGraph:
    """poses: (N, 6) params6 states; edges i→j with measurement z_ij ∈ R⁶
    (params6 of the expected T_i⁻¹ T_j) and information (E, 6, 6).

    prior: optional PGOPrior (fixed-lag smoothing / soft gauge). Supported
    by the dense solver; the robust loss never applies to it."""

    poses: jax.Array
    edge_i: jax.Array
    edge_j: jax.Array
    measurements: jax.Array
    information: jax.Array
    loss: Any = None  # robust kernel on edges; weights H,b only
    prior: Any = None  # optional PGOPrior
    n_fixed: int = dataclasses.field(default=1, metadata=dict(static=True))


@dataclasses.dataclass(frozen=True)
class PGOConfig:
    max_iterations: int = 30
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    solver: str = "dense"  # "dense" (Cholesky on 6N×6N) | "cg" (matrix-free)
    cg_iterations: int = 100
    cg_tol: float = 1e-10
    # optional noise-floor stopping (mirrors LMConfig.rel_cost_tol); 0 = off
    rel_cost_tol: float = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PGOResult:
    poses: jax.Array
    status: jax.Array
    iterations: jax.Array
    cost: jax.Array
    trace: dict


def _t_inv(T):
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = jnp.zeros_like(T).at[:3, :3].set(R.T).at[:3, 3].set(-R.T @ t).at[3, 3].set(1.0)
    return Ti


def _edge_residual(xi, xj, z):
    """r = [t-part, log R] of Z⁻¹ · T_i⁻¹ · T_j (zero iff T_i⁻¹T_j = Z)."""
    Ti = se3.transform_from_params6(xi)
    Tj = se3.transform_from_params6(xj)
    Z = se3.transform_from_params6(z)
    E = _t_inv(Z) @ (_t_inv(Ti) @ Tj)
    return jnp.concatenate([E[:3, 3], so3.log(E[:3, :3])])


def residuals_all(graph):
    xi = graph.poses[graph.edge_i]
    xj = graph.poses[graph.edge_j]
    return jax.vmap(_edge_residual)(xi, xj, graph.measurements)


def _prior_residual(prior, poses):
    x = poses.reshape(-1)[prior.idx]
    return prior.sqrt_info @ (x - prior.x_ref) + prior.offset


def compute_cost(graph):
    """Σ r_eᵀ Ω_e r_e (information-weighted; Ω = I reduces to Σ‖r‖²),
    plus ‖r_prior‖² when a PGOPrior is attached."""
    r = residuals_all(graph)
    cost = jnp.sum(jnp.einsum("ei,eij,ej->e", r, graph.information, r))
    if graph.prior is not None:
        rp = _prior_residual(graph.prior, graph.poses)
        cost = cost + jnp.sum(rp * rp)
    return cost


def _linearize(graph):
    xi = graph.poses[graph.edge_i]
    xj = graph.poses[graph.edge_j]

    def rj(a, b, z):
        r = _edge_residual(a, b, z)
        Ji = jax.jacfwd(_edge_residual, argnums=0)(a, b, z)
        Jj = jax.jacfwd(_edge_residual, argnums=1)(a, b, z)
        return r, Ji, Jj

    return jax.vmap(rj)(xi, xj, graph.measurements)


def _assemble(graph, r, Ji, Jj):
    """Dense H (6N,6N), b (6N) by scatter-add of per-edge blocks."""
    N = graph.poses.shape[0]
    dtype = graph.poses.dtype
    Om = graph.information.astype(dtype)
    if graph.loss is not None:
        # robust kernel weight from the information-weighted squared norm
        sq = jnp.einsum("ei,eij,ej->e", r, Om, r)
        Om = graph.loss.weight(sq)[:, None, None] * Om

    JiW = jnp.einsum("eki,ekl->eil", Ji, Om)  # JᵢᵀΩ (E,6,6)
    JjW = jnp.einsum("eki,ekl->eil", Jj, Om)

    H_ii = jnp.einsum("eil,elj->eij", JiW, Ji)
    H_ij = jnp.einsum("eil,elj->eij", JiW, Jj)
    H_ji = jnp.swapaxes(H_ij, -1, -2)
    H_jj = jnp.einsum("eil,elj->eij", JjW, Jj)
    b_i = jnp.einsum("eil,el->ei", JiW, r)
    b_j = jnp.einsum("eil,el->ei", JjW, r)

    H = jnp.zeros((N, N, 6, 6), dtype)
    H = H.at[graph.edge_i, graph.edge_i].add(H_ii)
    H = H.at[graph.edge_i, graph.edge_j].add(H_ij)
    H = H.at[graph.edge_j, graph.edge_i].add(H_ji)
    H = H.at[graph.edge_j, graph.edge_j].add(H_jj)
    H = H.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)

    b = jnp.zeros((N, 6), dtype)
    b = b.at[graph.edge_i].add(b_i)
    b = b.at[graph.edge_j].add(b_j)
    b = b.reshape(-1)

    if graph.prior is not None:
        p = graph.prior
        Lam = p.sqrt_info.T @ p.sqrt_info
        H = H.at[jnp.ix_(p.idx, p.idx)].add(Lam)
        rp = _prior_residual(p, graph.poses)
        b = b.at[p.idx].add(p.sqrt_info.T @ rp)
    return H, b


def _edge_blocks(graph, r, Ji, Jj):
    """Per-edge weighted H blocks + b contributions (no global assembly) —
    the matrix-free representation for the CG path (scales to 10⁴⁺ poses
    where the dense 6N×6N H stops fitting)."""
    dtype = graph.poses.dtype
    Om = graph.information.astype(dtype)
    if graph.loss is not None:
        sq = jnp.einsum("ei,eij,ej->e", r, Om, r)
        Om = graph.loss.weight(sq)[:, None, None] * Om
    JiW = jnp.einsum("eki,ekl->eil", Ji, Om)
    JjW = jnp.einsum("eki,ekl->eil", Jj, Om)
    H_ii = jnp.einsum("eil,elj->eij", JiW, Ji)
    H_ij = jnp.einsum("eil,elj->eij", JiW, Jj)
    H_jj = jnp.einsum("eil,elj->eij", JjW, Jj)
    b_i = jnp.einsum("eil,el->ei", JiW, r)
    b_j = jnp.einsum("eil,el->ei", JjW, r)
    return H_ii, H_ij, H_jj, b_i, b_j


def _pgo_matvec(u, H_ii, H_ij, H_jj, edge_i, edge_j, N, free):
    """H·u via gathers + segment sums; u (N,6)."""
    u = u * free
    ui = u[edge_i]
    uj = u[edge_j]
    out_i = jnp.einsum("eij,ej->ei", H_ii, ui) + jnp.einsum("eij,ej->ei", H_ij, uj)
    out_j = jnp.einsum("eji,ej->ei", H_ij, ui) + jnp.einsum("eij,ej->ei", H_jj, uj)
    out = jax.ops.segment_sum(out_i, edge_i, num_segments=N) + jax.ops.segment_sum(
        out_j, edge_j, num_segments=N
    )
    return out * free


def _pgo_cg_solve(graph, r, Ji, Jj, lam, free_nodes, config):
    """Damped Gauss-Newton step by block-Jacobi-preconditioned CG."""
    N = graph.poses.shape[0]
    dtype = graph.poses.dtype
    H_ii, H_ij, H_jj, b_i, b_j = _edge_blocks(graph, r, Ji, Jj)
    b = jax.ops.segment_sum(b_i, graph.edge_i, num_segments=N) + jax.ops.segment_sum(
        b_j, graph.edge_j, num_segments=N
    )  # (N,6)
    diag_blocks = jax.ops.segment_sum(
        H_ii, graph.edge_i, num_segments=N
    ) + jax.ops.segment_sum(H_jj, graph.edge_j, num_segments=N)  # (N,6,6)
    d = jnp.diagonal(diag_blocks, axis1=-2, axis2=-1)  # (N,6)

    def mv(u):
        base = _pgo_matvec(u, H_ii, H_ij, H_jj, graph.edge_i, graph.edge_j, N, free_nodes)
        return base + lam * d * (u * free_nodes)

    damped_diag = diag_blocks + lam * jax.vmap(jnp.diag)(d)
    pre_inv = jnp.linalg.inv(damped_diag + 1e-12 * jnp.eye(6, dtype=dtype))

    def pre(u):
        return jnp.einsum("nij,nj->ni", pre_inv, u) * free_nodes

    rhs = -b * free_nodes
    x = jnp.zeros_like(rhs)
    res = rhs
    z = pre(res)
    p = z
    rz = jnp.sum(res * z)

    def body(state):
        x, res, p, rz, k = state
        Ap = mv(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), jnp.finfo(dtype).tiny)
        x = x + alpha * p
        res = res - alpha * Ap
        z = pre(res)
        rz_new = jnp.sum(res * z)
        beta = rz_new / jnp.maximum(rz, jnp.finfo(dtype).tiny)
        return x, res, z + beta * p, rz_new, k + 1

    def cond(state):
        _, res, _, _, k = state
        return (k < config.cg_iterations) & (jnp.sum(res * res) > config.cg_tol**2)

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x, res, p, rz, 0))
    return x, b.reshape(-1)


def marginalize_oldest(graph, n_drop=1, *, fix_weight=1e8, reg=1e-9):
    """Fixed-lag marginalization: drop the oldest n_drop poses.

    The factors ADJACENT to the dropped poses (their edges, any existing
    prior, and the gauge fixation of dropped fixed poses — carried as a
    fix_weight·I absolute prior so the information stays finite) are
    linearized at the current poses and Schur-complemented onto the kept
    poses they touch (core/prior machinery, square-root form: the
    sliding-window BA recipe of arXiv:2109.02182 re-done in this engine's
    Gauss-Newton terms). Edges between kept poses stay NONLINEAR in the
    returned graph; only the absorbed information becomes quadratic.

    Host-side (concrete edge indices partition the factor set) — call
    between solves, not inside jit. Returns the reduced PoseGraph with
    poses[n_drop:], re-indexed kept edges, prior attached, and
    n_fixed = max(n_fixed − n_drop, 0) — fixed poses beyond the dropped
    window stay hard-fixed; the gauge of DROPPED fixed poses moves into
    the prior.
    """
    import numpy as np

    from moptimizer_jax.core.prior import marginalize as _marg

    dtype = graph.poses.dtype
    N = graph.poses.shape[0]
    ei = np.asarray(graph.edge_i)
    ej = np.asarray(graph.edge_j)
    absorbed = (ei < n_drop) | (ej < n_drop)
    if not absorbed.any() and graph.prior is None and graph.n_fixed <= 0:
        raise ValueError("nothing connects the dropped poses; just slice them off")

    sub = dataclasses.replace(
        graph,
        edge_i=jnp.asarray(ei[absorbed]),
        edge_j=jnp.asarray(ej[absorbed]),
        measurements=graph.measurements[jnp.asarray(np.where(absorbed)[0])],
        information=graph.information[jnp.asarray(np.where(absorbed)[0])],
        loss=None,  # the prior is a Gaussian; robust weights stay with live edges
    )
    r, Ji, Jj = _linearize(sub)
    H_A, b_A = _assemble(sub, r, Ji, Jj)  # includes graph.prior if present

    # gauge carried by dropped fixed poses → finite absolute prior on them
    n_fixed_dropped = min(graph.n_fixed, n_drop)
    if n_fixed_dropped > 0:
        scale = fix_weight * float(jnp.max(jnp.abs(jnp.diagonal(H_A))) + 1.0)
        fixed_flat = np.arange(6 * n_fixed_dropped)
        H_A = H_A.at[fixed_flat, fixed_flat].add(scale)

    # support: kept poses touching absorbed factors (+ existing prior support)
    touched = set()
    for a, b_ in zip(ei[absorbed], ej[absorbed]):
        for p in (int(a), int(b_)):
            if p >= n_drop:
                touched.add(p)
    if graph.prior is not None:
        for flat in np.asarray(graph.prior.idx):
            p = int(flat) // 6
            if p >= n_drop:
                touched.add(p)
    if graph.n_fixed > n_drop:
        touched.update(range(n_drop, graph.n_fixed))
    support = sorted(touched)
    if not support:
        raise ValueError("dropped poses touch no kept pose — the graph is disconnected")

    # marginalize over the (dropped ∪ support) submatrix only: kept poses
    # outside the support have zero rows in H_A, which would make the
    # marginal square root singular
    drop_flat = np.arange(6 * n_drop)
    supp_flat = np.concatenate([np.arange(6 * p, 6 * p + 6) for p in support])
    sub_idx = np.concatenate([drop_flat, supp_flat])
    H_sub = H_A[jnp.ix_(jnp.asarray(sub_idx), jnp.asarray(sub_idx))]
    H_sub = H_sub + reg * jnp.eye(len(sub_idx), dtype=dtype)
    b_sub = b_A[jnp.asarray(sub_idx)]
    x_sub = graph.poses.reshape(-1)[jnp.asarray(sub_idx)]
    keep_local = jnp.arange(len(drop_flat), len(sub_idx))
    x_ref, S, off = _marg(H_sub, b_sub, x_sub, keep_local)

    # remaining (kept-kept) edges, re-indexed into the reduced graph
    live = ~absorbed
    live_idx = jnp.asarray(np.where(live)[0])
    new_prior = PGOPrior(
        x_ref=x_ref,
        sqrt_info=S,
        offset=off,
        idx=jnp.asarray(supp_flat - 6 * n_drop, jnp.int32),
    )
    return dataclasses.replace(
        graph,
        poses=graph.poses[n_drop:],
        edge_i=jnp.asarray(ei[live] - n_drop),
        edge_j=jnp.asarray(ej[live] - n_drop),
        measurements=graph.measurements[live_idx],
        information=graph.information[live_idx],
        prior=new_prior,
        n_fixed=max(graph.n_fixed - n_drop, 0),
    )


@partial(jax.jit, static_argnames=("config",))
def solve_pgo(graph, config=PGOConfig()):
    if graph.prior is not None and config.solver == "cg":
        raise ValueError(
            "PGOPrior is supported by the dense solver; use "
            "PGOConfig(solver='dense') (the prior's SᵀS block is dense "
            "across its support, which breaks the edge-block matvec)"
        )
    dtype = graph.poses.dtype
    eps = jnp.finfo(dtype).eps
    N = graph.poses.shape[0]
    n_it = config.max_iterations

    free = (jnp.arange(6 * N) >= 6 * graph.n_fixed).astype(dtype)

    trace0 = dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
    )

    def outer_body(c):
        graph_c = dataclasses.replace(graph, poses=c["poses"])
        r, Ji, Jj = _linearize(graph_c)
        # y0 must be the SAME cost functional as the trial cost yi below
        # (compute_cost = edges + prior); an edge-only y0 makes ρ and the
        # convergence test compare unlike costs when a PGOPrior is attached
        # (prior-dominant graphs falsely CONVERGED at 0 iters)
        y0 = compute_cost(graph_c)

        if config.solver == "cg":
            # no dense assembly; λ seed needs only the diagonal blocks
            H_ii, _, H_jj, _, _ = _edge_blocks(graph_c, r, Ji, Jj)
            diag_blocks = jax.ops.segment_sum(
                H_ii, graph.edge_i, num_segments=N
            ) + jax.ops.segment_sum(H_jj, graph.edge_j, num_segments=N)
            diag_H = jnp.diagonal(diag_blocks, axis1=-2, axis2=-1).reshape(-1) * free
            H = b = None
        else:
            H, b = _assemble(graph_c, r, Ji, Jj)
            # gauge fixing: zero the fixed poses' rows/cols, identity diagonal
            H = H * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
            b = b * free
            diag_H = jnp.diagonal(H)
        converged0 = jnp.abs(y0) < 8 * eps
        lam = jnp.where(
            c["lam"] < 0.0, config.init_lambda_factor * jnp.max(jnp.abs(diag_H)), c["lam"]
        )

        inner0 = dict(
            k=jnp.zeros((), jnp.int32),
            poses=c["poses"],
            lam=lam,
            nu=jnp.asarray(2.0, dtype),
            y=y0,
            rho=jnp.asarray(jnp.nan, dtype),
            status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
            stop=converged0,
            terminal=converged0,
        )

        def inner_cond(s):
            return (s["k"] < config.inner_iterations) & ~s["stop"]

        def inner_body(s):
            if config.solver == "cg":
                d_nodes, b_cg = _pgo_cg_solve(
                    graph_c, r, Ji, Jj, s["lam"], free.reshape(N, 6), config
                )
                delta = d_nodes.reshape(-1)
                b_rho = b_cg * free  # gradient for the ρ denominator (src:93)
            else:
                A = H + s["lam"] * jnp.diag(diag_H)
                factor = jax.scipy.linalg.cho_factor(A)
                delta = jax.scipy.linalg.cho_solve(factor, -b) * free
                b_rho = b
            poses_i = c["poses"] + delta.reshape(N, 6)
            yi = compute_cost(dataclasses.replace(graph, poses=poses_i))

            is_nan = jnp.isnan(yi)
            rho = (y0 - yi) / jnp.dot(delta, s["lam"] * delta - b_rho)
            small = jnp.max(jnp.abs(delta)) < jnp.sqrt(eps)
            reject = rho < 0.0
            accept = ~is_nan & ~reject
            term_small = ~is_nan & reject & small
            retry = ~is_nan & reject & ~small

            status = jnp.where(
                is_nan,
                int(Status.NUMERIC_ERROR),
                jnp.where(
                    term_small,
                    jnp.where(
                        jnp.abs(yi) < 8 * eps,
                        int(Status.CONVERGED),
                        int(Status.SMALL_DELTA),
                    ),
                    s["status"],
                ),
            ).astype(jnp.int32)

            gain = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            terminal_i = is_nan | term_small
            if config.rel_cost_tol > 0.0:  # static: graph unchanged when off
                # yi <= y0 guards the NaN-ρ accept fallthrough
                rel_term = (
                    accept
                    & (yi <= y0)
                    & ((y0 - yi) <= config.rel_cost_tol * jnp.abs(y0))
                )
                terminal_i = terminal_i | rel_term
                status = jnp.where(
                    rel_term, jnp.int32(int(Status.CONVERGED)), status
                )
            return dict(
                k=s["k"] + 1,
                poses=jnp.where(accept, poses_i, s["poses"]),
                lam=jnp.where(
                    accept, s["lam"] * gain, jnp.where(retry, s["nu"] * s["lam"], s["lam"])
                ),
                nu=jnp.where(retry, 2.0 * s["nu"], s["nu"]),
                y=jnp.where(accept | is_nan | term_small, yi, s["y"]),
                rho=rho,
                status=status,
                stop=accept | is_nan | term_small,
                terminal=terminal_i,
            )

        inner = jax.lax.while_loop(inner_cond, inner_body, inner0)
        terminal = converged0 | inner["terminal"]
        status = jnp.where(
            converged0, jnp.asarray(int(Status.CONVERGED), jnp.int32), inner["status"]
        )
        trace = dict(
            cost=c["trace"]["cost"].at[c["it"]].set(y0),
            lam=c["trace"]["lam"].at[c["it"]].set(inner["lam"]),
            rho=c["trace"]["rho"].at[c["it"]].set(inner["rho"]),
        )
        return dict(
            poses=inner["poses"],
            lam=inner["lam"],
            it=jnp.where(terminal, c["it"], c["it"] + 1),
            status=status,
            done=terminal,
            trace=trace,
        )

    carry0 = dict(
        poses=graph.poses,
        lam=jnp.asarray(-1.0, dtype),
        it=jnp.zeros((), jnp.int32),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        done=jnp.asarray(False),
        trace=trace0,
    )

    def cond(c):
        return (c["it"] < n_it) & ~c["done"]

    c = jax.lax.while_loop(cond, outer_body, carry0)
    return PGOResult(
        poses=c["poses"],
        status=c["status"],
        iterations=c["it"],
        cost=compute_cost(dataclasses.replace(graph, poses=c["poses"])),
        trace=c["trace"],
    )
