"""Levenberg-Marquardt: jitted lax.while_loop with the reference's schedule.

Re-implements the semantics of the reference solver
(src/levenberg_marquadt_dyn.cpp:34-119) as a pure function over pytrees:

outer loop (≤ max_iterations, default 15 — reference optimizer.h:19):
    data ← update hooks;  (y0, H, b) ← Σ_blocks linearize
    |y0| < 8ε  →  CONVERGED                       (optimizer.h:26-29)
    λ < 0      →  λ = 1e-9 · max|diag H|          (src:16,67-68)
    ν = 2
    inner loop (≤ inner_iterations, default 3 — src:9):
        δ  = solve(H + λ·diag(H), −b)             (src:78-80, Eigen LDLT)
        xi = retract(x, δ)      — manifold-aware; Euclidean x+δ matches the
                                  reference's `// TODO Manifold` update (src:82-83)
        yi = Σ_blocks compute_cost(xi)            (src:86)
        NaN yi → NUMERIC_ERROR                    (src:88-91)
        ρ  = (y0 − yi) / δ·(λδ − b)               (src:93)
        ρ < 0:  max|δ| < √ε → CONVERGED if |yi|<8ε else SMALL_DELTA (src:97-105)
                else λ ← νλ, ν ← 2ν, retry        (src:107-108)
        ρ ≥ 0:  accept x ← xi, λ ← λ·max(1/3, 1−(2ρ−1)³), break     (src:112-114)
    → MAXIMUM_ITERATIONS_REACHED                  (src:118)

λ persists across outer iterations (member in the reference); ν resets to 2
each outer iteration (src:70). The per-iteration trace carries the same
fields the reference logger prints (src:72-75,94-95).
"""

import dataclasses
import enum
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from moptimizer_jax.core.linearize import (
    compute_block_costs,
    compute_cost,
    linearize,
    linearize_tangent,
)


class Status(enum.IntEnum):
    """Optimization status (values match reference types.h:6-12)."""

    CONVERGED = 0
    MAXIMUM_ITERATIONS_REACHED = 1
    SMALL_DELTA = 2
    NUMERIC_ERROR = 3
    FATAL_ERROR = 4


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Solver knobs with the reference's defaults (SURVEY.md §2.4.5)."""

    max_iterations: int = 15  # reference optimizer.h:19
    inner_iterations: int = 3  # reference src/levenberg_marquadt_dyn.cpp:9
    init_lambda_factor: float = 1e-9  # src:16
    diff_mode: Any = "auto"  # "auto" | "analytic" | "fd" | per-block tuple
    linear_solver: str = "lu"  # "lu" | "cholesky"
    verbose: bool = False  # live per-iteration debug lines (reference L_DEBUG)
    # Practical stopping rules: the reference's two
    # criteria (cost < 8ε, max|δ| < √ε on the ρ<0 path) essentially never
    # fire on real sensor data, so noise-floor problems burn max_iterations.
    # Both default OFF (0.0) — the traced graph and the LM iterate sequence
    # are then bit-identical to the parity semantics (trace tests pin this).
    rel_cost_tol: float = 0.0  # accept step w/ (y0−yi) ≤ tol·y0 → CONVERGED
    grad_tol: float = 0.0  # ‖b‖∞ = ‖JᵀΣr‖∞ < tol at outer start → CONVERGED
    # Mixed precision: evaluate residuals/Jacobians
    # in x's dtype (f32 — the fast device path) but run the H,b accumulation,
    # cost reductions, damped solve and λ/ρ arithmetic in this wider dtype
    # ("float64" / jnp.float64). Recovers the reference's f64 oracle
    # tolerances that plain f32 loses to reduction error and an
    # ill-conditioned f32 solve (Powell, camera calibration —
    # tests/test_f32_envelope.py). Requires jax_enable_x64. None = off.
    accum_dtype: Any = None
    # Per-cost-block trace granularity: the reference logs each cost's value
    # separately every outer iteration (src/levenberg_marquadt_dyn.cpp:41-42).
    # When on, trace["block_costs"] is (max_iterations, n_blocks) — the
    # pre-step cost of every block at each executed outer iteration. Default
    # off: the extra per-block evaluations change the traced graph (not the
    # iterate sequence).
    trace_block_costs: bool = False

    def __post_init__(self):
        if self.max_iterations < 0:
            # reference optimizer.h:34-35 throws std::invalid_argument
            raise ValueError("max_iterations cannot be less than 0.")
        if self.inner_iterations < 1:
            raise ValueError("inner_iterations must be >= 1.")
        if self.linear_solver not in ("lu", "cholesky", "unrolled"):
            raise ValueError(f"unknown linear_solver {self.linear_solver!r}")
        if self.rel_cost_tol < 0 or self.grad_tol < 0:
            raise ValueError("rel_cost_tol/grad_tol must be >= 0.")
        if self.accum_dtype is not None:
            import jax as _jax
            import jax.numpy as _jnp

            if _jnp.dtype(self.accum_dtype) == _jnp.dtype("float64") and not _jax.config.jax_enable_x64:
                raise ValueError(
                    "accum_dtype=float64 requires jax_enable_x64 "
                    "(jax.config.update('jax_enable_x64', True))"
                )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LMResult:
    x: jax.Array
    status: jax.Array  # int32, a Status value
    iterations: jax.Array  # executed outer iterations
    cost: jax.Array  # final accumulated cost Σ‖r‖²
    lam: jax.Array  # final damping
    trace: dict  # per-outer-iteration records (fixed size max_iterations)


def _solve_damped(H, diag_H, lam, b, method):
    A = H + lam * jnp.diag(diag_H)
    if method == "cholesky":
        factor = jax.scipy.linalg.cho_factor(A)
        return jax.scipy.linalg.cho_solve(factor, -b)
    if method == "unrolled":
        from moptimizer_jax.ops.small_solve import cholesky_solve_unrolled

        return cholesky_solve_unrolled(A, -b)
    return jnp.linalg.solve(A, -b)


def _retract(manifold, x, delta):
    if manifold is None:
        return x + delta
    return manifold.retract(x, delta)


def _linearize_all(problem, x, config, manifold):
    if manifold is None:
        return linearize(
            problem, x, mode=config.diff_mode, accum_dtype=config.accum_dtype
        )

    retract_fn = lambda xx, dd: manifold.retract(xx, dd)  # noqa: E731
    retract_fn.tangent_dim = manifold.tangent_dim
    return linearize_tangent(
        problem, x, retract_fn, mode=config.diff_mode,
        accum_dtype=config.accum_dtype,
    )


def _outer_iteration(problem, x, lam, config, manifold):
    """One outer LM iteration. Returns (x', λ', terminal, status', record)."""
    # with mixed precision (accum_dtype), H, b, costs, λ/ρ and the
    # convergence thresholds all live in the wider dtype; only the model
    # evaluation and the iterate x stay in x.dtype
    dtype = (
        jnp.dtype(config.accum_dtype) if config.accum_dtype is not None else x.dtype
    )
    eps = jnp.finfo(dtype).eps
    sqrt_eps = jnp.sqrt(eps)
    cost_small = lambda c: jnp.abs(c) < 8 * eps  # noqa: E731  (optimizer.h:26-29)

    problem = problem.update(x)
    y0, H, b = _linearize_all(problem, x, config, manifold)
    diag_H = jnp.diagonal(H)

    converged0 = cost_small(y0)
    if config.grad_tol > 0.0:  # static: graph unchanged when off
        converged0 = converged0 | (jnp.max(jnp.abs(b)) < config.grad_tol)
    lam = jnp.where(
        lam < 0.0, config.init_lambda_factor * jnp.max(jnp.abs(diag_H)), lam
    )

    n_inner = config.inner_iterations
    inner_trace0 = dict(
        cost_new=jnp.full((n_inner,), jnp.nan, dtype),
        rho=jnp.full((n_inner,), jnp.nan, dtype),
        lam=jnp.full((n_inner,), jnp.nan, dtype),
        nu=jnp.full((n_inner,), jnp.nan, dtype),
        accepted=jnp.zeros((n_inner,), bool),
    )
    inner0 = dict(
        k=jnp.zeros((), jnp.int32),
        x=x,
        lam=lam,
        nu=jnp.asarray(2.0, dtype),
        y=y0,
        rho=jnp.asarray(jnp.nan, dtype),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        stop=converged0,  # converged before inner loop → skip it
        terminal=converged0,
        accepted=jnp.asarray(False),
        trace=inner_trace0,
    )

    def inner_cond(s):
        return (s["k"] < config.inner_iterations) & ~s["stop"]

    def inner_body(s):
        delta = _solve_damped(H, diag_H, s["lam"], b, config.linear_solver)
        xi = _retract(manifold, x, delta.astype(x.dtype))
        yi = compute_cost(problem, xi, accum_dtype=config.accum_dtype)

        is_nan = jnp.isnan(yi)
        rho = (y0 - yi) / jnp.dot(delta, s["lam"] * delta - b)
        small = jnp.max(jnp.abs(delta)) < sqrt_eps  # reference delta.h:12-16
        reject = rho < 0.0  # NaN ρ falls through to accept, as in C++ (src:97)

        accept = ~is_nan & ~reject
        term_small = ~is_nan & reject & small
        retry = ~is_nan & reject & ~small

        if config.verbose:
            # mirrors "it | max | prev_cost | new_cost | rho | lambda | nu"
            # (reference src/levenberg_marquadt_dyn.cpp:72-75,94-95)
            jax.debug.print(
                "[DEBUG] lm inner: {k}/{m} {y0} {yi} {rho} {lam} {nu}",
                k=s["k"] + 1,
                m=config.inner_iterations,
                y0=y0,
                yi=yi,
                rho=rho,
                lam=s["lam"],
                nu=s["nu"],
            )

        status = jnp.where(
            is_nan,
            int(Status.NUMERIC_ERROR),
            jnp.where(
                term_small,
                jnp.where(
                    cost_small(yi), int(Status.CONVERGED), int(Status.SMALL_DELTA)
                ),
                s["status"],
            ),
        ).astype(jnp.int32)

        gain = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        new_lam = jnp.where(
            accept, s["lam"] * gain, jnp.where(retry, s["nu"] * s["lam"], s["lam"])
        )
        new_nu = jnp.where(retry, 2.0 * s["nu"], s["nu"])
        terminal = is_nan | term_small
        if config.rel_cost_tol > 0.0:  # static: graph unchanged when off
            # accepted step that GENUINELY improved the cost by less than
            # tol·y0: the solve has hit its noise floor — stop as CONVERGED.
            # yi <= y0 is load-bearing: a NaN-ρ fallthrough accepts even a
            # cost-INCREASING step (parity semantics), which must surface as
            # more iterations, not a CONVERGED label.
            rel_term = (
                accept
                & (yi <= y0)
                & ((y0 - yi) <= config.rel_cost_tol * jnp.abs(y0))
            )
            terminal = terminal | rel_term
            status = jnp.where(
                rel_term, jnp.int32(int(Status.CONVERGED)), status
            )

        # per-trial trace slot: the same fields the reference prints per
        # inner iteration (src/levenberg_marquadt_dyn.cpp:72-75,94-95);
        # lam/nu are the values USED in this trial (pre-update).
        k = s["k"]
        tr = s["trace"]
        trace = dict(
            cost_new=tr["cost_new"].at[k].set(yi),
            rho=tr["rho"].at[k].set(rho),
            lam=tr["lam"].at[k].set(s["lam"]),
            nu=tr["nu"].at[k].set(s["nu"]),
            accepted=tr["accepted"].at[k].set(accept),
        )

        return dict(
            k=s["k"] + 1,
            x=jnp.where(accept, xi, s["x"]),
            lam=new_lam,
            nu=new_nu,
            y=jnp.where(accept | terminal, yi, s["y"]),
            rho=rho,
            status=status,
            stop=accept | terminal,
            terminal=terminal,
            accepted=accept,
            trace=trace,
        )

    inner = jax.lax.while_loop(inner_cond, inner_body, inner0)

    terminal = converged0 | inner["terminal"]
    status = jnp.where(
        converged0, jnp.asarray(int(Status.CONVERGED), jnp.int32), inner["status"]
    )
    record = dict(
        cost=y0,
        cost_new=inner["y"],
        rho=inner["rho"],
        lam=inner["lam"],
        nu=inner["nu"],
        accepted=inner["accepted"],
        inner=inner["trace"],  # per-trial (inner_iterations,) arrays
    )
    if config.trace_block_costs:
        # pre-step per-block costs at this outer iteration's x (the
        # reference's per-cost logger line, src/levenberg_marquadt_dyn.cpp:41-42)
        record["block_costs"] = compute_block_costs(
            problem, x, accum_dtype=config.accum_dtype
        )
    return problem, inner["x"], inner["lam"], terminal, status, record


@partial(jax.jit, static_argnames=("config", "manifold"))
def _minimize_impl(problem, x0, config, manifold):
    dtype = (
        jnp.dtype(config.accum_dtype) if config.accum_dtype is not None else x0.dtype
    )
    n_it = config.max_iterations

    n_inner = config.inner_iterations
    trace0 = dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        cost_new=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
        nu=jnp.full((n_it,), jnp.nan, dtype),
        accepted=jnp.zeros((n_it,), bool),
        inner=dict(  # full per-trial record: (max_iterations, inner_iterations)
            cost_new=jnp.full((n_it, n_inner), jnp.nan, dtype),
            rho=jnp.full((n_it, n_inner), jnp.nan, dtype),
            lam=jnp.full((n_it, n_inner), jnp.nan, dtype),
            nu=jnp.full((n_it, n_inner), jnp.nan, dtype),
            accepted=jnp.zeros((n_it, n_inner), bool),
        ),
    )
    if config.trace_block_costs:
        trace0["block_costs"] = jnp.full(
            (n_it, len(problem.blocks)), jnp.nan, dtype
        )

    carry0 = dict(
        x=x0,
        lam=jnp.asarray(-1.0, dtype),
        problem=problem,
        it=jnp.zeros((), jnp.int32),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        done=jnp.asarray(False),
        trace=trace0,
    )

    def cond(c):
        return (c["it"] < n_it) & ~c["done"]

    def body(c):
        problem, x, lam, terminal, status, record = _outer_iteration(
            c["problem"], c["x"], c["lam"], config, manifold
        )
        trace = jax.tree.map(
            lambda v, r: v.at[c["it"]].set(r), c["trace"], record
        )
        # executed_iterations_: not incremented on the iteration that returns
        # (reference for-loop returns mid-body, src:34-119).
        return dict(
            x=x,
            lam=lam,
            problem=problem,
            it=jnp.where(terminal, c["it"], c["it"] + 1),
            status=status,
            done=terminal,
            trace=trace,
        )

    c = jax.lax.while_loop(cond, body, carry0)
    final_cost = compute_cost(c["problem"], c["x"], accum_dtype=config.accum_dtype)
    return LMResult(
        x=c["x"],
        status=c["status"],
        iterations=c["it"],
        cost=final_cost,
        lam=c["lam"],
        trace=c["trace"],
    )


def levenberg_marquardt(problem, x0, config=LMConfig(), manifold=None):
    """Minimize a Problem (or single block) from x0. Fully jitted.

    Equivalent of LevenbergMarquadtDynamic::minimize
    (src/levenberg_marquadt_dyn.cpp:34-119). Returns an LMResult; x0 is
    unchanged (the reference mutates it in place).
    """
    from moptimizer_jax.core.residual import Problem

    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    if len(problem.blocks) == 0:
        raise ValueError("No cost function added!")  # reference optimizer.h:48-51
    x0 = jnp.asarray(x0)
    return _minimize_impl(problem, x0, config, manifold)


@partial(jax.jit, static_argnames=("config", "manifold", "batch_data"))
def levenberg_marquardt_batched(
    problem, x0_batch, config=LMConfig(), manifold=None, batch_data=True
):
    """Solve B independent instances of one problem STRUCTURE in parallel.

    A capability with no reference counterpart: `problem`'s data
    leaves carry a leading batch axis B (every instance shares shapes and
    functions — e.g. B scan pairs, B curve datasets), `x0_batch` is (B, P),
    and the whole batch solves in ONE device program via vmap — the
    accept/reject control flow becomes per-instance masking, so a batch
    costs roughly one solve of the slowest instance instead of B dispatches.
    Small-problem throughput scales near-linearly until the chip saturates
    (measured: see PERF.md "batched solves").

    Returns an LMResult whose every field carries the leading B axis.
    Data-independent blocks (data=None) are replicated, not batched.

    batch_data=False: every instance shares ONE copy of the problem data
    (no leading B axis on data leaves) and only x0 varies — B starts on the
    same problem (multi-start globalization, or throughput benchmarking of
    identical solves) without B× data replication in HBM.
    """
    from moptimizer_jax.core.residual import Problem

    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    if len(problem.blocks) == 0:
        raise ValueError("No cost function added!")  # reference optimizer.h:48-51
    x0_batch = jnp.asarray(x0_batch)

    datas = tuple(b.data for b in problem.blocks)

    def solve_one(datas_i, x0):
        import dataclasses

        blocks = tuple(
            dataclasses.replace(b, data=d)
            for b, d in zip(problem.blocks, datas_i)
        )
        return _minimize_impl(Problem(blocks=blocks), x0, config, manifold)

    in_axes = (
        tuple(None if (d is None or not batch_data) else 0 for d in datas),
        0,
    )
    return jax.vmap(solve_one, in_axes=in_axes)(datas, x0_batch)


def solve_multistart(
    problem, x0_batch, config=LMConfig(), manifold=None, batch_data=False
):
    """Best-of-B multistart: B starts solved batched, lowest-cost healthy
    instance returned as a single LMResult (plus the full batch).

    Nonconvex residuals (rational fits, registration from poor priors) have
    basins; the classic remedy is restarts, which on the device cost barely more
    than one solve when vmapped (levenberg_marquardt_batched). Instances
    with Status.NUMERIC_ERROR are excluded; if every start failed, the
    lowest-cost one is returned (caller checks `.status`).

    Returns (best: LMResult, all: LMResult-with-leading-B-axis).
    """
    res = levenberg_marquardt_batched(
        problem, x0_batch, config, manifold, batch_data=batch_data
    )
    bad = res.status == int(Status.NUMERIC_ERROR)
    cost = jnp.where(bad, jnp.inf, res.cost)
    i = jnp.argmin(jnp.where(jnp.all(bad), res.cost, cost))
    best = jax.tree_util.tree_map(lambda leaf: leaf[i], res)
    return best, res


@partial(jax.jit, static_argnames=("config", "manifold"))
def lm_step(problem, x, lam, config=LMConfig(), manifold=None):
    """One outer LM iteration: (problem', x', λ', terminal, status, record).

    The reference's `step()` is a stub returning NUMERIC_ERROR
    (src/levenberg_marquadt_dyn.cpp:29-31); here it is the real loop body.
    Pass λ = −1 on the first call to trigger the λ-seed rule.
    """
    lam_dtype = (
        jnp.dtype(config.accum_dtype) if config.accum_dtype is not None else x.dtype
    )
    return _outer_iteration(problem, x, jnp.asarray(lam, lam_dtype), config, manifold)
