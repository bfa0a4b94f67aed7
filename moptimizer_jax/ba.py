"""Schur-complement bundle adjustment — the scale workload of the engine.

The reference stops at a 5-point camera-calibration reprojection test
(tst/camera_calibration.cpp); this module is the production-scale extension
its roadmap implies (BASELINE.json north star): joint refinement of C camera
poses and L landmarks from O pixel observations.

Structure (no sparse matrices, no dynamic shapes):

* residuals + per-observation Jacobians A_o = ∂r/∂cam (2×6),
  B_o = ∂r/∂pt (2×3) — one vmapped jacfwd over the observation axis;
* Gauss-Newton blocks via segment_sum:
      U_c = Σ AᵀA (C,6,6),  V_l = Σ BᵀB (L,3,3),  W_o = AᵀB (O,6,3)
* landmark elimination by the Schur complement, applied **matrix-free**:
      S u = U' u − Σ_o W_o · V'⁻¹ · (Σ_o W_oᵀ u)
  evaluated with gathers + segment_sums (batched device ops),
  solved by preconditioned CG (block-Jacobi U'⁻¹) — S is never materialized,
  so memory is O(C + L + O) regardless of camera-graph density;
* back-substitution δl = V'⁻¹ (h − Wᵀ δc) per landmark;
* the same LM λ/ν/ρ schedule as core.solver (reference
  src/levenberg_marquadt_dyn.cpp:67-114) over the joint state.

Sharding: every per-observation array (cam_idx, pt_idx, pixels) can be
device_put along the observation axis; the segment_sums then reduce across devices
under GSPMD — the distributed-BA layout of SURVEY.md §2.3.
"""

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from moptimizer_jax.core.solver import Status
from moptimizer_jax.lie import se3


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BAProblem:
    """State + data of a bundle-adjustment problem.

    camera_params: (C, 6) poses [t, ω] (reference params6 convention,
        src/so3.cpp:7-19), world→camera.
    points: (L, 3) landmarks.
    cam_idx, pt_idx: (O,) observation incidence.
    pixels: (O, 2) measured projections.
    intrinsics: (4,) [fx, fy, cx, cy] shared pinhole intrinsics.
    n_fixed_cameras: gauge fixing — deltas of the first k cameras are zeroed
        (static field).
    """

    camera_params: jax.Array
    points: jax.Array
    cam_idx: jax.Array
    pt_idx: jax.Array
    pixels: jax.Array
    intrinsics: jax.Array
    loss: Any = None  # robust loss (core.loss); weights H,b only, like the
    # reference's loss semantics (linearization.h:108-115). None = trivial.
    n_fixed_cameras: int = dataclasses.field(default=1, metadata=dict(static=True))


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iterations: int = 15
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    cg_iterations: int = 50
    cg_tol: float = 1e-8
    # optional noise-floor stopping (mirrors LMConfig.rel_cost_tol): an
    # accepted step improving the cost by <= tol*y0 terminates CONVERGED.
    # 0.0 = off (parity semantics).
    rel_cost_tol: float = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BAResult:
    camera_params: jax.Array
    points: jax.Array
    status: jax.Array
    iterations: jax.Array
    cost: jax.Array
    trace: dict


def _project(cam, point, intr):
    """Pinhole projection of a world point through a params6 pose."""
    T = se3.transform_from_params6(cam)
    pc = T[:3, :3] @ point + T[:3, 3]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    z = pc[2]
    return jnp.stack([fx * pc[0] / z + cx, fy * pc[1] / z + cy])


def _residual(cam, point, pixel, intr):
    return pixel - _project(cam, point, intr)


def residuals_all(problem):
    """(O, 2) residual array."""
    cams = problem.camera_params[problem.cam_idx]
    pts = problem.points[problem.pt_idx]
    return jax.vmap(_residual, (0, 0, 0, None))(
        cams, pts, problem.pixels, problem.intrinsics
    )


def compute_cost(problem):
    r = residuals_all(problem)
    return jnp.sum(r * r)


def _linearize(problem):
    """Per-observation residuals and Jacobians (r, A (O,2,6), B (O,2,3))."""
    cams = problem.camera_params[problem.cam_idx]
    pts = problem.points[problem.pt_idx]

    def rj(cam, pt, pix):
        r = _residual(cam, pt, pix, problem.intrinsics)
        A = jax.jacfwd(_residual, argnums=0)(cam, pt, pix, problem.intrinsics)
        B = jax.jacfwd(_residual, argnums=1)(cam, pt, pix, problem.intrinsics)
        return r, A, B

    return jax.vmap(rj)(cams, pts, problem.pixels)


def _outer_rows(X, Y):
    """Σ_i X[...,i,:,None]·Y[...,i,None,:] over the i = 2 residual rows,
    unrolled to broadcast elementwise sums: written as an einsum this is a
    batch of (n,2)ᵀ(2,m) tiny dots, a poor shape for any matmul unit;
    unrolled it fuses into elementwise work."""
    return (
        X[..., 0, :, None] * Y[..., 0, None, :]
        + X[..., 1, :, None] * Y[..., 1, None, :]
    )


def _gn_blocks(problem, r, A, B):
    """Segment-summed Gauss-Newton blocks. A robust loss (problem.loss)
    contributes an IRLS weight w = loss(‖r‖²) per observation on H,b only
    (reference loss semantics, linearization.h:108-115)."""
    C = problem.camera_params.shape[0]
    L = problem.points.shape[0]
    if problem.loss is not None:
        w = problem.loss.weight(jnp.sum(r * r, axis=1))  # (O,)
        Aw = w[:, None, None] * A
        Bw = w[:, None, None] * B
        rw = w[:, None] * r
    else:
        Aw, Bw, rw = A, B, r
    U = jax.ops.segment_sum(
        _outer_rows(Aw, A), problem.cam_idx, num_segments=C
    )  # (C,6,6)
    V = jax.ops.segment_sum(
        _outer_rows(Bw, B), problem.pt_idx, num_segments=L
    )  # (L,3,3)
    W = _outer_rows(Aw, B)  # (O,6,3)
    g = jax.ops.segment_sum(
        A[:, 0, :] * rw[:, 0, None] + A[:, 1, :] * rw[:, 1, None],
        problem.cam_idx, num_segments=C,
    )  # (C,6)
    h = jax.ops.segment_sum(
        B[:, 0, :] * rw[:, 0, None] + B[:, 1, :] * rw[:, 1, None],
        problem.pt_idx, num_segments=L,
    )  # (L,3)
    return U, V, W, g, h


def _damp_blocks(M, lam):
    d = jnp.diagonal(M, axis1=-2, axis2=-1)  # (..., k)
    return M + lam * jax.vmap(jnp.diag)(d)


def _inv3x3(A):
    """Closed-form batched 3×3 inverse (adjugate/determinant).

    jnp.linalg.inv on an (L,3,3) batch dispatches a generic LU per element;
    unrolled this is a few fused elementwise ops (cf. ba_dense._chol3x3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    idet = 1.0 / (a * co_a + b * co_b + c * co_c)
    return (
        jnp.stack(
            [
                jnp.stack([co_a, c * h - b * i, b * f - c * e], axis=-1),
                jnp.stack([co_b, a * i - c * g, c * d - a * f], axis=-1),
                jnp.stack([co_c, b * g - a * h, a * e - b * d], axis=-1),
            ],
            axis=-2,
        )
        * idet[..., None, None]
    )


def _schur_matvec(u, U_d, W, Vinv, cam_idx, pt_idx, C, L, cam_mask):
    """S·u with S = U' − W V'⁻¹ Wᵀ, matrix-free. u: (C,6)."""
    u = u * cam_mask  # fixed cameras contribute nothing
    # batched small matvecs as broadcast sums (tiny-dot einsums are a poor
    # matmul shape)
    Uu = jnp.sum(U_d * u[:, None, :], axis=-1)  # (C,6)
    Wu = jnp.sum(W * u[cam_idx][:, :, None], axis=1)  # (O,3): W_oᵀ u_cam(o)
    t = jax.ops.segment_sum(Wu, pt_idx, num_segments=L)  # (L,3)
    s = jnp.sum(Vinv * t[:, None, :], axis=-1)  # (L,3)
    back = jax.ops.segment_sum(
        jnp.sum(W * s[pt_idx][:, None, :], axis=-1), cam_idx, num_segments=C
    )  # (C,6)
    return (Uu - back) * cam_mask


def _pcg(matvec, b, Minv_mv, iters, tol):
    """Preconditioned conjugate gradients on the camera system."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = Minv_mv(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, Ap), jnp.finfo(b.dtype).tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv_mv(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, jnp.finfo(b.dtype).tiny)
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    def cond(state):
        _, r, _, _, k = state
        return (k < iters) & (jnp.vdot(r, r) > tol * tol)

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x


def _solve_delta(problem, U, V, W, g, h, lam, config):
    """One damped Gauss-Newton solve: returns (δcam (C,6), δpt (L,3))."""
    C = problem.camera_params.shape[0]
    L = problem.points.shape[0]
    dtype = problem.camera_params.dtype

    U_d = _damp_blocks(U, lam)
    V_d = _damp_blocks(V, lam)
    Vinv = _inv3x3(V_d + 1e-12 * jnp.eye(3, dtype=dtype))  # (L,3,3)

    cam_mask = (
        (jnp.arange(C) >= problem.n_fixed_cameras).astype(dtype)[:, None]
    )  # (C,1)

    # rhs = −(g − W V'⁻¹ h)  (we solve for δ with H δ = −b convention, src:80)
    t = jnp.sum(Vinv * h[:, None, :], axis=-1)
    rhs = -(g - jax.ops.segment_sum(
        jnp.sum(W * t[problem.pt_idx][:, None, :], axis=-1),
        problem.cam_idx,
        num_segments=C,
    ))
    rhs = rhs * cam_mask

    # block-Jacobi preconditioner from U'
    U_inv = jnp.linalg.inv(U_d + 1e-12 * jnp.eye(6, dtype=dtype))

    def mv(u):
        return _schur_matvec(
            u.reshape(C, 6), U_d, W, Vinv, problem.cam_idx, problem.pt_idx, C, L, cam_mask
        ).reshape(-1)

    def pre(u):
        return (
            jnp.sum(U_inv * u.reshape(C, 6)[:, None, :], axis=-1) * cam_mask
        ).reshape(-1)

    d_cam = _pcg(mv, rhs.reshape(-1), pre, config.cg_iterations, config.cg_tol).reshape(C, 6)
    d_cam = d_cam * cam_mask

    # back-substitute landmarks: δl = V'⁻¹ (−h − Wᵀ δcam)
    Wtd = jax.ops.segment_sum(
        jnp.sum(W * d_cam[problem.cam_idx][:, :, None], axis=1),
        problem.pt_idx,
        num_segments=L,
    )
    d_pt = jnp.sum(Vinv * (-h - Wtd)[:, None, :], axis=-1)
    return d_cam, d_pt


def _lm_trials(
    state, y0, b_flat, cams0, pts0, solve_fn, cost_fn, inner_iterations,
    metrics_fn=None, rel_cost_tol=0.0,
):
    """The reference's inner LM trial loop (src/levenberg_marquadt_dyn.cpp:
    77-114) over a (cameras, points) pair — thin wrapper around
    _lm_trials_tree for the common two-leaf case.

    state: dict with cams/pts/lam/nu/y/rho/status/stop/terminal.
    solve_fn(lam) -> (d_cam, d_pt); cost_fn(cams, pts) -> scalar.
    metrics_fn(d_cam, d_pt, lam) -> (ρ denominator δ·(λδ−b), max|δ|):
    overrides the default b_flat-based computation — the sharded dense
    engine supplies one whose landmark terms psum over the mesh axis.
    """
    tree_state = dict(state)
    tree_state["params"] = (tree_state.pop("cams"), tree_state.pop("pts"))
    tree_metrics = (
        None
        if metrics_fn is None
        else (lambda delta, lam: metrics_fn(delta[0], delta[1], lam))
    )
    out = _lm_trials_tree(
        tree_state,
        y0,
        b_flat,
        (cams0, pts0),
        lambda lam: tuple(solve_fn(lam)),
        lambda p: cost_fn(p[0], p[1]),
        inner_iterations,
        metrics_fn=tree_metrics,
        rel_cost_tol=rel_cost_tol,
    )
    cams, pts = out.pop("params")
    return dict(out, cams=cams, pts=pts)


def _lm_trials_tree(
    state, y0, b_flat, params0, solve_fn, cost_fn, inner_iterations,
    metrics_fn=None, rel_cost_tol=0.0,
):
    """Inner LM trial loop over an arbitrary parameter pytree — shared by
    the matrix-free CG engine (ba.py, params = (cams, pts)), the dense-Schur
    engine (ba_dense.py) and its self-calibrating variant
    (params = (cams, pts, intrinsics)).

    state: dict with params/lam/nu/y/rho/status/stop/terminal.
    solve_fn(lam) -> delta pytree (same structure as params0);
    cost_fn(params) -> scalar; b_flat: flattened gradient matching the
    leaf-concatenation order of the params pytree (unused if metrics_fn).
    metrics_fn(delta, lam) -> (ρ denominator δ·(λδ−b), max|δ|).

    Runs as a lax.while_loop so an accepted first trial (the common case)
    pays for exactly one damped solve + one cost evaluation — a statically
    unrolled variant would execute all `inner_iterations` solves and mask
    the results, tripling the per-outer-iteration cost of the dense-Schur
    engine.
    """
    dtype = y0.dtype
    eps = jnp.finfo(dtype).eps
    state = dict(state, k=jnp.zeros((), jnp.int32))

    def cond(s):
        return (s["k"] < inner_iterations) & ~s["stop"]

    def body(s):
        delta = solve_fn(s["lam"])
        params_i = jax.tree_util.tree_map(jnp.add, params0, delta)
        yi = cost_fn(params_i)

        is_nan = jnp.isnan(yi)
        if metrics_fn is None:
            delta_flat = jnp.concatenate(
                [d.reshape(-1) for d in jax.tree_util.tree_leaves(delta)]
            )
            denom = jnp.dot(delta_flat, s["lam"] * delta_flat - b_flat)
            max_abs_delta = jnp.max(jnp.abs(delta_flat))
        else:
            denom, max_abs_delta = metrics_fn(delta, s["lam"])
        rho = (y0 - yi) / denom
        small = max_abs_delta < jnp.sqrt(eps)
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
        terminal = is_nan | term_small
        if rel_cost_tol > 0.0:  # static: graph unchanged when off
            # accepted step at the noise floor → stop as CONVERGED (the
            # practical criterion of core.solver.LMConfig.rel_cost_tol)
            # yi <= y0 guards the NaN-ρ accept fallthrough: a
            # cost-increasing accepted step must not be labeled CONVERGED
            rel_term = (
                accept & (yi <= y0) & ((y0 - yi) <= rel_cost_tol * jnp.abs(y0))
            )
            terminal = terminal | rel_term
            status = jnp.where(
                rel_term, jnp.int32(int(Status.CONVERGED)), status
            )
        return dict(
            params=jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), params_i, s["params"]
            ),
            lam=jnp.where(
                accept,
                s["lam"] * gain,
                jnp.where(retry, s["nu"] * s["lam"], s["lam"]),
            ),
            nu=jnp.where(retry, 2.0 * s["nu"], s["nu"]),
            y=jnp.where(accept | is_nan | term_small, yi, s["y"]),
            rho=rho,
            status=status,
            stop=accept | is_nan | term_small,
            terminal=terminal,
            k=s["k"] + 1,
        )

    state = jax.lax.while_loop(cond, body, state)
    del state["k"]
    return state


def _lm_init_state_tree(params, lam, y0, dtype):
    converged0 = jnp.abs(y0) < 8 * jnp.finfo(dtype).eps
    return dict(
        params=params,
        lam=lam,
        nu=jnp.asarray(2.0, dtype),
        y=y0,
        rho=jnp.asarray(jnp.nan, dtype),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        stop=converged0,
        terminal=converged0,
    )


def _lm_init_state(cams, pts, lam, y0, dtype):
    st = _lm_init_state_tree((cams, pts), lam, y0, dtype)
    cams_, pts_ = st.pop("params")
    return dict(st, cams=cams_, pts=pts_)


@partial(jax.jit, static_argnames=("config",))
def ba_step(problem, lam, config=BAConfig()):
    """One outer LM iteration (jitted; inner trial loop unrolled since
    inner_iterations is static and ≤3).

    Exposed for streaming/checkpointed drivers (step, inspect, persist,
    continue). For full solves prefer solve_ba: the single-dispatch
    device loop adds no per-step host round trip.
    Returns (cams, pts, λ', terminal, status, record).
    """
    dtype = problem.camera_params.dtype
    eps = jnp.finfo(dtype).eps

    r, A, B = _linearize(problem)
    U, V, W, g, h = _gn_blocks(problem, r, A, B)
    y0 = jnp.sum(r * r)

    converged0 = jnp.abs(y0) < 8 * eps
    max_diag = jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(U, axis1=-2, axis2=-1))),
        jnp.max(jnp.abs(jnp.diagonal(V, axis1=-2, axis2=-1))),
    )
    lam = jnp.where(lam < 0.0, config.init_lambda_factor * max_diag, lam)

    state = _lm_init_state(problem.camera_params, problem.points, lam, y0, dtype)
    b_flat = jnp.concatenate([g.reshape(-1), h.reshape(-1)])

    def solve_fn(lam_k):
        return _solve_delta(problem, U, V, W, g, h, lam_k, config)

    def cost_fn(cams_i, pts_i):
        return compute_cost(
            dataclasses.replace(problem, camera_params=cams_i, points=pts_i)
        )

    state = _lm_trials(
        state,
        y0,
        b_flat,
        problem.camera_params,
        problem.points,
        solve_fn,
        cost_fn,
        config.inner_iterations,
        rel_cost_tol=config.rel_cost_tol,
    )

    terminal = converged0 | state["terminal"]
    status = jnp.where(
        converged0, jnp.asarray(int(Status.CONVERGED), jnp.int32), state["status"]
    )
    record = dict(cost=y0, cost_new=state["y"], rho=state["rho"], lam=state["lam"])
    return state["cams"], state["pts"], state["lam"], terminal, status, record


# engine="auto" routing thresholds: the dense-Schur engine is used while its
# (6C)² replicated camera system stays small — ~4·(6C)² f32 bytes of S + its
# factor (≈2.6 GB at C = 3000) — and while the (L·K)/O grid-padding
# inflation stays moderate; past either bound the matrix-free CG engine's
# O-proportional work takes over. Neither bound has been measured against
# the CG engine on the GPU yet (PERF.md, open questions).
DENSE_MAX_CAMERAS = 3000
DENSE_MAX_PADDING = 16.0
# OOM guard: the dense engine's estimated peak device memory
# (ba_dense.dense_memory_bytes — (L,K) grid + linearization products + S +
# factor) must leave headroom for XLA temporaries and the caller's arrays.
# A JAX process on an H100 80GB gets bytes_limit = 63.8e9 bytes (three
# quarters of the card, chip_smoke.py phase 1); this keeps ~28 GB of it
# free. Past it the auto route falls back to the O-proportional CG engine
# instead of running out of memory.
DENSE_MAX_BYTES = 36e9


def select_engine(problem):
    """engine="auto" routing decision (host-side, cheap). See solve_ba.

    Routes on the SEGMENTED slot factor (ba_dense.dense_slot_factor, r5):
    solve_ba_dense's valence-segmented default means a hub landmark only
    inflates its own segment, so skewed problems that exceeded the
    single-K padding bound stay dense-eligible when segmentation applies
    (L ≥ 1024 — below that the historical (L·K)/O bound is what runs)."""
    from moptimizer_jax import ba_dense

    C = problem.camera_params.shape[0]
    if (
        C <= DENSE_MAX_CAMERAS
        and ba_dense.dense_slot_factor(problem) <= DENSE_MAX_PADDING
        and ba_dense.dense_memory_bytes(problem) <= DENSE_MAX_BYTES
    ):
        return "dense"
    return "cg"


def solve_ba(problem, config=BAConfig(), host_loop=False, engine="cg"):
    """LM over (cameras, landmarks) with Schur-eliminated inner solves.

    Follows the reference LM schedule exactly (λ seed 1e-9·max diag,
    ρ accept/reject, λ·ν backoff — src/levenberg_marquadt_dyn.cpp:67-114)
    with the damped solve replaced by a Schur-complement camera solve.

    engine:
      "cg"    — matrix-free Schur preconditioned CG (this module).
      "dense" — explicit-Schur engine (ba_dense.solve_ba_dense).
      "auto"  — route on problem shape: dense while C ≤ DENSE_MAX_CAMERAS,
                the SEGMENTED landmark-grid slot factor ≤
                DENSE_MAX_PADDING (ba_dense.dense_slot_factor — under the
                valence-segmented default a hub landmark only inflates
                its own segment), and the estimated peak HBM
                (ba_dense.dense_memory_bytes) ≤ DENSE_MAX_BYTES (OOM
                guard); else CG.

    host_loop=True drives ba_step from Python (one dispatch per outer
    iteration) — useful for checkpointing/streaming; the default runs the
    whole solve in one jitted lax.while_loop dispatch (faster, see ba_step).
    """
    if engine == "auto":
        engine = select_engine(problem)
    if engine == "dense":
        from moptimizer_jax import ba_dense

        return ba_dense.solve_ba_dense(
            problem,
            ba_dense.DenseBAConfig(
                max_iterations=config.max_iterations,
                inner_iterations=config.inner_iterations,
                init_lambda_factor=config.init_lambda_factor,
            ),
        )
    if engine != "cg":
        raise ValueError(f"unknown engine {engine!r}")
    if host_loop:
        return _solve_ba_host(problem, config)
    return _solve_ba_device(problem, config)


def _solve_ba_host(problem, config):
    dtype = problem.camera_params.dtype
    n_it = config.max_iterations
    lam = jnp.asarray(-1.0, dtype)
    status = jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32)
    records = []
    executed = 0
    for it in range(n_it):
        cams, pts, lam, terminal, status, record = ba_step(problem, lam, config)
        problem = dataclasses.replace(problem, camera_params=cams, points=pts)
        records.append(record)
        if bool(terminal):
            executed = it  # reference: executed_iterations_ not incremented on return
            break
        executed = it + 1

    import numpy as _np

    def _column(key):
        col = _np.full((n_it,), _np.nan, dtype=_np.float64)
        for i, rec in enumerate(records):
            col[i] = float(rec[key])
        return jnp.asarray(col, dtype)

    trace = {k: _column(k) for k in ("cost", "cost_new", "rho", "lam")} if records else dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        cost_new=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
    )
    return BAResult(
        camera_params=problem.camera_params,
        points=problem.points,
        status=status,
        iterations=jnp.asarray(executed, jnp.int32),
        cost=compute_cost(problem),
        trace=trace,
    )


@partial(jax.jit, static_argnames=("config",))
def _solve_ba_device(problem, config=BAConfig()):
    """Single-dispatch solve: lax.while_loop over the ba_step body."""
    dtype = problem.camera_params.dtype
    n_it = config.max_iterations

    trace0 = dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        cost_new=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
    )
    carry0 = dict(
        cams=problem.camera_params,
        pts=problem.points,
        lam=jnp.asarray(-1.0, dtype),
        it=jnp.zeros((), jnp.int32),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        done=jnp.asarray(False),
        trace=trace0,
    )

    def cond(c):
        return (c["it"] < n_it) & ~c["done"]

    def body(c):
        prob = dataclasses.replace(
            problem, camera_params=c["cams"], points=c["pts"]
        )
        cams, pts, lam, terminal, status, record = ba_step.__wrapped__(
            prob, c["lam"], config
        )
        trace = {k: v.at[c["it"]].set(record[k]) for k, v in c["trace"].items()}
        return dict(
            cams=cams,
            pts=pts,
            lam=lam,
            it=jnp.where(terminal, c["it"], c["it"] + 1),
            status=status,
            done=terminal,
            trace=trace,
        )

    c = jax.lax.while_loop(cond, body, carry0)
    final = dataclasses.replace(problem, camera_params=c["cams"], points=c["pts"])
    return BAResult(
        camera_params=c["cams"],
        points=c["pts"],
        status=c["status"],
        iterations=c["it"],
        cost=compute_cost(final),
        trace=c["trace"],
    )
