"""Self-calibrating bundle adjustment: joint (cameras, landmarks, shared
intrinsics) refinement.

Extends ba.py's Schur-complement solver with a global intrinsics block
θ = [fx, fy, cx, cy] coupled to every observation. After eliminating
landmarks, the reduced system covers (6C + 4) unknowns:

    [ S_cc  S_cθ ] [δc]   [ r_c ]        S_cc = U' − W V'⁻¹ Wᵀ
    [ S_cθᵀ S_θθ ] [δθ] = [ r_θ ],       S_cθ = P − W V'⁻¹ Y
                                         S_θθ = Z' − Yᵀ V'⁻¹ Y
with per-observation K_o = ∂r/∂θ (2,4), P = Σ_c AᵀK, Y_l = Σ_{o∈l} BᵀK,
Z = Σ KᵀK — all segment-summed batched ops, solved matrix-free by the same
preconditioned CG, then δl back-substituted with the extra −Y δθ term.

The camera-calibration workflow this completes is the reference's
tst/camera_calibration.cpp with K hard-coded (:29-30) — here K is estimated.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from moptimizer_jax import ba
from moptimizer_jax.core.solver import Status


def _linearize_full(problem):
    """(r, A (O,2,6), B (O,2,3), K (O,2,4)) with intrinsics Jacobian."""
    cams = problem.camera_params[problem.cam_idx]
    pts = problem.points[problem.pt_idx]

    def rj(cam, pt, pix):
        r = ba._residual(cam, pt, pix, problem.intrinsics)
        A = jax.jacfwd(ba._residual, argnums=0)(cam, pt, pix, problem.intrinsics)
        B = jax.jacfwd(ba._residual, argnums=1)(cam, pt, pix, problem.intrinsics)
        K = jax.jacfwd(
            lambda th: ba._residual(cam, pt, pix, th)
        )(problem.intrinsics)
        return r, A, B, K

    return jax.vmap(rj)(cams, pts, problem.pixels)


def _gn_blocks_full(problem, r, A, B, K):
    C = problem.camera_params.shape[0]
    L = problem.points.shape[0]
    if problem.loss is not None:
        w = problem.loss.weight(jnp.sum(r * r, axis=1))
        Aw = w[:, None, None] * A
        Bw = w[:, None, None] * B
        Kw = w[:, None, None] * K
        rw = w[:, None] * r
    else:
        Aw, Bw, Kw, rw = A, B, K, r
    # ba._outer_rows / broadcast sums instead of O-batched tiny-dot einsums
    # (PERF.md finding 2)
    def rows_dot(X, v):  # Σ_i X[:,i,:]·v[:,i] → (O, n)
        return X[:, 0, :] * v[:, 0, None] + X[:, 1, :] * v[:, 1, None]

    U = jax.ops.segment_sum(ba._outer_rows(Aw, A), problem.cam_idx, num_segments=C)
    V = jax.ops.segment_sum(ba._outer_rows(Bw, B), problem.pt_idx, num_segments=L)
    W = ba._outer_rows(Aw, B)  # (O,6,3)
    P = jax.ops.segment_sum(ba._outer_rows(Aw, K), problem.cam_idx, num_segments=C)  # (C,6,4)
    Y = jax.ops.segment_sum(ba._outer_rows(Bw, K), problem.pt_idx, num_segments=L)  # (L,3,4)
    Z = jnp.sum(ba._outer_rows(Kw, K), axis=0)  # (4,4)
    g = jax.ops.segment_sum(rows_dot(A, rw), problem.cam_idx, num_segments=C)
    h = jax.ops.segment_sum(rows_dot(B, rw), problem.pt_idx, num_segments=L)
    g_t = jnp.sum(rows_dot(K, rw), axis=0)  # (4,)
    return U, V, W, P, Y, Z, g, h, g_t


def _solve_delta_full(problem, blocks, lam, config):
    """Damped Schur solve over (cams, θ); returns (δcam, δpt, δθ)."""
    U, V, W, P, Y, Z, g, h, g_t = blocks
    C = problem.camera_params.shape[0]
    L = problem.points.shape[0]
    dtype = problem.camera_params.dtype
    cam_idx, pt_idx = problem.cam_idx, problem.pt_idx

    U_d = ba._damp_blocks(U, lam)
    V_d = ba._damp_blocks(V, lam)
    Z_d = Z + lam * jnp.diag(jnp.diagonal(Z))
    Vinv = ba._inv3x3(V_d + 1e-12 * jnp.eye(3, dtype=dtype))

    cam_mask = (jnp.arange(C) >= problem.n_fixed_cameras).astype(dtype)[:, None]

    def pack(u_c, u_t):
        return jnp.concatenate([u_c.reshape(-1), u_t])

    def unpack(u):
        return u[: 6 * C].reshape(C, 6), u[6 * C :]

    # batched small matvecs as broadcast sums (tiny-dot einsums are a poor
    # matmul shape)
    def bmv(M, v):  # (n,i,j)·(n,j) → (n,i)
        return jnp.sum(M * v[:, None, :], axis=-1)

    def matvec(u):
        u_c, u_t = unpack(u)
        u_c = u_c * cam_mask
        # direct blocks
        out_c = bmv(U_d, u_c) + jnp.sum(P * u_t[None, None, :], axis=-1)
        out_t = jnp.sum(P * u_c[:, :, None], axis=(0, 1)) + Z_d @ u_t
        # landmark elimination: t_l = V⁻¹ (Wᵀu_c + Y u_t) per landmark
        Wu = jnp.sum(W * u_c[cam_idx][:, :, None], axis=1)  # (O,3)
        t = jax.ops.segment_sum(Wu, pt_idx, num_segments=L) + jnp.sum(
            Y * u_t[None, None, :], axis=-1
        )
        s = bmv(Vinv, t)
        out_c = out_c - jax.ops.segment_sum(
            bmv(W, s[pt_idx]), cam_idx, num_segments=C
        )
        out_t = out_t - jnp.sum(Y * s[:, :, None], axis=(0, 1))
        return pack(out_c * cam_mask, out_t)

    # rhs = −(g_red) for both blocks
    t0 = bmv(Vinv, h)
    r_c = -(g - jax.ops.segment_sum(
        bmv(W, t0[pt_idx]), cam_idx, num_segments=C
    )) * cam_mask
    r_t = -(g_t - jnp.sum(Y * t0[:, :, None], axis=(0, 1)))
    rhs = pack(r_c, r_t)

    # block-Jacobi preconditioner (U' blocks + Z' block)
    U_inv = jnp.linalg.inv(U_d + 1e-12 * jnp.eye(6, dtype=dtype))
    Z_inv = jnp.linalg.inv(Z_d + 1e-12 * jnp.eye(4, dtype=dtype))

    def pre(u):
        u_c, u_t = unpack(u)
        return pack(bmv(U_inv, u_c) * cam_mask, Z_inv @ u_t)

    sol = ba._pcg(matvec, rhs, pre, config.cg_iterations, config.cg_tol)
    d_cam, d_t = unpack(sol)
    d_cam = d_cam * cam_mask

    # back-substitute: δl = V'⁻¹(−h − Wᵀδc − Y δθ)
    Wtd = jax.ops.segment_sum(
        jnp.sum(W * d_cam[cam_idx][:, :, None], axis=1), pt_idx, num_segments=L
    )
    d_pt = bmv(Vinv, -h - Wtd - jnp.sum(Y * d_t[None, None, :], axis=-1))
    return d_cam, d_pt, d_t


@partial(jax.jit, static_argnames=("config",))
def ba_step_selfcal(problem, lam, config=ba.BAConfig()):
    """One LM iteration refining cameras, landmarks AND intrinsics."""
    dtype = problem.camera_params.dtype
    eps = jnp.finfo(dtype).eps

    r, A, B, K = _linearize_full(problem)
    blocks = _gn_blocks_full(problem, r, A, B, K)
    U, V = blocks[0], blocks[1]
    g, h, g_t = blocks[6], blocks[7], blocks[8]
    y0 = jnp.sum(r * r)

    converged0 = jnp.abs(y0) < 8 * eps
    max_diag = jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(U, axis1=-2, axis2=-1))),
        jnp.max(jnp.abs(jnp.diagonal(V, axis1=-2, axis2=-1))),
    )
    lam = jnp.where(lam < 0.0, config.init_lambda_factor * max_diag, lam)

    state = dict(
        cams=problem.camera_params,
        pts=problem.points,
        intr=problem.intrinsics,
        lam=lam,
        nu=jnp.asarray(2.0, dtype),
        y=y0,
        rho=jnp.asarray(jnp.nan, dtype),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        stop=converged0,
        terminal=converged0,
    )
    b_flat = jnp.concatenate([g.reshape(-1), h.reshape(-1), g_t])

    for _ in range(config.inner_iterations):
        d_cam, d_pt, d_t = _solve_delta_full(problem, blocks, state["lam"], config)
        cams_i = problem.camera_params + d_cam
        pts_i = problem.points + d_pt
        intr_i = problem.intrinsics + d_t
        yi = ba.compute_cost(
            dataclasses.replace(
                problem, camera_params=cams_i, points=pts_i, intrinsics=intr_i
            )
        )
        is_nan = jnp.isnan(yi)
        delta_flat = jnp.concatenate([d_cam.reshape(-1), d_pt.reshape(-1), d_t])
        rho = (y0 - yi) / jnp.dot(delta_flat, state["lam"] * delta_flat - b_flat)
        small = jnp.max(jnp.abs(delta_flat)) < jnp.sqrt(eps)
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
                    jnp.abs(yi) < 8 * eps, int(Status.CONVERGED), int(Status.SMALL_DELTA)
                ),
                state["status"],
            ),
        ).astype(jnp.int32)

        gain = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        terminal_i = is_nan | term_small
        if config.rel_cost_tol > 0.0:  # mirrors BAConfig.rel_cost_tol
            # yi <= y0 guards the NaN-ρ accept fallthrough
            rel_term = (
                accept
                & (yi <= y0)
                & ((y0 - yi) <= config.rel_cost_tol * jnp.abs(y0))
            )
            terminal_i = terminal_i | rel_term
            status = jnp.where(rel_term, jnp.int32(int(Status.CONVERGED)), status)
        trial = dict(
            cams=jnp.where(accept, cams_i, state["cams"]),
            pts=jnp.where(accept, pts_i, state["pts"]),
            intr=jnp.where(accept, intr_i, state["intr"]),
            lam=jnp.where(
                accept,
                state["lam"] * gain,
                jnp.where(retry, state["nu"] * state["lam"], state["lam"]),
            ),
            nu=jnp.where(retry, 2.0 * state["nu"], state["nu"]),
            y=jnp.where(accept | is_nan | term_small, yi, state["y"]),
            rho=rho,
            status=status,
            stop=accept | is_nan | term_small,
            terminal=terminal_i,
        )
        frozen = state["stop"]
        state = jax.tree_util.tree_map(
            lambda old, new: jnp.where(frozen, old, new), state, trial
        )

    terminal = converged0 | state["terminal"]
    status = jnp.where(
        converged0, jnp.asarray(int(Status.CONVERGED), jnp.int32), state["status"]
    )
    record = dict(cost=y0, cost_new=state["y"], rho=state["rho"], lam=state["lam"])
    return state["cams"], state["pts"], state["intr"], state["lam"], terminal, status, record


def solve_ba_selfcal(problem, config=ba.BAConfig()):
    """Full self-calibrating BA (host-driven loop over ba_step_selfcal)."""
    dtype = problem.camera_params.dtype
    lam = jnp.asarray(-1.0, dtype)
    status = jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32)
    executed = 0
    records = []
    for it in range(config.max_iterations):
        cams, pts, intr, lam, terminal, status, record = ba_step_selfcal(
            problem, lam, config
        )
        problem = dataclasses.replace(
            problem, camera_params=cams, points=pts, intrinsics=intr
        )
        records.append(record)
        if bool(terminal):
            executed = it
            break
        executed = it + 1
    return (
        ba.BAResult(
            camera_params=problem.camera_params,
            points=problem.points,
            status=status,
            iterations=jnp.asarray(executed, jnp.int32),
            cost=ba.compute_cost(problem),
            trace={},
        ),
        problem.intrinsics,
    )
