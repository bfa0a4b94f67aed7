"""Standalone pure-numpy Levenberg-Marquardt oracle.

An INDEPENDENT implementation of the reference solver, written directly
from /root/reference/src/levenberg_marquadt_dyn.cpp:34-119 (schedule),
include/moptimizer/linearization.h:78-116 (forward-difference scheme +
H,b accumulation), optimizer.h:26-29 and delta.h:12-16 (convergence
predicates), and types.h:6-12 (status codes). It imports NOTHING from
moptimizer_jax except embedded public DATASETS (the Ceres curve data,
the simple-model table, the gravity constant) — every line of solver and
model arithmetic here is re-derived from the reference sources, so the
golden trace fixtures are cross-validated by a second implementation
instead of the JAX solver validating itself.

Trace layout mirrors tests/trace_problems.result_to_arrays so the parity
test compares dict-to-dict.
"""

import numpy as np

_EPS = np.finfo(np.float64).eps
_SQRT_EPS = np.sqrt(_EPS)

# status codes — reference types.h:6-12
CONVERGED = 0
MAXIMUM_ITERATIONS_REACHED = 1
SMALL_DELTA = 2
NUMERIC_ERROR = 3


# ---- minimal SO(3), re-derived from reference src/so3.cpp ----------------


def so3_exp(w):
    """Rodrigues: exp([w]ₓ) (reference so3.cpp Exp, generic branch +
    Taylor fallback for tiny angles)."""
    w = np.asarray(w, np.float64)
    th2 = float(w @ w)
    K = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )
    if th2 < 1e-24:
        return np.eye(3) + K + 0.5 * (K @ K)
    th = np.sqrt(th2)
    return np.eye(3) + (np.sin(th) / th) * K + ((1.0 - np.cos(th)) / th2) * (K @ K)


def so3_log(R):
    """Rotation vector of R (reference so3.cpp Log)."""
    R = np.asarray(R, np.float64)
    c = max(-1.0, min(1.0, (np.trace(R) - 1.0) / 2.0))
    th = np.arccos(c)
    if th < 1e-12:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return (th / (2.0 * np.sin(th))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def transform_from_params6(x):
    """t + Exp(ω) → 4×4 (reference so3.cpp:7-19 convention)."""
    T = np.eye(4)
    T[:3, 3] = x[:3]
    T[:3, :3] = so3_exp(x[3:6])
    return T


# ---- the solver ----------------------------------------------------------


def fd_jacobian(residual, x):
    """Reference forward-difference scheme (linearization.h:78-106):
    per-coordinate step h = √ε·|xⱼ| floored at √ε, r evaluated at x once."""
    r0 = np.asarray(residual(x), np.float64).reshape(-1)
    J = np.zeros((r0.size, x.size))
    for j in range(x.size):
        h = _SQRT_EPS * abs(x[j])
        if h == 0.0:
            h = _SQRT_EPS
        xp = x.copy()
        xp[j] += h
        J[:, j] = (np.asarray(residual(xp), np.float64).reshape(-1) - r0) / h
    return r0, J


def numpy_lm(residual, x0, max_iterations=15, inner_iterations=3):
    """Full reference LM loop in numpy; returns the trace-dict.

    Outer loop src:39-118, λ seed src:16,67-68, damped solve src:78-80,
    ρ src:93, reject path src:97-110, accept path src:112-114. λ persists
    across outer iterations; ν resets to 2 (src:70). executed_iterations
    is NOT incremented on the iteration that returns (the reference's
    for-loop returns mid-body). Trace slots mirror the JAX solver's
    (NaN-padded fixed-size arrays)."""
    n_it, n_in = max_iterations, inner_iterations
    x = np.asarray(x0, np.float64).copy()

    tr = dict(
        trace_cost=np.full(n_it, np.nan),
        trace_cost_new=np.full(n_it, np.nan),
        trace_rho=np.full(n_it, np.nan),
        trace_lam=np.full(n_it, np.nan),
        trace_nu=np.full(n_it, np.nan),
        trace_accepted=np.zeros(n_it, bool),
        trace_inner_cost_new=np.full((n_it, n_in), np.nan),
        trace_inner_rho=np.full((n_it, n_in), np.nan),
        trace_inner_lam=np.full((n_it, n_in), np.nan),
        trace_inner_nu=np.full((n_it, n_in), np.nan),
        trace_inner_accepted=np.zeros((n_it, n_in), bool),
    )

    lam = -1.0
    status = MAXIMUM_ITERATIONS_REACHED
    executed = 0

    for it in range(n_it):
        r0, J = fd_jacobian(residual, x)
        y0 = float(r0 @ r0)
        H = J.T @ J
        b = J.T @ r0
        diag_H = np.diag(H).copy()

        tr["trace_cost"][it] = y0

        if lam < 0.0:  # λ seed (src:16,67-68)
            lam = 1e-9 * float(np.max(np.abs(diag_H)))
        nu = 2.0

        if abs(y0) < 8 * _EPS:  # isCostSmall (optimizer.h:26-29)
            status = CONVERGED
            tr["trace_cost_new"][it] = y0
            tr["trace_lam"][it] = lam
            tr["trace_nu"][it] = nu
            break

        y = y0
        rho = np.nan
        accepted = False
        terminal = False
        for k in range(n_in):
            delta = np.linalg.solve(H + lam * np.diag(diag_H), -b)  # src:78-80
            xi = x + delta  # Euclidean (the reference's TODO Manifold, src:82)
            ri = np.asarray(residual(xi), np.float64).reshape(-1)
            yi = float(ri @ ri)

            tr["trace_inner_cost_new"][it, k] = yi
            tr["trace_inner_lam"][it, k] = lam
            tr["trace_inner_nu"][it, k] = nu

            if np.isnan(yi):  # src:88-91
                status = NUMERIC_ERROR
                y, terminal = yi, True
                tr["trace_inner_rho"][it, k] = np.nan
                rho = np.nan
                break

            rho = (y0 - yi) / float(delta @ (lam * delta - b))  # src:93
            tr["trace_inner_rho"][it, k] = rho

            if rho < 0.0:  # reject (NaN ρ falls through to accept, src:97)
                if np.max(np.abs(delta)) < _SQRT_EPS:  # delta.h:12-16
                    status = CONVERGED if abs(yi) < 8 * _EPS else SMALL_DELTA
                    y, terminal = yi, True
                    break
                lam = nu * lam  # src:107-108
                nu = 2.0 * nu
                continue

            # accept (src:112-114)
            tr["trace_inner_accepted"][it, k] = True
            x = xi
            y = yi
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            accepted = True
            break

        tr["trace_cost_new"][it] = y
        tr["trace_rho"][it] = rho
        tr["trace_lam"][it] = lam
        tr["trace_nu"][it] = nu
        tr["trace_accepted"][it] = accepted

        if terminal:
            break
        executed += 1

    r_final = np.asarray(residual(x), np.float64).reshape(-1)
    return dict(
        x=x,
        status=np.int32(status),
        iterations=np.int32(executed),
        cost=np.float64(r_final @ r_final),
        **tr,
    )


# ---- the nine fixture problems, model math re-derived from the reference -


def _curve_residual():
    # dataset only (the public Ceres exponential data both codebases embed)
    from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA

    data = np.asarray(CERES_CURVE_DATA, np.float64)

    def residual(x):  # tst/curve_fitting.cpp:86-93
        return data[:, 1] - np.exp(x[0] * data[:, 0] + x[1])

    return residual


def _powell_residual():
    def residual(x):  # tst/powell.cpp:21-29
        return np.array(
            [
                x[0] + 10.0 * x[1],
                np.sqrt(5.0) * (x[2] - x[3]),
                (x[1] - 2.0 * x[2]) ** 2,
                np.sqrt(10.0) * (x[0] - x[3]) ** 2,
            ]
        )

    return residual


def _rational_residual():
    # dataset only (tst/test_models.h:12-14 table)
    from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y

    xd = np.asarray(SIMPLE_X, np.float64)
    yd = np.asarray(SIMPLE_Y, np.float64)

    def residual(x):  # tst/test_models.h:13
        return yd - (x[0] * xd) / (x[1] + xd)

    return residual


def _camera_residual(points, pixels):
    # constants from tst/camera_calibration.cpp:24-31
    K = np.array(
        [
            [586.122314453125, 0.0, 638.8477694496105, 0.0],
            [0.0, 722.3973388671875, 323.031267074588, 0.0],
            [0.0, 0.0, 1.0, 0.0],
        ]
    )
    # AngleAxis(π/2, X) · AngleAxis(π/2, Z)
    rx = so3_exp(np.array([np.pi / 2, 0.0, 0.0]))
    rz = so3_exp(np.array([0.0, 0.0, np.pi / 2]))
    T_cl = np.eye(4)
    T_cl[:3, :3] = rx @ rz
    pts = np.asarray(points, np.float64)
    pix = np.asarray(pixels, np.float64)

    def residual(x):  # tst/camera_calibration.cpp:35-41
        T = transform_from_params6(x)
        out = np.empty(2 * pts.shape[0])
        for i in range(pts.shape[0]):
            p = K @ T @ T_cl @ pts[i]
            out[2 * i] = pix[i, 0] - p[0] / p[2]
            out[2 * i + 1] = pix[i, 1] - p[1] / p[2]
        return out

    return residual


def _accelerometer_residual(x_true):
    g = np.array([0.0, 0.0, 9.81])  # models/accelerometer.h:12
    m = so3_exp(x_true) @ g

    def residual(x):  # models/accelerometer.h:22-42
        return m - so3_exp(x) @ g

    return residual


def _state_model_residual(anchor_rotvec, anchor_lin):
    R0 = so3_exp(np.asarray(anchor_rotvec, np.float64))
    lin0 = np.asarray(anchor_lin, np.float64)

    def residual(x):  # tst/state_model.cpp:37-46 Minus
        R = so3_exp(x[:3])
        return np.concatenate([so3_log(R0.T @ R), x[3:] - lin0])

    return residual


def _point2point_residual():
    import pathlib

    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    src = np.loadtxt(data)[:, :3].astype(np.float64)  # tst/point2point.cpp:125-138
    T_true = transform_from_params6(
        np.array([10.5, 10.2, 0.1, 0.3, 0.4, 0.5])
    )
    tgt = src @ T_true[:3, :3].T + T_true[:3, 3]

    def residual(x):  # tst/point2point.cpp:32-51
        T = transform_from_params6(x)
        warped = src @ T[:3, :3].T + T[:3, 3]
        return (warped - tgt).reshape(-1)

    return residual


def oracle_problems():
    """name -> (residual_fn, x0, lm kwargs) — mirrors trace_problems.PROBLEMS."""
    cam_points = np.array(
        [
            [2.055643, 0.065643, 0.684357, 1.0],
            [1.963083, -0.765833, 0.653833, 1.0],
            [2.927500, 0.707000, 0.125250, 1.0],
            [2.957833, 0.384667, 0.123667, 1.0],
            [2.756000, 0.712000, -0.298000, 1.0],
        ]
    )
    cam_pixels = np.array(
        [[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]], np.float64
    )
    return {
        "curve_near": (_curve_residual(), np.zeros(2), {}),
        "curve_far": (_curve_residual(), np.array([1.2, 2.0]), dict(max_iterations=50)),
        "powell": (
            _powell_residual(),
            np.array([3.0, -1.0, 0.0, 4.0]),
            dict(max_iterations=25),
        ),
        "simple_rational": (_rational_residual(), np.array([0.9, 0.2]), {}),
        "camera_calibration": (
            _camera_residual(cam_points, cam_pixels),
            np.zeros(6),
            {},
        ),
        "camera_calibration_bad": (
            _camera_residual(cam_points, cam_pixels),
            np.array([0.5, 0.5, 0.5, 0.2, 0.5, 0.5]),
            dict(max_iterations=50),
        ),
        "accelerometer": (
            _accelerometer_residual(np.array([0.15, -0.1, 0.2])),
            np.array([0.1, 0.0, 0.0]),
            {},
        ),
        "state_model": (
            _state_model_residual(
                np.array([0.1, 0.2, 0.3]),
                np.concatenate([[-0.4, 0.11, -0.9], np.zeros(9)]),
            ),
            np.concatenate([[0.9, -0.8, 0.6, 1.5, -2.0, 0.5], np.zeros(9)]),
            dict(max_iterations=10),
        ),
        "point2point": (_point2point_residual(), np.zeros(6), {}),
    }
