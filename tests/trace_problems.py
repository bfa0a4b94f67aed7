"""Registry of reference oracle problems for LM trajectory-trace parity.

Each entry builds (problem, x0, LMConfig kwargs, modes) for one of the
reference's convergence oracles (BASELINE.md anchors). The trace-parity
harness (tests/test_trace_parity.py) runs each in float64 with the
reference's forward-difference scheme (`diff_mode="fd"`, emulating
linearization.h:78-106) and pins the full per-iteration LM trace — the same
record the reference logger prints per inner trial
(src/levenberg_marquadt_dyn.cpp:72-75,94-95).

Shared between the fixture generator (tests/make_trace_fixtures.py) and the
regression test so both always see identical problems.
"""

import pathlib

import jax.numpy as jnp
import numpy as np


def _curve_near():
    from moptimizer_jax.models.curve_fitting import exponential_curve_block

    return exponential_curve_block(), jnp.zeros(2, jnp.float64), {}


def _curve_far():
    from moptimizer_jax.models.curve_fitting import exponential_curve_block

    return (
        exponential_curve_block(),
        jnp.array([1.2, 2.0], jnp.float64),
        dict(max_iterations=50),
    )


def _powell():
    from moptimizer_jax.models.powell import powell_block

    return (
        powell_block(analytic=True),
        jnp.array([3.0, -1.0, 0.0, 4.0], jnp.float64),
        dict(max_iterations=25),
    )


def _simple_rational():
    from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block

    return (
        rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=jnp.float64),
        jnp.array([0.9, 0.2], jnp.float64),
        {},
    )


def _camera_calibration():
    from moptimizer_jax.models.camera import camera_reprojection_block

    points = np.array(
        [
            [2.055643, 0.065643, 0.684357, 1.0],
            [1.963083, -0.765833, 0.653833, 1.0],
            [2.927500, 0.707000, 0.125250, 1.0],
            [2.957833, 0.384667, 0.123667, 1.0],
            [2.756000, 0.712000, -0.298000, 1.0],
        ]
    )
    pixels = np.array(
        [[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]],
        dtype=np.float64,
    )
    return camera_reprojection_block(points, pixels), jnp.zeros(6, jnp.float64), {}


def _camera_calibration_bad():
    """The reference's BadWeather start (tst/camera_calibration.cpp:111-114):
    x0 = (0.5, 0.5, 0.5, 0.2, 0.5, 0.5), 50 iterations."""
    block, _, _ = _camera_calibration()
    return (
        block,
        jnp.array([0.5, 0.5, 0.5, 0.2, 0.5, 0.5], jnp.float64),
        dict(max_iterations=50),
    )


def _accelerometer():
    """Gravity alignment r = m − R·g (reference models/accelerometer.h);
    measurement synthesized from a known attitude.

    x0 is the reference differentiation test's (0.1, 0, 0)
    (tst/differentiation.cpp:172-174) rather than 0: at x = 0 the Gauss-
    Newton H = [g]ₓᵀ[g]ₓ has an EXACT zero diagonal entry (rotation about
    gravity is unobservable), so the reference's multiplicative λ·diag(H)
    damping leaves the system exactly singular — from a generic start the
    diagonal is positive and LM converges along the observable directions."""
    from moptimizer_jax.lie import so3
    from moptimizer_jax.models.accelerometer import GRAVITY, accelerometer_block

    x_true = jnp.array([0.15, -0.1, 0.2], jnp.float64)
    m = so3.exp(x_true) @ jnp.asarray(GRAVITY, jnp.float64)
    return (
        accelerometer_block(np.asarray(m), analytic=True),
        jnp.array([0.1, 0.0, 0.0], jnp.float64),
        {},
    )


def _state_model():
    """15-DoF SO(3)×R¹² boxminus state (reference tst/state_model.cpp:83-112,
    anchor rotation Exp(0.1,0.2,0.3), start at its x-vector values)."""
    from moptimizer_jax.models.state import product_state_block

    anchor_lin = np.concatenate([[-0.4, 0.11, -0.9], np.zeros(9)])
    block = product_state_block(np.array([0.1, 0.2, 0.3]), anchor_lin)
    # large initial rotation offset: the log∘exp composition is genuinely
    # nonlinear there, so the trace records several GN contractions instead
    # of one (the linear R¹² part would converge in a single step)
    x0 = np.concatenate([[0.9, -0.8, 0.6, 1.5, -2.0, 0.5], np.zeros(9)])
    return block, jnp.asarray(x0, jnp.float64), dict(max_iterations=10)


def _point2point():
    from moptimizer_jax.lie import se3
    from moptimizer_jax.models.point2point import point2point_block
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    src = jnp.asarray(load_txt_cloud(data).astype(np.float64))
    x_true = jnp.array([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], jnp.float64)
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return point2point_block(src, tgt), jnp.zeros(6, jnp.float64), {}


# name -> (builder, modes available for cross-mode checks)
PROBLEMS = {
    "curve_near": (_curve_near, ("fd", "auto")),
    "curve_far": (_curve_far, ("fd", "auto")),
    "powell": (_powell, ("fd", "auto", "analytic")),
    "simple_rational": (_simple_rational, ("fd", "auto", "analytic")),
    "camera_calibration": (_camera_calibration, ("fd", "auto")),
    "camera_calibration_bad": (_camera_calibration_bad, ("fd", "auto")),
    "accelerometer": (_accelerometer, ("fd", "auto", "analytic")),
    "state_model": (_state_model, ("fd", "auto")),
    "point2point": (_point2point, ("fd", "auto")),
}

FIXTURE_DIR = pathlib.Path(__file__).parent / "data" / "traces"


def run_trace(name, mode="fd"):
    """Solve oracle `name` in f64 with `mode`; returns the LMResult."""
    from moptimizer_jax import LMConfig, levenberg_marquardt
    from moptimizer_jax.core.residual import problem

    builder, _ = PROBLEMS[name]
    block, x0, cfg_kwargs = builder()
    cfg = LMConfig(diff_mode=mode, **cfg_kwargs)
    return levenberg_marquardt(problem(block), x0, cfg)


def result_to_arrays(res):
    """Flatten an LMResult (incl. nested inner trace) into a dict of np arrays."""
    out = dict(
        x=np.asarray(res.x),
        status=np.asarray(res.status),
        iterations=np.asarray(res.iterations),
        cost=np.asarray(res.cost),
    )
    for k, v in res.trace.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"trace_inner_{kk}"] = np.asarray(vv)
        else:
            out[f"trace_{k}"] = np.asarray(v)
    return out
