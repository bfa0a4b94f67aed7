"""f32 accuracy envelope: which reference oracle tolerances survive single
precision.

The production default on the GPU is f32 (with
jax_default_matmul_precision=highest library-wide, so matmuls are genuine
f32, not TF32); every parity test elsewhere runs f64. This module re-runs
the reference convergence oracles in f32 on the CPU backend (the CI proxy;
chip_smoke.py's battery re-checks the curve fit and the mixed-precision
Powell oracle on the card) and pins, per oracle, the tightest tolerance
that holds with ≥4× margin:

| Oracle (reference source, f64 tolerance)                    | f32 envelope |
|---|---|
| curve fit → (0.291861, 0.131439) (curve_fitting.cpp ±5e-5)  | ±5e-5 HOLDS  |
| Powell → 0 (powell.cpp ±5e-5)                               | ±1e-2 (grad² conditioning: J ~ x² near 0 puts the f32 gradient floor at √ε₃₂ scale) |
| camera calibration vs Ceres soln (camera_calib. ±5e-5)      | ±2e-3 CPU-f32 proxy (the GPU's envelope is not measured yet) |
| simple rational → (0.362, 0.556) (simple_model.cpp ±0.01)   | ±0.01 HOLDS  |
| point2point ICP x → ground truth (point2point.cpp, smoke)   | ±2e-3       |
| accelerometer attitude residual → 0                          | cost ~4e-8, needs λ₀ ≥ 1e-6 (rank-deficient H at the reference's 1e-9 seed is f32-singular) |

The fd diff mode is EXCLUDED in f32: h = √ε₃₂·|x| ≈ 3e-4·|x| truncation
error swamps every oracle (documented, not a bug) — production f32 uses AD.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.residual import problem


def _solve(block, x0, **cfg_kwargs):
    cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", **cfg_kwargs)
    res = levenberg_marquardt(problem(block), jnp.asarray(x0, jnp.float32), cfg)
    assert res.x.dtype == jnp.float32  # the solve really ran in f32
    return res


def test_curve_fitting_f32_holds_reference_tolerance():
    """±5e-5 (the reference's own f64 tolerance) HOLDS in f32."""
    from moptimizer_jax.models.curve_fitting import exponential_curve_block

    res = _solve(exponential_curve_block(dtype=jnp.float32), np.zeros(2))
    np.testing.assert_allclose(
        np.asarray(res.x), [0.291861, 0.131439], atol=5e-5
    )


def test_curve_fitting_f32_bad_start():
    """From (1.2, 2.0) with 50 iterations (curve_fitting.cpp:123-147)."""
    from moptimizer_jax.models.curve_fitting import exponential_curve_block

    res = _solve(
        exponential_curve_block(dtype=jnp.float32),
        np.array([1.2, 2.0]),
        max_iterations=50,
    )
    np.testing.assert_allclose(
        np.asarray(res.x), [0.291861, 0.131439], atol=1e-4
    )


def test_powell_f32():
    """Reference: → 0 ±5e-5 in f64. In f32 the quartic valley floor is set
    by the gradient's f32 rounding (J entries ~x² ~1e-6 near the solution),
    leaving parameters at the 1e-3 scale: envelope ±1e-2."""
    from moptimizer_jax.models.powell import powell_block

    res = _solve(
        powell_block(analytic=True),
        np.array([3.0, -1.0, 0.0, 4.0]),
        max_iterations=25,
    )
    np.testing.assert_allclose(np.asarray(res.x), np.zeros(4), atol=1e-2)


def test_simple_rational_f32_holds_reference_tolerance():
    """±0.01 (simple_model.cpp) HOLDS in f32, both reference starts
    ((0.9, 0.2) and (1.9, 1.5) — simple_model.cpp:29,38)."""
    from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block

    blk = rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=jnp.float32)
    for x0 in ([0.9, 0.2], [1.9, 1.5]):
        res = _solve(blk, np.array(x0))
        np.testing.assert_allclose(
            np.asarray(res.x), [0.362, 0.556], atol=0.01
        )


def test_camera_calibration_f32():
    """Reference pins ±5e-5 vs Ceres in f64; in f32 the pixel-scale
    residuals (~1e2) leave ~κ·ε₃₂ relative noise in the normal equations:
    envelope ±2e-3 (20× the f64 tolerance, still sub-milliradian)."""
    from moptimizer_jax.models.camera import camera_reprojection_block

    points = np.array(
        [
            [2.055643, 0.065643, 0.684357, 1.0],
            [1.963083, -0.765833, 0.653833, 1.0],
            [2.927500, 0.707000, 0.125250, 1.0],
            [2.957833, 0.384667, 0.123667, 1.0],
            [2.756000, 0.712000, -0.298000, 1.0],
        ],
        dtype=np.float32,
    )
    pixels = np.array(
        [[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]],
        dtype=np.float32,
    )
    ceres_solution = np.array(
        [-0.010075, 0.020714, -0.058274, 0.018369, -0.001367, 0.027415]
    )
    res = _solve(camera_reprojection_block(points, pixels), np.zeros(6))
    np.testing.assert_allclose(np.asarray(res.x), ceres_solution, atol=2e-3)


def test_point2point_f32():
    """ICP on the 29,310-pt scan (known correspondences): f32 recovers the
    reference transform to ±2e-3 (the production-default configuration —
    what bench.py measures)."""
    import pathlib

    from moptimizer_jax.lie import se3
    from moptimizer_jax.models.point2point import point2point_block
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    src = jnp.asarray(load_txt_cloud(data).astype(np.float32))
    x_true = np.array([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], np.float32)
    T = se3.transform_from_params6(jnp.asarray(x_true))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    res = _solve(point2point_block(src, tgt), np.zeros(6), max_iterations=15)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=2e-3)


def test_accelerometer_f32():
    """Attitude residual: f32 needs a stronger λ seed on rank-deficient H.

    H = Jᵀ J has a near-null direction (rotation about the measured
    gravity), so the reference's λ₀ = 1e-9·max diag seed (src:16) puts the
    damped system's condition number at ~1/ε₃₂ — the f32 Cholesky produces
    garbage steps and the solve stalls (measured: cost stuck at 0.19).
    With init_lambda_factor ≥ 1e-6 it converges in 3 iterations to the f32
    floor (~4e-8). THIS is the envelope finding: rank-deficient problems
    in f32 need λ₀ ≥ 1e-6 (or f64)."""
    from moptimizer_jax.lie import so3
    from moptimizer_jax.models.accelerometer import GRAVITY, accelerometer_block

    m = so3.exp(jnp.asarray([0.15, -0.1, 0.2], jnp.float32)) @ jnp.asarray(
        GRAVITY, jnp.float32
    )
    res = _solve(
        accelerometer_block(np.asarray(m)),
        np.array([0.1, 0.0, 0.0]),
        init_lambda_factor=1e-6,
    )
    assert float(res.cost) < 1e-6  # measured floor 4e-8, 25x margin


# ---- mixed precision: f32 models, f64 accumulation (r4) -------------------


def _solve_mixed(block, x0, **cfg_kwargs):
    cfg = LMConfig(
        diff_mode="auto",
        linear_solver="cholesky",
        accum_dtype=jnp.float64,
        **cfg_kwargs,
    )
    res = levenberg_marquardt(problem(block), jnp.asarray(x0, jnp.float32), cfg)
    assert res.x.dtype == jnp.float32  # iterate stays f32
    assert res.cost.dtype == jnp.float64  # reductions ran wide
    return res


def test_powell_mixed_recovers_reference_tolerance():
    """accum_dtype=f64 recovers the reference's ±5e-5 Powell tolerance from
    f32 residual/Jacobian evaluation (plain f32: only ±1e-2 above) — the
    quartic valley's loss was in the f32 gradient REDUCTION and the
    ill-conditioned f32 solve, not the model evaluation."""
    from moptimizer_jax.models.powell import powell_block

    res = _solve_mixed(
        powell_block(analytic=True),
        np.array([3.0, -1.0, 0.0, 4.0]),
        max_iterations=25,
    )
    np.testing.assert_allclose(np.asarray(res.x), np.zeros(4), atol=5e-5)


def test_camera_calibration_mixed_recovers_reference_tolerance():
    """accum_dtype=f64 meets the reference's ±5e-5 vs-Ceres tolerance from
    f32 models (plain f32: ±2e-3 above)."""
    from moptimizer_jax.models.camera import camera_reprojection_block

    points = np.array(
        [
            [2.055643, 0.065643, 0.684357, 1.0],
            [1.963083, -0.765833, 0.653833, 1.0],
            [2.927500, 0.707000, 0.125250, 1.0],
            [2.957833, 0.384667, 0.123667, 1.0],
            [2.756000, 0.712000, -0.298000, 1.0],
        ],
        dtype=np.float32,
    )
    pixels = np.array(
        [[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]],
        dtype=np.float32,
    )
    ceres_solution = np.array(
        [-0.010075, 0.020714, -0.058274, 0.018369, -0.001367, 0.027415]
    )
    res = _solve_mixed(camera_reprojection_block(points, pixels), np.zeros(6))
    np.testing.assert_allclose(np.asarray(res.x), ceres_solution, atol=5e-5)


def test_accelerometer_mixed_reference_lambda_seed():
    """With f64 accumulation the reference's λ₀ factor 1e-9 works again
    (plain f32 needed λ₀ ≥ 1e-6: the rank-deficient H was f32-singular)."""
    from moptimizer_jax.lie import so3
    from moptimizer_jax.models.accelerometer import GRAVITY, accelerometer_block

    x_true = jnp.array([0.15, -0.1, 0.2], jnp.float32)
    m = so3.exp(x_true) @ jnp.asarray(GRAVITY, jnp.float32)
    res = _solve_mixed(
        accelerometer_block(np.asarray(m), analytic=True),
        np.array([0.1, 0.0, 0.0]),
    )
    assert float(res.cost) < 1e-9


def test_mixed_requires_x64_guard():
    """A clear error when accum_dtype=f64 is requested without x64."""
    import jax

    assert jax.config.jax_enable_x64  # the suite runs with x64 on
    # the guard logic itself (simulated): building the config succeeds here
    LMConfig(accum_dtype=jnp.float64)
