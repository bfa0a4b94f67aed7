"""Camera-calibration reprojection parity against the pinned Ceres solution
(reference tst/camera_calibration.cpp:92-122)."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.residual import problem
from moptimizer_jax.models.camera import camera_reprojection_block

# Reference fixture data (tst/camera_calibration.cpp:66-76).
POINTS = np.array(
    [
        [2.055643, 0.065643, 0.684357, 1.0],
        [1.963083, -0.765833, 0.653833, 1.0],
        [2.927500, 0.707000, 0.125250, 1.0],
        [2.957833, 0.384667, 0.123667, 1.0],
        [2.756000, 0.712000, -0.298000, 1.0],
    ]
)
PIXELS = np.array([[621, 67], [878, 76], [491, 279], [559, 282], [481, 388]], dtype=np.float64)

# Pinned oracle (tst/camera_calibration.cpp:97-98).
CERES_SOLUTION = np.array([-0.0101064, 0.0206767, -0.0582803, 0.0183564, -0.00130745, 0.027414])
TOLERANCE = 5e-5


def test_good_weather():
    blk = camera_reprojection_block(POINTS, PIXELS)
    res = levenberg_marquardt(
        problem(blk), jnp.zeros(6), LMConfig(diff_mode="fd")
    )
    np.testing.assert_allclose(res.x, CERES_SOLUTION, atol=TOLERANCE)


def test_bad_weather():
    """Far initial guess, 50 iterations (reference :113-122)."""
    blk = camera_reprojection_block(POINTS, PIXELS)
    res = levenberg_marquardt(
        problem(blk),
        jnp.array([0.5, 0.5, 0.5, 0.2, 0.5, 0.5]),
        LMConfig(diff_mode="fd", max_iterations=50),
    )
    np.testing.assert_allclose(res.x, CERES_SOLUTION, atol=TOLERANCE)


def test_auto_diff():
    blk = camera_reprojection_block(POINTS, PIXELS)
    res = levenberg_marquardt(problem(blk), jnp.zeros(6), LMConfig(diff_mode="auto"))
    np.testing.assert_allclose(res.x, CERES_SOLUTION, atol=TOLERANCE)
