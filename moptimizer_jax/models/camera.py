"""Pinhole reprojection residual for camera extrinsic calibration.

Reference tst/camera_calibration.cpp:12-60: state x ∈ R⁶ → T (params6),
π = K·T·T_cl·p (homogeneous), r = pixel − (π₀/π₂, π₁/π₂). The fixture's
hard-coded intrinsics K (:29-30) and camera↔laser frame rotation (:22-26)
are reproduced as defaults so the pinned Ceres solution (:97-98) is a direct
oracle.
"""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax.core.residual import make_block
from moptimizer_jax.lie import se3


# Reference fixture intrinsics (tst/camera_calibration.cpp:29-30).
DEFAULT_K = np.array(
    [
        [586.122314453125, 0.0, 638.8477694496105, 0.0],
        [0.0, 722.3973388671875, 323.031267074588, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ]
)


def default_camera_laser_frame():
    """Rx(π/2)·Rz(π/2) block-diagonal 4×4 (tst/camera_calibration.cpp:22-26)."""
    c, s = 0.0, 1.0  # cos(π/2), sin(π/2)
    rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)
    T = np.eye(4)
    T[:3, :3] = rx @ rz
    return T


def _prepare(x):
    return se3.transform_from_params6(x)


def _make_residual(K, T_cl):
    def residual(T, data_i):
        p = data_i["point"]  # homogeneous (4,)
        pix = data_i["pixel"]  # (2,)
        proj = K @ (T @ (T_cl @ p))
        return pix - proj[:2] / proj[2]

    return residual


def camera_reprojection_block(points_h, pixels, *, K=None, camera_laser_frame=None, loss=None, weight_matrix=None):
    """points_h: (N, 4) homogeneous points; pixels: (N, 2)."""
    points_h = jnp.asarray(points_h)
    dtype = points_h.dtype
    K = jnp.asarray(DEFAULT_K if K is None else K, dtype=dtype)
    T_cl = jnp.asarray(
        default_camera_laser_frame() if camera_laser_frame is None else camera_laser_frame,
        dtype=dtype,
    )
    data = dict(point=points_h, pixel=jnp.asarray(pixels, dtype=dtype))
    return make_block(
        _make_residual(K, T_cl),
        data=data,
        prepare_fn=_prepare,
        loss=loss,
        weight_matrix=weight_matrix,
        name="camera_reprojection",
    )
