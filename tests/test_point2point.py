"""Point-to-point registration parity on the 29,310-point LiDAR scan
(reference tst/point2point.cpp:88-216)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import linearize
from moptimizer_jax.core.residual import problem
from moptimizer_jax.lie import se3, so3
from moptimizer_jax.models.point2point import point2point_block
from moptimizer_jax.utils.pointcloud import load_txt_cloud

DATA = pathlib.Path(__file__).parent / "data" / "fachada.txt"


def _euler_zyx(rx, ry, rz):
    """AngleAxis(rx,X)·AngleAxis(ry,Y)·AngleAxis(rz,Z) as in the fixture
    (reference tst/point2point.cpp:93-97)."""

    def ax(angle, axis):
        w = np.zeros(3)
        w[axis] = angle
        return np.asarray(so3.exp(jnp.asarray(w)))

    return ax(rx, 0) @ ax(ry, 1) @ ax(rz, 2)


@pytest.fixture(scope="module")
def clouds():
    src = load_txt_cloud(DATA)
    assert src.shape == (29310, 3)
    T = np.eye(4)
    T[:3, :3] = _euler_zyx(0.3, 0.4, 0.5)
    T[:3, 3] = [10.5, 10.2, 0.1]
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return jnp.asarray(src), jnp.asarray(tgt), T


def test_consistency_over_diff_modes(clouds):
    """All linearization paths agree on cost and Hessian to 1e-7
    (reference ConsistencyOverCostsClasses, tst/point2point.cpp:142-189)."""
    src, tgt, _ = clouds
    x0 = jnp.zeros(6)
    blk_an = point2point_block(src, tgt, analytic=True)
    blk = point2point_block(src, tgt)

    c_an, H_an, b_an = linearize(blk_an, x0, mode="analytic")
    c_ad, H_ad, b_ad = linearize(blk, x0, mode="auto")
    c_fd, H_fd, b_fd = linearize(blk, x0, mode="fd")

    np.testing.assert_allclose(c_an, c_ad, rtol=1e-12)
    np.testing.assert_allclose(c_an, c_fd, rtol=1e-7)
    np.testing.assert_allclose(H_an, H_ad, rtol=1e-10)
    # FD vs analytic: reference tolerance regime (absolute 1e-7 · scale)
    np.testing.assert_allclose(H_fd, H_an, rtol=1e-5)


def test_icp_known_correspondences(clouds):
    """LM recovers the ground-truth transform with identity correspondences
    (reference Optimization test, tst/point2point.cpp:192-216)."""
    src, tgt, T_true = clouds
    blk = point2point_block(src, tgt)
    res = levenberg_marquardt(
        problem(blk), jnp.zeros(6), LMConfig(diff_mode="auto", max_iterations=50)
    )
    T_est = np.asarray(se3.transform_from_params6(res.x))
    # residual transform should be ~identity
    err = np.linalg.inv(T_est) @ T_true
    np.testing.assert_allclose(err[:3, :3], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(err[:3, 3], 0.0, atol=1e-4)
    assert float(res.cost) < 1e-8


def test_icp_analytic_gauss_newton_style(clouds):
    """Analytic-Jacobian path also converges (J = [I | −[src]ₓ] is the
    linearization at identity; with LM damping it still reaches the optimum)."""
    src, tgt, T_true = clouds
    blk = point2point_block(src, tgt, analytic=True)
    res = levenberg_marquardt(
        problem(blk), jnp.zeros(6), LMConfig(diff_mode="analytic", max_iterations=100)
    )
    T_est = np.asarray(se3.transform_from_params6(res.x))
    err = np.linalg.inv(T_est) @ T_true
    np.testing.assert_allclose(err[:3, :3], np.eye(3), atol=1e-3)
    np.testing.assert_allclose(err[:3, 3], 0.0, atol=1e-2)
