"""Scan odometry + mini-SLAM pipeline: trajectory recovery and drift
reduction via loop closure (ATE-checked, the BASELINE.md accuracy metric)."""

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax.evaluation import ate_rmse
from moptimizer_jax.lie import se3, so3
from moptimizer_jax.odometry import scan_odometry, scan_slam
from moptimizer_jax.core.solver import LMConfig


def _structured_scene(rng, n=3000):
    """Two perpendicular noisy planes — enough structure for ICP."""
    xy = rng.uniform(0, 10, size=(n // 2, 2))
    p1 = np.column_stack([xy, 0.02 * rng.normal(size=n // 2)])
    p2 = np.column_stack(
        [xy[:, 0], 0.02 * rng.normal(size=n // 2) + 5, xy[:, 1]]
    )
    return np.vstack([p1, p2])


@pytest.fixture(scope="module")
def trajectory_scans():
    """A scene observed from K poses along a short trajectory; scan k is the
    scene in the sensor frame of pose k (p_sensor = P_k⁻¹ · p_world)."""
    rng = np.random.default_rng(0)
    scene = _structured_scene(rng)
    K = 5
    poses = []
    cur = np.zeros(6)
    step = np.array([0.4, 0.1, 0.02, 0.01, 0.03, 0.05])
    for _ in range(K):
        poses.append(cur.copy())
        T = np.asarray(se3.transform_from_params6(jnp.asarray(cur)))
        Tn = T @ np.asarray(se3.transform_from_params6(jnp.asarray(step)))
        cur = np.concatenate([Tn[:3, 3], np.asarray(so3.log(jnp.asarray(Tn[:3, :3])))])
    scans = []
    for p in poses:
        T = np.asarray(se3.transform_from_params6(jnp.asarray(p)))
        Tinv = np.linalg.inv(T)
        scans.append(jnp.asarray(scene @ Tinv[:3, :3].T + Tinv[:3, 3]))
    return scans, jnp.asarray(np.stack(poses))


def test_scan_odometry_recovers_trajectory(trajectory_scans):
    scans, gt_poses = trajectory_scans
    cfg = LMConfig(diff_mode="auto", max_iterations=40)
    poses, rels = scan_odometry(scans, method="icp", config=cfg, nn_backend="xla")
    assert poses.shape == gt_poses.shape
    ate = float(ate_rmse(poses, gt_poses, align=False))
    assert ate < 1e-3
    # relative measurements consistent with ground truth steps
    for k in range(len(scans) - 1):
        T_est = np.asarray(se3.transform_from_params6(rels[k]))
        Ti = np.asarray(se3.transform_from_params6(gt_poses[k]))
        Tj = np.asarray(se3.transform_from_params6(gt_poses[k + 1]))
        np.testing.assert_allclose(T_est, np.linalg.inv(Ti) @ Tj, atol=1e-4)


def test_scan_slam_loop_closure(trajectory_scans):
    scans, gt_poses = trajectory_scans
    cfg = LMConfig(diff_mode="auto", max_iterations=40)
    result, poses_odo = scan_slam(
        scans,
        method="icp",
        loop_closures=[(0, len(scans) - 1)],
        config=cfg,
        nn_backend="xla",
    )
    ate_slam = float(ate_rmse(result.poses, gt_poses, align=False))
    assert ate_slam < 1e-3
    assert np.isfinite(float(result.cost))
