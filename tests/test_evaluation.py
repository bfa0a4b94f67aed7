"""ATE/RPE harness + point-to-plane model + lm_step tests."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt, lm_step
from moptimizer_jax.core.residual import problem
from moptimizer_jax.evaluation import ate_rmse, rpe, umeyama_alignment
from moptimizer_jax.lie import se3, so3
from moptimizer_jax.models.point2plane import point2plane_block
from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block


def test_umeyama_recovers_transform():
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.normal(size=(200, 3)))
    R = so3.exp(jnp.array([0.3, -0.2, 0.5]))
    t = jnp.array([1.0, -2.0, 0.5])
    tgt = src @ R.T + t
    s_est, R_est, t_est = umeyama_alignment(src, tgt)
    np.testing.assert_allclose(R_est, R, atol=1e-10)
    np.testing.assert_allclose(t_est, t, atol=1e-10)
    np.testing.assert_allclose(s_est, 1.0, atol=1e-12)


def test_ate_zero_for_identical_and_aligned():
    rng = np.random.default_rng(1)
    traj = jnp.asarray(rng.normal(size=(50, 3)))
    assert float(ate_rmse(traj, traj, align=False)) < 1e-12
    # rigidly transformed trajectory aligns back to zero error
    R = so3.exp(jnp.array([0.1, 0.2, 0.3]))
    moved = traj @ R.T + jnp.array([5.0, 1.0, -2.0])
    assert float(ate_rmse(moved, traj, align=True)) < 1e-10
    assert float(ate_rmse(moved, traj, align=False)) > 1.0


def test_rpe_zero_for_consistent():
    rng = np.random.default_rng(2)
    poses = jnp.asarray(0.1 * rng.normal(size=(20, 6)))
    t_err, r_err = rpe(poses, poses)
    assert float(t_err) < 1e-12 and float(r_err) < 1e-12


def test_point2plane_converges():
    rng = np.random.default_rng(3)
    # planar-ish scene with varied normals
    src = rng.uniform(0, 10, size=(2000, 3))
    normals = rng.normal(size=(2000, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    x_true = jnp.array([0.2, -0.1, 0.3, 0.04, -0.03, 0.05])
    T = np.asarray(se3.transform_from_params6(x_true))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    blk = point2plane_block(src, tgt, normals)
    res = levenberg_marquardt(
        problem(blk), jnp.zeros(6), LMConfig(diff_mode="auto", max_iterations=30)
    )
    T_est = np.asarray(se3.transform_from_params6(res.x))
    np.testing.assert_allclose(T_est, T, atol=1e-6)


def test_point2plane_analytic_matches_ad_at_identity():
    from moptimizer_jax.core.linearize import linearize

    rng = np.random.default_rng(4)
    src = rng.uniform(0, 5, size=(100, 3))
    normals = rng.normal(size=(100, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    tgt = src + 0.01 * rng.normal(size=src.shape)
    blk = point2plane_block(src, tgt, normals, analytic=True)
    x0 = jnp.zeros(6)
    _, H_an, b_an = linearize(blk, x0, mode="analytic")
    _, H_ad, b_ad = linearize(blk, x0, mode="auto")
    np.testing.assert_allclose(H_an, H_ad, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(b_an, b_ad, rtol=1e-10, atol=1e-10)


def test_lm_step_reaches_same_optimum_as_minimize():
    """Manually driving lm_step (the reference's stubbed step(), implemented
    here for real) reproduces minimize's trajectory."""
    blk = rational_block(SIMPLE_X, SIMPLE_Y, dtype=jnp.float64)
    prob = problem(blk)
    cfg = LMConfig(diff_mode="fd")
    x = jnp.array([0.9, 0.2])
    lam = jnp.asarray(-1.0)
    for _ in range(15):
        prob, x, lam, terminal, status, record = lm_step(prob, x, lam, cfg)
        if bool(terminal):
            break
    res = levenberg_marquardt(problem(blk), jnp.array([0.9, 0.2]), cfg)
    np.testing.assert_allclose(x, res.x, atol=1e-10)
