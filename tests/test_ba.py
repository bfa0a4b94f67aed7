"""Bundle adjustment: Schur-CG vs dense oracle, convergence, sharding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import ba
from moptimizer_jax.core.solver import Status


def make_synthetic_ba(C=4, L=30, noise=0.0, seed=0, n_fixed=2, dtype=jnp.float64):
    """Cameras on an arc looking at a box of points; every camera sees every
    point. Returns (perturbed problem, ground-truth problem)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(L, 3)) + np.array([0.0, 0.0, 8.0])
    cams = []
    for i in range(C):
        # small rotations, cameras spread on x with z toward the scene
        w = 0.05 * rng.normal(size=3)
        t = np.array([1.5 * i - 0.75 * (C - 1), 0.3 * rng.normal(), 0.0])
        cams.append(np.concatenate([t, w]))
    cams = np.stack(cams)
    intr = np.array([500.0, 500.0, 320.0, 240.0])

    cam_idx = np.repeat(np.arange(C), L)
    pt_idx = np.tile(np.arange(L), C)

    gt = ba.BAProblem(
        camera_params=jnp.asarray(cams, dtype),
        points=jnp.asarray(pts, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        pixels=jnp.zeros((C * L, 2), dtype),
        intrinsics=jnp.asarray(intr, dtype),
        n_fixed_cameras=n_fixed,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(
        gt.camera_params[gt.cam_idx], gt.points[gt.pt_idx], gt.intrinsics
    )
    if noise:
        pixels = pixels + noise * rng.normal(size=pixels.shape)
    gt = dataclasses.replace(gt, pixels=jnp.asarray(pixels, dtype))

    # perturb non-fixed cameras and all points
    cams_p = cams.copy()
    cams_p[n_fixed:] += 0.02 * rng.normal(size=cams_p[n_fixed:].shape)
    pts_p = pts + 0.05 * rng.normal(size=pts.shape)
    start = dataclasses.replace(
        gt,
        camera_params=jnp.asarray(cams_p, dtype),
        points=jnp.asarray(pts_p, dtype),
    )
    return start, gt


def test_schur_solve_matches_dense_oracle():
    """One damped Schur-CG step ≡ the dense (6C+3L) damped solve."""
    prob, _ = make_synthetic_ba(C=3, L=12, n_fixed=1)
    r, A, B = ba._linearize(prob)
    U, V, W, g, h = ba._gn_blocks(prob, r, A, B)
    lam = 1e-4
    cfg = ba.BAConfig(cg_iterations=200, cg_tol=1e-14)
    d_cam, d_pt = ba._solve_delta(prob, U, V, W, g, h, lam, cfg)

    # dense assembly
    C, L, O = 3, 12, len(prob.cam_idx)
    n = 6 * C + 3 * L
    J = np.zeros((2 * O, n))
    rr = np.asarray(r).reshape(-1)
    for o in range(O):
        c, l = int(prob.cam_idx[o]), int(prob.pt_idx[o])
        J[2 * o : 2 * o + 2, 6 * c : 6 * c + 6] = np.asarray(A[o])
        J[2 * o : 2 * o + 2, 6 * C + 3 * l : 6 * C + 3 * l + 3] = np.asarray(B[o])
    H = J.T @ J
    b = J.T @ rr
    Hd = H + lam * np.diag(np.diag(H))
    # gauge: remove fixed-camera rows/cols
    free = np.ones(n, bool)
    free[:6] = False
    delta = np.zeros(n)
    delta[free] = np.linalg.solve(Hd[np.ix_(free, free)], -b[free])

    np.testing.assert_allclose(
        np.asarray(d_cam).reshape(-1), delta[: 6 * C], rtol=1e-6, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(d_pt).reshape(-1), delta[6 * C :], rtol=1e-6, atol=1e-10
    )


def test_ba_converges_to_ground_truth():
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=3)
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=30))
    assert float(res.cost) < 1e-12
    np.testing.assert_allclose(res.camera_params, gt.camera_params, atol=1e-5)
    np.testing.assert_allclose(res.points, gt.points, atol=1e-5)


def test_ba_noisy_reaches_low_cost():
    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=4, noise=0.5)
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=30))
    # with 0.5px noise on 200 obs: residual cost ~ O(noise² · 2O)
    assert float(res.cost) < 2 * 0.5**2 * 2 * len(start.cam_idx)
    assert int(res.status) in (
        int(Status.SMALL_DELTA),
        int(Status.MAXIMUM_ITERATIONS_REACHED),
        int(Status.CONVERGED),
    )


def test_ba_fixed_cameras_stay_fixed():
    start, gt = make_synthetic_ba(C=4, L=25, n_fixed=2, seed=5)
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=20))
    np.testing.assert_array_equal(res.camera_params[:2], start.camera_params[:2])


def test_ba_sharded_observations_match():
    """Observation axis sharded over 8 devices (GSPMD) ≡ single device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from moptimizer_jax.parallel import make_mesh

    start, _ = make_synthetic_ba(C=4, L=32, n_fixed=2, seed=6)  # O = 128
    res_single = ba.solve_ba(start, ba.BAConfig(max_iterations=10))

    mesh = make_mesh(8)
    shard = NamedSharding(mesh, P("data"))
    start_sharded = dataclasses.replace(
        start,
        cam_idx=jax.device_put(start.cam_idx, shard),
        pt_idx=jax.device_put(start.pt_idx, shard),
        pixels=jax.device_put(start.pixels, shard),
    )
    res_shard = ba.solve_ba(start_sharded, ba.BAConfig(max_iterations=10))
    np.testing.assert_allclose(
        res_shard.camera_params, res_single.camera_params, atol=1e-8
    )
    np.testing.assert_allclose(res_shard.points, res_single.points, atol=1e-8)


def test_ba_robust_loss_downweights_outliers():
    """A handful of corrupted pixel observations: Geman-McClure BA stays near
    ground truth; unweighted BA is dragged off."""
    from moptimizer_jax import GemanMcClure

    start, gt = make_synthetic_ba(C=5, L=40, n_fixed=2, seed=7)
    rng = np.random.default_rng(8)
    pixels = np.array(start.pixels)  # writable copy
    bad = rng.choice(len(pixels), size=10, replace=False)
    pixels[bad] += 300.0  # gross outliers
    start_noisy = dataclasses.replace(start, pixels=jnp.asarray(pixels))

    res_plain = ba.solve_ba(start_noisy, ba.BAConfig(max_iterations=30))
    start_robust = dataclasses.replace(
        start_noisy, loss=GemanMcClure(tau=jnp.asarray(4.0))
    )
    res_robust = ba.solve_ba(start_robust, ba.BAConfig(max_iterations=30))

    err_plain = float(jnp.max(jnp.abs(res_plain.points - gt.points)))
    err_robust = float(jnp.max(jnp.abs(res_robust.points - gt.points)))
    assert err_robust < 0.01
    assert err_robust < err_plain / 5


def test_ba_host_loop_matches_device_loop():
    start, gt = make_synthetic_ba(C=4, L=25, n_fixed=2, seed=11)
    cfg = ba.BAConfig(max_iterations=10)
    res_dev = ba.solve_ba(start, cfg)
    res_host = ba.solve_ba(start, cfg, host_loop=True)
    np.testing.assert_allclose(res_host.camera_params, res_dev.camera_params, atol=1e-10)
    np.testing.assert_allclose(res_host.points, res_dev.points, atol=1e-10)
    assert int(res_host.iterations) == int(res_dev.iterations)


def test_ba_rel_cost_tol_stops_early():
    """BAConfig.rel_cost_tol (r4, mirrors LMConfig): noise-floor stopping
    terminates CONVERGED in fewer iterations at an equal minimum."""
    prob, _ = make_synthetic_ba(C=5, L=50, noise=0.5, seed=7)
    base = ba.solve_ba(prob, ba.BAConfig(max_iterations=30))
    fast = ba.solve_ba(prob, ba.BAConfig(max_iterations=30, rel_cost_tol=1e-8))
    assert int(fast.iterations) <= int(base.iterations)
    assert int(fast.status) == int(Status.CONVERGED)
    np.testing.assert_allclose(float(fast.cost), float(base.cost), rtol=1e-4)
