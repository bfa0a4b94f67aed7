"""Pose-graph optimization: odometry chain + loop closures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import pose_graph as pgo
from moptimizer_jax.lie import se3, so3
import pytest


def _compose_params6(a, b):
    T = se3.transform_from_params6(jnp.asarray(a)) @ se3.transform_from_params6(
        jnp.asarray(b)
    )
    return np.concatenate([np.asarray(T[:3, 3]), np.asarray(so3.log(T[:3, :3]))])


def _relative(a, b):
    """params6 of T_a⁻¹ T_b."""
    Ta = np.asarray(se3.transform_from_params6(jnp.asarray(a)))
    Tb = np.asarray(se3.transform_from_params6(jnp.asarray(b)))
    E = np.linalg.inv(Ta) @ Tb
    return np.concatenate([E[:3, 3], np.asarray(so3.log(jnp.asarray(E[:3, :3])))])


def make_ring_graph(N=12, seed=0, drift=0.03):
    """Ground-truth poses on a ring; edges: odometry chain + a loop closure.
    Initial guess integrates noisy odometry (accumulating drift)."""
    rng = np.random.default_rng(seed)
    gt = []
    step = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 2 * np.pi / N])
    cur = np.zeros(6)
    for _ in range(N):
        gt.append(cur)
        cur = _compose_params6(cur, step)
    gt = np.stack(gt)

    edges_i, edges_j, meas = [], [], []
    for k in range(N - 1):
        edges_i.append(k)
        edges_j.append(k + 1)
        meas.append(_relative(gt[k], gt[k + 1]))
    # loop closures
    edges_i += [N - 1, 0]
    edges_j += [0, N // 2]
    meas.append(_relative(gt[N - 1], gt[0]))
    meas.append(_relative(gt[0], gt[N // 2]))

    # drifted initialization: integrate odometry with noise
    init = [gt[0]]
    for k in range(N - 1):
        noisy = meas[k] + drift * rng.normal(size=6)
        init.append(_compose_params6(init[-1], noisy))
    init = np.stack(init)

    E = len(edges_i)
    return pgo.PoseGraph(
        poses=jnp.asarray(init),
        edge_i=jnp.asarray(edges_i),
        edge_j=jnp.asarray(edges_j),
        measurements=jnp.asarray(np.stack(meas)),
        information=jnp.broadcast_to(jnp.eye(6), (E, 6, 6)),
        n_fixed=1,
    ), jnp.asarray(gt)


def test_residual_zero_at_ground_truth():
    graph, gt = make_ring_graph(drift=0.0)
    graph_gt = dataclasses.replace(graph, poses=gt)
    assert float(pgo.compute_cost(graph_gt)) < 1e-18


def test_pgo_corrects_drift():
    graph, gt = make_ring_graph(N=12, drift=0.03)
    start_cost = float(pgo.compute_cost(graph))
    res = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    assert float(res.cost) < start_cost * 1e-2
    # first pose stays fixed
    np.testing.assert_array_equal(res.poses[0], graph.poses[0])


def test_pgo_exact_measurements_recovers_gt():
    """With exact measurements and a drifted init, PGO lands on the GT poses
    (gauge fixed at pose 0 which equals GT pose 0)."""
    graph, gt = make_ring_graph(N=10, drift=0.02, seed=2)
    res = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=50))
    assert float(res.cost) < 1e-16
    # compare as transforms (params may differ by log-branch)
    for k in range(10):
        T_est = np.asarray(se3.transform_from_params6(res.poses[k]))
        T_gt = np.asarray(se3.transform_from_params6(gt[k]))
        np.testing.assert_allclose(T_est, T_gt, atol=1e-6)


def test_information_weighting():
    """Scaling all edge informations scales the cost linearly and leaves the
    optimum unchanged (reference covariance semantics, tst/covariance.cpp)."""
    graph, _ = make_ring_graph(N=8, drift=0.02, seed=3)
    c1 = float(pgo.compute_cost(graph))
    graph2 = dataclasses.replace(graph, information=2.0 * graph.information)
    c2 = float(pgo.compute_cost(graph2))
    np.testing.assert_allclose(c2, 2 * c1, rtol=1e-12)
    r1 = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    r2 = pgo.solve_pgo(graph2, pgo.PGOConfig(max_iterations=30))
    np.testing.assert_allclose(r1.poses, r2.poses, atol=1e-8)


def test_pgo_robust_loss_survives_bad_loop_closure():
    """One grossly wrong loop-closure edge: Geman-McClure keeps the solution
    near ground truth; plain least squares is dragged off."""
    from moptimizer_jax import GemanMcClure

    graph, gt = make_ring_graph(N=12, drift=0.01, seed=5)
    meas = np.array(graph.measurements)
    meas[-1] = meas[-1] + np.array([3.0, -2.0, 1.0, 0.3, 0.2, -0.1])  # bogus closure
    bad_graph = dataclasses.replace(graph, measurements=jnp.asarray(meas))

    res_plain = pgo.solve_pgo(bad_graph, pgo.PGOConfig(max_iterations=40))
    res_robust = pgo.solve_pgo(
        dataclasses.replace(bad_graph, loss=GemanMcClure(tau=jnp.asarray(0.5))),
        pgo.PGOConfig(max_iterations=40),
    )

    def max_pose_err(poses):
        errs = []
        for k in range(12):
            T_est = np.asarray(se3.transform_from_params6(poses[k]))
            T_gt = np.asarray(se3.transform_from_params6(gt[k]))
            errs.append(np.abs(np.linalg.inv(T_est) @ T_gt - np.eye(4)).max())
        return max(errs)

    assert max_pose_err(res_robust.poses) < max_pose_err(res_plain.poses) / 3


def test_huber_cauchy_losses():
    """Huber/Cauchy IRLS weights: 1 in the inlier region, decaying beyond."""
    from moptimizer_jax import Cauchy, Huber

    h = Huber(delta=jnp.asarray(2.0))
    np.testing.assert_allclose(h.weight(jnp.asarray(1.0)), 1.0)
    np.testing.assert_allclose(h.weight(jnp.asarray(16.0)), 2.0 / 4.0)
    c = Cauchy(c=jnp.asarray(2.0))
    np.testing.assert_allclose(c.weight(jnp.asarray(0.0)), 1.0)
    np.testing.assert_allclose(c.weight(jnp.asarray(4.0)), 0.5)


def test_pgo_cg_matches_dense():
    """Matrix-free CG solver reproduces the dense-Cholesky trajectory."""
    graph, gt = make_ring_graph(N=14, drift=0.02, seed=9)
    res_dense = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    res_cg = pgo.solve_pgo(
        graph,
        pgo.PGOConfig(max_iterations=30, solver="cg", cg_iterations=300, cg_tol=1e-13),
    )
    np.testing.assert_allclose(res_cg.poses, res_dense.poses, atol=1e-7)
    assert float(res_cg.cost) < 1e-14


@pytest.mark.slow
def test_pgo_cg_large_graph():
    """CG path on a 300-pose chain (dense would be 1800×1800 — still fine,
    but this pins the scalable path's convergence)."""
    graph, gt = make_ring_graph(N=300, drift=0.005, seed=10)
    start_cost = float(pgo.compute_cost(graph))
    res = pgo.solve_pgo(
        graph, pgo.PGOConfig(max_iterations=40, solver="cg", cg_iterations=400)
    )
    assert float(res.cost) < start_cost * 1e-3


def test_pgo_prior_dominant_graph_not_falsely_converged():
    """Regression: y0 used edge-only cost while the trial cost included
    the PGOPrior term, so a prior-dominant graph (edges near-satisfied,
    nonzero prior offset) returned CONVERGED after 0 iterations at the
    initial point. y0 must be compute_cost (edges + prior)."""
    graph, gt = make_ring_graph(N=8, drift=0.0, seed=7)
    # edges exactly satisfied at gt; attach a prior pulling pose 1 elsewhere
    target = np.asarray(gt[1]) + np.array([0.5, -0.3, 0.2, 0.05, -0.04, 0.03])
    prior = pgo.PGOPrior(
        x_ref=jnp.asarray(target),
        sqrt_info=3.0 * jnp.eye(6),
        offset=jnp.zeros(6),
        idx=jnp.arange(6, 12, dtype=jnp.int32),
    )
    g = dataclasses.replace(graph, poses=gt, prior=prior)
    start = float(pgo.compute_cost(g))
    assert start > 1.0  # prior term dominates; edge term ~ 0
    res = pgo.solve_pgo(g, pgo.PGOConfig(max_iterations=30, solver="dense"))
    assert int(res.iterations) > 0
    # solver must trade edge cost against the prior: true total cost drops
    assert float(res.cost) < 0.9 * start


def test_pgo_rel_cost_tol_stops_early():
    """PGOConfig.rel_cost_tol (r4): noise-floor stopping, equal optimum."""
    graph, _ = make_ring_graph(N=10, drift=0.03, seed=8)
    base = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=40))
    fast = pgo.solve_pgo(
        graph, pgo.PGOConfig(max_iterations=40, rel_cost_tol=1e-8)
    )
    assert int(fast.iterations) <= int(base.iterations)
    np.testing.assert_allclose(
        float(fast.cost), float(base.cost), rtol=1e-3, atol=1e-12
    )
