"""Fixed-lag marginalization in the PGO back-end (pose_graph.marginalize_oldest).

Contracts:
1. Marginalizing at a CONVERGED solution leaves the kept poses at that
   solution (the prior's offset makes its gradient vanish there).
2. Marginalize-then-add-new-information ≈ the full joint solve (exact up
   to the linearization of the absorbed factors — tight at small noise).
3. The gauge survives: after dropping the fixed pose, the reduced graph
   (n_fixed=0) is solvable and anchored by the prior.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import pose_graph as pgo
from moptimizer_jax.lie import se3, so3


def _compose(a, b):
    T = se3.transform_from_params6(a) @ se3.transform_from_params6(b)
    return jnp.concatenate([T[:3, 3], so3.log(T[:3, :3])])


def _chain_graph(n=6, noise=1e-3, seed=0):
    """A pose chain with odometry edges + one skip edge (0→2) so that
    marginalizing pose 0 produces a genuine multi-pose prior."""
    rng = np.random.default_rng(seed)
    step = np.array([1.0, 0.1, 0.0, 0.0, 0.0, 0.05])
    gt = [jnp.zeros(6)]
    for _ in range(n - 1):
        gt.append(_compose(gt[-1], jnp.asarray(step)))
    gt = jnp.stack(gt)

    edge_i, edge_j, meas = [], [], []
    for k in range(n - 1):
        edge_i.append(k)
        edge_j.append(k + 1)
        z = np.asarray(step) + noise * rng.normal(size=6)
        meas.append(z)
    # skip edge 0→2
    edge_i.append(0)
    edge_j.append(2)
    T02 = _compose(jnp.asarray(step), jnp.asarray(step))
    meas.append(np.asarray(T02) + noise * rng.normal(size=6))

    E = len(edge_i)
    init = np.asarray(gt) + 0.01 * rng.normal(size=(n, 6)) * (np.arange(n) > 0)[:, None]
    return pgo.PoseGraph(
        poses=jnp.asarray(init),
        edge_i=jnp.asarray(edge_i),
        edge_j=jnp.asarray(edge_j),
        measurements=jnp.asarray(np.stack(meas)),
        information=jnp.broadcast_to(jnp.eye(6), (E, 6, 6)),
        n_fixed=1,
    )


@pytest.mark.slow
def test_marginalize_at_converged_solution_is_stationary():
    graph = _chain_graph()
    res = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    conv = dataclasses.replace(graph, poses=res.poses)

    red = pgo.marginalize_oldest(conv, 1)
    assert red.poses.shape[0] == graph.poses.shape[0] - 1
    assert red.prior is not None and red.n_fixed == 0

    res2 = pgo.solve_pgo(red, pgo.PGOConfig(max_iterations=30))
    np.testing.assert_allclose(
        np.asarray(res2.poses), np.asarray(res.poses[1:]), atol=1e-7
    )


def test_marginalize_then_new_edge_matches_full():
    """Sliding window: marginalize pose 0, then add a new loop edge among
    kept poses; compare to the full graph with the same new edge."""
    graph = _chain_graph(noise=1e-4)
    res = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    conv = dataclasses.replace(graph, poses=res.poses)

    # new edge 1→5 measured from ground-truth-ish relative pose
    z_new = np.asarray(res.poses[5])  # placeholder magnitude
    Ti = se3.transform_from_params6(res.poses[1])
    Tj = se3.transform_from_params6(res.poses[5])
    E = jnp.linalg.inv(Ti) @ Tj
    z_new = np.concatenate([np.asarray(E[:3, 3]), np.asarray(so3.log(E[:3, :3]))])
    z_new = z_new + 2e-3 * np.random.default_rng(1).normal(size=6)

    def add_edge(g, i, j):
        return dataclasses.replace(
            g,
            edge_i=jnp.concatenate([g.edge_i, jnp.asarray([i])]),
            edge_j=jnp.concatenate([g.edge_j, jnp.asarray([j])]),
            measurements=jnp.concatenate([g.measurements, jnp.asarray(z_new)[None]]),
            information=jnp.concatenate([g.information, jnp.eye(6)[None]]),
        )

    full = pgo.solve_pgo(add_edge(conv, 1, 5), pgo.PGOConfig(max_iterations=30))

    red = pgo.marginalize_oldest(conv, 1)
    red = add_edge(red, 0, 4)  # re-indexed
    win = pgo.solve_pgo(red, pgo.PGOConfig(max_iterations=30))

    np.testing.assert_allclose(
        np.asarray(win.poses), np.asarray(full.poses[1:]), atol=1e-5
    )


@pytest.mark.slow
def test_sequential_marginalization():
    """Marginalize twice in a row (prior folded into the next prior)."""
    graph = _chain_graph(n=7)
    res = pgo.solve_pgo(graph, pgo.PGOConfig(max_iterations=30))
    conv = dataclasses.replace(graph, poses=res.poses)
    red1 = pgo.marginalize_oldest(conv, 1)
    r1 = pgo.solve_pgo(red1, pgo.PGOConfig(max_iterations=30))
    red2 = pgo.marginalize_oldest(
        dataclasses.replace(red1, poses=r1.poses), 1
    )
    r2 = pgo.solve_pgo(red2, pgo.PGOConfig(max_iterations=30))
    np.testing.assert_allclose(
        np.asarray(r2.poses), np.asarray(res.poses[2:]), atol=1e-6
    )


@pytest.mark.slow
def test_fixed_lag_slam_tracks_batch_odometry():
    """scan_slam_fixed_lag on the standing 24-scan world: bounded-window
    streaming stays within the batch odometry's ATE bound (the loop has no
    closures here, so fixed-lag ≈ odometry with windowed refinement)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    from test_slam_sequence import ATE_ODOMETRY_BOUND, make_sequence

    from moptimizer_jax.core.solver import LMConfig
    from moptimizer_jax.evaluation import ate_rmse
    from moptimizer_jax.odometry import scan_slam_fixed_lag

    scans, gt = make_sequence()
    cfg = LMConfig(diff_mode="auto", max_iterations=40)
    poses = scan_slam_fixed_lag(
        scans, window=6, config=cfg, nn_backend="grid", max_corr_dist=0.5
    )
    assert poses.shape == (len(scans), 6)
    ate = float(ate_rmse(poses, gt, align=False))
    assert ate < ATE_ODOMETRY_BOUND


def test_prior_rejected_by_cg_solver():
    graph = _chain_graph()
    red = pgo.marginalize_oldest(graph, 1)
    with pytest.raises(ValueError):
        pgo.solve_pgo(red, pgo.PGOConfig(solver="cg"))
