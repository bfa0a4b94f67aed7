"""Batched LM: B independent same-structure solves in one device program.

No reference counterpart (the C++ library solves one problem per
`minimize` call); on the device, vmapping the whole solver turns per-instance
accept/reject control flow into masking and lets small problems share one
dispatch — the serving-throughput path (PERF.md "batched solves").
Correctness contract: every batched instance must match its individual
solve exactly (the vmapped while_loop freezes finished instances via
select, preserving their state up to f64 round-off — vmap changes
XLA fusion/reduction order, so agreement is to ~1e-12, not bitwise).
"""

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import (
    LMConfig,
    Status,
    levenberg_marquardt,
    levenberg_marquardt_batched,
)
from moptimizer_jax.core.residual import make_block, problem
from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA


def _residual(x, d):
    return jnp.stack([d[1] - jnp.exp(x[0] * d[0] + x[1])])


def test_batched_matches_individual_solves():
    """4 curve-fitting instances (different data subsets AND different
    starts, hence different iteration counts) ≡ 4 individual solves."""
    data = np.asarray(CERES_CURVE_DATA)
    datas = np.stack(
        [
            data[:48],
            data[8:56],
            data[16:64],
            data[3:51],
        ]
    )  # (B, 48, 2)
    x0s = jnp.asarray(
        [[0.0, 0.0], [0.3, 0.1], [1.2, 2.0], [-0.5, 0.4]], jnp.float64
    )
    cfg = LMConfig(max_iterations=40)

    blk_batched = make_block(_residual, data=jnp.asarray(datas, jnp.float64))
    res_b = levenberg_marquardt_batched(problem(blk_batched), x0s, cfg)

    for i in range(4):
        blk_i = make_block(_residual, data=jnp.asarray(datas[i], jnp.float64))
        res_i = levenberg_marquardt(problem(blk_i), x0s[i], cfg)
        np.testing.assert_allclose(
            np.asarray(res_b.x[i]), np.asarray(res_i.x), rtol=1e-8, atol=1e-12
        )
        assert int(res_b.status[i]) == int(res_i.status)
        # near convergence max|δ| hovers at the √ε SMALL_DELTA threshold
        # for several iterations, so 1e-14 state differences move the stop
        # by a few iterations; x/status/cost above are the real contract
        assert abs(int(res_b.iterations[i]) - int(res_i.iterations)) <= 5
        np.testing.assert_allclose(
            np.asarray(res_b.cost[i]), np.asarray(res_i.cost), rtol=1e-8, atol=1e-20
        )


def test_batched_none_data_block_replicates():
    """A data=None block (single residual over the state) batches over x0
    only — the Powell problem from 3 different starts."""
    from moptimizer_jax.models.powell import powell_block

    x0s = jnp.asarray(
        [[3.0, -1.0, 0.0, 4.0], [1.0, 1.0, 1.0, 1.0], [-2.0, 3.0, 0.5, -1.5]],
        jnp.float64,
    )
    cfg = LMConfig(max_iterations=30)
    res_b = levenberg_marquardt_batched(
        problem(powell_block(analytic=True)), x0s, cfg
    )
    assert res_b.x.shape == (3, 4)
    for i in range(3):
        res_i = levenberg_marquardt(problem(powell_block(analytic=True)), x0s[i], cfg)
        np.testing.assert_allclose(
            np.asarray(res_b.x[i]), np.asarray(res_i.x), rtol=1e-8, atol=1e-12
        )
    np.testing.assert_allclose(np.asarray(res_b.x), 0.0, atol=2e-4)


def test_multistart_picks_best_basin():
    """Rational fit: some starts find the (0.362, 0.556) basin, some find a
    worse stationary point or blow up; multistart returns the global one."""
    from moptimizer_jax import solve_multistart
    from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block

    blk = rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=jnp.float64)
    x0s = jnp.asarray(
        [[0.9, 0.2], [1.9, 1.5], [50.0, -40.0], [-3.0, 0.01]], jnp.float64
    )
    best, allres = solve_multistart(
        problem(blk), x0s, LMConfig(max_iterations=40)
    )
    assert allres.x.shape == (4, 2)
    assert int(best.status) != int(Status.NUMERIC_ERROR)
    np.testing.assert_allclose(np.asarray(best.x), [0.362, 0.556], atol=0.01)
    # best really is the min healthy cost
    costs = np.asarray(allres.cost)
    statuses = np.asarray(allres.status)
    healthy = costs[statuses != int(Status.NUMERIC_ERROR)]
    np.testing.assert_allclose(float(best.cost), healthy.min(), rtol=1e-12)


def test_icp_batched_with_nn_update():
    """registration.icp_batched: B FULL ICP solves (per-iteration NN
    correspondence search) in one program, each matching its individual
    icp() solve."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.registration import icp, icp_batched

    rng = np.random.default_rng(15)
    B, N = 3, 1500
    srcs = rng.uniform(0, 10, (B, N, 3))
    x_true = np.array(
        [
            [0.1, -0.05, 0.08, 0.02, -0.01, 0.03],
            [-0.07, 0.04, 0.02, -0.015, 0.02, 0.01],
            [0.03, 0.06, -0.04, 0.01, 0.015, -0.02],
        ]
    )
    tgts = np.stack(
        [
            np.asarray(
                srcs[i]
                @ np.asarray(se3.transform_from_params6(jnp.asarray(x_true[i])))[:3, :3].T
                + np.asarray(se3.transform_from_params6(jnp.asarray(x_true[i])))[:3, 3]
            )
            for i in range(B)
        ]
    )
    res = icp_batched(
        jnp.asarray(srcs, jnp.float64),
        jnp.asarray(tgts, jnp.float64),
        max_corr_dist=1.0,
    )
    assert res.x.shape == (B, 6)
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-6)
    for i in range(B):
        res_i = icp(
            jnp.asarray(srcs[i], jnp.float64),
            jnp.asarray(tgts[i], jnp.float64),
            nn_backend="xla",
            max_corr_dist=1.0,
        )
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(res_i.x), atol=1e-9
        )


def test_batched_icp_point2point():
    """B=3 known-correspondence scan alignments in one program (the
    bench.py workload, batched): each recovers its own transform."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.models.point2point import point2point_block

    rng = np.random.default_rng(13)
    B, N = 3, 5000
    srcs = rng.uniform(0, 20, (B, N, 3))
    x_true = np.array(
        [
            [1.0, -0.5, 0.3, 0.1, -0.2, 0.15],
            [-0.4, 0.8, 0.05, -0.05, 0.1, 0.2],
            [0.2, 0.1, -0.6, 0.3, 0.02, -0.1],
        ]
    )
    tgts = np.stack(
        [
            np.asarray(srcs[i] @ np.asarray(se3.transform_from_params6(jnp.asarray(x_true[i])))[:3, :3].T
                       + np.asarray(se3.transform_from_params6(jnp.asarray(x_true[i])))[:3, 3])
            for i in range(B)
        ]
    )
    blk = point2point_block(
        jnp.asarray(srcs, jnp.float64), jnp.asarray(tgts, jnp.float64)
    )
    # point2point_block data leaves are (B, N, 3) here; the batched solver
    # vmaps the leading axis
    res = levenberg_marquardt_batched(
        problem(blk), jnp.zeros((B, 6), jnp.float64), LMConfig(max_iterations=20)
    )
    np.testing.assert_allclose(np.asarray(res.x), x_true, atol=1e-8)
