"""Shard-invariance: the multi-device analogue of the reference's
split-cost test (tst/multiple_objectives.cpp) and parallel-vs-serial test
(tst/parallel.cpp:70-94) — run on 8 faked CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core.linearize import compute_cost, linearize
from moptimizer_jax.core.residual import problem
from moptimizer_jax.lie import se3
from moptimizer_jax.models.point2point import point2point_block
from moptimizer_jax.parallel import (
    distributed_levenberg_marquardt,
    make_mesh,
    pad_block_to,
    sharded_compute_cost,
    sharded_linearize,
)


@pytest.fixture(scope="module")
def cloud_pair():
    rng = np.random.default_rng(42)
    src = rng.uniform(0, 10, size=(100_000, 3))
    x_true = jnp.array([1.0, 2.0, 3.0, 0.2, 0.2, 0.2])
    T = np.asarray(se3.transform_from_params6(x_true))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return jnp.asarray(src), jnp.asarray(tgt)


@pytest.mark.slow
def test_sharded_cost_equals_serial(cloud_pair):
    """Parallel ≈ serial cost to 1e-8 on a large cloud (reference
    tst/parallel.cpp:84-93 uses 1M points; 100k here keeps CI fast)."""
    src, tgt = cloud_pair
    blk = point2point_block(src, tgt)
    x = jnp.array([0.5, 0.0, 0.1, 0.05, 0.0, -0.02])
    mesh = make_mesh(8)
    c_serial = compute_cost(blk, x)
    c_shard = sharded_compute_cost(blk, x, mesh)
    np.testing.assert_allclose(c_shard, c_serial, rtol=1e-12)


@pytest.mark.slow
def test_sharded_linearize_equals_serial(cloud_pair):
    src, tgt = cloud_pair
    blk = point2point_block(src, tgt)
    x = jnp.array([0.5, 0.0, 0.1, 0.05, 0.0, -0.02])
    mesh = make_mesh(8)
    c0, H0, b0 = linearize(blk, x, mode="auto")
    c1, H1, b1 = sharded_linearize(blk, x, mesh, mode="auto")
    np.testing.assert_allclose(c1, c0, rtol=1e-12)
    np.testing.assert_allclose(H1, H0, rtol=1e-10)
    np.testing.assert_allclose(b1, b0, rtol=1e-10)


@pytest.mark.slow
def test_shard_counts_1_2_8_agree(cloud_pair):
    src, tgt = cloud_pair
    blk = point2point_block(src, tgt)
    x = jnp.array([0.1, -0.2, 0.3, 0.01, 0.02, 0.03])
    results = []
    for n in (1, 2, 8):
        mesh = make_mesh(n)
        results.append(sharded_linearize(blk, x, mesh, mode="auto"))
    for c, H, b in results[1:]:
        np.testing.assert_allclose(c, results[0][0], rtol=1e-12)
        np.testing.assert_allclose(H, results[0][1], rtol=1e-10)
        np.testing.assert_allclose(b, results[0][2], rtol=1e-10)


def test_padding_does_not_change_linearization(cloud_pair):
    src, tgt = cloud_pair
    blk = point2point_block(src[:777], tgt[:777])  # 777 not divisible by 8
    x = jnp.array([0.1, -0.2, 0.3, 0.01, 0.02, 0.03])
    c0, H0, b0 = linearize(blk, x, mode="auto")
    padded = pad_block_to(blk, 8)
    c1, H1, b1 = linearize(padded, x, mode="auto")
    np.testing.assert_allclose(c1, c0, rtol=1e-13)
    np.testing.assert_allclose(H1, H0, rtol=1e-13)
    np.testing.assert_allclose(b1, b0, rtol=1e-13)


def test_distributed_lm_matches_single_device(cloud_pair):
    """Full solver trajectory identical sharded vs not (the reference's
    split-cost invariance, lifted to devices)."""
    src, tgt = cloud_pair
    sub_s, sub_t = src[:8192], tgt[:8192]
    blk = point2point_block(sub_s, sub_t)
    cfg = LMConfig(diff_mode="auto", max_iterations=30)
    res_single = levenberg_marquardt(problem(blk), jnp.zeros(6), cfg)
    mesh = make_mesh(8)
    res_dist = distributed_levenberg_marquardt(problem(blk), jnp.zeros(6), mesh, cfg)
    np.testing.assert_allclose(res_dist.x, res_single.x, atol=1e-10)
    assert int(res_dist.status) == int(res_single.status)
    # per-iteration costs agree; near-machine-zero tail values may differ in
    # summation order, hence the small atol
    np.testing.assert_allclose(
        np.asarray(res_dist.trace["cost"]),
        np.asarray(res_single.trace["cost"]),
        rtol=1e-8,
        atol=1e-18,
        equal_nan=True,
    )
    # and it actually solved the alignment
    x_true = np.array([1.0, 2.0, 3.0, 0.2, 0.2, 0.2])
    T_true = np.asarray(se3.transform_from_params6(jnp.asarray(x_true)))
    T_est = np.asarray(se3.transform_from_params6(res_dist.x))
    np.testing.assert_allclose(T_est, T_true, atol=1e-5)


def test_icp_batched_sharded_matches_single_device():
    """Fleet ICP with the batch axis sharded over the 8-device mesh equals
    the single-device vmapped path per lane (the
    serving-workload form of the SURVEY §2.3 DP plan)."""
    from moptimizer_jax.registration import icp_batched

    rng = np.random.default_rng(7)
    B, N = 8, 256
    srcs = np.stack([rng.uniform(0, 4, size=(N, 3)) for _ in range(B)])
    x_true = np.stack(
        [np.concatenate([rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.1, 0.1, 3)])
         for _ in range(B)]
    )
    tgts = np.stack(
        [
            s @ np.asarray(se3.transform_from_params6(jnp.asarray(x)))[:3, :3].T
            + np.asarray(se3.transform_from_params6(jnp.asarray(x)))[:3, 3]
            for s, x in zip(srcs, x_true)
        ]
    )
    cfg = LMConfig(diff_mode="auto", max_iterations=12, linear_solver="cholesky")
    res_single = icp_batched(srcs, tgts, config=cfg)
    mesh = make_mesh(8, axis="fleet")
    res_shard = icp_batched(srcs, tgts, config=cfg, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(res_shard.x), np.asarray(res_single.x), atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(res_shard.status), np.asarray(res_single.status)
    )
    np.testing.assert_allclose(np.asarray(res_shard.x), x_true, atol=1e-3)
    # uneven fleet: loud error, not silent truncation
    with pytest.raises(ValueError, match="must divide"):
        icp_batched(srcs[:6], tgts[:6], config=cfg, mesh=mesh)
