"""Bitwise determinism of the linearization — the property the reference
lacks (its TBB parallelComputeCost has a data race papered over by CI
retries, SURVEY.md §2.4.3). Here CI asserts bitwise-reproducible H,b."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax.core.linearize import compute_cost, linearize
from moptimizer_jax.lie import se3
from moptimizer_jax.models.point2point import point2point_block
from moptimizer_jax.parallel import make_mesh, sharded_linearize
import pytest


def _clouds(n=50_000):
    rng = np.random.default_rng(9)
    src = jnp.asarray(rng.uniform(0, 10, (n, 3)))
    T = se3.transform_from_params6(jnp.asarray([1.0, 2.0, 3.0, 0.2, 0.2, 0.2]))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return src, tgt


def test_linearize_bitwise_reproducible():
    src, tgt = _clouds()
    blk = point2point_block(src, tgt)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.05, 0.0, -0.02])
    runs = [linearize(blk, x, mode="auto") for _ in range(3)]
    for c, H, b in runs[1:]:
        np.testing.assert_array_equal(np.asarray(c), np.asarray(runs[0][0]))
        np.testing.assert_array_equal(np.asarray(H), np.asarray(runs[0][1]))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(runs[0][2]))


@pytest.mark.slow
def test_parallel_cost_bitwise_reproducible():
    """The deterministic replacement for the reference's racy
    parallelComputeCost (tst/parallel.cpp would flake here; we can't)."""
    src, tgt = _clouds()
    blk = point2point_block(src, tgt)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.05, 0.0, -0.02])
    mesh = make_mesh(8)
    runs = [sharded_linearize(blk, x, mesh, mode="auto") for _ in range(3)]
    for c, H, b in runs[1:]:
        np.testing.assert_array_equal(np.asarray(c), np.asarray(runs[0][0]))
        np.testing.assert_array_equal(np.asarray(H), np.asarray(runs[0][1]))
    c0 = compute_cost(blk, x)
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(compute_cost(blk, x)), np.asarray(c0))
