"""Segment-ops-as-matmuls: equivalence with jax.ops.segment_sum / gather."""

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax.ops.segmented import (
    gather_onehot,
    required_span,
    segment_sum_onehot,
    segment_sum_sorted,
)


def test_onehot_segment_sum():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(5000, 2, 3)))
    ids = jnp.asarray(rng.integers(0, 64, 5000))
    ref = jax.ops.segment_sum(v, ids, num_segments=64)
    np.testing.assert_allclose(segment_sum_onehot(v, ids, 64), ref, atol=1e-12)


def test_onehot_gather():
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.normal(size=(64, 6)))
    ids = jnp.asarray(rng.integers(0, 64, 5000))
    np.testing.assert_array_equal(gather_onehot(table, ids), table[ids])


def test_sorted_tiled_segment_sum():
    rng = np.random.default_rng(2)
    for O, L, tile in [(50_000, 5_000, 4096), (10_000, 300, 1024), (777, 50, 256)]:
        ids_np = np.sort(rng.integers(0, L, O))
        v = jnp.asarray(rng.normal(size=(O, 4)))
        span = required_span(ids_np, tile)
        got = segment_sum_sorted(
            v, jnp.asarray(ids_np), L, tile=tile, span=max(128, span)
        )
        ref = jax.ops.segment_sum(v, jnp.asarray(ids_np), num_segments=L)
        np.testing.assert_allclose(got, ref, atol=1e-10)


def test_sorted_tiled_empty_segments():
    """Segments with zero members stay exactly zero."""
    ids = jnp.asarray(np.sort(np.array([1, 1, 4, 4, 4, 9])))
    v = jnp.asarray(np.ones((6, 2)))
    out = segment_sum_sorted(v, ids, 12, tile=4, span=16)
    ref = jax.ops.segment_sum(v, ids, num_segments=12)
    np.testing.assert_array_equal(out, ref)
