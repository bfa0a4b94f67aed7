"""Valence-segmented (L, K) grouping (r5): layout invariants + equivalence.

With uniform-random observations the single-K grid is ~60% padding
(counts ~ Poisson(O/L), K = the max), and every K-proportional stage
streams that padding. `group_by_landmark(segments=...)` sorts rows by
valence and processes a few contiguous segments at their own widths; the
math is unchanged, so everything here is an exact-layout or
float-tolerance equivalence test against the unsegmented path.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from moptimizer_jax import ba, ba_dense

from test_ba import make_synthetic_ba


def make_skewed_ba(C=6, L=48, seed=0, noise=0.5):
    """Synthetic BA with strongly varying landmark valence."""
    start, _ = make_synthetic_ba(C=C, L=L, noise=noise, seed=seed)
    rng = np.random.default_rng(seed)
    pt = np.asarray(start.pt_idx)
    # per-landmark keep probability in [0.15, 1.0] — valence 1..C spread
    p_keep = rng.uniform(0.15, 1.0, size=L)[pt]
    keep = rng.random(len(pt)) < p_keep
    # every landmark needs >= 1 observation for a well-posed V block
    for l in range(L):
        idx = np.where(pt == l)[0]
        if not keep[idx].any():
            keep[idx[0]] = True
    return dataclasses.replace(
        start,
        cam_idx=start.cam_idx[np.where(keep)[0]],
        pt_idx=start.pt_idx[np.where(keep)[0]],
        pixels=start.pixels[np.where(keep)[0]],
    )


def test_segmented_grouping_invariants():
    prob = make_skewed_ba()
    g = ba_dense.group_by_landmark(prob, segments=3)
    L = prob.points.shape[0]
    assert g.seg_bounds, "skewed valence must trigger segmentation"
    perm = np.asarray(g.perm)
    inv = np.asarray(g.inv_perm)
    assert (perm[inv] == np.arange(L)).all()
    assert (inv[perm] == np.arange(L)).all()

    counts = np.bincount(np.asarray(prob.pt_idx), minlength=L)
    row_counts = np.asarray(g.mask).sum(axis=1).astype(int)
    # row i holds landmark perm[i], sorted by valence descending
    assert (row_counts == counts[perm]).all()
    assert (np.diff(row_counts) <= 0).all()

    # segment bounds: non-increasing widths covering all rows, and every
    # row's valence fits inside its segment's width
    prev_end, prev_k = 0, None
    for end, k in g.seg_bounds:
        assert 0 < end <= L
        assert prev_k is None or k <= prev_k
        assert row_counts[prev_end:end].max(initial=0) <= k
        prev_end, prev_k = end, k
    assert prev_end == L
    assert int(np.asarray(g.mask).sum()) == len(np.asarray(prob.pt_idx))


def test_auto_keeps_identity_layout_when_not_worth_it():
    # uniform valence (every camera sees every point): zero padding, no
    # segmentation; small L: below the auto threshold
    start, _ = make_synthetic_ba(C=4, L=30, noise=0.3, seed=1)
    g = ba_dense.group_by_landmark(start, segments="auto")
    assert g.seg_bounds == () and g.perm is None
    g1 = ba_dense.group_by_landmark(start)
    np.testing.assert_array_equal(np.asarray(g.pixels), np.asarray(g1.pixels))
    np.testing.assert_array_equal(np.asarray(g.cam_ids), np.asarray(g1.cam_ids))


def test_segmented_cost_matches_flat():
    prob = make_skewed_ba(seed=3)
    g = ba_dense.group_by_landmark(prob, segments=3)
    c_flat = float(ba.compute_cost(prob))
    c_seg = float(
        ba_dense._cost_grouped(
            prob.camera_params, g.sort_points(prob.points),
            prob.intrinsics, g,
        )
    )
    assert abs(c_seg - c_flat) < 1e-9 * max(1.0, abs(c_flat))


def test_segmented_blocks_match_unsegmented():
    prob = make_skewed_ba(seed=4)
    C = prob.camera_params.shape[0]
    g1 = ba_dense.group_by_landmark(prob)
    g3 = ba_dense.group_by_landmark(prob, segments=3)

    r, A, B = ba_dense._linearize_grouped(
        prob.camera_params, prob.points, prob.intrinsics, g1
    )
    U1, V1, W1, gg1, h1 = ba_dense._gn_blocks_grouped(g1, r, A, B, C, prob.loss)
    y1 = float(jnp.sum(r * r))

    U3, V3, W3, gg3, h3, y3 = ba_dense._linearize_and_blocks(
        prob.camera_params, g3.sort_points(prob.points), prob.intrinsics,
        g3, prob.loss,
    )
    perm = np.asarray(g3.perm)
    np.testing.assert_allclose(np.asarray(U3), np.asarray(U1), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gg3), np.asarray(gg1), rtol=1e-9, atol=1e-9)
    # V/h come back in grid-row order = valence-sorted landmark order
    np.testing.assert_allclose(np.asarray(V3), np.asarray(V1)[perm], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(h3), np.asarray(h1)[perm], rtol=1e-9, atol=1e-9)
    assert isinstance(W3, list) and len(W3) == len(g3.seg_bounds)
    assert abs(y3 - y1) < 1e-9 * max(1.0, y1)


def test_segmented_solve_matches_unsegmented():
    prob = make_skewed_ba(seed=5)
    r1 = ba_dense.solve_ba_dense(prob, grouped=ba_dense.group_by_landmark(prob))
    r3 = ba_dense.solve_ba_dense(
        prob, grouped=ba_dense.group_by_landmark(prob, segments=3)
    )
    f = np.finfo(np.asarray(prob.points).dtype)
    tol = 1e5 * f.eps
    assert abs(float(r1.cost) - float(r3.cost)) < tol * max(1.0, float(r1.cost))
    np.testing.assert_allclose(
        np.asarray(r3.camera_params), np.asarray(r1.camera_params),
        rtol=1e4 * f.eps, atol=1e4 * f.eps,
    )
    np.testing.assert_allclose(
        np.asarray(r3.points), np.asarray(r1.points),
        rtol=1e4 * f.eps, atol=1e4 * f.eps,
    )


def test_segmented_step_keeps_points_order_contract():
    """ba_step_dense's points contract is the problem's own landmark order,
    segmented or not."""
    prob = make_skewed_ba(seed=6)
    dtype = prob.points.dtype
    g1 = ba_dense.group_by_landmark(prob)
    g3 = ba_dense.group_by_landmark(prob, segments=3)
    lam0 = jnp.asarray(-1.0, dtype)
    cams1, pts1, *_ = ba_dense.ba_step_dense(prob, g1, lam0)
    cams3, pts3, *_ = ba_dense.ba_step_dense(prob, g3, lam0)
    f = np.finfo(np.asarray(prob.points).dtype)
    np.testing.assert_allclose(
        np.asarray(pts3), np.asarray(pts1), rtol=1e4 * f.eps, atol=1e4 * f.eps
    )
    np.testing.assert_allclose(
        np.asarray(cams3), np.asarray(cams1), rtol=1e4 * f.eps, atol=1e4 * f.eps
    )


def test_sharded_entry_flattens_segmented_grid():
    """solve_ba_dense_sharded accepts a segmented grid by flattening it back
    to landmark order (segments don't align with shard boundaries)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[: min(2, len(jax.devices()))])
    mesh = Mesh(devs, ("data",))
    prob = make_skewed_ba(seed=7)
    g3 = ba_dense.group_by_landmark(prob, segments=3)
    cfg = ba_dense.DenseBAConfig(max_iterations=3, schur_chunk=16)
    res_seg = ba_dense.solve_ba_dense_sharded(prob, mesh, cfg, grouped=g3)
    res_ref = ba_dense.solve_ba_dense(prob, cfg)
    f = np.finfo(np.asarray(prob.points).dtype)
    assert abs(float(res_seg.cost) - float(res_ref.cost)) < 1e5 * f.eps * max(
        1.0, float(res_ref.cost)
    )


def test_segmented_routing_rescues_large_hub():
    """A hub incidence whose single-K padding factor exceeds the dense
    bound routes dense once segmentation applies (L >= 1024): the hub only
    inflates its own one-row segment (ba.select_engine, r5)."""
    from test_ba_dense import make_hub_ba

    hub = make_hub_ba(C=25, L=2000)
    assert ba_dense.padding_factor(hub) > ba.DENSE_MAX_PADDING
    assert ba_dense.dense_slot_factor(hub) < 1.5
    assert ba.select_engine(hub) == "dense"

    # below the auto-policy L threshold the historical routing holds
    small_hub = make_hub_ba(C=25, L=500)
    assert ba.select_engine(small_hub) == "cg"


def test_plan_segments_mega_hub_fast_and_effective():
    """Thousands of distinct valences (a mega-hub) must not blow up the
    boundary search (candidates are subsampled) and the plan must still
    crush the padding: one 5000-valence row in a Poisson(5) field."""
    import time

    rng = np.random.default_rng(0)
    counts = np.sort(
        np.concatenate([[5000, 3000, 800], rng.poisson(5, 100_000)])
    )[::-1]
    t0 = time.perf_counter()
    bounds, cost = ba_dense._plan_segments(counts, 4)
    assert time.perf_counter() - t0 < 5.0
    full = len(counts) * int(counts[0])
    assert cost < 0.01 * full
    assert bounds[-1][0] == len(counts)
