"""Voxel hash-grid NN: exactness vs brute force + ICP integration.

The grid must EQUAL the brute-force kernel (ops/nn_search.py) for every
query whose true NN distance is inside the neighborhood radius — on uniform
clouds, surface-like clouds (fachada), hash-collision-heavy clouds, and
out-of-range queries.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax.ops.grid_nn import (
    build_hash_grid,
    estimate_spacing,
    grid_nearest_neighbors,
)
from moptimizer_jax.ops.nn_search import nearest_neighbors


def _bruteforce_f64(query, points, chunk=2048):
    """Exact f64 numpy NN oracle (the Pallas/XLA kernels' ‖q‖²−2qp+‖p‖²
    expansion loses ~1e-3 relative in f32 and mis-ranks near-ties, so the
    production kernel is not a trustworthy exactness oracle)."""
    q = np.asarray(query, np.float64)
    p = np.asarray(points, np.float64)
    idx = np.empty(q.shape[0], np.int64)
    d2 = np.empty(q.shape[0], np.float64)
    for s in range(0, q.shape[0], chunk):
        block = q[s : s + chunk, None, :] - p[None, :, :]
        dist = np.einsum("qmk,qmk->qm", block, block)
        idx[s : s + chunk] = np.argmin(dist, axis=1)
        d2[s : s + chunk] = np.min(dist, axis=1)
    return idx, d2


def _check_exact(query, points, cell, rings=1):
    grid = build_hash_grid(points, cell)
    gi, gd = grid_nearest_neighbors(jnp.asarray(query), grid, rings=rings)
    gi, gd = np.asarray(gi), np.asarray(gd)
    bi, bd = _bruteforce_f64(query, points)

    in_range = bd < (rings * cell) ** 2 * (1 - 1e-5)  # exclude f32 knife edges
    mismatch = in_range & (gi != bi)
    if mismatch.any():
        # the only admissible mismatch is an exact-tie (duplicate points)
        d_alt = np.sum(
            (query[mismatch].astype(np.float64) - points[gi[mismatch]]) ** 2,
            axis=-1,
        )
        np.testing.assert_allclose(d_alt, bd[mismatch], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(
        gd[in_range], bd[in_range], rtol=1e-4, atol=1e-10
    )
    # whatever the grid returns is a real point at its true distance
    found = gi >= 0
    d_check = np.sum(
        (query[found].astype(np.float64) - points[gi[found]]) ** 2, axis=-1
    )
    np.testing.assert_allclose(gd[found], d_check, rtol=1e-4, atol=1e-10)
    return in_range.mean()


@pytest.mark.slow
def test_exact_uniform_cloud():
    rng = np.random.default_rng(0)
    points = rng.uniform(0, 10, (20000, 3)).astype(np.float32)
    query = rng.uniform(0, 10, (5000, 3)).astype(np.float32)
    frac = _check_exact(query, points, cell=0.5)
    assert frac > 0.99  # sanity: almost every query has an in-range NN


@pytest.mark.slow
def test_exact_fachada_scan():
    """Real LiDAR scan (29,310 points, reference tst/data/fachada.txt)."""
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    points = load_txt_cloud(data).astype(np.float32)
    rng = np.random.default_rng(1)
    # queries = jittered subsample (the ICP warm-start regime)
    sel = rng.choice(points.shape[0], 8000, replace=False)
    query = points[sel] + rng.normal(0, 0.05, (8000, 3)).astype(np.float32)
    spacing = estimate_spacing(points)
    frac = _check_exact(query, points, cell=5.0 * spacing)
    assert frac > 0.95


def test_exact_negative_coords_and_outliers():
    """Negative cells exercise the int→uint hash wrap; far queries must
    come back invalid (idx −1, d² inf)."""
    rng = np.random.default_rng(2)
    points = rng.uniform(-30, -10, (5000, 3)).astype(np.float32)
    query = np.concatenate(
        [
            rng.uniform(-30, -10, (2000, 3)),
            rng.uniform(100, 120, (100, 3)),  # nowhere near the cloud
        ]
    ).astype(np.float32)
    grid = build_hash_grid(points, 1.0)
    gi, gd = map(np.asarray, grid_nearest_neighbors(jnp.asarray(query), grid))
    # radius semantics: far queries are invalid even if a hash collision
    # surfaced some bucket — beyond-radius candidates are discarded
    assert (gi[-100:] == -1).all()
    assert np.isinf(gd[-100:]).all()
    _check_exact(query[:2000], points, cell=1.0)


@pytest.mark.slow
def test_exact_skewed_occupancy():
    """A dense clump + sparse halo: one slot holds hundreds of points (big K),
    exactness must survive bucket merging."""
    rng = np.random.default_rng(3)
    clump = rng.normal(0, 0.05, (3000, 3))
    halo = rng.uniform(-5, 5, (2000, 3))
    points = np.concatenate([clump, halo]).astype(np.float32)
    query = (points[::3] + rng.normal(0, 0.02, (points[::3].shape))).astype(
        np.float32
    )
    _check_exact(query, points, cell=1.0)


def test_rings_2_extends_radius():
    rng = np.random.default_rng(4)
    points = rng.uniform(0, 10, (3000, 3)).astype(np.float32)
    query = rng.uniform(0, 10, (500, 3)).astype(np.float32)
    frac1 = _check_exact(query, points, cell=0.2, rings=1)
    frac2 = _check_exact(query, points, cell=0.2, rings=2)
    assert frac2 >= frac1


def test_estimate_spacing_survives_duplicates():
    """Real LiDAR has exact duplicate points; the 2nd-NN distance is then
    zero and a naive estimate collapses (→ cell → 0 → K → M, the module's
    documented worst case). The estimator must skip zero-distance
    duplicates."""
    rng = np.random.default_rng(6)
    base = rng.uniform(0, 10, (4000, 3)).astype(np.float32)
    # triple every point: ≥2 exact duplicates for every sample
    points = np.concatenate([base, base, base])
    s_dup = estimate_spacing(points)
    s_clean = estimate_spacing(base)
    assert s_dup > 0
    # duplicates must not collapse the estimate; tripling the cloud leaves
    # the first positive-NN distance equal to the clean cloud's spacing
    np.testing.assert_allclose(s_dup, s_clean, rtol=0.35)

    # all-duplicate pathological cloud: loud failure, not a zero cell size
    with pytest.raises(ValueError):
        estimate_spacing(np.zeros((64, 3), np.float32))


@pytest.mark.slow
def test_exact_large_scale_default_heuristic():
    """>100k-point cloud with NO radius given: the production default
    (cell = 5× estimated spacing, registration.make_searcher) must still be
    exact vs brute force (the heuristic was previously
    untested past 30k points)."""
    rng = np.random.default_rng(7)
    # surface-like cloud (2.5D) — the LiDAR regime the heuristic targets
    xy = rng.uniform(0, 60, (150_000, 2))
    z = np.sin(xy[:, 0] * 0.3) + 0.1 * rng.normal(size=150_000)
    points = np.column_stack([xy, z]).astype(np.float32)
    query = (
        points[rng.choice(150_000, 4000, replace=False)]
        + rng.normal(0, 0.03, (4000, 3)).astype(np.float32)
    ).astype(np.float32)
    cell = 5.0 * estimate_spacing(points)
    frac = _check_exact(query, points, cell=cell)
    assert frac > 0.99


@pytest.mark.slow
def test_device_build_matches_host_build():
    """build_hash_grid_device ≡ build_hash_grid: same table shape, same
    bucket MEMBERSHIP per slot (content order may differ — sort
    tie-breaking), and identical query results."""
    from moptimizer_jax.ops.grid_nn import build_hash_grid_device

    rng = np.random.default_rng(9)
    points = np.concatenate(
        [
            rng.uniform(-5, 5, (20000, 3)),  # negative coords: hash wrap
            rng.normal(0, 0.05, (2000, 3)),  # dense clump: big buckets
        ]
    ).astype(np.float32)
    g_host = build_hash_grid(points, 0.7)
    g_dev = build_hash_grid_device(points, 0.7)

    assert g_host.table_idx.shape == g_dev.table_idx.shape
    hi, di = np.asarray(g_host.table_idx), np.asarray(g_dev.table_idx)
    for s in range(hi.shape[0]):
        assert set(hi[s][hi[s] >= 0]) == set(di[s][di[s] >= 0]), f"slot {s}"

    query = rng.uniform(-5, 5, (3000, 3)).astype(np.float32)
    ih, dh = map(np.asarray, grid_nearest_neighbors(jnp.asarray(query), g_host))
    idv, ddv = map(np.asarray, grid_nearest_neighbors(jnp.asarray(query), g_dev))
    np.testing.assert_allclose(dh, ddv, rtol=1e-6, equal_nan=False)
    # indices equal except exact-distance ties
    diff = ih != idv
    if diff.any():
        np.testing.assert_allclose(dh[diff], ddv[diff], rtol=1e-6)


def test_auto_routes_to_grid_at_scale(monkeypatch):
    """nn_backend='auto' must use the grid past the measured crossover when
    a correspondence gate is set (previously 'auto'
    never picked the grid). Distinguishable by semantics: the grid returns
    idx −1 / d² inf for queries beyond the gate radius, brute force returns
    the (far) true NN."""
    from moptimizer_jax import registration

    rng = np.random.default_rng(8)
    tgt = rng.uniform(0, 10, (2000, 3)).astype(np.float32)
    far_query = jnp.asarray([[500.0, 500.0, 500.0]], jnp.float32)

    monkeypatch.setattr(registration, "GRID_AUTO_MIN_TARGETS", 1000)
    searcher = registration.make_searcher(jnp.asarray(tgt), "auto", 1.0)
    idx, d2 = map(np.asarray, searcher(far_query))
    assert idx[0] == -1 and np.isinf(d2[0])  # grid radius semantics

    # ungated stays brute force (exact global NN however far)
    searcher = registration.make_searcher(jnp.asarray(tgt), "auto", None)
    idx, d2 = map(np.asarray, searcher(far_query))
    assert idx[0] >= 0 and np.isfinite(d2[0])

    # below the crossover stays brute force even gated
    monkeypatch.setattr(registration, "GRID_AUTO_MIN_TARGETS", 50_000)
    searcher = registration.make_searcher(jnp.asarray(tgt), "auto", 1.0)
    idx, d2 = map(np.asarray, searcher(far_query))
    assert idx[0] >= 0 and np.isfinite(d2[0])


def test_pairwise_registrar_compiles_once():
    """PairwiseRegistrar reuses one executable across same-shape pairs —
    the SLAM front-end property (measured: icp()'s per-call closures cost
    a recompile per pair). Also: results match
    the one-shot icp() path."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.registration import PairwiseRegistrar, icp

    rng = np.random.default_rng(12)
    reg = PairwiseRegistrar(max_corr_dist=2.0, nn_backend="grid")
    x_true = jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.01, 0.03], jnp.float32)
    T = se3.transform_from_params6(x_true)
    for seed in range(3):  # three different same-shape pairs
        src = jnp.asarray(
            np.random.default_rng(seed).uniform(0, 10, (3000, 3)).astype(np.float32)
        )
        tgt = src @ T[:3, :3].T + T[:3, 3]
        res = reg.register(src, tgt, x0=jnp.zeros(6, jnp.float32))
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=1e-4)
    # ONE fused build+solve executable serves every pair, including the
    # first (r5: the adaptive build only LEARNS capacities; the separate
    # prebuilt-grid solve stays uncompiled until an overflow redo needs it)
    assert reg._solve_grid_fused._cache_size() == 1
    assert reg._solve_grid._cache_size() == 0

    # parity with the one-shot icp() builder on the last pair
    res_icp = icp(src, tgt, jnp.zeros(6, jnp.float32), nn_backend="grid",
                  max_corr_dist=2.0,
                  config=reg.config)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(res_icp.x), atol=1e-6
    )


def test_pairwise_registrar_gicp():
    """GICP through the registrar: compile-once across same-shape pairs,
    matches the one-shot gicp() result."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.registration import PairwiseRegistrar, gicp

    rng = np.random.default_rng(14)
    # surface-like cloud so the GICP covariances are anisotropic
    xy = rng.uniform(0, 8, (2500, 2))
    z = 0.2 * np.sin(xy[:, 0]) + 0.01 * rng.normal(size=2500)
    src_np = np.column_stack([xy, z]).astype(np.float32)
    reg = PairwiseRegistrar(method="gicp", max_corr_dist=1.0)
    x_true = jnp.asarray([0.05, -0.03, 0.02, 0.01, -0.02, 0.03], jnp.float32)
    T = se3.transform_from_params6(x_true)
    for seed in range(2):
        src = jnp.asarray(src_np + 0.001 * np.random.default_rng(seed).normal(size=src_np.shape).astype(np.float32))
        tgt = src @ T[:3, :3].T + T[:3, 3]
        res = reg.register(src, tgt, x0=jnp.zeros(6, jnp.float32))
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=2e-3)
    assert reg._solve_brute._cache_size() == 1

    res_one = gicp(src, tgt, jnp.zeros(6, jnp.float32), max_corr_dist=1.0,
                   config=reg.config)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_one.x), atol=1e-5)


def test_build_validates():
    with pytest.raises(ValueError):
        build_hash_grid(np.zeros((5, 2)), 1.0)
    with pytest.raises(ValueError):
        build_hash_grid(np.zeros((5, 3)), 0.0)


def test_icp_grid_backend_recovers_transform():
    """icp(..., nn_backend='grid') end-to-end on the fachada scan, vs the
    same ground-truth-transform recovery the brute-force tests pin."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.registration import icp
    from moptimizer_jax.utils.pointcloud import load_txt_cloud

    data = pathlib.Path(__file__).parent / "data" / "fachada.txt"
    cloud = load_txt_cloud(data).astype(np.float32)[::4]
    src = jnp.asarray(cloud)
    x_true = jnp.asarray([0.4, -0.3, 0.2, 0.05, -0.04, 0.06], jnp.float32)
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]

    res = icp(src, tgt, nn_backend="grid", max_corr_dist=1.0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=2e-3)


def test_icp_grid_matches_bruteforce_trajectory():
    """Same solve with grid vs brute-force backends: identical converged x
    (every correspondence decision identical when all NNs are in range)."""
    from moptimizer_jax.lie import se3
    from moptimizer_jax.registration import icp

    rng = np.random.default_rng(5)
    src = jnp.asarray(rng.uniform(0, 10, (4000, 3)).astype(np.float32))
    x_true = jnp.asarray([0.2, -0.1, 0.15, 0.03, 0.02, -0.04], jnp.float32)
    T = se3.transform_from_params6(x_true)
    tgt = src @ T[:3, :3].T + T[:3, 3]

    res_grid = icp(src, tgt, nn_backend="grid", max_corr_dist=2.0)
    res_bf = icp(src, tgt, nn_backend="xla", max_corr_dist=2.0)
    np.testing.assert_allclose(
        np.asarray(res_grid.x), np.asarray(res_bf.x), atol=1e-5
    )


# ---- cell-major bucket join (r4) ----------------------------------------


def _both_modes(query, grid, **kw):
    qi, qd = grid_nearest_neighbors(jnp.asarray(query), grid, mode="query", **kw)
    ci, cd = grid_nearest_neighbors(jnp.asarray(query), grid, mode="auto", **kw)
    return np.asarray(qi), np.asarray(qd), np.asarray(ci), np.asarray(cd)


def test_cell_major_identical_to_query_major_uniform():
    """Same candidate enumeration order + f32 arithmetic → bitwise-equal
    results (incl. tie-breaks) on a uniform cloud with out-of-range rows."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-5, 5, size=(20_000, 3)).astype(np.float32)
    q = rng.uniform(-6, 6, size=(8_192, 3)).astype(np.float32)  # some misses
    grid = build_hash_grid(pts, 0.4)
    qi, qd, ci, cd = _both_modes(q, grid)
    np.testing.assert_array_equal(qi, ci)
    np.testing.assert_array_equal(qd, cd)


@pytest.mark.slow
def test_cell_major_identical_surface_cloud():
    """Surface-like (high-occupancy cells) — the regime the bucket join is
    for; also checks rings=2."""
    rng = np.random.default_rng(12)
    xy = rng.uniform(0, 20, size=(30_000, 2))
    z = np.sin(xy[:, :1]) * np.cos(xy[:, 1:]) + 0.01 * rng.normal(size=(30_000, 1))
    pts = np.concatenate([xy, z], axis=1).astype(np.float32)
    q = (pts + 0.05 * rng.normal(size=pts.shape)).astype(np.float32)
    grid = build_hash_grid(pts, 0.5)
    qi, qd, ci, cd = _both_modes(q, grid, rings=2)
    np.testing.assert_array_equal(qi, ci)
    np.testing.assert_array_equal(qd, cd)


def test_cell_major_exact_vs_f64_oracle():
    rng = np.random.default_rng(13)
    pts = rng.uniform(-3, 3, size=(15_000, 3)).astype(np.float32)
    q = (pts[:6000] + 0.03 * rng.normal(size=(6000, 3))).astype(np.float32)
    grid = build_hash_grid(pts, 0.3)
    gi, gd = grid_nearest_neighbors(jnp.asarray(q), grid, mode="auto")
    gi, gd = np.asarray(gi), np.asarray(gd)
    bi, bd = _bruteforce_f64(q, pts)
    in_range = bd < 0.3**2 * (1 - 1e-5)
    mism = in_range & (gi != bi)
    if mism.any():  # exact ties only
        d_alt = np.sum((q[mism].astype(np.float64) - pts[gi[mism]]) ** 2, -1)
        np.testing.assert_allclose(d_alt, bd[mism], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(gd[in_range], bd[in_range], rtol=1e-4, atol=1e-10)


def test_cell_major_fallback_capacity_overflow():
    """query_capacity smaller than the densest cell → the lax.cond falls
    back to the query-major path; results stay identical."""
    rng = np.random.default_rng(14)
    pts = rng.uniform(0, 4, size=(5_000, 3)).astype(np.float32)
    # pile 200 queries into one cell to force rank >= Kq
    q = np.concatenate(
        [
            rng.uniform(0, 4, size=(2_000, 3)),
            np.float32([[1.05, 1.05, 1.05]]) + 0.01 * rng.random((200, 3)),
        ]
    ).astype(np.float32)
    grid = build_hash_grid(pts, 0.5)
    qi, qd = grid_nearest_neighbors(jnp.asarray(q), grid, mode="query")
    ci, cd = grid_nearest_neighbors(
        jnp.asarray(q), grid, mode="auto", query_capacity=8
    )
    np.testing.assert_array_equal(np.asarray(qi), np.asarray(ci))
    np.testing.assert_array_equal(np.asarray(qd), np.asarray(cd))


def test_cell_major_fallback_extent():
    """Relative extent beyond 1024 cells/axis → fallback, same results."""
    rng = np.random.default_rng(15)
    pts = rng.uniform(0, 2, size=(3_000, 3)).astype(np.float32)
    q = pts[:500].copy()
    q[0] = [3000.0, 0.0, 0.0]  # 30,000 cells away at cell=0.1
    grid = build_hash_grid(pts, 0.1)
    qi, qd = grid_nearest_neighbors(jnp.asarray(q), grid, mode="query")
    ci, cd = grid_nearest_neighbors(jnp.asarray(q), grid, mode="auto")
    np.testing.assert_array_equal(np.asarray(qi), np.asarray(ci))
    np.testing.assert_array_equal(np.asarray(qd), np.asarray(cd))


def test_cell_major_duplicates_and_tiny():
    """Duplicate-heavy cloud (exact ties) and tiny query sets."""
    rng = np.random.default_rng(16)
    base = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    pts = np.concatenate([base, base, base])  # every point ×3
    q = (base[:100] + 0.01 * rng.normal(size=(100, 3))).astype(np.float32)
    grid = build_hash_grid(pts, 0.2)
    qi, qd, ci, cd = _both_modes(q, grid)
    np.testing.assert_array_equal(qi, ci)
    np.testing.assert_array_equal(qd, cd)
    # single query exercises the Q < 2 guard
    i1, d1 = grid_nearest_neighbors(jnp.asarray(q[:1]), grid)
    assert np.asarray(i1).shape == (1,)


def test_fixed_capacity_build_and_overflow_recovery():
    """build_hash_grid_fixed ≡ adaptive build at sufficient capacity; at
    insufficient capacity it flags overflow instead of silently corrupting
    the table; PairwiseRegistrar recovers by rebuilding (monotonic policy)."""
    from moptimizer_jax.ops.grid_nn import build_hash_grid_fixed
    from moptimizer_jax.registration import PairwiseRegistrar
    from moptimizer_jax.lie import se3

    rng = np.random.default_rng(31)
    pts = rng.uniform(0, 8, (6000, 3)).astype(np.float32)
    g_ref = build_hash_grid(pts, 0.5)
    g_fix, ovf = build_hash_grid_fixed(
        pts, 0.5, g_ref.n_slots, g_ref.bucket_size, g_ref.max_cell_occupancy
    )
    assert not bool(ovf)
    q = (pts[:2000] + 0.05 * rng.normal(size=(2000, 3))).astype(np.float32)
    i1, d1 = grid_nearest_neighbors(jnp.asarray(q), g_ref)
    i2, d2 = grid_nearest_neighbors(jnp.asarray(q), g_fix)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    # too-small K → overflow flag
    _, ovf2 = build_hash_grid_fixed(pts, 0.5, g_ref.n_slots, 1, 16)
    assert bool(ovf2)

    # registrar: seed policy on a SPARSE scan, then register a pair whose
    # target is 3× denser — overflow path must rebuild and stay correct
    sparse = rng.uniform(0, 20, (6000, 3)).astype(np.float32)
    dense = rng.uniform(0, 6, (6000, 3)).astype(np.float32)
    x_true = jnp.asarray([0.2, -0.1, 0.05, 0.01, 0.02, -0.015], jnp.float32)
    T = np.asarray(se3.transform_from_params6(x_true))
    reg = PairwiseRegistrar(max_corr_dist=0.5, nn_backend="grid")
    for tgt in (sparse, dense):
        src = (tgt @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3]).astype(np.float32)
        res = reg.register(jnp.asarray(src), jnp.asarray(tgt), x0=jnp.zeros(6, jnp.float32))
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=2e-3)
    # policy grew monotonically and kept the final capacities
    assert reg._grid_policy is not None
