"""ICP with real correspondence search (no index alignment) + NN kernel tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax.lie import se3
from moptimizer_jax.ops import nn_search
from moptimizer_jax.ops.nn_search import _nn_pallas, _nn_xla, nearest_neighbors
from moptimizer_jax.registration import icp
from moptimizer_jax import GemanMcClure


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    src = rng.uniform(0, 10, size=(4000, 3))
    x_true = np.array([0.3, -0.2, 0.4, 0.05, -0.04, 0.08])
    T = np.asarray(se3.transform_from_params6(jnp.asarray(x_true)))
    tgt = src @ T[:3, :3].T + T[:3, 3]
    perm = rng.permutation(len(tgt))  # destroy index alignment
    return jnp.asarray(src), jnp.asarray(tgt[perm]), x_true, T


def test_nn_xla_matches_numpy():
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.uniform(0, 10, (500, 3)), jnp.float32)
    p = jnp.asarray(rng.uniform(0, 10, (800, 3)), jnp.float32)
    d2 = ((np.asarray(q)[:, None] - np.asarray(p)[None]) ** 2).sum(-1)
    idx, dist = _nn_xla(q, p)
    np.testing.assert_array_equal(idx, d2.argmin(1))
    np.testing.assert_allclose(dist, d2.min(1), rtol=1e-4, atol=1e-4)


def test_nn_pallas_vpu_interpret_matches_numpy():
    """The Triton kernel in interpret mode: exact f32 distances, the
    running min across many target tiles, aligned and non-aligned sizes."""
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.uniform(0, 10, (640, 3)), jnp.float32)
    p = jnp.asarray(rng.uniform(0, 10, (1152, 3)), jnp.float32)
    d2 = ((np.asarray(q)[:, None] - np.asarray(p)[None]) ** 2).sum(-1)
    idx, dist = _nn_pallas(q, p, interpret=True)
    np.testing.assert_array_equal(idx, d2.argmin(1))
    np.testing.assert_allclose(dist, d2.min(1), rtol=1e-5, atol=1e-6)
    # non-aligned
    idx2, _ = _nn_pallas(q[:33], p[:77], interpret=True)
    np.testing.assert_array_equal(idx2, d2[:33, :77].argmin(1))


def _nn_case(name):
    """(query, points, expected first-argmin indices) of one kernel case."""
    rng = np.random.default_rng(21)
    if name == "ragged_query":  # Q not a multiple of the query block
        q = rng.uniform(0, 5, (nn_search.BLOCK_Q * 3 + 5, 3))
        p = rng.uniform(0, 5, (nn_search.BLOCK_P * 2, 3))
    elif name == "padding_never_wins":  # one real point, the rest padding
        q = rng.uniform(-1e3, 1e3, (40, 3))
        p = rng.uniform(0, 5, (1, 3))
    elif name == "far_queries":  # real points far away still beat padding
        q = rng.uniform(1e3, 2e3, (40, 3))
        p = rng.uniform(-100, 100, (nn_search.BLOCK_P + 3, 3))
    elif name == "exact_ties_first_index":  # duplicates inside one tile
        base = rng.uniform(0, 5, (20, 3))
        p = np.concatenate([base, base, base])
        q = base + 0.01
    else:  # "ties_across_tiles": a duplicate several tiles later
        base = rng.uniform(0, 5, (nn_search.BLOCK_P, 3))
        p = np.concatenate([base, rng.uniform(50, 60, (nn_search.BLOCK_P * 2, 3)), base])
        q = base[::-1] + 0.01
    q, p = q.astype(np.float32), p.astype(np.float32)
    d2 = ((q[:, None].astype(np.float64) - p[None]) ** 2).sum(-1)
    return q, p, d2.argmin(1)  # numpy argmin: first index of the minimum


@pytest.mark.parametrize(
    "case",
    ["ragged_query", "padding_never_wins", "far_queries", "exact_ties_first_index",
     "ties_across_tiles"],
)
def test_nn_kernel_interpret_cases(case):
    q, p, expect = _nn_case(case)
    idx, dist = _nn_pallas(jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_array_equal(idx, expect)
    assert np.all(np.isfinite(np.asarray(dist)))
    assert np.all(np.asarray(idx) < len(p))


def test_nn_unequal_sizes_and_padding():
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.uniform(0, 10, (33, 3)), jnp.float32)  # not tile-aligned
    p = jnp.asarray(rng.uniform(0, 10, (77, 3)), jnp.float32)
    d2 = ((np.asarray(q)[:, None] - np.asarray(p)[None]) ** 2).sum(-1)
    idx, _ = nearest_neighbors(q, p, backend="xla")
    np.testing.assert_array_equal(idx, d2.argmin(1))
    idx2, _ = _nn_pallas(q, p, interpret=True)
    np.testing.assert_array_equal(idx2, d2.argmin(1))


@pytest.mark.parametrize(
    "backend, interpret, expect",
    [("auto", False, "xla"), ("xla", False, "xla"), ("pallas", True, "pallas"),
     ("pallas", False, ValueError), ("bogus", False, ValueError)],
)
def test_nn_dispatch_off_gpu(monkeypatch, backend, interpret, expect):
    """Off a GPU, "auto" is the XLA scan; the kernel runs only when asked
    for with interpret=True — never a quiet interpretation or fallback."""
    assert jax.default_backend() == "cpu"
    calls = []
    monkeypatch.setattr(nn_search, "_nn_xla", lambda q, p, chunk: calls.append("xla"))
    monkeypatch.setattr(
        nn_search, "_nn_pallas", lambda q, p, interpret: calls.append("pallas")
    )
    q = jnp.zeros((4, 3), jnp.float32)
    if expect is ValueError:
        with pytest.raises(ValueError):
            nearest_neighbors(q, q, backend=backend, interpret=interpret)
        assert calls == []
    else:
        nearest_neighbors(q, q, backend=backend, interpret=interpret)
        assert calls == [expect]


@pytest.mark.gpu
def test_nn_kernel_on_gpu():
    """The compiled kernel (not the interpreter) against numpy."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernel is compiled only for the card")
    rng = np.random.default_rng(9)
    q = rng.uniform(0, 10, (3000, 3)).astype(np.float32)
    p = rng.uniform(0, 10, (5000, 3)).astype(np.float32)
    d2 = ((q[:, None].astype(np.float64) - p[None]) ** 2).sum(-1)
    idx, dist = nearest_neighbors(jnp.asarray(q), jnp.asarray(p), backend="auto")
    np.testing.assert_array_equal(idx, d2.argmin(1))
    np.testing.assert_allclose(dist, d2.min(1), rtol=1e-5, atol=1e-6)


def test_icp_unknown_correspondences(scene):
    """ICP recovers the transform from a shuffled target cloud — the full
    pipeline the reference never assembled."""
    src, tgt_shuffled, x_true, T_true = scene
    res = icp(src, tgt_shuffled, nn_backend="xla")
    T_est = np.asarray(se3.transform_from_params6(res.x))
    err = np.linalg.inv(T_est) @ T_true
    np.testing.assert_allclose(err[:3, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(err[:3, 3], 0.0, atol=1e-5)


def test_icp_with_outliers_and_robust_loss(scene):
    """Outlier target points + Geman-McClure + max correspondence distance."""
    src, tgt_shuffled, x_true, T_true = scene
    rng = np.random.default_rng(13)
    outliers = jnp.asarray(rng.uniform(50, 60, size=(500, 3)))
    tgt_noisy = jnp.concatenate([tgt_shuffled, outliers])
    res = icp(
        src,
        tgt_noisy,
        nn_backend="xla",
        loss=GemanMcClure(tau=jnp.asarray(1.0)),
        max_corr_dist=2.0,
    )
    T_est = np.asarray(se3.transform_from_params6(res.x))
    err = np.linalg.inv(T_est) @ T_true
    np.testing.assert_allclose(err[:3, :3], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(err[:3, 3], 0.0, atol=1e-4)


def test_gicp_unknown_correspondences(scene):
    """GICP (per-point covariances, state-dependent information) recovers the
    transform from a shuffled target cloud."""
    from moptimizer_jax.registration import gicp

    src, tgt_shuffled, x_true, T_true = scene
    res = gicp(src, tgt_shuffled, nn_backend="xla", k=8)
    T_est = np.asarray(se3.transform_from_params6(res.x))
    err = np.linalg.inv(T_est) @ T_true
    np.testing.assert_allclose(err[:3, :3], np.eye(3), atol=1e-4)
    np.testing.assert_allclose(err[:3, 3], 0.0, atol=1e-3)


def test_surface_normals_and_covariances():
    """PCA normals on a synthetic plane point along its true normal."""
    from moptimizer_jax.ops.surface import estimate_normals, gicp_covariances

    rng = np.random.default_rng(20)
    # plane z = 0.3x + 0.1y with small jitter
    xy = rng.uniform(0, 10, size=(2000, 2))
    z = 0.3 * xy[:, 0] + 0.1 * xy[:, 1] + 0.001 * rng.normal(size=2000)
    cloud = jnp.asarray(np.column_stack([xy, z]))
    n_true = np.array([-0.3, -0.1, 1.0])
    n_true /= np.linalg.norm(n_true)

    normals = np.asarray(estimate_normals(cloud, k=12, orient_to=[0, 0, 100.0]))
    dots = normals @ n_true
    assert np.mean(dots > 0.99) > 0.95

    covs = np.asarray(gicp_covariances(cloud, k=12, epsilon=1e-3))
    # smallest eigen-direction of C should be ~the normal, with eigenvalue ε
    w, v = np.linalg.eigh(covs[0])
    np.testing.assert_allclose(w[0], 1e-3, rtol=1e-3)
    assert abs(v[:, 0] @ n_true) > 0.99


# ---- point-to-plane front-end ---------------------------------------------


def _surface_scene(seed=21, n=6000):
    """Smooth surface-like cloud (normals well-defined) + known transform."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12, (n, 2))
    z = 0.5 * np.sin(xy[:, 0] * 0.8) * np.cos(xy[:, 1] * 0.6)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    x_true = jnp.asarray([0.08, -0.05, 0.03, 0.02, -0.015, 0.025], jnp.float32)
    T = np.asarray(se3.transform_from_params6(x_true))
    src = (tgt @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3]).astype(
        np.float32
    )
    return jnp.asarray(src), jnp.asarray(tgt), x_true


def test_point2plane_recovers_transform():
    from moptimizer_jax.registration import point2plane

    src, tgt, x_true = _surface_scene()
    res = point2plane(src, tgt, nn_backend="xla", max_corr_dist=0.5)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=2e-3)


def test_point2plane_registrar_and_register_pair():
    """method='point2plane' through PairwiseRegistrar and the pipeline API;
    compile-once across same-shape pairs."""
    from moptimizer_jax.odometry import register_pair
    from moptimizer_jax.registration import PairwiseRegistrar

    src, tgt, x_true = _surface_scene(seed=22)
    reg = PairwiseRegistrar(
        method="point2plane", max_corr_dist=0.5, nn_backend="xla"
    )
    res = reg.register(src, tgt)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_true), atol=2e-3)
    # second same-shape pair reuses the executable
    src2, tgt2, x_true2 = _surface_scene(seed=23)
    res2 = reg.register(src2, tgt2)
    np.testing.assert_allclose(np.asarray(res2.x), np.asarray(x_true2), atol=2e-3)
    assert reg._solve_brute._cache_size() == 1

    x, r = register_pair(src, tgt, method="point2plane", registrar=reg)
    np.testing.assert_allclose(np.asarray(x), np.asarray(res.x), atol=1e-7)


def test_point2plane_beats_point2point_on_smooth_surface():
    """On a smooth low-noise surface with sliding-prone geometry,
    point-to-plane converges at least as accurately as point-to-point from
    the same start — the reason the variant exists."""
    from moptimizer_jax.registration import icp, point2plane

    rng = np.random.default_rng(24)
    xy = rng.uniform(0, 12, (6000, 2))
    z = 0.25 * np.sin(xy[:, 0] * 0.5)  # weakly constrained along y
    tgt = np.column_stack([xy, z]).astype(np.float32)
    x_true = jnp.asarray([0.05, 0.0, 0.02, 0.0, 0.0, 0.01], jnp.float32)
    T = np.asarray(se3.transform_from_params6(x_true))
    src = jnp.asarray(
        (tgt @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3]).astype(
            np.float32
        )
    )
    tgtj = jnp.asarray(tgt)
    # observable components only (y-translation slides on this geometry)
    obs = np.array([0, 2, 3, 4, 5])
    r_p2p = icp(src, tgtj, nn_backend="xla", max_corr_dist=0.4)
    r_p2l = point2plane(src, tgtj, nn_backend="xla", max_corr_dist=0.4)
    e_p2p = np.abs(np.asarray(r_p2p.x) - np.asarray(x_true))[obs].max()
    e_p2l = np.abs(np.asarray(r_p2l.x) - np.asarray(x_true))[obs].max()
    assert e_p2l < 5e-3
    assert e_p2l <= e_p2p * 3  # and never catastrophically worse


def test_coarse_multistart_recovers_large_yaw():
    """coarse_multistart (r4): at 60° inter-scan yaw the single-start
    coarse pass lands in a wrong basin and the solve fails outright; 8
    yaw-rotated starts solved in one batched program recover exactly
    (the measured first-pair failure mode of PERF.md's p2plane
    section, fixed at the seeding level)."""
    from moptimizer_jax.registration import PairwiseRegistrar

    rng = np.random.default_rng(41)
    per = 1200
    s_ = 8.0
    u = rng.uniform(-s_, s_, size=(4, per))
    v = rng.uniform(0, 3.0, size=(4, per))
    walls = [
        np.column_stack([u[0], np.full(per, -s_), v[0]]),
        np.column_stack([u[1], np.full(per, s_), v[1]]),
        np.column_stack([np.full(per, -s_), u[2], v[2]]),
        np.column_stack([np.full(per, s_), u[3], v[3]]),
    ]
    g = rng.uniform(-s_, s_, size=(1200, 2))
    tgt = np.vstack(walls + [np.column_stack([g, np.zeros(1200)])]).astype(
        np.float32
    )
    tgt += 0.01 * rng.normal(size=tgt.shape).astype(np.float32)

    x_true = jnp.asarray([0.5, -0.4, 0.05, 0.0, 0.0, 1.05], jnp.float32)
    T = np.asarray(se3.transform_from_params6(x_true))
    src = (tgt @ np.linalg.inv(T)[:3, :3].T + np.linalg.inv(T)[:3, 3]).astype(
        np.float32
    )

    # coarse_multistart=0 forces the single-start coarse pass (since r5 the
    # DEFAULT is "auto" → 8 starts whenever a gate is set, which solves this)
    reg0 = PairwiseRegistrar(
        max_corr_dist=0.4, nn_backend="xla", coarse_multistart=0
    )
    err0 = float(
        jnp.max(jnp.abs(reg0.register(jnp.asarray(src), jnp.asarray(tgt)).x - x_true))
    )
    reg8 = PairwiseRegistrar(
        max_corr_dist=0.4, nn_backend="xla", coarse_multistart=8
    )
    err8 = float(
        jnp.max(jnp.abs(reg8.register(jnp.asarray(src), jnp.asarray(tgt)).x - x_true))
    )
    assert err0 > 0.5  # the documented single-start failure
    assert err8 < 1e-3  # multistart recovers (measured 3e-5)
