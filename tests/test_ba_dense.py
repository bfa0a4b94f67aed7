"""Dense-Schur BA engine: grouping, algebra vs the CG engine, convergence.

The dense engine must be algebraically identical to ba.py's matrix-free
engine (same GN blocks, same LM schedule); only the linear-system path
differs (explicit S + Cholesky vs matrix-free CG). So the two engines'
trajectories agree to solver tolerance, and both match the dense
(6C+3L)-oracle step."""

import dataclasses

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba, ba_dense
from moptimizer_jax.core.loss import Huber
from moptimizer_jax.core.solver import Status

from test_ba import make_synthetic_ba


def test_grouping_roundtrip():
    """The (L, K) grid contains exactly the original observations."""
    start, _ = make_synthetic_ba(C=5, L=17, noise=0.5, seed=3)
    g = ba_dense.group_by_landmark(start)
    L = start.points.shape[0]
    K = g.pixels.shape[1]
    assert g.pixels.shape == (L, K, 2)
    # every original observation appears in its landmark's row
    pix = np.asarray(start.pixels)
    cam = np.asarray(start.cam_idx)
    pt = np.asarray(start.pt_idx)
    gm = np.asarray(g.mask)
    gp = np.asarray(g.pixels)
    gc = np.asarray(g.cam_ids)
    assert gm.sum() == len(pt)
    for o in range(len(pt)):
        row = gp[pt[o]][gm[pt[o]] > 0]
        cams_row = gc[pt[o]][gm[pt[o]] > 0]
        hits = np.where((np.abs(row - pix[o]) < 1e-12).all(axis=1))[0]
        assert len(hits) >= 1
        assert cam[o] in cams_row


def test_grouped_cost_matches_flat():
    start, _ = make_synthetic_ba(C=4, L=23, noise=1.0, seed=1)
    g = ba_dense.group_by_landmark(start)
    c_flat = float(ba.compute_cost(start))
    c_grp = float(
        ba_dense._cost_grouped(
            start.camera_params, start.points, start.intrinsics, g
        )
    )
    assert abs(c_flat - c_grp) < 1e-9 * max(1.0, abs(c_flat))


def test_gn_blocks_match_flat_engine():
    """U, V, g, h from the grouped/one-hot path ≡ the flat segment_sum path."""
    start, _ = make_synthetic_ba(C=4, L=19, noise=0.8, seed=2)
    g = ba_dense.group_by_landmark(start)
    C = start.camera_params.shape[0]

    r_f, A_f, B_f = ba._linearize(start)
    U_f, V_f, W_f, g_f, h_f = ba._gn_blocks(start, r_f, A_f, B_f)

    r, A, B = ba_dense._linearize_grouped(
        start.camera_params, start.points, start.intrinsics, g
    )
    U, V, W, gg, h = ba_dense._gn_blocks_grouped(g, r, A, B, C, start.loss)

    np.testing.assert_allclose(np.asarray(U), np.asarray(U_f), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(V), np.asarray(V_f), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gg), np.asarray(g_f), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_f), rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_analytic_jacobians_match_ad():
    """The closed-form A, B (cached R/t/Jr path) ≡ jacfwd of ba._residual."""
    start, _ = make_synthetic_ba(C=5, L=21, noise=0.7, seed=9)
    g = ba_dense.group_by_landmark(start)
    r, A, B = ba_dense._linearize_grouped(
        start.camera_params, start.points, start.intrinsics, g
    )

    gm = np.asarray(g.mask)
    gc = np.asarray(g.cam_ids)
    gp = np.asarray(g.pixels)
    for l in range(0, 21, 5):
        for k in range(gm.shape[1]):
            if gm[l, k] == 0:
                continue
            cam = start.camera_params[gc[l, k]]
            pt = start.points[l]
            pix = jnp.asarray(gp[l, k])
            r_ad = ba._residual(cam, pt, pix, start.intrinsics)
            A_ad = jax.jacfwd(ba._residual, argnums=0)(cam, pt, pix, start.intrinsics)
            B_ad = jax.jacfwd(ba._residual, argnums=1)(cam, pt, pix, start.intrinsics)
            np.testing.assert_allclose(np.asarray(r[l, k]), np.asarray(r_ad), rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(np.asarray(A[l, k]), np.asarray(A_ad), rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(np.asarray(B[l, k]), np.asarray(B_ad), rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_dense_step_matches_dense_oracle():
    """One damped dense-Schur solve ≡ the full (6C+3L) dense damped solve."""
    start, _ = make_synthetic_ba(C=4, L=12, noise=0.5, seed=5, n_fixed=1)
    g = ba_dense.group_by_landmark(start)
    C = start.camera_params.shape[0]
    L = start.points.shape[0]
    dtype = start.camera_params.dtype
    lam = jnp.asarray(1e-3, dtype)

    r, A, B = ba_dense._linearize_grouped(
        start.camera_params, start.points, start.intrinsics, g
    )
    U, V, W, gg, h = ba_dense._gn_blocks_grouped(g, r, A, B, C, start.loss)
    fixed_mask = (jnp.arange(C) >= start.n_fixed_cameras).astype(dtype)
    d_cam, d_pt = ba_dense._solve_delta_dense(
        g, C, U, V, W, gg, h, lam, fixed_mask, chunk=5
    )

    # dense oracle on the flat problem (same construction as test_ba's oracle)
    r_f, A_f, B_f = ba._linearize(start)
    O = r_f.shape[0]
    n = 6 * C + 3 * L
    J = np.zeros((2 * O, n))
    for o in range(O):
        c = int(start.cam_idx[o])
        l = int(start.pt_idx[o])
        J[2 * o : 2 * o + 2, 6 * c : 6 * c + 6] = np.asarray(A_f[o])
        J[2 * o : 2 * o + 2, 6 * C + 3 * l : 6 * C + 3 * l + 3] = np.asarray(B_f[o])
    rv = np.asarray(r_f).reshape(-1)
    H = J.T @ J
    b = J.T @ rv
    Hd = H + float(lam) * np.diag(np.diag(H)) + 1e-12 * np.eye(n)
    # gauge fixing: remove fixed-camera columns
    keep = np.ones(n, dtype=bool)
    keep[: 6 * start.n_fixed_cameras] = False
    delta = np.zeros(n)
    delta[keep] = np.linalg.solve(Hd[np.ix_(keep, keep)], -b[keep])

    got = np.concatenate(
        [np.asarray(d_cam).reshape(-1), np.asarray(d_pt).reshape(-1)]
    )
    np.testing.assert_allclose(got, delta, rtol=1e-6, atol=1e-9)


def test_dense_engine_matches_cg_engine_trajectory():
    start, _ = make_synthetic_ba(C=5, L=40, noise=0.2, seed=7)
    res_cg = ba.solve_ba(start, ba.BAConfig(max_iterations=8, cg_iterations=200,
                                            cg_tol=1e-12))
    res_d = ba_dense.solve_ba_dense(
        start, ba_dense.DenseBAConfig(max_iterations=8)
    )
    np.testing.assert_allclose(
        np.asarray(res_d.camera_params),
        np.asarray(res_cg.camera_params),
        rtol=1e-5,
        atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(res_d.trace["cost"]),
        np.asarray(res_cg.trace["cost"]),
        rtol=1e-6,
        atol=1e-10,
    )


def test_dense_converges_to_ground_truth():
    start, gt = make_synthetic_ba(C=4, L=30, noise=0.0, seed=0)
    res = ba_dense.solve_ba_dense(start, ba_dense.DenseBAConfig(max_iterations=20))
    assert float(res.cost) < 1e-10
    np.testing.assert_allclose(
        np.asarray(res.camera_params), np.asarray(gt.camera_params), atol=1e-5
    )


def test_dense_robust_loss_and_fixed_cameras():
    start, gt = make_synthetic_ba(C=4, L=30, noise=0.1, seed=4, n_fixed=2)
    # corrupt a few observations
    pix = np.asarray(start.pixels).copy()
    pix[::11] += 80.0
    start = dataclasses.replace(
        start, pixels=jnp.asarray(pix), loss=Huber(delta=2.0)
    )
    res = ba_dense.solve_ba_dense(start, ba_dense.DenseBAConfig(max_iterations=25))
    # fixed cameras untouched
    np.testing.assert_array_equal(
        np.asarray(res.camera_params[:2]), np.asarray(start.camera_params[:2])
    )
    # inliers still well explained despite outliers
    med = np.median(
        np.linalg.norm(
            np.asarray(ba.residuals_all(
                dataclasses.replace(
                    start, camera_params=res.camera_params, points=res.points
                )
            )),
            axis=1,
        )
    )
    assert med < 1.0


def test_dense_sharded_matches_single_device():
    """Landmark-sharded dense-Schur solve ≡ single-device solve (8-device
    CPU mesh, L=41 deliberately not a shard multiple → exercises padding).

    This is the dense engine's shard-invariance test — the distributed-BA
    analogue of the reference's split-cost invariance
    (tst/multiple_objectives.cpp) run over a mesh the reference lacks."""
    from moptimizer_jax.parallel import make_mesh

    start, _ = make_synthetic_ba(C=5, L=41, noise=0.3, seed=13)
    cfg = ba_dense.DenseBAConfig(max_iterations=10, schur_chunk=8)
    res1 = ba_dense.solve_ba_dense(start, cfg)
    res8 = ba_dense.solve_ba_dense_sharded(start, make_mesh(8), cfg)

    # psum tree order ≠ single-device sum order at the FP level, so the
    # SMALL_DELTA stop may trigger one iteration apart; the trajectory over
    # the common prefix and the converged state must agree.
    it1, it8 = int(res1.iterations), int(res8.iterations)
    assert abs(it8 - it1) <= 1, (it1, it8)
    n = min(it1, it8)
    np.testing.assert_allclose(
        np.asarray(res8.trace["cost"])[:n],
        np.asarray(res1.trace["cost"])[:n],
        rtol=1e-9,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res8.camera_params),
        np.asarray(res1.camera_params),
        rtol=1e-7,
        atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(res8.points), np.asarray(res1.points), rtol=1e-7, atol=1e-10
    )


def test_dense_sharded_shard_count_invariance():
    """1-, 2- and 8-way landmark sharding give the same trajectory."""
    from moptimizer_jax.parallel import make_mesh

    start, _ = make_synthetic_ba(C=4, L=24, noise=0.5, seed=21)
    cfg = ba_dense.DenseBAConfig(max_iterations=6, schur_chunk=4)
    results = [
        ba_dense.solve_ba_dense_sharded(start, make_mesh(n), cfg)
        for n in (1, 2, 8)
    ]
    for res in results[1:]:
        np.testing.assert_allclose(
            np.asarray(res.camera_params),
            np.asarray(results[0].camera_params),
            rtol=1e-9,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(res.cost), np.asarray(results[0].cost), rtol=1e-9
        )


def test_dense_uneven_valence():
    """Landmarks with wildly different observation counts (padding stress)."""
    rng = np.random.default_rng(11)
    C, L = 6, 15
    dtype = jnp.float64
    pts = rng.uniform(-2, 2, size=(L, 3)) + np.array([0.0, 0.0, 8.0])
    cams = np.stack(
        [
            np.concatenate(
                [[1.2 * i - 3.0, 0.1 * rng.normal(), 0.0], 0.03 * rng.normal(size=3)]
            )
            for i in range(C)
        ]
    )
    # landmark l seen by (l % C) + 1 cameras
    cam_idx, pt_idx = [], []
    for l in range(L):
        for c in range((l % C) + 1):
            cam_idx.append(c)
            pt_idx.append(l)
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    prob = ba.BAProblem(
        camera_params=jnp.asarray(cams, dtype),
        points=jnp.asarray(pts, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        pixels=jnp.zeros((len(cam_idx), 2), dtype),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0], dtype),
        n_fixed_cameras=2,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(
        prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics
    )
    prob = dataclasses.replace(prob, pixels=pixels)
    start = dataclasses.replace(
        prob,
        camera_params=prob.camera_params
        + 0.01 * jnp.asarray(rng.normal(size=cams.shape), dtype)
        * (jnp.arange(C) >= 2)[:, None],
        points=prob.points + 0.05 * jnp.asarray(rng.normal(size=pts.shape), dtype),
    )
    res = ba_dense.solve_ba_dense(start, ba_dense.DenseBAConfig(max_iterations=25))
    assert float(res.cost) < 1e-9
    assert int(res.status) in (
        int(Status.CONVERGED),
        int(Status.SMALL_DELTA),
        int(Status.MAXIMUM_ITERATIONS_REACHED),
    )


# ---------------------------------------------------------------------------
# engine="auto" routing + padding guard (hub-landmark / skewed valence)


def make_hub_ba(C=25, L=500, seed=2, dtype=jnp.float64):
    """Skewed-valence problem: landmark 0 is a hub observed by EVERY camera;
    every other landmark is observed by exactly one camera (round-robin).
    K = C while mean valence ≈ 1, so the (L·K)/O padding factor blows up —
    the case ba_dense's grouping is worst at (ba_dense.py module docstring)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(L, 3)) + np.array([0.0, 0.0, 8.0])
    cams = np.stack(
        [
            np.concatenate(
                [[1.5 * i - 0.75 * (C - 1), 0.3 * rng.normal(), 0.0],
                 0.05 * rng.normal(size=3)]
            )
            for i in range(C)
        ]
    )
    pt_idx = np.concatenate([np.zeros(C, np.int64), np.arange(1, L)])
    cam_idx = np.concatenate([np.arange(C), np.arange(L - 1) % C])
    O = len(pt_idx)
    gt = ba.BAProblem(
        camera_params=jnp.asarray(cams, dtype),
        points=jnp.asarray(pts, dtype),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        pixels=jnp.zeros((O, 2), dtype),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0], dtype),
        n_fixed_cameras=2,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(
        gt.camera_params[gt.cam_idx], gt.points[gt.pt_idx], gt.intrinsics
    )
    return dataclasses.replace(gt, pixels=jnp.asarray(pixels, dtype))


def test_padding_factor():
    """Exact padding factor on uniform and hub incidences."""
    start, _ = make_synthetic_ba(C=4, L=30)  # every camera sees every point
    assert ba_dense.padding_factor(start) == 1.0  # K = C, O = C·L

    hub = make_hub_ba(C=25, L=500)
    O = 25 + 499
    assert ba_dense.padding_factor(hub) == 500 * 25 / O
    assert ba_dense.padding_factor(hub) > ba.DENSE_MAX_PADDING


def test_engine_auto_routing():
    """auto → dense for well-shaped problems, cg past the padding guard."""
    start, _ = make_synthetic_ba(C=4, L=30)
    assert ba.select_engine(start) == "dense"
    assert ba.select_engine(make_hub_ba()) == "cg"


def test_engine_auto_oom_guard(monkeypatch):
    """A problem whose estimated dense-engine HBM footprint exceeds
    DENSE_MAX_BYTES routes to CG instead of OOMing.

    The estimate is shape-only (dense_memory_bytes), so the wiring is pinned
    by shrinking the budget below a small problem's footprint; the estimator
    itself is pinned against its documented cost model."""
    start, _ = make_synthetic_ba(C=4, L=30)
    est = ba_dense.dense_memory_bytes(start)
    # cost model: 250 B per (L,K) grid slot + S and its factor
    K = 4  # every camera sees every point in make_synthetic_ba
    assert est == 250.0 * 30 * K + 8.0 * (6 * 4) ** 2

    assert ba.select_engine(start) == "dense"
    monkeypatch.setattr(ba, "DENSE_MAX_BYTES", est - 1)
    assert ba.select_engine(start) == "cg"


def test_engine_auto_runs_both_routes():
    """solve_ba(engine=...) executes and both engines agree on a moderate
    hub problem (same GN algebra; only the camera-system solver differs)."""
    # moderate skew: hub seen by all 5 cameras, rest seen by 2 → routes dense
    start, _ = make_synthetic_ba(C=5, L=24, noise=0.3, seed=17)
    cfg = ba.BAConfig(max_iterations=8)
    res_auto = ba.solve_ba(start, cfg, engine="auto")
    res_cg = ba.solve_ba(start, cfg, engine="cg")
    assert float(res_auto.cost) <= 1.001 * float(res_cg.cost) + 1e-9

    import pytest

    with pytest.raises(ValueError):
        ba.solve_ba(start, cfg, engine="bogus")


def test_hub_problem_cg_solves():
    """The padding-guard fallback actually works on the skewed problem."""
    hub = make_hub_ba(C=6, L=60)
    start = dataclasses.replace(
        hub,
        camera_params=hub.camera_params
        + 0.01
        * jnp.asarray(
            np.random.default_rng(0).normal(size=hub.camera_params.shape)
        )
        * (jnp.arange(6) >= 2)[:, None],
    )
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=12), engine="auto")
    assert float(res.cost) < 1e-6  # noiseless pixels → near-zero reprojection


# ---------------------------------------------------------------------------
# sharded engine with robust loss + gauge fixing


def test_dense_sharded_robust_loss_and_fixed_cameras():
    """Sharded dense engine ≡ single-device with Huber loss + 2 fixed
    cameras (the branches the r1 shard-invariance tests left unpinned)."""
    from moptimizer_jax.parallel import make_mesh

    start, _ = make_synthetic_ba(C=5, L=23, noise=0.4, seed=29, n_fixed=2)
    # inject outliers so the robust weights actually vary
    pix = np.array(start.pixels)
    pix[::7] += 40.0
    start = dataclasses.replace(
        start, pixels=jnp.asarray(pix), loss=Huber(delta=5.0)
    )
    cfg = ba_dense.DenseBAConfig(max_iterations=8, schur_chunk=4)
    res1 = ba_dense.solve_ba_dense(start, cfg)
    res8 = ba_dense.solve_ba_dense_sharded(start, make_mesh(8), cfg)

    np.testing.assert_allclose(
        np.asarray(res8.camera_params),
        np.asarray(res1.camera_params),
        rtol=1e-9,
        atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res8.points), np.asarray(res1.points), rtol=1e-9, atol=1e-12
    )
    # gauge fixing respected on both paths
    np.testing.assert_array_equal(
        np.asarray(res8.camera_params[:2]), np.asarray(start.camera_params[:2])
    )
    np.testing.assert_allclose(
        np.asarray(res8.trace["cost"]), np.asarray(res1.trace["cost"]),
        rtol=1e-9, atol=1e-12,
    )


def test_schur_precision_convergence_equivalent():
    """schur_precision perturbs only the GN step (costs/ρ stay exact):
    final costs after a full solve agree tightly across settings. On CPU
    the setting is a no-op numerically (on a GPU it allows TF32) — this
    pins the PLUMBING; the on-card cost agreement at O=500k is checked by
    chip_smoke.py's ba phase (PERF.md)."""
    prob, _gt = make_synthetic_ba(C=6, L=60, noise=0.5, seed=11)
    res_hi = ba_dense.solve_ba_dense(
        prob, ba_dense.DenseBAConfig(max_iterations=10, schur_precision="highest")
    )
    res_lo = ba_dense.solve_ba_dense(
        prob, ba_dense.DenseBAConfig(max_iterations=10, schur_precision="default")
    )
    np.testing.assert_allclose(
        float(res_lo.cost), float(res_hi.cost), rtol=1e-4
    )
