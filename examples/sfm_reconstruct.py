"""Example: incremental structure-from-motion on top of the BA engine.

Counterpart of the reference's experimental OpenCV SfM driver
(/root/reference/experimental/src/scene_reconstruct.cpp:45-62 — excluded
from its default build, CMakeLists.txt:48-50): that program hands image
paths to cv::sfm::reconstruct; this one runs the same pipeline stages
from feature MATCHES (the engine's domain starts where the feature
extractor ends), each stage built on this framework:

1. two-view bootstrap: essential matrix from the normalized 8-point
   system, decomposed into (R, t) with the cheirality check;
2. triangulation: per-track DLT least squares;
3. incremental resection (PnP): each new camera's pose from its 2D-3D
   matches via the engine's own LM solver (a reprojection residual block);
4. global refinement: Schur-complement bundle adjustment (ba.solve_ba)
   after every few cameras and at the end.

Synthetic scene with pixel noise; prints per-stage stats and the final
similarity-aligned reconstruction error vs ground truth.

    python examples/sfm_reconstruct.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import dataclasses

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba
from moptimizer_jax.core.residual import make_block, problem
from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt
from moptimizer_jax.lie import se3, so3


# ---- classical two-view geometry (host-side numpy; runs once) ------------


def essential_8pt(x1, x2):
    """Essential matrix from ≥8 normalized correspondences (x1 ↔ x2).

    Linear 8-point system + projection onto the essential manifold
    (singular values (s, s, 0))."""
    A = np.stack(
        [
            x2[:, 0] * x1[:, 0], x2[:, 0] * x1[:, 1], x2[:, 0],
            x2[:, 1] * x1[:, 0], x2[:, 1] * x1[:, 1], x2[:, 1],
            x1[:, 0], x1[:, 1], np.ones(len(x1)),
        ],
        axis=1,
    )
    _, _, Vt = np.linalg.svd(A)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt = np.linalg.svd(E)
    s = (S[0] + S[1]) / 2.0
    return U @ np.diag([s, s, 0.0]) @ Vt


def decompose_essential(E, x1, x2):
    """(R, t) with the cheirality check: of the four decompositions, keep
    the one triangulating the most points in front of both cameras."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    best, best_count = None, -1
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
            P2 = np.hstack([R, t[:, None]])
            X = triangulate_dlt(P1, P2, x1, x2)
            z1 = X[:, 2]
            z2 = (X @ R.T + t)[:, 2]
            count = int(((z1 > 0) & (z2 > 0)).sum())
            if count > best_count:
                best, best_count = (R, t), count
    return best


def triangulate_dlt(P1, P2, x1, x2):
    """DLT triangulation of correspondences under projections P1, P2
    (normalized coordinates). Vectorized per-track 4×4 SVD."""
    n = len(x1)
    A = np.zeros((n, 4, 4))
    A[:, 0] = x1[:, 0, None] * P1[2] - P1[0]
    A[:, 1] = x1[:, 1, None] * P1[2] - P1[1]
    A[:, 2] = x2[:, 0, None] * P2[2] - P2[0]
    A[:, 3] = x2[:, 1, None] * P2[2] - P2[1]
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1]
    return X[:, :3] / X[:, 3:4]


def triangulate_multi(cam_params, intr, obs_cam, obs_px):
    """Triangulate ONE track from ≥2 observations (camera params6 list)."""
    fx, fy, cx, cy = intr
    rows = []
    for c, px in zip(obs_cam, obs_px):
        T = np.asarray(se3.transform_from_params6(jnp.asarray(c)))
        P = T[:3, :]  # normalized projection (world → cam)
        xn = np.array([(px[0] - cx) / fx, (px[1] - cy) / fy])
        rows.append(xn[0] * P[2] - P[0])
        rows.append(xn[1] * P[2] - P[1])
    A = np.stack(rows)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]


# ---- resection (PnP) through the engine's LM solver ----------------------


def resect_camera(points3d, pixels, intrinsics, x0):
    """Camera pose from 2D-3D matches: minimize reprojection error over the
    6-DoF params with the engine's own LM (the reference camera-calibration
    residual, tst/camera_calibration.cpp, generalized to any point set)."""

    def residual(x, d):
        return ba._residual(x, d["pt"], d["px"], jnp.asarray(intrinsics))

    blk = make_block(
        residual,
        data=dict(pt=jnp.asarray(points3d), px=jnp.asarray(pixels)),
        name="resection",
    )
    cfg = LMConfig(diff_mode="auto", linear_solver="cholesky", max_iterations=20)
    return levenberg_marquardt(problem(blk), jnp.asarray(x0), cfg)


# ---- the pipeline ---------------------------------------------------------


def make_scene(rng, C=8, L=300, noise_px=0.4):
    """Cameras on an arc looking at a landmark cloud; full visibility."""
    pts = rng.uniform(-4, 4, size=(L, 3)) + np.array([0.0, 0.0, 12.0])
    cams = []
    for i in range(C):
        th = 0.12 * (i - C / 2)
        t = np.array([6.0 * np.sin(th), 0.4 * rng.normal(), 12.0 * (1 - np.cos(th))])
        w = np.asarray(so3.log(jnp.asarray(_yaw_pitch(th))))
        # world→camera params: camera at pose (R,t) world means T_wc⁻¹
        T = np.eye(4)
        T[:3, :3] = _yaw_pitch(th)
        T[:3, 3] = t
        Ti = np.linalg.inv(T)
        cams.append(
            np.concatenate([Ti[:3, 3], np.asarray(so3.log(jnp.asarray(Ti[:3, :3])))])
        )
    cams = np.stack(cams)
    intr = np.array([520.0, 520.0, 320.0, 240.0])
    obs_px = np.zeros((C, L, 2))
    for c in range(C):
        for l in range(L):
            obs_px[c, l] = np.asarray(
                ba._project(
                    jnp.asarray(cams[c]), jnp.asarray(pts[l]), jnp.asarray(intr)
                )
            )
    obs_px += noise_px * rng.normal(size=obs_px.shape)
    return cams, pts, intr, obs_px


def _yaw_pitch(th):
    c, s = np.cos(-th * 0.8), np.sin(-th * 0.8)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def aligned_error(est_pts, gt_pts):
    """RMS landmark error after similarity (Umeyama) alignment — the gauge
    (scale + global pose) is unobservable in SfM."""
    mu_e, mu_g = est_pts.mean(0), gt_pts.mean(0)
    E0, G0 = est_pts - mu_e, gt_pts - mu_g
    U, S, Vt = np.linalg.svd(G0.T @ E0 / len(E0))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    scale = np.trace(np.diag(S) @ D) / (E0**2).mean(0).sum()
    aligned = scale * E0 @ R.T + mu_g
    return float(np.sqrt(((aligned - gt_pts) ** 2).sum(1).mean()))


def run(C=8, L=300, seed=0, refine_every=3, verbose=True):
    rng = np.random.default_rng(seed)
    cams_gt, pts_gt, intr, obs_px = make_scene(rng, C, L)
    fx, fy, cx, cy = intr

    def norm_px(px):
        return np.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy], axis=1)

    # --- stage 1: two-view bootstrap (cameras 0, 1)
    x1, x2 = norm_px(obs_px[0]), norm_px(obs_px[1])
    E = essential_8pt(x1, x2)
    R, t = decompose_essential(E, x1, x2)
    # camera 0 at identity; camera 1 = (R, t) up to scale
    cam_est = [np.zeros(6)]
    cam_est.append(np.concatenate([t, np.asarray(so3.log(jnp.asarray(R)))]))
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([R, t[:, None]])
    pts_est = triangulate_dlt(P1, P2, x1, x2)
    if verbose:
        print(f"bootstrap: {len(pts_est)} landmarks triangulated from views 0-1")

    def run_ba(n_cams):
        prob = ba.BAProblem(
            camera_params=jnp.asarray(np.stack(cam_est)),
            points=jnp.asarray(pts_est),
            cam_idx=jnp.asarray(np.repeat(np.arange(n_cams), L)),
            pt_idx=jnp.asarray(np.tile(np.arange(L), n_cams)),
            pixels=jnp.asarray(obs_px[:n_cams].reshape(-1, 2)),
            intrinsics=jnp.asarray(intr),
            n_fixed_cameras=1,
        )
        res = ba.solve_ba(prob, ba.BAConfig(max_iterations=20))
        return np.asarray(res.camera_params), np.asarray(res.points), res

    # refine the two-view seed
    cams_np, pts_est, res = run_ba(2)
    cam_est = list(cams_np)

    # --- stages 2-3: incremental resection + periodic refinement
    for c in range(2, C):
        x0 = cam_est[-1]  # previous camera seeds the next
        r = resect_camera(pts_est, obs_px[c], intr, x0)
        cam_est.append(np.asarray(r.x))
        if verbose:
            print(
                f"resected camera {c}: reprojection cost "
                f"{float(r.cost) / L:.3f} px² /obs"
            )
        if (c + 1) % refine_every == 0 or c == C - 1:
            cams_np, pts_est, res = run_ba(c + 1)
            cam_est = list(cams_np)
            if verbose:
                print(
                    f"  BA over {c + 1} cams: cost/obs "
                    f"{float(res.cost) / ((c + 1) * L):.4f} px², "
                    f"{int(res.iterations)} iters"
                )

    err = aligned_error(pts_est, pts_gt)
    rms_px = float(np.sqrt(float(res.cost) / (C * L * 2)))
    if verbose:
        print(
            f"final: {C} cameras, {L} landmarks — aligned landmark RMS "
            f"{err:.4f} (scene extent ~8), reprojection RMS {rms_px:.3f} px"
        )
    return err, rms_px


def main():
    err, rms_px = run()
    assert err < 0.05, err  # pinned: ~6e-3 measured at 0.4 px noise
    assert rms_px < 1.0, rms_px
    print("OK")


if __name__ == "__main__":
    main()
