"""Example: Schur-complement bundle adjustment on a synthetic scene.

    python examples/bundle_adjustment.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba
from moptimizer_jax.core.solver import Status
from moptimizer_jax.evaluation import ate_rmse


def main():
    rng = np.random.default_rng(0)
    C, L = 8, 200  # cameras, landmarks; every camera sees every landmark
    pts = rng.uniform(-3, 3, size=(L, 3)) + np.array([0.0, 0.0, 10.0])
    cams = np.stack(
        [
            np.concatenate(
                [[2.0 * i - (C - 1), 0.3 * rng.normal(), 0.0], 0.05 * rng.normal(size=3)]
            )
            for i in range(C)
        ]
    )
    prob = ba.BAProblem(
        camera_params=jnp.asarray(cams),
        points=jnp.asarray(pts),
        cam_idx=jnp.asarray(np.repeat(np.arange(C), L)),
        pt_idx=jnp.asarray(np.tile(np.arange(L), C)),
        pixels=jnp.zeros((C * L, 2)),
        intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0]),
        n_fixed_cameras=2,
    )
    pixels = jax.vmap(ba._project, (0, 0, None))(
        prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics
    )
    pixels = pixels + 0.3 * rng.normal(size=pixels.shape)  # 0.3 px noise
    gt_points = prob.points

    start = dataclasses.replace(
        prob,
        pixels=jnp.asarray(pixels),
        camera_params=jnp.asarray(
            cams + np.concatenate([np.zeros((2, 6)), 0.02 * rng.normal(size=(C - 2, 6))])
        ),
        points=jnp.asarray(pts + 0.1 * rng.normal(size=pts.shape)),
    )

    print(f"initial reprojection cost: {float(ba.compute_cost(start)):.1f}")
    res = ba.solve_ba(start, ba.BAConfig(max_iterations=30))
    print(f"final cost: {float(res.cost):.3f}  status = {Status(int(res.status)).name}")
    print(f"landmark ATE vs ground truth: {float(ate_rmse(res.points, gt_points)):.5f}")

    # At production scale prefer engine="auto": it routes to the dense-Schur
    # engine (explicit S + one Cholesky, valence-segmented observation
    # grid;
    # PERF.md) while camera count / grid shape / HBM allow, and falls
    # back to the matrix-free Schur-CG engine past those bounds:
    res_auto = ba.solve_ba(start, ba.BAConfig(max_iterations=30), engine="auto")
    print(f"engine='auto' final cost: {float(res_auto.cost):.3f}")


if __name__ == "__main__":
    main()
