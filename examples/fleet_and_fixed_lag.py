"""Round-3 API tour: batched fleet registration + streaming fixed-lag SLAM.

Self-checking (asserts); runs on CPU or GPU:

    python examples/fleet_and_fixed_lag.py

1. `registration.icp_batched` — B full ICP solves (per-iteration NN
   correspondence updates) vmapped into ONE device program. On a GPU this is
   the serving path: ~100× single-solve throughput on small clouds
   (PERF.md "batched solves").
2. `solve_multistart` — best-of-B starts at ~the cost of one solve.
3. `odometry.scan_slam_fixed_lag` — streaming SLAM with bounded memory:
   the oldest pose Schur-marginalizes into a square-root prior instead of
   being discarded (core/prior.py; pose_graph.marginalize_oldest).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax.numpy as jnp

from moptimizer_jax import LMConfig, solve_multistart
from moptimizer_jax.core.residual import problem
from moptimizer_jax.lie import se3, so3
from moptimizer_jax.models.rational import SIMPLE_X, SIMPLE_Y, rational_block
from moptimizer_jax.odometry import scan_slam_fixed_lag
from moptimizer_jax.registration import icp_batched

rng = np.random.default_rng(0)

# --- 1. fleet registration: 4 scan pairs, one device program -------------
B, N = 4, 2000
srcs = rng.uniform(0, 10, (B, N, 3)).astype(np.float32)
x_true = (0.05 * rng.normal(size=(B, 6))).astype(np.float32)
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
res = icp_batched(jnp.asarray(srcs), jnp.asarray(tgts), max_corr_dist=1.0)
err = np.abs(np.asarray(res.x) - x_true).max()
print(f"[1] fleet ICP: {B} pairs in one program, max|x−x*| = {err:.2e}")
assert err < 1e-3

# --- 2. multistart: escape the wrong basin -------------------------------
blk = rational_block(SIMPLE_X, SIMPLE_Y, analytic=True, dtype=jnp.float32)
x0s = jnp.asarray([[0.9, 0.2], [50.0, -40.0], [-3.0, 0.01]], jnp.float32)
best, _ = solve_multistart(problem(blk), x0s, LMConfig(max_iterations=40))
print(f"[2] multistart best x = {np.asarray(best.x)} (expect ≈ [0.362, 0.556])")
assert np.allclose(np.asarray(best.x), [0.362, 0.556], atol=0.01)

# --- 3. streaming fixed-lag SLAM -----------------------------------------
def make_scans(k_scans=10, n=2048):
    per = n // 5
    s = 12.0
    u = rng.uniform(-s, s, size=(4, per))
    v = rng.uniform(0.0, 5.0, size=(4, per))
    walls = [
        np.column_stack([u[0], np.full(per, -s), v[0]]),
        np.column_stack([u[1], np.full(per, s), v[1]]),
        np.column_stack([np.full(per, -s), u[2], v[2]]),
        np.column_stack([np.full(per, s), u[3], v[3]]),
    ]
    g = rng.uniform(-s, s, size=(n - 4 * per, 2))
    world = np.vstack(walls + [np.column_stack([g, np.zeros(len(g))])])
    scans, Ts = [], []
    for k in range(k_scans):
        t = np.array([0.5 * k, 0.1 * k, 1.0])
        w = np.array([0.0, 0.0, 0.03 * k])
        T = np.asarray(se3.transform_from_params6(jnp.asarray(np.concatenate([t, w]), jnp.float32)))
        Ti = np.linalg.inv(T)
        local = world @ Ti[:3, :3].T + Ti[:3, 3]
        scans.append(jnp.asarray(local + 0.005 * rng.normal(size=local.shape), jnp.float32))
        Ts.append(T)
    # odometry convention: poses relative to scan 0 (P0 = I)
    T0i = np.linalg.inv(Ts[0])
    gts = []
    for T in Ts:
        Tr = T0i @ T
        gts.append(
            np.concatenate([Tr[:3, 3], np.asarray(so3.log(jnp.asarray(Tr[:3, :3], jnp.float32)))])
        )
    return scans, np.stack(gts)


scans, gt = make_scans()
poses = scan_slam_fixed_lag(
    scans, window=4, config=LMConfig(diff_mode="auto", max_iterations=30),
    max_corr_dist=0.5,
)
drift = np.abs(np.asarray(poses[-1][:3]) - gt[-1][:3]).max()
print(f"[3] fixed-lag SLAM over {len(scans)} scans (window 4): final-pose drift {drift:.3f} m")
assert drift < 0.05

print("fleet_and_fixed_lag: ALL OK")
