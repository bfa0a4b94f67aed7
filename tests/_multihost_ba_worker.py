"""Worker for tests/test_multihost.py — 2-process distributed dense-Schur BA.

Extends the curve-fitting multihost coverage to the
landmark-sharded dense-Schur engine: a real jax.distributed coordinator,
a 4-device mesh spanning 2 processes, the (L, K) grid sharded along L with
cross-process psums of the camera-space Schur objects. The distributed
result must match a process-local single-device dense solve of the same
problem.

Usage: python _multihost_ba_worker.py <process_id> <port>
"""

import dataclasses
import os
import sys

proc_id = int(sys.argv[1])
port = sys.argv[2]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from moptimizer_jax import ba, ba_dense  # noqa: E402
from moptimizer_jax.parallel import multihost  # noqa: E402

multihost.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=proc_id
)
assert jax.process_count() == 2
mesh = multihost.global_mesh()
assert mesh.shape["data"] == 4

# identical synthetic BA problem on both processes (seeded): C=6 cameras,
# L=32 landmarks (divisible by 4 devices), every camera sees every landmark
rng = np.random.default_rng(11)
C, L = 6, 32
pts = rng.uniform(-3, 3, size=(L, 3)) + np.array([0.0, 0.0, 10.0])
cams = np.stack(
    [
        np.concatenate(
            [[1.0 * i - 0.5 * (C - 1), 0.2 * rng.normal(), 0.0],
             0.03 * rng.normal(size=3)]
        )
        for i in range(C)
    ]
)
cam_idx = np.repeat(np.arange(C), L)
pt_idx = np.tile(np.arange(L), C)
O = len(cam_idx)
prob = ba.BAProblem(
    camera_params=jnp.asarray(cams),
    points=jnp.asarray(pts),
    cam_idx=jnp.asarray(cam_idx),
    pt_idx=jnp.asarray(pt_idx),
    pixels=jnp.zeros((O, 2)),
    intrinsics=jnp.asarray([500.0, 500.0, 320.0, 240.0]),
    n_fixed_cameras=2,
)
pixels = jax.vmap(ba._project, (0, 0, None))(
    prob.camera_params[prob.cam_idx], prob.points[prob.pt_idx], prob.intrinsics
)
pixels = np.asarray(pixels) + 0.3 * rng.normal(size=pixels.shape)
start = dataclasses.replace(
    prob,
    pixels=jnp.asarray(pixels),
    camera_params=prob.camera_params
    + 0.005
    * jnp.asarray(rng.normal(size=cams.shape))
    * (jnp.arange(C) >= 2)[:, None].astype(jnp.float64),
    points=prob.points + 0.02 * jnp.asarray(rng.normal(size=pts.shape)),
)

# make_global_array round-trip: per-process L-shards reassemble to global L
grouped = ba_dense.group_by_landmark(start)
local_pix = multihost.host_local_shard(np.asarray(grouped.pixels))
assert local_pix.shape[0] == L // 2
g_pix = multihost.make_global_array(local_pix, mesh)
assert g_pix.shape == grouped.pixels.shape

cfg = ba_dense.DenseBAConfig(max_iterations=8, schur_chunk=8)
res_dist = ba_dense.solve_ba_dense_sharded(start, mesh, cfg, grouped=grouped)
cams_dist = np.asarray(jax.device_get(res_dist.camera_params))

# process-local single-device oracle
res_local = ba_dense.solve_ba_dense(start, cfg, grouped=grouped)
cams_local = np.asarray(res_local.camera_params)

np.testing.assert_allclose(cams_dist, cams_local, rtol=1e-8, atol=1e-10)
assert np.isfinite(float(res_dist.cost))

# --- Schur-CG engine across processes: observation axis GSPMD-sharded
# (the __graft_entry__ dryrun pattern, now with a REAL 2-process mesh).
# Each process contributes its local observation rows; the engine's
# segment-sums and gathers partition across DCN automatically.
def _local(a):
    return multihost.host_local_shard(np.asarray(a))


start_cg = dataclasses.replace(
    start,
    pixels=multihost.make_global_array(_local(start.pixels), mesh),
    cam_idx=multihost.make_global_array(_local(start.cam_idx), mesh),
    pt_idx=multihost.make_global_array(_local(start.pt_idx), mesh),
)
cfg_cg = ba.BAConfig(max_iterations=8)
res_cg = ba.solve_ba(start_cg, cfg_cg)
cams_cg = np.asarray(jax.device_get(res_cg.camera_params))
res_cg_local = ba.solve_ba(start, cfg_cg)
# cross-shard reduction order differs from the single-device sum: f64
# round-off only
np.testing.assert_allclose(
    cams_cg, np.asarray(res_cg_local.camera_params), rtol=1e-6, atol=1e-8
)

print(
    f"RESULT {proc_id} {float(res_dist.cost):.15e} {cams_dist[2, 0]:.15f} "
    f"{cams_cg[2, 0]:.15f}",
    flush=True,
)
jax.distributed.shutdown()
