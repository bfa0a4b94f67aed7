"""Worker for tests/test_multihost.py — one of two cooperating processes.

Runs the FULL distributed LM engine over a 2-process × 2-device CPU mesh
(local gloo coordinator): each process feeds only its local shard of the
curve-fitting data (reference tst/curve_fitting.cpp dataset), the GSPMD
path inserts the cross-process collectives, and the result must equal a
process-local single-device solve of the same global problem.

Usage: python _multihost_worker.py <process_id> <port>
"""

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

from moptimizer_jax import LMConfig, levenberg_marquardt  # noqa: E402
from moptimizer_jax.core.residual import make_block, problem  # noqa: E402
from moptimizer_jax.models.curve_fitting import CERES_CURVE_DATA  # noqa: E402
from moptimizer_jax.parallel import multihost  # noqa: E402
from moptimizer_jax.parallel.sharded import (  # noqa: E402
    distributed_levenberg_marquardt,
)

assert not multihost.is_initialized()
multihost.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=proc_id
)
assert multihost.is_initialized()
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()
assert len(jax.local_devices()) == 2

mesh = multihost.global_mesh()


def residual(x, d):
    return jnp.stack([d[1] - jnp.exp(x[0] * d[0] + x[1])])


# 64 rows → 32 per process → 16 per device (shard-exact, no padding)
data_full = jnp.asarray(np.asarray(CERES_CURVE_DATA)[:64], jnp.float64)
data_local = multihost.host_local_shard(np.asarray(data_full))
assert data_local.shape[0] == 32

blk = multihost.make_global_block(
    make_block(residual, data=data_local), mesh
)
leaf = blk.data
assert leaf.shape[0] == 64  # global residual count reassembled

cfg = LMConfig(max_iterations=25)
res = distributed_levenberg_marquardt(problem(blk), jnp.zeros(2, jnp.float64), mesh, cfg)
x_dist = np.asarray(jax.device_get(res.x))

# process-local oracle: same global data, single local device
res_local = levenberg_marquardt(
    problem(make_block(residual, data=data_full)), jnp.zeros(2, jnp.float64), cfg
)
x_local = np.asarray(res_local.x)

np.testing.assert_allclose(x_dist, x_local, rtol=1e-10, atol=1e-12)
print(f"RESULT {proc_id} {x_dist[0]:.15f} {x_dist[1]:.15f}", flush=True)
jax.distributed.shutdown()
