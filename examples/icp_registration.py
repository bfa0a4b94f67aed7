"""Example: full ICP with NN correspondence search and robust loss.

    python examples/icp_registration.py [path/to/cloud.txt]

Loads a cloud (defaults to the bundled 29,310-point LiDAR scan), applies a
known transform, shuffles the target (destroying index alignment), and
recovers the transform with `moptimizer_jax.registration.icp`.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pathlib
import sys

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import GemanMcClure, Status
from moptimizer_jax.lie import se3
from moptimizer_jax.registration import icp
from moptimizer_jax.utils.pointcloud import load_txt_cloud
from moptimizer_jax.utils.stopwatch import Stopwatch


def main():
    default = pathlib.Path(__file__).parent.parent / "tests" / "data" / "fachada.txt"
    path = sys.argv[1] if len(sys.argv) > 1 else default
    src = jnp.asarray(load_txt_cloud(path), dtype=jnp.float32)
    print(f"loaded {src.shape[0]} points from {path}")

    x_true = jnp.asarray([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], dtype=jnp.float32)
    T = se3.transform_from_params6(x_true)
    rng = np.random.default_rng(0)
    tgt = (src @ T[:3, :3].T + T[:3, 3])[rng.permutation(src.shape[0])]

    from moptimizer_jax import LMConfig

    sw = Stopwatch()
    sw.tick()
    res = icp(
        src,
        tgt,
        loss=GemanMcClure(tau=jnp.asarray(1.0, jnp.float32)),
        config=LMConfig(
            diff_mode="auto", max_iterations=100, linear_solver="cholesky"
        ),
    )
    dt = sw.tock()
    print(f"status = {Status(int(res.status)).name}  iterations = {int(res.iterations)}")
    print(f"estimated params: {res.x}")
    print(f"true params:      {x_true}")
    print(f"wall time (incl. compile): {dt:.2f}s")


if __name__ == "__main__":
    main()
