"""Tile sizes and launch shape of the brute-force NN kernel, by timing.

    python benchmarks/nn_kernel_tune.py

Sweeps (block_q, block_p, num_warps, num_stages) of
`ops.nn_search._nn_pallas` on the 29,310-point fachada scan queried against
itself after a small rigid warp, checks every configuration against the
plain XLA scan's indices, and prints each median time beside the card's
name and power limit. Needs a GPU.
"""

import itertools
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from moptimizer_jax.ops.nn_search import _nn_pallas, _nn_xla  # noqa: E402
from moptimizer_jax.utils.cache import enable_persistent_cache  # noqa: E402
from moptimizer_jax.utils.pointcloud import load_txt_cloud  # noqa: E402


def median_seconds(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"needs a GPU; JAX's default device is {jax.devices()[0].platform!r}")
    enable_persistent_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()
    print(f"card: {card}", flush=True)

    p = load_txt_cloud(ROOT / "tests" / "data" / "fachada.txt").astype(np.float32)
    q = p + np.float32(0.05)
    qd, pd = jnp.asarray(q), jnp.asarray(p)
    ref_idx = np.asarray(_nn_xla(qd, pd)[0])
    print(f"plain XLA scan: {median_seconds(_nn_xla, qd, pd) * 1e3:.3f} ms", flush=True)

    def run(bq, bp, warps, stages):
        fn = jax.jit(lambda a, b: _nn_pallas(
            a, b, block_q=bq, block_p=bp, num_warps=warps, num_stages=stages))
        try:
            idx = np.asarray(fn(qd, pd)[0])
            t = median_seconds(fn, qd, pd)
        except Exception as e:  # a launch shape the compiler refuses
            print(f"block_q={bq} block_p={bp} warps={warps} stages={stages}: "
                  f"{type(e).__name__}: {str(e).splitlines()[0][:160]}", flush=True)
            return float("inf")
        agree = float(np.mean(idx == ref_idx))
        print(f"block_q={bq:4d} block_p={bp:4d} warps={warps} stages={stages}: "
              f"{t * 1e3:8.3f} ms  (index agreement with XLA {agree:.5f})", flush=True)
        return t

    times = {}
    for bq, bp, warps in itertools.product((16, 32, 64), (64, 128, 256), (2, 4, 8)):
        times[(bq, bp, warps, 2)] = run(bq, bp, warps, 2)
    bq, bp, warps, _ = min(times, key=times.get)
    for stages in (1, 3, 4):
        times[(bq, bp, warps, stages)] = run(bq, bp, warps, stages)
    best = min(times, key=times.get)
    print(f"best: block_q={best[0]} block_p={best[1]} num_warps={best[2]} "
          f"num_stages={best[3]}: {times[best] * 1e3:.3f} ms on {card}", flush=True)


if __name__ == "__main__":
    main()
