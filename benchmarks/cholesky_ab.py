"""A/B: XLA Cholesky vs the blocked matmul Cholesky (ops/block_cholesky).

    python benchmarks/cholesky_ab.py [C ...]

Measures the full SPD solve (factor + solve, what the dense-Schur BA engine
pays per inner LM trial) at (6C)² sizes, by default for C in {170, 340,
500, 1000, 2000, 3000}, plus the factor-only time, in f32 at the library's
default matmul precision. Prints a markdown table for PERF.md.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax.ops import block_cholesky


def bench(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    print(f"devices: {jax.devices()}")
    xla_solve = jax.jit(lambda A, b: block_cholesky.spd_solve(A, b, method="xla"))
    blk_solve = jax.jit(
        lambda A, b: block_cholesky.spd_solve(A, b, method="blocked", base=256)
    )
    xla_factor = jax.jit(jnp.linalg.cholesky)
    blk_factor = jax.jit(
        lambda A: block_cholesky.blocked_cholesky_and_inverse(A, base=256)
    )

    rows = []
    sizes = [int(a) for a in sys.argv[1:]] or [170, 340, 500, 1000, 2000, 3000]
    for C in sizes:
        n = 6 * C
        rng = np.random.default_rng(C)
        A = rng.standard_normal((n, n)).astype(np.float32)
        A = jnp.asarray(A @ A.T / n + n * np.eye(n, dtype=np.float32))
        b = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        t_xla = bench(xla_solve, A, b)
        t_blk = bench(blk_solve, A, b)
        t_xf = bench(xla_factor, A)
        t_bf = bench(blk_factor, A)
        # blocked does 2·N³/3 FLOPs (factor + inverse factor), syrk as gemm
        # adds ~N³/3 more → count the useful N³/3 for roofline honesty
        gflop = n**3 / 3 / 1e9
        rows.append((C, n, t_xla, t_blk, t_xf, t_bf, gflop / t_bf))
        # check agreement at f32
        err = float(
            jnp.max(jnp.abs(xla_solve(A, b) - blk_solve(A, b)))
            / (1e-30 + jnp.max(jnp.abs(xla_solve(A, b))))
        )
        print(
            f"C={C:5d} n={n:6d} solve: xla {t_xla*1e3:9.2f} ms  "
            f"blocked {t_blk*1e3:9.2f} ms  ({t_xla/t_blk:5.2f}x)  "
            f"factor: xla {t_xf*1e3:9.2f} ms  blocked {t_bf*1e3:9.2f} ms  "
            f"rel_err={err:.2e}",
            flush=True,
        )

    print("\n| C | 6C | XLA solve (ms) | blocked solve (ms) | speedup | "
          "useful GFLOP/s (blocked, N³/3) |")
    print("|---|---|---|---|---|---|")
    for C, n, t_xla, t_blk, _, _, gfs in rows:
        print(
            f"| {C} | {n} | {t_xla*1e3:.2f} | {t_blk*1e3:.2f} | "
            f"{t_xla/t_blk:.2f}× | {gfs:.0f} |"
        )


if __name__ == "__main__":
    main()
