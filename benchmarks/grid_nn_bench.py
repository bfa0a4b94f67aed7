"""Grid-NN at scale: 1M queries x 1M targets on one GPU.

The brute-force kernel is O(Q·M) = 10^12 candidate pairs here — out of
reach. The hash grid reduces work to Q · 27 · K candidates. Reports build
time (host), query wall time, and achieved candidate throughput.

Run: python benchmarks/grid_nn_bench.py [Q] [M]
     python benchmarks/grid_nn_bench.py crossover
       — times brute force (the NN kernel) vs grid at M = 10k..1M (Q = M, the ICP
         regime) to locate the routing threshold for
         registration.make_searcher's nn_backend="auto"
         (GRID_AUTO_MIN_TARGETS). Results → PERF.md.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _make_cloud(M, Q, rng, extent=100.0):
    """Surface-like 2.5D height field, ~LiDAR density statistics."""
    xy = rng.uniform(0, extent, (M, 2))
    z = np.sin(xy[:, 0] * 0.2) + 0.1 * rng.normal(size=M)
    points = np.column_stack([xy, z]).astype(np.float32)
    sel = rng.choice(M, Q, replace=True)
    query = (points[sel] + rng.normal(0, 0.05, (Q, 3))).astype(np.float32)
    return points, query


def crossover():
    """Brute (Pallas) vs grid query time across target-cloud sizes.

    Q = M (ICP registers clouds of comparable size). The grid's build cost
    is amortized across the ~30 LM iterations of a solve, so the routing
    decision compares per-iteration QUERY times; build time is reported
    separately. Drives GRID_AUTO_MIN_TARGETS in registration.py.
    """
    import jax
    import jax.numpy as jnp

    from moptimizer_jax.ops.grid_nn import (
        build_hash_grid,
        build_hash_grid_device,
        grid_nearest_neighbors,
    )
    from moptimizer_jax.ops.nn_search import nearest_neighbors

    rng = np.random.default_rng(0)
    import functools

    def slope(fn_of_q, qd, reps=3, k1=1, k2=5):
        """Marginal in-jit time per query sweep (the quantity the LM loop
        pays per iteration): K applications chained in one dispatch,
        two-point slope — a single-dispatch timing folds the fixed
        dispatch cost into every row."""

        @functools.partial(jax.jit, static_argnames=("n",))
        def run_n(qd, n):
            def body(c, _):
                i, d = fn_of_q(qd + c * 1e-6)
                return c + 1.0, i.sum()
            c, s_ = jax.lax.scan(body, jnp.float32(0.0), None, length=n)
            return s_[-1]

        np.asarray(run_n(qd, k1)); np.asarray(run_n(qd, k2))
        t1 = t2 = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter(); np.asarray(run_n(qd, k1)); t1 = min(t1, time.perf_counter() - t0)
            t0 = time.perf_counter(); np.asarray(run_n(qd, k2)); t2 = min(t2, time.perf_counter() - t0)
        return (t2 - t1) / (k2 - k1)

    sizes = tuple(int(a) for a in sys.argv[2:]) or (
        10_000, 30_000, 100_000, 300_000, 1_000_000
    )
    print("| M = Q | brute query (kernel) | grid query (cell-major) | grid build | grid K | winner |", flush=True)
    print("|---|---|---|---|---|---|", flush=True)
    for M in sizes:
        # constant density: extent grows with sqrt(M) so spacing (and the
        # cell heuristic) stay LiDAR-like at every size
        extent = 100.0 * np.sqrt(M / 1e6)
        points, query = _make_cloud(M, M, rng, extent)
        spacing = float(np.sqrt(extent * extent / M))
        cell = 5.0 * spacing

        qd = jax.device_put(jnp.asarray(query))
        pd = jax.device_put(jnp.asarray(points))

        t_brute = slope(lambda q: nearest_neighbors(q, pd, backend="pallas"), qd)

        t0 = time.perf_counter()
        build = build_hash_grid_device if M >= 20_000 else build_hash_grid
        grid = build(points, cell)
        np.asarray(grid.table_idx[0, 0])
        t_build = time.perf_counter() - t0
        t_grid = slope(lambda q: grid_nearest_neighbors(q, grid), qd)
        winner = "grid" if t_grid < t_brute else "brute"
        print(
            f"| {M:,} | {t_brute*1e3:.1f} ms | {t_grid*1e3:.1f} ms | "
            f"{t_build*1e3:.1f} ms | {grid.bucket_size} | {winner} |",
            flush=True,
        )


def main():
    import jax
    import jax.numpy as jnp

    from moptimizer_jax.ops.grid_nn import build_hash_grid, grid_nearest_neighbors

    Q = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    M = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000

    rng = np.random.default_rng(0)
    points, query = _make_cloud(M, Q, rng)

    spacing = float(np.sqrt(100.0 * 100.0 / M))  # ~mean xy spacing
    cell = 5.0 * spacing

    t0 = time.perf_counter()
    grid = build_hash_grid(points, cell)
    jax.block_until_ready(grid.table_pts)
    t_build = time.perf_counter() - t0
    S, K = grid.table_idx.shape
    print(f"build: {t_build*1e3:.1f} ms  S={S} K={K} table={S*K*16/1e6:.1f} MB")

    qd = jax.device_put(jnp.asarray(query))
    idx, d2 = grid_nearest_neighbors(qd, grid, chunk=8192)
    np.asarray(idx)  # warm-up compile + host materialization

    reps = 3
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        idx, d2 = grid_nearest_neighbors(qd, grid, chunk=8192)
        np.asarray(idx)
        best = min(best, time.perf_counter() - t0)

    n_cand = Q * 27 * K
    gathered_gb = Q * 27 * K * 16 / 1e9  # idx + xyz per candidate
    found = float(jnp.mean((idx >= 0).astype(jnp.float32)))
    print(
        f"query: {best*1e3:.1f} ms for Q={Q:,} x M={M:,}  "
        f"({n_cand/best/1e9:.1f} G candidates/s, {gathered_gb/best:.0f} GB/s "
        f"gather stream, {found*100:.1f}% matched)"
    )


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "crossover":
        crossover()
    else:
        main()
