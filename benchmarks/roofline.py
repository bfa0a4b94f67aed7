"""Speed-of-light accounting for the hot kernels.

For each hot kernel: an explicit FLOP/byte cost model and the achieved
fraction of the card's published peaks (utils/profiling.roofline, keyed by
device_kind — an unknown device is an error).

Measurement protocol: each kernel is applied K times inside ONE jitted
`lax.fori_loop` (input perturbed by the loop index so XLA cannot hoist the
loop-invariant computation; a scalar of the output is folded into the
carry so nothing is dead), the result is fetched to the host (np.asarray),
and per-application device time is the two-point slope
(t(K2) - t(K1)) / (K2 - K1) — the fixed dispatch cost and the host fetch
cancel exactly.

Run on a GPU: python -m benchmarks.roofline
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from moptimizer_jax.core.loss import TrivialLoss
from moptimizer_jax.ops import block_cholesky, icp_linearize, nn_search
from moptimizer_jax.utils import profiling


def chain_time(step, k, args=(), reps=3):
    """Wall time of k chained kernel applications in one dispatch.

    Kernel inputs go through `args` (explicit jit parameters), NOT closures:
    a closed-over device array is baked into the program as a literal, which
    bloats the compile request and invites constant folding.
    """

    @jax.jit
    def run(c0, *arrays):
        def body(i, c):
            return step(i, c, *arrays)

        return jax.lax.fori_loop(0, k, body, c0)

    c0 = jnp.zeros((), jnp.float32)
    np.asarray(run(c0, *args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(run(c0, *args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def slope_bench(step, k1=2, k2=10, args=(), reps=3):
    """Per-application device seconds via the two-point slope in K.

    Returns (dt, valid). A non-positive slope (t2 <= t1) means the chained
    device work never rose above the dispatch jitter — the
    measurement FAILED; the row must be marked invalid, not clamped to an
    absurd throughput.
    """
    t1 = chain_time(step, k1, args, reps)
    t2 = chain_time(step, k2, args, reps)
    if t2 <= t1:
        print(
            f"    WARNING: non-positive slope (t({k1})={t1*1e3:.2f} ms >= "
            f"t({k2})={t2*1e3:.2f} ms) — measurement invalid; widen k1/k2",
            flush=True,
        )
        return (t2 - t1) / (k2 - k1), False
    return (t2 - t1) / (k2 - k1), True


def fused_linearize_row(N):
    """Fused moment ICP linearization: one HBM sweep of src+tgt.

    Cost model: bytes = 2 clouds × N × 3 × 4 B read (output is 9 scalars);
    flops ≈ 85/point (rotate 15, residual 6, norm 5, cross 9, M products 18,
    weighted moment products 12, reduction adds 20) — elementwise work, so the
    binding roofline is HBM bandwidth.
    """
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(0, 30, (N, 3)).astype(np.float32))
    tgt = src + 0.01
    loss = TrivialLoss()
    x0 = jnp.zeros(6, jnp.float32)

    def step(i, c, src, tgt):
        # Perturb the DATA (not just x): the moment sweep is x-independent,
        # so an x-only perturbation lets XLA hoist the whole HBM pass out of
        # the chain. Perturb src ONLY — perturbing both clouds lets the
        # residual's eps cancel algebraically — and fold the FULL (H, b)
        # into the carry: H's translation block is Σ I = N·I, a
        # data-independent constant, so carrying H[0,0] alone lets XLA
        # dead-code-eliminate the entire sweep (caught by the slope-validity
        # check on the 16M row).
        eps = i.astype(jnp.float32) * 1e-30 + c * 1e-30
        _, H, b = icp_linearize.icp_linearize(src + eps, tgt, x0, loss)
        return c + (jnp.sum(H) + jnp.sum(b)) * 1e-30

    # chain long enough that the per-iteration memory sweep rises well
    # above the ms-scale dispatch jitter
    k2 = max(40, int(4e8 / N))
    dt, valid = slope_bench(step, k1=max(4, k2 // 10), k2=k2, args=(src, tgt))
    r = profiling.roofline(dt, flops=85 * N, bytes_accessed=24 * N)
    return dict(name=f"fused ICP linearize ({N/1e6:.0f}M pts)", dt=dt, r=r, valid=valid)


def nn_row(Q, M):
    """Brute-force NN (the Triton kernel on a GPU): ~9 f32 operations per
    (query, point) pair on the CUDA cores, exact f32 differences. Useful
    metric: candidate pairs/s."""
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.uniform(0, 30, (Q, 3)).astype(np.float32))
    t = jnp.asarray(rng.uniform(0, 30, (M, 3)).astype(np.float32))

    def step(i, c, q, t):
        q2 = q.at[0, 0].add(i.astype(jnp.float32) * 1e-6 + c * 1e-30)
        _, d = nn_search.nearest_neighbors(q2, t)
        return c + d[0] * 1e-30

    # k gap wide enough that slope noise cannot flip the sign
    dt, valid = slope_bench(step, k1=2, k2=10, args=(q, t))
    r = profiling.roofline(dt, flops=8.0 * Q * M, bytes_accessed=4 * 3 * (Q + M))
    print(f"    pairs/s: {Q*M/dt/1e9:.1f} G", flush=True)
    return dict(name=f"NN search Pallas ({Q//1000}k × {M//1000}k)", dt=dt, r=r, valid=valid)


def grid_nn_row(Q=1_000_000, M=1_000_000, cell=0.5):
    """Hash-grid NN query at 1M×1M (the cell-major bucket join).

    The query-major path streams one 27-bucket gather PER QUERY; the
    cell-major path gathers each occupied query cell's neighborhood once.
    Accounted two ways: bytes_accessed = bucket rows actually fetched
    (n_cells·27·K·16 B — the gather stage), flops = the padded distance
    block (n_cells·Kq·27K·9 — the distance stage). Useful metric printed:
    candidate pairs/s equivalent of the query-major work it replaces."""
    from moptimizer_jax.ops import grid_nn

    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 100, (M, 2))
    z = np.sin(xy[:, 0] * 0.3) * np.cos(xy[:, 1] * 0.2) + 0.02 * rng.normal(size=M)
    pts = np.column_stack([xy, z]).astype(np.float32)
    q = jnp.asarray((pts + 0.02 * rng.normal(size=pts.shape)).astype(np.float32))
    grid = grid_nn.build_hash_grid_device(pts, cell)
    K = grid.bucket_size

    # occupied query cells (host, for the cost model only)
    cells = np.floor(np.asarray(q) / cell).astype(np.int64)
    key = cells[:, 0] * (1 << 40) + cells[:, 1] * (1 << 20) + cells[:, 2]
    n_cells = len(np.unique(key))
    Kq = -(-(grid.max_cell_occupancy * 5 // 4 + 4) // 8) * 8

    def step(i, c, q, grid):
        q2 = q.at[0, 0].add(i.astype(jnp.float32) * 1e-6 + c * 1e-30)
        _, d = grid_nn.grid_nearest_neighbors(q2, grid)
        return c + d[0] * 1e-30

    dt, valid = slope_bench(step, k1=1, k2=5, args=(q, grid))
    r = profiling.roofline(
        dt,
        flops=9.0 * n_cells * Kq * 27 * K,
        bytes_accessed=16.0 * n_cells * 27 * K,
    )
    print(
        f"    query-major-equivalent candidates/s: {Q*27*K/dt/1e9:.1f} G; "
        f"bucket rows/s: {n_cells*27*2/dt/1e6:.0f} M",
        flush=True,
    )
    return dict(
        name=f"grid NN cell-major ({Q//1000}k × {M//1000}k, K={K})",
        dt=dt,
        r=r,
        valid=valid,
        note=(
            "pipeline of sort/scatter rows + elementwise distance block: no "
            "single resource ceiling applies"
        ),
    )


def cholesky_row(n, method):
    """Camera-system SPD solve at n=6C: n³/3 useful FLOPs (factor), near-pure
    panel matmuls — accounted vs the f32-matmul ceiling.

    The per-iteration perturbation materializes a fresh A2 (the loop-invariant
    A cannot be updated in place), an O(n²) read+write that IS in the timed
    chain — so its bytes are folded into the cost model rather than silently
    deflating the roofline fraction. For method="blocked" the
    kernel EXECUTES ~2n³/3 FLOPs (factor + co-recursed inverse factor) while
    only n³/3 are "useful"; both throughputs are reported so the A/B table
    cannot be misread as a 2× utilization gap.
    """
    rng = np.random.default_rng(2)
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = jnp.asarray((A + A.T) / 2 + n * np.eye(n, dtype=np.float32))
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    def step(i, c, A, b):
        A2 = A + (i.astype(jnp.float32) * 1e-6 + c * 1e-30) * jnp.eye(n, dtype=A.dtype)
        x = block_cholesky.spd_solve(A2, b, method)
        return c + x[0] * 1e-30

    k1, k2 = (1, 5) if method == "blocked" else (2, 10)
    dt, valid = slope_bench(step, k1=k1, k2=k2, args=(A, b), reps=2)
    executed = (2 * n**3 / 3) if method == "blocked" else (n**3 / 3)
    # bytes: factor read+write of A (2·4n²) + perturbation materialization
    # read+write (2·4n²), all inside the timed chain
    r = profiling.roofline(dt, flops=n**3 / 3, bytes_accessed=4 * 4 * n * n)
    note = ""
    if method == "blocked":
        note = f"executes 2n³/3 ⇒ {executed / dt / 1e9:.0f} GFLOP/s hardware"
    return dict(name=f"SPD solve {method} (n={n})", dt=dt, r=r, valid=valid, note=note)


def schur_build_row(C=200, L=50_000, K=25, chunk=512, precision="highest"):
    """Dense-Schur S build: the engine's dominant matmul — per chunk one
    (3·chunk, 6C)ᵀ(3·chunk, 6C) product ⇒ 2·3L·(6C)² FLOPs total.

    Measured at both precisions: "highest" (full f32, accounted against
    the f32 peak) and "default" (the production default,
    DenseBAConfig.schur_precision; TF32 on a GPU, accounted against the
    TF32 peak)."""
    from moptimizer_jax import ba_dense

    rng = np.random.default_rng(3)
    U_d = jnp.asarray(rng.standard_normal((C, 6, 6)).astype(np.float32))
    Vc = jnp.asarray(
        np.tril(rng.standard_normal((L, 3, 3))).astype(np.float32)
        + 2 * np.eye(3, dtype=np.float32)
    )
    W = jnp.asarray(rng.standard_normal((L, K, 6, 3)).astype(np.float32))
    grouped = ba_dense.GroupedBA(
        pixels=jnp.zeros((L, K, 2), jnp.float32),
        cam_ids=jnp.asarray(rng.integers(0, C, (L, K)), jnp.int32),
        mask=jnp.ones((L, K), jnp.float32),
    )
    fixed = jnp.ones(C, jnp.float32)

    def step(i, c, U_d, Vc, W, grouped, fixed):
        W2 = W * (1.0 + i.astype(jnp.float32) * 1e-7 + c * 1e-30)
        S = ba_dense._build_schur(
            U_d, Vc, W2, grouped, fixed, chunk, precision=precision
        )
        return c + S[0, 0] * 1e-30

    dt, valid = slope_bench(step, k1=2, k2=8, args=(U_d, Vc, W, grouped, fixed))
    flops = 2.0 * 3 * L * (6 * C) ** 2  # the A2ᵀA2 accumulation
    bytes_a = 4.0 * (L * K * 18 + L * K * 18)  # read W, write+reread G
    r = profiling.roofline(
        dt, flops=flops, bytes_accessed=bytes_a,
        precision="f32" if precision == "highest" else "tf32",
    )
    return dict(name=f"dense-Schur S build (C={C}, L={L//1000}k, K={K}, {precision})", dt=dt, r=r, valid=valid)


def main():
    print(f"devices: {jax.devices()}", flush=True)
    rows = []
    for make in (
        lambda: fused_linearize_row(1_000_000),
        lambda: fused_linearize_row(16_000_000),
        lambda: nn_row(29_310, 29_310),
        lambda: grid_nn_row(),
        lambda: cholesky_row(6 * 2048, "xla"),
        lambda: cholesky_row(6 * 2048, "blocked"),
        lambda: schur_build_row(),
        lambda: schur_build_row(precision="default"),
    ):
        row = make()
        print(f"done: {row['name']} {row['dt']*1e3:.3f} ms/app", flush=True)
        rows.append(row)

    print("\n| Kernel | Device time | GFLOP/s | GB/s | Bound | % of roofline | Notes |")
    print("|---|---|---|---|---|---|---|")
    for row in rows:
        name, dt, r = row["name"], row["dt"], row["r"]
        if not row["valid"]:
            print(f"| {name} | INVALID (non-positive slope) | — | — | — | — | re-run |")
            continue
        print(
            f"| {name} | {dt*1e3:.2f} ms | {r['gflops_per_sec']:.0f} | "
            f"{r['gbytes_per_sec']:.0f} | {r['bound']} | "
            f"{100*r['frac_of_light']:.0f}% | {row.get('note', '')} |"
        )


if __name__ == "__main__":
    main()
