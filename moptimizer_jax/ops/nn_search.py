"""Brute-force nearest-neighbor correspondence search.

The one hot kernel with no reference implementation to mirror: the reference
reserves its `update()` hook for "nearest neighboor search on data"
(docs/Cost.puml) but never implements it — its tests use index-aligned
correspondences (tst/point2point.cpp:103). Here it fills that hook for real
ICP.

Two paths:
* `_nn_pallas` — the GPU kernel (Pallas through Triton). The grid covers
  query blocks only; each program keeps its queries and an elementwise
  running (min, first tile) pair in registers and loops over target tiles,
  so the (Q, M) distance matrix never reaches device memory. Distances are
  exact f32 differences (q−p)², with no ‖q‖²−2q·p+‖p‖² cancellation. The
  K=3 contraction gives the tensor cores nothing to do, so the work is
  plain FMA on the CUDA cores.
* `_nn_xla` — chunked XLA scan: one (chunk, M) distance block per chunk via
  the expansion form. The CPU path, the plain version the kernel is timed
  against, and what GSPMD partitions when the target cloud is sharded.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Padded target points sit at this coordinate: their squared distance
# overflows to +inf, which never beats the running minimum (strict <, which
# starts at +inf).
_PAD = 1e30

# Tile sizes and launch shape of the kernel, chosen by timing on an H100
# SXM at the 29,310-point scan (benchmarks/nn_kernel_tune.py, PERF.md).
BLOCK_Q = 16
BLOCK_P = 64
NUM_WARPS = 8
NUM_STAGES = 1


def _pad_to(x, m, axis, fill):
    n = x.shape[axis]
    target = ((n + m - 1) // m) * m
    if target == n:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return jnp.pad(x, widths, constant_values=fill)


def _nn_kernel(qx_ref, qy_ref, qz_ref, px_ref, py_ref, pz_ref, idx_ref, dist_ref,
               *, block_p):
    qx = qx_ref[...][:, None]  # (BQ, 1)
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]
    block_q = qx.shape[0]

    def body(j, carry):
        best, tile = carry  # (BQ, BP): running min per column, and its tile
        sl = pl.ds(j * block_p, block_p)
        dx = qx - px_ref[sl][None, :]
        dy = qy - py_ref[sl][None, :]
        dz = qz - pz_ref[sl][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        better = d2 < best  # strict: an equal later tile never displaces
        return jnp.where(better, d2, best), jnp.where(better, j, tile)

    init = (
        jnp.full((block_q, block_p), jnp.inf, jnp.float32),
        jnp.zeros((block_q, block_p), jnp.int32),
    )
    best, tile = jax.lax.fori_loop(0, px_ref.shape[0] // block_p, body, init)

    dmin = jnp.min(best, axis=1)
    col = jax.lax.broadcasted_iota(jnp.int32, best.shape, 1)
    # first index among the columns that hold the minimum: within a column
    # the tile is already the first one, so this is the global first argmin
    cand = jnp.where(best == dmin[:, None], tile * block_p + col, jnp.int32(2**31 - 1))
    idx_ref[...] = jnp.min(cand, axis=1)
    dist_ref[...] = dmin


@functools.partial(
    jax.jit,
    static_argnames=("block_q", "block_p", "num_warps", "num_stages", "interpret"),
)
def _nn_pallas(query, points, block_q=BLOCK_Q, block_p=BLOCK_P, num_warps=NUM_WARPS,
               num_stages=NUM_STAGES, interpret=False):
    Q = query.shape[0]
    q = _pad_to(query.astype(jnp.float32), block_q, 0, 0.0)
    p = _pad_to(points.astype(jnp.float32), block_p, 0, _PAD)
    Qp, Mp = q.shape[0], p.shape[0]

    q_spec = pl.BlockSpec((block_q,), lambda i: (i,))
    p_spec = pl.BlockSpec((Mp,), lambda i: (0,))
    idx, dist = pl.pallas_call(
        functools.partial(_nn_kernel, block_p=block_p),
        grid=(Qp // block_q,),
        in_specs=[q_spec] * 3 + [p_spec] * 3,
        out_specs=[q_spec, q_spec],
        out_shape=[
            jax.ShapeDtypeStruct((Qp,), jnp.int32),
            jax.ShapeDtypeStruct((Qp,), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="nn_search",
    )(*q.T, *p.T)
    return idx[:Q], dist[:Q]


@functools.partial(jax.jit, static_argnames=("chunk",))
def _nn_xla(query, points, chunk=1024):
    """Chunked scan over query rows; distance block via one matmul per chunk."""
    Q = query.shape[0]
    qf = query.astype(jnp.float32)
    pf = points.astype(jnp.float32)
    pn = jnp.sum(pf * pf, axis=1)
    qp = _pad_to(qf, chunk, 0, 0.0)
    n_chunks = qp.shape[0] // chunk

    def body(carry, q_chunk):
        cross = jax.lax.dot_general(
            q_chunk,
            pf,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = (
            jnp.sum(q_chunk * q_chunk, axis=1, keepdims=True)
            - 2.0 * cross
            + pn[None, :]
        )
        return carry, (jnp.argmin(d2, axis=1).astype(jnp.int32), jnp.min(d2, axis=1))

    _, (idx, dist) = jax.lax.scan(body, None, qp.reshape(n_chunks, chunk, -1))
    return idx.reshape(-1)[:Q], dist.reshape(-1)[:Q]


def nearest_neighbors(query, points, *, backend="auto", chunk=1024, interpret=False):
    """For each query point, the index of (and squared distance to) its
    nearest point in `points`. Returns (indices (Q,), sq_dists (Q,)); ties
    go to the first index.

    backend: "auto" (the kernel on a GPU, XLA elsewhere), "pallas" (the
    Triton kernel; off a GPU only with interpret=True), "xla".
    """
    if query.shape[0] == 0 or points.shape[0] == 0:
        raise ValueError(
            f"nearest_neighbors needs non-empty clouds; got query {query.shape}, "
            f"points {points.shape}"
        )
    on_gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        backend = "pallas" if on_gpu else "xla"
    if backend == "pallas":
        if not (on_gpu or interpret):
            raise ValueError(
                f"backend='pallas' is a GPU kernel; the default backend is "
                f"{jax.default_backend()!r}. Use backend='xla', or interpret=True "
                "to run the kernel in the Pallas interpreter."
            )
        return _nn_pallas(query, points, interpret=interpret)
    if backend == "xla":
        return _nn_xla(query, points, chunk=chunk)
    raise ValueError(f"unknown nearest-neighbor backend {backend!r}")


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def knn(query, points, k, chunk=1024):
    """k nearest neighbors per query point (XLA chunked lax.top_k path).

    Returns (indices (Q, k), sq_dists (Q, k)), nearest first. Used by the
    normal/covariance estimation utilities (GICP, point-to-plane).
    """
    Q = query.shape[0]
    qf = query.astype(jnp.float32)
    pf = points.astype(jnp.float32)
    pn = jnp.sum(pf * pf, axis=1)
    qp = _pad_to(qf, chunk, 0, 0.0)
    n_chunks = qp.shape[0] // chunk

    def body(carry, q_chunk):
        cross = jax.lax.dot_general(
            q_chunk,
            pf,
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = jnp.sum(q_chunk * q_chunk, axis=1, keepdims=True) - 2.0 * cross + pn[None, :]
        neg_d, idx = jax.lax.top_k(-d2, k)
        return carry, (idx.astype(jnp.int32), -neg_d)

    _, (idx, dist) = jax.lax.scan(body, None, qp.reshape(n_chunks, chunk, -1))
    return idx.reshape(-1, k)[:Q], dist.reshape(-1, k)[:Q]
