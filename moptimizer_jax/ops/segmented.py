"""Segment reductions and gathers as one-hot matmuls — a dense-matmul
alternative to row-granular scatter/gather.

On the accelerator this engine was first built for, gathers/scatters cost a
fixed price per row, so at BA scale (500k observations) every
`jax.ops.segment_sum` / fancy-index cost tens of ms regardless of byte
volume. A segmented reduction IS a matmul with a one-hot matrix, and
one-hot matmuls stream at matmul/memory speed (whether this still beats
the GPU's segment_sum is an open question, PERF.md):

* small segment spaces (cameras, C ≤ ~1024):
      seg_sum(v)[c] = Σ_o 1[ids_o = c]·v_o  =  one_hotᵀ @ v    (one matmul)
      gather(table)[o] = one_hot @ table                        (one matmul)
* large sorted segment spaces (landmarks, L ~ 10⁴⁺): tile the observation
  axis; within a tile the sorted ids span a bounded range, so a local
  (tile, span) one-hot reduces the tile by matmul and only the
  (n_tiles · span) partials — typically ~10× fewer rows than O — go through
  a scatter into the (L, D) output.

`required_span(ids, tile)` computes (host-side, once per problem build) the
static span that makes the tiled reduction exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _one_hot(ids, n, dtype):
    # (len(ids), n) — iota comparison; XLA streams it into the matmul
    return (ids[:, None] == jnp.arange(n, dtype=ids.dtype)[None, :]).astype(dtype)


def segment_sum_onehot(values, ids, n_segments):
    """Σ over rows by segment id via one (n_segments, O)·(O, D) matmul.
    For small n_segments (≲ 1024); ids need not be sorted."""
    flat = values.reshape(values.shape[0], -1)
    oh = _one_hot(ids, n_segments, flat.dtype)  # (O, C)
    out = jax.lax.dot_general(
        oh,
        flat,
        (((0,), (0,)), ((), ())),
        preferred_element_type=flat.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )  # (C, D)
    return out.reshape((n_segments,) + values.shape[1:])


def gather_onehot(table, ids):
    """table[ids] via one (O, C)·(C, D) matmul. For small first dims."""
    flat = table.reshape(table.shape[0], -1)
    oh = _one_hot(ids, table.shape[0], flat.dtype)
    out = jnp.matmul(oh, flat, precision=jax.lax.Precision.HIGHEST)
    return out.reshape((ids.shape[0],) + table.shape[1:])


def required_span(ids, tile=4096):
    """Smallest static `span` for segment_sum_sorted on these sorted ids
    (host-side, once per problem build)."""
    ids = np.asarray(ids)
    O = len(ids)
    span = 1
    for start in range(0, O, tile):
        seg = ids[start : start + tile]
        span = max(span, int(seg[-1]) - int(seg[0]) + 1)
    return span


@functools.partial(jax.jit, static_argnames=("n_segments", "tile", "span"))
def segment_sum_sorted(values, ids, n_segments, tile=4096, span=1024):
    """Segment sum for SORTED ids over a large segment space.

    Requires: ids sorted ascending and, within any `tile` consecutive rows,
    spanning < `span` distinct values — use required_span(ids, tile) to pick
    span when building the problem. Rows whose local offset exceeds span are
    silently dropped (the caller guarantees coverage).
    """
    O = values.shape[0]
    flat = values.reshape(O, -1)
    D = flat.shape[1]
    n_tiles = -(-O // tile)
    pad = n_tiles * tile - O
    if pad:
        flat = jnp.pad(flat, ((0, pad), (0, 0)))
        ids = jnp.pad(ids, (0, pad), constant_values=n_segments + span)

    idsT = ids.reshape(n_tiles, tile)
    valsT = flat.reshape(n_tiles, tile, D)
    base = idsT[:, 0]  # (n_tiles,)
    local = idsT - base[:, None]
    in_span = (local >= 0) & (local < span)

    def tile_reduce(v, loc, ok):
        oh = ((loc[:, None] == jnp.arange(span)[None, :]) & ok[:, None]).astype(
            v.dtype
        )  # (tile, span)
        return jax.lax.dot_general(
            oh,
            v,
            (((0,), (0,)), ((), ())),
            preferred_element_type=v.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )  # (span, D)

    partials = jax.vmap(tile_reduce)(valsT, local, in_span)  # (n_tiles, span, D)

    # scatter the (n_tiles·span) partials — far fewer rows than O
    seg_of_partial = (base[:, None] + jnp.arange(span)[None, :]).reshape(-1)
    seg_of_partial = jnp.minimum(seg_of_partial, n_segments)  # pad → drop bucket
    out = jax.ops.segment_sum(
        partials.reshape(-1, D), seg_of_partial, num_segments=n_segments + 1
    )
    return out[:n_segments].reshape((n_segments,) + values.shape[1:])
