"""Voxel hash-grid nearest-neighbor search — the HBM-resident-scale path.

The brute-force kernel (ops/nn_search.py) is exact but O(Q·M): at 1M×1M the
10¹² candidate pairs are out of reach of any dense kernel. This module is
the classic spatial-hash answer re-shaped for XLA:

* **Build** (host, once per target cloud — same pattern as
  ba_dense.group_by_landmark): voxelize at `cell_size`, hash each occupied
  cell into a power-of-two table, bucket points per slot, pad buckets to the
  max slot occupancy K. Result is a dense (S, K) index table + (S, K, 3)
  coordinate table — static shapes, no pointers, gather-friendly.
* **Query** (jitted, device; r4 cell-major "bucket join", the default):
  queries are grouped by voxel cell (one multi-operand sort + contiguous
  padded-buffer bookkeeping), each occupied cell's (2·rings+1)³-bucket
  neighborhood (27 for rings=1) is gathered ONCE for all its queries, and
  structure-of-arrays distances reduce elementwise — the gathered row
  count (≈ queries ÷ mean cell occupancy) is the design variable. A lax.cond falls back to the
  query-major per-query gather when static capacities don't hold; results
  are elementwise identical either way.
* **Fixed-capacity build** (`build_hash_grid_fixed`): one-dispatch,
  sync-free table build at caller-supplied capacities with a device
  overflow flag — scan streams (registration.PairwiseRegistrar) remember
  capacities across same-density scans.

Semantics: returns the EXACT nearest neighbor for every query whose true NN
distance is < rings·cell_size; queries with nothing that close get
d² = +inf (→ the ICP validity mask rejects them — the semantics ICP wants,
reference model.h:33 bool-validity). Hash collisions merge buckets, which
only ADDS real candidate points — never wrong answers (true distances are
always computed). Exactness holds because K is the max SLOT occupancy: no
bucket ever overflows.

Degenerate case: cell_size much larger than the cloud extent piles every
point into one slot and K → M (memory S·K·3 ≈ brute force). Pick
cell_size ≈ the ICP correspondence radius; `registration.icp` does this
automatically from `max_corr_dist`.

Fills the `update()` hook the reference reserves for NN search
(/root/reference/docs/Cost.puml) at scales its TBB loops never reached.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Large-prime XOR hash (Teschner et al.); uint32 wrap-around on both the
# numpy build side and the jnp query side keeps host/device slots identical.
_P1, _P2, _P3 = np.uint32(73856093), np.uint32(19349663), np.uint32(83492791)

# Padding-slot coordinate: (q − PAD_COORD)² overflows f32 to +inf for any
# finite query, so padding candidates lose every min/argmin without a
# separate idx-validity gather in the hot loop.
PAD_COORD = np.float32(1e30)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HashGrid:
    """Dense bucketed voxel hash table (built host-side, queried jitted).

    table_idx: (S, K) int32 point index per bucket slot, −1 padding.
    table_pts: (S, K, 3) point coordinates, PAD_COORD in padding slots.
    cell_size: () float — voxel edge length.
    max_cell_occupancy: static int — max points in one occupied CELL (before
    hash-collision bucket merging; K bounds the merged SLOT occupancy and is
    typically larger). 0 = unknown (older pickles); sizes the cell-major
    query path's default per-cell query capacity.
    """

    table_idx: jax.Array
    table_pts: jax.Array
    cell_size: jax.Array
    max_cell_occupancy: int = dataclasses.field(
        metadata=dict(static=True), default=0
    )  # rounded UP to a multiple of 16 by the builders so same-density
    # clouds share one value — static fields key the jit cache, and the
    # compile-once SLAM front-end (PairwiseRegistrar) must not recompile
    # per scan pair
    n_points: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def n_slots(self):
        return self.table_idx.shape[0]

    @property
    def bucket_size(self):
        return self.table_idx.shape[1]


def _hash_cells_np(cells, n_slots):
    c = cells.astype(np.int64).astype(np.uint32)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & np.uint32(n_slots - 1)).astype(np.int64)


def _hash_cells_jnp(cells, n_slots):
    c = cells.astype(jnp.uint32)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & jnp.uint32(n_slots - 1)).astype(jnp.int32)


def build_hash_grid(points, cell_size, *, occupancy_factor=2.0, min_slots=1, min_bucket=1, min_cell_occupancy=0):
    """Bucket `points` (M, 3) into a hash grid with voxel edge `cell_size`.

    Host-side numpy, run once per target cloud (outside jit). The table size
    S is the next power of two ≥ occupancy_factor · (# occupied cells);
    the bucket capacity K is the max slot occupancy, so the table is lossless.

    min_slots/min_bucket/min_cell_occupancy: capacity FLOORS — scan streams
    (PairwiseRegistrar) pass the running maxima so the table shape (a jit
    cache key) stays stable across same-density scans instead of flip-
    flopping at a rounding boundary and recompiling the solve (r4).
    """
    pts = np.asarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (M, 3); got {pts.shape}")
    M = pts.shape[0]
    cell_size = float(cell_size)
    if not cell_size > 0:
        raise ValueError(f"cell_size must be positive; got {cell_size}")

    cells = np.floor(pts / cell_size).astype(np.int64)
    # occupied-cell count for table sizing via a 64-bit mixing key — exact
    # up to astronomically-unlikely int64 collisions, and ~20× faster than
    # np.unique over a structured 3-column view at M = 1M
    key = (
        cells[:, 0] * np.int64(73856093)
        + cells[:, 1] * np.int64(19349663)
        + cells[:, 2] * np.int64(83492791)
    )
    _, cell_counts = np.unique(key, return_counts=True)
    n_occupied = len(cell_counts)
    max_cell_occ = max(
        ((int(cell_counts.max()) + 15) // 16) * 16, int(min_cell_occupancy)
    )
    n_slots = 1 << max(int(np.ceil(np.log2(max(occupancy_factor * n_occupied, 1)))), 4)
    n_slots = max(n_slots, int(min_slots))

    slot = _hash_cells_np(cells, n_slots)
    order = np.argsort(slot, kind="stable")
    counts = np.bincount(slot, minlength=n_slots)
    # Bucket capacity = max slot occupancy (losslessness), rounded up to a
    # multiple of 16: S is already pow2, so the whole (S, K) table shape is
    # then stable across same-density clouds and the jitted query kernel is
    # compiled ONCE per sequence instead of once per scan pair (the SLAM
    # front-end regime, benchmarks/slam_sequence_bench.py). A multiple of
    # 16 (not a power of two) keeps the padding waste ≤ 16 slots — at 1M
    # points the table is hundreds of MB and pow2 rounding up to doubled
    # it, which dominated the host→device table transfer. Padding slots
    # carry idx −1 and are masked in the query; exactness is unaffected.
    K = max(int(counts.max()), 1)
    K = max(((K + 15) // 16) * 16, int(min_bucket))

    starts = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(M) - starts[slot[order]]

    table_idx = np.full((n_slots, K), -1, dtype=np.int32)
    # padding coordinate = PAD_COORD (not 0): any query's distance to a
    # padding slot overflows to +inf in f32, so padding candidates mask
    # THEMSELVES without needing the idx table in the hot query loop
    table_pts = np.full((n_slots, K, 3), PAD_COORD, dtype=np.float32)
    rows = slot[order]
    table_idx[rows, rank] = order.astype(np.int32)
    table_pts[rows, rank] = pts[order]

    return HashGrid(
        table_idx=jnp.asarray(table_idx),
        table_pts=jnp.asarray(table_pts),
        cell_size=jnp.asarray(cell_size, jnp.float32),
        max_cell_occupancy=max_cell_occ,
        n_points=M,
    )


def _count_distinct_sorted(sorted_keys):
    return 1 + jnp.sum((sorted_keys[1:] != sorted_keys[:-1]).astype(jnp.int32))


@jax.jit
def _device_occupancy(cells32):
    """(distinct-cell count, max cell occupancy) from 32-bit mixed keys
    (device phase 1).

    ~100 expected birthday collisions at M = 1M undercount the count /
    overcount the max negligibly — the count only sizes the table
    (occupancy_factor covers it) and the max only seeds the cell-major
    query capacity (its fallback covers it)."""
    key = (
        cells32[:, 0] * jnp.int32(73856093)
        + cells32[:, 1] * jnp.int32(19349663)
        + cells32[:, 2] * jnp.int32(83492791)
    )
    sk = jnp.sort(key)
    n = sk.shape[0]
    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    ar = jnp.arange(n, dtype=jnp.int32)
    run = ar - jax.lax.cummax(jnp.where(first, ar, 0))
    return _count_distinct_sorted(sk), jnp.max(run) + 1


@functools.partial(jax.jit, static_argnames=("n_slots",))
def _device_max_occupancy(cells32, n_slots):
    slot = _hash_cells_jnp(cells32, n_slots)
    counts = jnp.zeros((n_slots,), jnp.int32).at[slot].add(1)
    return jnp.max(counts)


@functools.partial(jax.jit, static_argnames=("n_slots", "K"))
def _device_fill_table(pts, cells32, n_slots, K):
    M = pts.shape[0]
    slot = _hash_cells_jnp(cells32, n_slots)
    order = jnp.argsort(slot, stable=True)
    slot_sorted = slot[order]
    counts = jnp.zeros((n_slots,), jnp.int32).at[slot].add(1)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    rank = jnp.arange(M, dtype=jnp.int32) - starts[slot_sorted]
    flat_pos = slot_sorted * K + rank
    table_idx = (
        jnp.full((n_slots * K,), -1, jnp.int32).at[flat_pos].set(order.astype(jnp.int32))
    )
    table_pts = (
        jnp.full((n_slots * K, 3), PAD_COORD, jnp.float32).at[flat_pos].set(pts[order])
    )
    return table_idx.reshape(n_slots, K), table_pts.reshape(n_slots, K, 3)


def build_hash_grid_device(points, cell_size, *, occupancy_factor=2.0, min_slots=1, min_bucket=1, min_cell_occupancy=0):
    """Device-side grid build — same table semantics as build_hash_grid.

    The host build materializes the (S, K) table in numpy and ships it over
    the host↔device link: at M = 1M that is a ~470 MB transfer, vs a 12 MB
    cloud upload. Here the table
    is built ON the device (hash, scatter-counted occupancy, stable argsort
    bucketing); only two scalars (occupancy, max bucket) cross to the host,
    because the table SHAPE must be static. Bucket CONTENT order may differ
    from the host build (sort tie-breaking), which is semantically
    irrelevant: queries reduce min/argmin over the bucket union.

    Returns the same HashGrid pytree; use for large clouds already on
    device (registration.make_searcher routes on size).
    """
    pts = jnp.asarray(points, jnp.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (M, 3); got {pts.shape}")
    cell_size = float(cell_size)
    if not cell_size > 0:
        raise ValueError(f"cell_size must be positive; got {cell_size}")

    cells32 = jnp.floor(pts / cell_size).astype(jnp.int32)
    n_occupied, max_cell_occ = map(int, _device_occupancy(cells32))
    max_cell_occ = max(((max_cell_occ + 15) // 16) * 16, int(min_cell_occupancy))
    n_slots = 1 << max(int(np.ceil(np.log2(max(occupancy_factor * n_occupied, 1)))), 4)
    n_slots = max(n_slots, int(min_slots))
    K = int(_device_max_occupancy(cells32, n_slots))
    K = max(((max(K, 1) + 15) // 16) * 16, int(min_bucket))
    table_idx, table_pts = _device_fill_table(pts, cells32, n_slots, K)
    return HashGrid(
        table_idx=table_idx,
        table_pts=table_pts,
        cell_size=jnp.asarray(cell_size, jnp.float32),
        max_cell_occupancy=max_cell_occ,
        n_points=int(pts.shape[0]),
    )


@functools.partial(jax.jit, static_argnames=("n_slots", "K"))
def _device_fill_table_checked(pts, cells32, n_slots, K):
    """_device_fill_table with FIXED capacities: overflowing ranks are
    dropped (mode="drop") and an overflow flag is returned instead of
    silently corrupting neighbor slots."""
    M = pts.shape[0]
    slot = _hash_cells_jnp(cells32, n_slots)
    order = jnp.argsort(slot, stable=True)
    slot_sorted = slot[order]
    counts = jnp.zeros((n_slots,), jnp.int32).at[slot].add(1)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)]
    )
    rank = jnp.arange(M, dtype=jnp.int32) - starts[slot_sorted]
    overflow = jnp.max(counts) > K
    flat_pos = jnp.where(rank < K, slot_sorted * K + rank, n_slots * K)
    table_idx = (
        jnp.full((n_slots * K,), -1, jnp.int32)
        .at[flat_pos]
        .set(order.astype(jnp.int32), mode="drop")
    )
    table_pts = (
        jnp.full((n_slots * K, 3), PAD_COORD, jnp.float32)
        .at[flat_pos]
        .set(pts[order], mode="drop")
    )
    return table_idx.reshape(n_slots, K), table_pts.reshape(n_slots, K, 3), overflow


def build_hash_grid_fixed(points, cell_size, n_slots, K, max_cell_occupancy=0):
    """SYNC-FREE device-side build with caller-supplied static capacities.

    The adaptive builds must bring two scalars to the host to size the
    table (a blocking host round trip each);
    scan streams have stable density, so PairwiseRegistrar remembers the
    capacities of previous scans and builds subsequent tables in one
    dispatch with NO host synchronization.

    Returns (HashGrid, overflow) where overflow is a DEVICE scalar bool:
    True means some slot exceeded K and points were dropped — the table is
    then incomplete and the caller must rebuild with build_hash_grid_device
    (larger capacities) and redo whatever consumed it. Fetch the flag
    together with the downstream result so the check costs no extra round
    trip."""
    pts = jnp.asarray(points, jnp.float32)
    cell_size_f = float(cell_size)
    cells32 = jnp.floor(pts / cell_size_f).astype(jnp.int32)
    table_idx, table_pts, overflow = _device_fill_table_checked(
        pts, cells32, int(n_slots), int(K)
    )
    grid = HashGrid(
        table_idx=table_idx,
        table_pts=table_pts,
        cell_size=jnp.asarray(cell_size_f, jnp.float32),
        max_cell_occupancy=int(max_cell_occupancy),
        n_points=int(pts.shape[0]),
    )
    return grid, overflow


def _neighbor_offsets(rings):
    r = np.arange(-rings, rings + 1)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)


def _query_major(qf, grid, offsets, rings, chunk):
    """One gather of the k³-cell neighborhood PER QUERY — the r1-r3 path.

    Kept as the fallback for query distributions the cell-major path's
    static capacities can't hold (see grid_nearest_neighbors); also
    selectable with mode="query"."""
    Q = qf.shape[0]
    S = grid.n_slots

    n_chunks = -(-Q // chunk)
    pad = n_chunks * chunk - Q
    qp = jnp.pad(qf, ((0, pad), (0, 0)))

    def body(carry, q):  # q: (chunk, 3)
        cell = jnp.floor(q / grid.cell_size).astype(jnp.int32)  # (chunk, 3)
        cells = cell[:, None, :] + offsets[None, :, :]  # (chunk, k³, 3)
        slots = _hash_cells_jnp(cells, S)  # (chunk, k³)
        cand_pts = grid.table_pts[slots]  # (chunk, k³, K, 3) slot-granular gather
        cand_idx = grid.table_idx[slots]  # (chunk, k³, K)
        # structure-of-arrays distance: three (chunk, k³·K) ops with the
        # candidate axis minor — reducing over a size-3 minor axis wastes
        # most of each vector register
        cf = cand_pts.reshape(q.shape[0], -1, 3)
        dx = q[:, 0:1] - cf[..., 0]
        dy = q[:, 1:2] - cf[..., 1]
        dz = q[:, 2:3] - cf[..., 2]
        d2 = dx * dx + dy * dy + dz * dz  # (chunk, k³·K)
        # padding slots (PAD_COORD → d² = +inf) AND beyond-guaranteed-radius
        # candidates → +inf: a hash collision may surface a far point for a
        # query whose own neighborhood is empty; radius semantics must
        # reject it.
        r2 = (rings * grid.cell_size) ** 2
        cand_if = cand_idx.reshape(q.shape[0], -1)
        d2f = jnp.where((cand_if >= 0) & (d2 < r2), d2, jnp.inf)
        # winner via two min-reduces instead of argmin/take_along_axis.
        # Tie-break: smallest global point index among exact-tie candidates
        # (order-independent, deterministic; the cell-major path uses the
        # identical rule so both modes agree bitwise).
        best_d2 = jnp.min(d2f, axis=1)
        best_idx = jnp.min(
            jnp.where(d2f == best_d2[:, None], cand_if, jnp.iinfo(jnp.int32).max),
            axis=1,
        )
        best_idx = jnp.where(jnp.isfinite(best_d2), best_idx, -1)
        return carry, (best_idx, best_d2)

    _, (idx, d2) = jax.lax.scan(body, None, qp.reshape(n_chunks, chunk, 3))
    return idx.reshape(-1)[:Q], d2.reshape(-1)[:Q]


# Packed cell key: 10 bits per axis relative to the query cloud's min cell.
# 1024 cells/axis = 1024·cell_size of relative extent — ample for any scan
# where a cell ≈ the correspondence radius; larger extents (ok_extent
# false) fall back to the query-major path.
_KEY_BITS = 10
_KEY_SPAN = 1 << _KEY_BITS


def grid_nearest_neighbors(
    query,
    grid,
    *,
    rings=1,
    chunk=4096,
    mode="auto",
    query_capacity=None,
    max_cells=None,
):
    """Nearest neighbor of each query within rings·cell_size, via the grid.

    Returns (idx (Q,) int32, d² (Q,) f32). Queries whose true NN distance is
    < rings·cell_size get the exact nearest neighbor (equal to brute force);
    all others get idx = −1 and d² = +inf. Candidates beyond the guaranteed
    radius are discarded even when a hash collision surfaces one, so the
    result is radius-search semantics, not best-effort.

    mode="auto" (default) runs the CELL-MAJOR bucket join: queries are
    grouped by their voxel cell (one argsort over packed 30-bit cell keys +
    scatter bookkeeping), and each occupied query cell's k³-bucket
    neighborhood is gathered ONCE for all its queries instead of once per
    query — gather descriptors and HBM traffic drop by the mean cell
    occupancy (the query-major path's dominant cost at 1M×1M). Distances
    reduce elementwise over
    a (cells_chunk, Kq, k³·K) block. The result is ELEMENTWISE IDENTICAL to
    mode="query" (same candidate enumeration order, same f32 arithmetic,
    same tie-breaks); a lax.cond falls back to the query-major path when the
    static capacities don't hold for this query set:

    * relative extent ≥ 1024 cells on any axis,
    * more than max_cells (default: the grid's slot count) occupied query
      cells,
    * more than query_capacity (default: the grid's bucket size K — the
      same-density heuristic) queries in one cell.

    mode="query" forces the per-query gather path.
    """
    return _grid_nn_jit(query, grid, rings, chunk, mode, query_capacity, max_cells)


@functools.partial(
    jax.jit, static_argnames=("rings", "chunk", "mode", "query_capacity", "max_cells")
)
def _grid_nn_jit(query, grid, rings, chunk, mode, query_capacity, max_cells):
    Q = query.shape[0]
    qf = query.astype(jnp.float32)
    offsets = jnp.asarray(_neighbor_offsets(rings), jnp.int32)  # (k³, 3)
    if mode == "query" or Q < 2:
        return _query_major(qf, grid, offsets, rings, chunk)
    if mode != "auto":
        raise ValueError(f"unknown mode {mode!r}")

    S = grid.n_slots
    K = grid.bucket_size
    n_off = offsets.shape[0]
    if query_capacity is not None:
        Kq = int(query_capacity)
    elif grid.max_cell_occupancy > 0:
        # same-density heuristic on the TRUE cell occupancy (K bounds the
        # hash-collision-MERGED slot occupancy and is typically 2-3× larger,
        # which would inflate the padded compute block): 1.25× margin for
        # query clouds somewhat denser than the target, fallback covers more
        Kq = -(-(grid.max_cell_occupancy * 5 // 4 + 4) // 8) * 8
    else:
        Kq = K
    # occupied QUERY cells can never exceed Q, so min(S, Q) bounds the padded
    # buffers without losing exactness (a skewed-occupancy grid can have a
    # large Kq; sizing by S alone would cost S·Kq·20 B of HBM regardless of Q)
    C_max = int(max_cells) if max_cells is not None else min(S, Q)
    # cells per while-loop chunk: bound the live (CC, Kq, k³·K) distance
    # block to ~32 MB of f32 (the cap has not been tuned on the GPU yet;
    # PERF.md, open questions).
    CC = max(8, min(1024, (1 << 23) // max(Kq * n_off * K, 1)))
    C_pad = -(-C_max // CC) * CC

    # ---- group queries by cell: ONE multi-operand sort carries the coords
    # and the inverse permutation along with the key (saves a separate
    # qf[order] gather) ----
    cell = jnp.floor(qf / grid.cell_size).astype(jnp.int32)  # (Q, 3)
    cmin = jnp.min(cell, axis=0)
    rel = cell - cmin
    ok_extent = jnp.max(rel) < _KEY_SPAN
    key = (rel[:, 0] << (2 * _KEY_BITS)) | (rel[:, 1] << _KEY_BITS) | rel[:, 2]
    arangeQ = jnp.arange(Q, dtype=jnp.int32)
    sk, qsx, qsy, qsz, order = jax.lax.sort(
        (key, qf[:, 0], qf[:, 1], qf[:, 2], arangeQ), num_keys=1
    )
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    gid = jnp.cumsum(first.astype(jnp.int32)) - 1  # (Q,) group id, sorted order
    n_cells = gid[-1] + 1
    ok_cells = n_cells <= C_max
    # rank within cell group: gid is sorted, so each group's start position
    # is the running max of first-occurrence positions — one cummax instead
    # of a scatter-min + gather
    rank = arangeQ - jax.lax.cummax(jnp.where(first, arangeQ, 0))
    ok_rank = jnp.max(rank) < Kq
    # the winner index rides back through an f32 buffer lane as an exact
    # float VALUE, not an int bitcast: small ints bitcast to f32 denormals,
    # which some backends flush to zero (an H100 keeps them — the denormal
    # probe of chip_smoke.py's battery) — exact for point counts < 2²⁴; older
    # HashGrid pickles without n_points fall back on the table-size bound
    n_pts = grid.n_points if grid.n_points > 0 else grid.table_idx.size
    ok = ok_extent & ok_cells & ok_rank & (n_pts < (1 << 24))

    # (cell, rank)-padded query buffer: ONE Q-row scatter builds the
    # per-cell query tiles; the loop then touches only contiguous slices.
    # The chunk's CELLS are re-derived from each rank-0 row's coordinates
    # (every real cell has one — no separate key table or scatter needed).
    # Padding rows are zero; their garbage results are never read back
    # (only real queries' flat positions are gathered in the epilogue).
    flat = jnp.where(rank < Kq, gid * Kq + rank, C_pad * Kq)
    qpad = (
        jnp.zeros((C_pad * Kq, 3), jnp.float32)
        .at[flat]
        .set(jnp.stack([qsx, qsy, qsz], axis=-1), mode="drop")
    )

    r2 = (rings * grid.cell_size) ** 2

    def fast(_):
        # merged candidate table (r5): coords and index in ONE (S, K, 4)
        # row, so the ring gather issues n_cells·k³ descriptors instead of
        # 2× that (coords + idx separately); the one-time sequential
        # concat write is bandwidth-cheap.
        # float transport of idx is exact below 2²⁴ — gated in `ok`.
        aug = jnp.concatenate(
            [grid.table_pts, grid.table_idx[..., None].astype(jnp.float32)],
            axis=-1,
        )  # (S, K, 4)

        def body(c):
            i, obuf = c
            c0 = i * CC
            qc = jax.lax.dynamic_slice(
                qpad, (c0 * Kq, jnp.int32(0)), (CC * Kq, 3)
            ).reshape(CC, Kq, 3)  # contiguous — no descriptors
            # per-cell voxel from the (always-occupied) rank-0 row's coords
            cells = jnp.floor(qc[:, 0, :] / grid.cell_size).astype(jnp.int32)
            nbr = cells[:, None, :] + offsets[None, :, :]  # (CC, k³, 3)
            slots = _hash_cells_jnp(nbr, S)  # (CC, k³)
            cand4 = aug[slots]  # (CC, k³, K, 4) — ONE gather per cell·ring
            cand = cand4[..., :3]
            cand_idx = cand4[..., 3]  # float-transported point index
            # structure-of-arrays distances (see _query_major): all ops on
            # (CC, Kq, k³·K) with the candidate axis minor for full lanes
            cf = cand.reshape(CC, n_off * K, 3)
            dx = qc[:, :, 0:1] - cf[:, None, :, 0]
            dy = qc[:, :, 1:2] - cf[:, None, :, 1]
            dz = qc[:, :, 2:3] - cf[:, None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz  # (CC, Kq, k³·K)
            # the cand_idx >= 0 mask is load-bearing for tables whose padding
            # slots are NOT PAD_COORD (legacy zero-padded pickles): a query
            # near the origin would otherwise match a phantom (0,0,0) slot;
            # cand_idx is already gathered — one compare.
            valid = cand_idx.reshape(CC, 1, n_off * K) >= 0
            d2 = jnp.where((d2 < r2) & valid, d2, jnp.inf)
            # two min-reduces instead of argmin + take_along_axis (see
            # _query_major); same smallest-global-index tie-break
            bd2 = jnp.min(d2, axis=-1)  # (CC, Kq)
            idx_win = jnp.min(
                jnp.where(
                    d2 == bd2[..., None],
                    cand_idx.reshape(CC, 1, n_off * K),
                    jnp.inf,  # float sentinel: idx rides as an exact float
                ),
                axis=-1,
            )
            idx_win = jnp.where(jnp.isfinite(bd2), idx_win, -1.0)
            # pack (d², float(idx)) into one 2-lane buffer: the epilogue
            # then pays ONE row-gather + ONE row-scatter instead of two
            # each; float transport is exact below 2²⁴ (gated in `ok`)
            packed = jnp.stack(
                [bd2.reshape(-1), idx_win.reshape(-1).astype(jnp.float32)],
                axis=-1,
            )  # (CC·Kq, 2)
            obuf = jax.lax.dynamic_update_slice(
                obuf, packed, (c0 * Kq, jnp.int32(0))
            )
            return (i + jnp.int32(1), obuf)

        n_chunks = (n_cells + CC - 1) // CC  # dynamic trip count: no work
        # is spent on table padding beyond the occupied cells
        init = jnp.broadcast_to(
            jnp.asarray([jnp.inf, -1.0], jnp.float32), (C_pad * Kq, 2)
        ).copy()
        _, obuf = jax.lax.while_loop(
            lambda c: c[0] < n_chunks, body, (jnp.int32(0), init)
        )
        # flat-position gather (one 2-lane row per REAL query) + unpermute
        got = jnp.zeros((Q, 2), jnp.float32).at[order].set(obuf[flat])
        fd = got[:, 0]
        fi = got[:, 1].astype(jnp.int32)
        return fi, fd

    def fallback(_):
        return _query_major(qf, grid, offsets, rings, chunk)

    return jax.lax.cond(ok, fast, fallback, None)


def estimate_spacing(points, *, sample=1024, seed=0, k=8):
    """Median nearest-neighbor spacing of a point cloud (host-side helper).

    Brute-forces a random sample against the full cloud — O(sample·M), used
    once at grid-build time to choose a default cell size.

    Duplicate points (common in real LiDAR) make the 2nd neighbor another
    zero-distance copy, which would collapse the estimate (and with it the
    grid cell size → K → M, the module's documented worst case). So per
    sampled point we take the first *strictly positive* distance among its
    k nearest, and exclude rows whose k neighbors are all duplicates.
    """
    from moptimizer_jax.ops.nn_search import knn

    pts = jnp.asarray(points, jnp.float32)
    M = pts.shape[0]
    if M < 2:
        raise ValueError("need at least 2 points to estimate spacing")
    n = min(sample, M)
    sel = jax.random.choice(jax.random.PRNGKey(seed), M, (n,), replace=False)
    sampled = pts[sel]
    _, d2 = knn(sampled, pts, min(k, M))
    # first strictly-positive distance per row (row includes the self-match
    # at d=0 and any zero-distance duplicates)
    positive = d2 > 0
    first_pos = jnp.where(positive, d2, jnp.inf).min(axis=1)
    valid = jnp.isfinite(first_pos)
    if not bool(valid.any()):
        raise ValueError(
            f"all {n} sampled points have >= {k} exact duplicates; "
            "cannot estimate spacing — pass an explicit cell size"
        )
    spacing = float(jnp.sqrt(jnp.median(first_pos[valid])))
    return spacing
