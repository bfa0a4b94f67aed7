"""Dense-Schur bundle adjustment — the explicit-Schur engine.

Why a second engine: the matrix-free Schur-CG engine (ba.py) pays 2
row-granular gathers + 2 segment-sums (`jax.ops.segment_sum`, fancy
indexing) per CG iteration, and the accelerator this engine was first built
for ran those far off its memory bandwidth. This engine removes EVERY
row-granular op from the hot path (whether that still pays on the GPU is
an open question, PERF.md):

* observations are **grouped by landmark** once at build time (host-side
  argsort + padding to a dense (L, K) grid): landmark-axis reductions become
  masked dense sums over K, and per-observation landmark lookups become
  broadcasts;
* camera-axis gathers and reductions become **one-hot matmuls**
  (ops/segmented.py) — the incidence never changes,
  so the one-hot pattern is fused from the integer cam-id grid each use;
* the Schur complement S = U' − W V'⁻¹ Wᵀ (6C × 6C) is **materialized
  explicitly** by blocked matmul accumulation (lax.scan over landmark chunks of
  the per-chunk dense camera-incidence tensor A_l = Σ_k 1[cam=c]·W_lk) and
  the camera system is solved by a single Cholesky — no CG loop, no
  per-iteration row ops. The dense-matmul answer to Ceres's DENSE_SCHUR.

Cost model: the S build is 2·(6C)²·(3L)/2 FLOPs of pure f32 matmul — at
C=200, L=50k that is ~0.4 TFLOP-scale work — plus
O(Σ L_s·K_s) element streams over the valence-segmented grid (r5: rows
sorted by observation count and processed in 2-4 width segments, so the
Poisson-valence padding tax of the single-K grid — ~60% of slots at the
headline shape — is not streamed; see GroupedBA). Memory is
O(L·K + chunk·C·18 + (6C)²); the (6C)² camera system's solve time at
C = 3000 on the GPU is in PERF.md (benchmarks/cholesky_ab.py). When landmark
valence is extremely skewed even segmentation can't absorb it below the
routing bound — `engine="auto"` falls back to ba.solve_ba's matrix-free
CG (ba.select_engine, routing on dense_slot_factor).

Same problem type (ba.BAProblem), same LM schedule (reference
src/levenberg_marquadt_dyn.cpp:34-119 λ/ν/ρ rules via ba._lm_trials), same
result type (ba.BAResult).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import ba
from moptimizer_jax.core.solver import Status
from moptimizer_jax.ops import block_cholesky


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GroupedBA:
    """Landmark-grouped observation grid (built host-side, once).

    pixels:  (L, K, 2) measured projections, 0 in padding slots.
    cam_ids: (L, K) int32 camera of each slot, 0 in padding slots.
    mask:    (L, K) 1.0 for real observations, 0.0 for padding.

    Optional **valence-segmented** layout (r5, `group_by_landmark(...,
    segments=...)`): rows are sorted by observation count (descending) and
    split into a few contiguous segments, each processed at its own slot
    width K_s ≤ K. With uniform-random observations (counts ~ Poisson(O/L))
    the single-K grid is ~60% padding slots, and every K-proportional
    stage (linearization, GN blocks, the one-hot folds of the S build)
    streams and computes that padding; 2-4 segments halve it (measured
    savings table in PERF.md). When segmented:

    perm:       (L,) int32 — grid row i holds original landmark perm[i]
    inv_perm:   (L,) int32 — argsort(perm); original landmark j is row
                inv_perm[j]
    seg_bounds: static tuple of (end_row, K_s) pairs, rows [prev_end,
                end_row) processed at width K_s (K_s non-increasing)

    Unsegmented grids (the default) keep perm=None / seg_bounds=() and
    behave exactly as before.
    """

    pixels: jax.Array
    cam_ids: jax.Array
    mask: jax.Array
    perm: jax.Array | None = None
    inv_perm: jax.Array | None = None
    seg_bounds: tuple = dataclasses.field(
        default=(), metadata=dict(static=True)
    )

    def sort_points(self, pts):
        """Original-landmark-order array → grid-row order (rows = perm)."""
        return pts if self.perm is None else jnp.take(pts, self.perm, axis=0)

    def unsort_points(self, pts):
        """Grid-row-order array → original landmark order."""
        return pts if self.inv_perm is None else jnp.take(pts, self.inv_perm, axis=0)


def _seg_views(grouped):
    """[(row_slice, single-grid GroupedBA view)] — always ≥ 1 entry.

    Views slice rows [s:e] and truncate the slot axis to the segment's
    K_s; XLA fuses the (loop-invariant) slices into their consumers.
    """
    if not grouped.seg_bounds:
        return [(slice(0, grouped.pixels.shape[0]), grouped)]
    out = []
    s = 0
    for e, k in grouped.seg_bounds:
        out.append(
            (
                slice(s, e),
                GroupedBA(
                    pixels=grouped.pixels[s:e, :k],
                    cam_ids=grouped.cam_ids[s:e, :k],
                    mask=grouped.mask[s:e, :k],
                ),
            )
        )
        s = e
    return out


def _plan_segments(counts_sorted_desc, max_segments):
    """Choose (end_row, K_s) bounds minimizing Σ L_s·K_s (host-side).

    Candidate boundaries are the rows where the sorted valence drops, so
    the search space is ≤ K_max points; brute force over ≤ (max_segments−1)
    of them is exact for the usual tens of distinct valences. For
    extreme-valence problems (a hub row can make K_max thousands) the
    candidate set is subsampled to keep the search O(40³) — the plan is
    then near-optimal rather than exact, which only costs a few % of the
    trimmed slot work."""
    from itertools import combinations

    s = counts_sorted_desc
    L = len(s)
    # rows where the sorted valence drops — the only useful boundaries —
    # in one O(L) pass (a per-valence searchsorted loop was O(K_max·L):
    # 39 s measured at K_max=L=200k)
    cand = (np.flatnonzero(np.diff(s) != 0) + 1).tolist()
    if len(cand) > 40:
        step = len(cand) / 40.0
        cand = sorted({cand[int(i * step)] for i in range(40)})

    def cost(bounds):
        tot, prev = 0, 0
        for b in list(bounds) + [L]:
            if b <= prev:
                continue
            tot += (b - prev) * int(s[prev])
            prev = b
        return tot

    best_bounds, best_cost = (), cost(())
    for n in range(1, max_segments):
        if len(cand) < n:
            break
        for bs in combinations(cand, n):
            c = cost(bs)
            if c < best_cost:
                best_cost, best_bounds = c, bs
    bounds = []
    prev = 0
    for b in list(best_bounds) + [L]:
        if b <= prev:
            continue
        bounds.append((b, int(s[prev])))
        prev = b
    return tuple(bounds), best_cost


def padding_factor(problem):
    """(L·K)/O — the dense-grid inflation of `group_by_landmark`.

    K is the max landmark valence, so one hub landmark observed by every
    camera inflates every row to its width. The dense engine's work and
    memory scale with L·K, the CG engine's with O; `ba.solve_ba(engine=
    "auto")` routes on this number (host-side, cheap: one bincount)."""
    pt_idx = np.asarray(problem.pt_idx)
    L = problem.points.shape[0]
    O = max(len(pt_idx), 1)
    K = max(int(np.bincount(pt_idx, minlength=L).max()), 1)
    return L * K / O


# the segments="auto" policy constants — ONE place; both the routing
# estimators (_auto_slot_work) and the layout builder (group_by_landmark)
# go through _auto_plan so they can never diverge
_AUTO_MIN_L = 1024
_AUTO_KEEP_FRACTION = 0.85


def _auto_plan(counts, segments, max_segments):
    """Shared segmentation policy (host-side).

    Returns (perm, seg_bounds, slot_work): perm/seg_bounds are None/()
    when the policy keeps the single-K layout, and slot_work is the
    Σ L_s·K_s the chosen layout streams (L·K for single-K)."""
    L = len(counts)
    K = max(int(counts.max()), 1) if L else 1
    full = L * K
    if segments == "auto":
        max_seg = max_segments if L >= _AUTO_MIN_L else 1
    else:
        max_seg = int(segments)
    if max_seg <= 1:
        return None, (), full
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    bounds, cost = _plan_segments(counts[perm], max_seg)
    if len(bounds) < 2 or (
        segments == "auto" and cost > _AUTO_KEEP_FRACTION * full
    ):
        return None, (), full
    return perm, bounds, cost


def _auto_slot_work(problem, max_segments=4):
    """(slot_work, L, K) under the segments="auto" policy solve_ba_dense
    applies: the Σ L_s·K_s the valence-segmented grid actually streams, or
    L·K when the policy keeps the single-K layout (host-side, one bincount
    + an O(L) boundary search)."""
    pt_idx = np.asarray(problem.pt_idx)
    L = problem.points.shape[0]
    counts = np.bincount(pt_idx, minlength=L)
    K = max(int(counts.max()), 1)
    _, _, slot_work = _auto_plan(counts, "auto", max_segments)
    return slot_work, L, K


def dense_slot_factor(problem):
    """slot_work/O of the dense engine under its segments="auto" default.

    The segmentation-aware replacement for `padding_factor` in routing:
    a single hub landmark observed by every camera inflates the single-K
    grid to (L·K)/O but only its own (tiny) segment here, so skewed
    problems that used to force the CG engine stay dense-eligible
    (`ba.select_engine`)."""
    slot_work, _, _ = _auto_slot_work(problem)
    return slot_work / max(len(np.asarray(problem.pt_idx)), 1)


def dense_memory_bytes(problem):
    """Rough peak-HBM estimate (bytes, f32) of the dense engine on `problem`.

    Host-side, shapes only (one bincount — same cost class as
    padding_factor). Two terms dominate:

    * the (L, K) grid and its linearization products — per STREAMED slot
      (Σ L_s·K_s under the auto segmentation policy): camera cache g21 84,
      r 8, A 48, B 24, W=AᵀB 72 ≈ 234 B; plus the stored grid itself
      (pixels 8 + cam_ids 4 + mask 4 = 16 B on all L·K slots — storage
      keeps the single padded array; only the compute views truncate);
    * the replicated camera system — S (6C)² plus its Cholesky factor.

    `ba.select_engine` routes to the CG engine when this estimate exceeds
    DENSE_MAX_BYTES, so a too-big S/grid falls back instead of OOMing.
    """
    slot_work, L, K = _auto_slot_work(problem)
    C = problem.camera_params.shape[0]
    return 234.0 * slot_work + 16.0 * L * K + 8.0 * (6 * C) ** 2


def group_by_landmark(problem, segments=1, max_segments=4):
    """Reorder a BAProblem's observation arrays into the (L, K) grid.

    Host-side numpy, run once per problem build (outside jit); K is the
    maximum number of observations of any landmark.

    segments:
      1        — exact historical layout: rows in landmark order, one K.
      "auto"   — sort rows by valence and split into up to `max_segments`
                 width segments when L ≥ 1024 and that trims ≥ 15% of the
                 L·K slot work (the Poisson-valence padding tax — see
                 GroupedBA docstring); otherwise identical to segments=1.
      int ≥ 2  — force splitting into up to that many segments.

    Segmented grids carry perm/inv_perm; the solve entry points sort the
    landmark state in and out at the boundary (two O(L) gathers per solve),
    so callers always see points in the problem's own order.
    """
    pt_idx = np.asarray(problem.pt_idx)
    cam_idx = np.asarray(problem.cam_idx)
    pixels = np.asarray(problem.pixels)
    L = problem.points.shape[0]
    dtype = pixels.dtype

    counts = np.bincount(pt_idx, minlength=L)
    K = max(int(counts.max()), 1)

    perm, seg_bounds, _ = _auto_plan(counts, segments, max_segments)

    # row of each landmark in the grid
    row_of = np.arange(L, dtype=np.int64)
    if perm is not None:
        row_of[perm] = np.arange(L, dtype=np.int64)

    order = np.argsort(pt_idx, kind="stable")
    # slot of each (sorted) observation within its landmark group
    starts = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(pt_idx)) - starts[pt_idx[order]]

    grid_pix = np.zeros((L, K, 2), dtype=dtype)
    grid_cam = np.zeros((L, K), dtype=np.int32)
    grid_mask = np.zeros((L, K), dtype=dtype)
    rows = row_of[pt_idx[order]]
    grid_pix[rows, slot] = pixels[order]
    grid_cam[rows, slot] = cam_idx[order]
    grid_mask[rows, slot] = 1.0
    return GroupedBA(
        pixels=jnp.asarray(grid_pix),
        cam_ids=jnp.asarray(grid_cam),
        mask=jnp.asarray(grid_mask),
        perm=None if perm is None else jnp.asarray(perm),
        inv_perm=None if perm is None else jnp.asarray(
            np.argsort(perm).astype(np.int32)
        ),
        seg_bounds=seg_bounds,
    )


def _cam_onehot(cam_ids, mask, C, dtype):
    """(L, K, C) one-hot of the camera grid, zero in padding slots.

    Built by iota-compare so XLA fuses it into the consuming matmul instead
    of storing O·C floats in HBM.
    """
    oh = (cam_ids[..., None] == jnp.arange(C, dtype=cam_ids.dtype)).astype(dtype)
    return oh * mask[..., None]


def _camera_cache(cams, with_jacobian=True):
    """Per-camera rotation/translation (+ SO(3) right Jacobian).

    The SE(3) exp map is the only transcendental work in the BA residual;
    evaluating it per CAMERA (C rows) instead of per OBSERVATION (O rows,
    as a naive vmapped residual does) removes O(O) sin/cos/sqrt from every
    linearization and every cost trial. Packed flat so one one-hot matmul
    gathers it onto the (L, K) grid.
    """
    from moptimizer_jax.lie import so3

    def one(cam):
        t, w = cam[:3], cam[3:]
        R = so3.exp(w)
        cols = [R.reshape(9), t]
        if with_jacobian:
            cols.append(so3.right_jacobian(w).reshape(9))
        return jnp.concatenate(cols)

    return jax.vmap(one)(cams)  # (C, 12 or 21)


def _gather_cache(cache, grouped, C):
    return jnp.einsum(
        "lkc,cq->lkq",
        _cam_onehot(grouped.cam_ids, grouped.mask, C, cache.dtype),
        cache,
    )  # (L, K, q)


def _linearize_grouped(cams, pts, intr, grouped):
    """Masked residuals + analytic Jacobians on the (L, K) grid.

    r (L,K,2), A = ∂r/∂cam (L,K,2,6), B = ∂r/∂pt (L,K,2,3), closed form
    (pinned against jacfwd in tests/test_ba_dense.py):

        pc = R p + t,  π = (fx·x/z + cx, fy·y/z + cy),  r = pix − π
        ∂π/∂pc = [[fx/z, 0, −fx·x/z²], [0, fy/z, −fy·y/z²]]
        ∂pc/∂t = I,  ∂pc/∂ω = −R [p]× Jr(ω),  ∂pc/∂p = R

    (Exp(ω+δ) ≈ Exp(ω)Exp(Jr δ) gives the −R[p]×Jr term; reference
    parameterize-then-Exp convention, tst/point2point.cpp:31.) Padding
    slots are forced to exactly 0 with jnp.where so garbage projections
    (a padded slot may put the point behind camera 0) cannot leak NaN/Inf.
    """
    from moptimizer_jax.lie import so3

    C = cams.shape[0]
    fx, fy = intr[0], intr[1]
    cx, cy = intr[2], intr[3]
    g21 = _gather_cache(_camera_cache(cams), grouped, C)  # (L,K,21)

    def rj(q, p, pix):
        # Fully unrolled scalar arithmetic: under the double vmap every
        # small matrix product here becomes a batched (L·K)-element tiny
        # dot if written with @, a poor shape for any matmul unit; unrolled
        # it is pure fused elementwise work.
        R = [[q[0], q[1], q[2]], [q[3], q[4], q[5]], [q[6], q[7], q[8]]]
        t = (q[9], q[10], q[11])
        Jr = [[q[12], q[13], q[14]], [q[15], q[16], q[17]], [q[18], q[19], q[20]]]
        p0, p1, p2 = p[0], p[1], p[2]
        x = R[0][0] * p0 + R[0][1] * p1 + R[0][2] * p2 + t[0]
        y = R[1][0] * p0 + R[1][1] * p1 + R[1][2] * p2 + t[1]
        z = R[2][0] * p0 + R[2][1] * p1 + R[2][2] * p2 + t[2]
        iz = 1.0 / z
        r = jnp.stack([pix[0] - (fx * x * iz + cx), pix[1] - (fy * y * iz + cy)])
        # Jpi rows are sparse: [fx·iz, 0, −fx·x·iz²], [0, fy·iz, −fy·y·iz²]
        a0, b0 = fx * iz, -fx * x * iz * iz
        a1, b1 = fy * iz, -fy * y * iz * iz
        # JpiR[α,m] collapses to two terms per entry
        JpiR = [
            [a0 * R[0][m] + b0 * R[2][m] for m in range(3)],
            [a1 * R[1][m] + b1 * R[2][m] for m in range(3)],
        ]
        # Hp = hat(p) @ Jr
        Hp = [
            [-p2 * Jr[1][m] + p1 * Jr[2][m] for m in range(3)],
            [p2 * Jr[0][m] - p0 * Jr[2][m] for m in range(3)],
            [-p1 * Jr[0][m] + p0 * Jr[1][m] for m in range(3)],
        ]
        Arot = [
            [sum(JpiR[al][i] * Hp[i][m] for i in range(3)) for m in range(3)]
            for al in range(2)
        ]
        zero = jnp.zeros_like(iz)
        A = jnp.stack(
            [
                jnp.stack([-a0, zero, -b0] + Arot[0]),
                jnp.stack([zero, -a1, -b1] + Arot[1]),
            ]
        )  # (2,6)
        B = jnp.stack(
            [jnp.stack([-v for v in JpiR[0]]), jnp.stack([-v for v in JpiR[1]])]
        )  # (2,3)
        return r, A, B

    r, A, B = jax.vmap(jax.vmap(rj, (0, None, 0)))(g21, pts, grouped.pixels)
    m = grouped.mask
    r = jnp.where(m[..., None] > 0, r, 0.0)
    A = jnp.where(m[..., None, None] > 0, A, 0.0)
    B = jnp.where(m[..., None, None] > 0, B, 0.0)
    return r, A, B


def _cost_grouped(cams, pts, intr, grouped, axis_name=None):
    """Σ‖r‖² on the grid. Segment-aware: pts must be in grid-row order
    (grouped.sort_points) when the grid is valence-segmented."""
    C = cams.shape[0]
    fx, fy = intr[0], intr[1]
    cx, cy = intr[2], intr[3]
    cache = _camera_cache(cams, with_jacobian=False)

    def res(q, p, pix):
        # unrolled R·p + t (batched tiny dots are a poor matmul shape — see
        # _linearize_grouped)
        x = q[0] * p[0] + q[1] * p[1] + q[2] * p[2] + q[9]
        y = q[3] * p[0] + q[4] * p[1] + q[5] * p[2] + q[10]
        z = q[6] * p[0] + q[7] * p[1] + q[8] * p[2] + q[11]
        iz = 1.0 / z
        return pix - jnp.stack([fx * x * iz + cx, fy * y * iz + cy])

    y = jnp.zeros((), cams.dtype)
    for sl, seg in _seg_views(grouped):
        g12 = _gather_cache(cache, seg, C)
        r = jax.vmap(jax.vmap(res, (0, None, 0)))(g12, pts[sl], seg.pixels)
        r = jnp.where(seg.mask[..., None] > 0, r, 0.0)
        y = y + jnp.sum(r * r)
    if axis_name is not None:
        y = jax.lax.psum(y, axis_name)
    return y


def _gn_blocks_grouped(grouped, r, A, B, C, loss, axis_name=None,
                       precision="default"):
    """Gauss-Newton blocks, all dense: U,g by one-hot matmul over cameras,
    V,h by masked sum over the K axis, W kept on the grid.

    Robust-loss weight w = loss(‖r‖²) applies to H,b only (reference
    linearization.h:108-115).

    precision: matmul pass count for the one-hot U/g contractions. The
    library-wide 'highest' (6 bf16 passes) made this stage 14.07 ms of the
    23 ms outer step at O=500k — 'default' (1 pass) measures 2.45 ms with
    max relative U/g perturbation ~1e-4 (benchmarks/gn_blocks_ab.py, r5):
    the same GN-step-only trade as DenseBAConfig.schur_precision (costs
    and the accept/reject ρ stay full-precision, LM absorbs step noise).

    axis_name: when running under shard_map with the landmark axis sharded,
    the camera-axis reductions U and g contract over the (distributed) L
    axis and are psum'd across devices; V, W, h stay landmark-local."""
    if loss is not None:
        w = loss.weight(jnp.sum(r * r, axis=-1))  # (L,K)
        w = jnp.where(grouped.mask > 0, w, 0.0)
        Aw = w[..., None, None] * A
        Bw = w[..., None, None] * B
        rw = w[..., None] * r
    else:
        Aw, Bw, rw = A, B, r

    oh = _cam_onehot(grouped.cam_ids, grouped.mask, C, r.dtype)  # (L,K,C)
    # The i-contractions (i = 2 residual rows) are unrolled to broadcast
    # elementwise sums (ba._outer_rows — einsum form is (L·K)-batched tiny
    # dots). Only the camera-axis
    # one-hot contractions (huge L·K contraction dim) stay real matmuls.
    AtA = ba._outer_rows(Aw, A)  # (L,K,6,6)
    Ar = A[..., 0, :] * rw[..., 0, None] + A[..., 1, :] * rw[..., 1, None]  # (L,K,6)
    with jax.default_matmul_precision(precision):
        U = jnp.einsum("lkc,lkjm->cjm", oh, AtA)  # one-hot matmul → (C,6,6)
        g = jnp.einsum("lkc,lkj->cj", oh, Ar)  # (C,6)
    V = jnp.sum(ba._outer_rows(Bw, B), axis=1)  # sum over K → (L,3,3)
    W = ba._outer_rows(Aw, B)  # (L,K,6,3)
    h = jnp.sum(
        B[..., 0, :] * rw[..., 0, None] + B[..., 1, :] * rw[..., 1, None], axis=1
    )  # (L,3)
    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        g = jax.lax.psum(g, axis_name)
    return U, V, W, g, h


def _linearize_and_blocks(cams, pts, intr, grouped, loss, axis_name=None,
                          precision="default"):
    """Per-segment linearization + GN blocks over a (possibly segmented) grid.

    Returns (U, V, W_segs, g, h, y0): U (C,6,6) and g (C,6) accumulate over
    segments (and psum over axis_name — done once here, not per segment);
    V (L,3,3), h (L,3) concatenate along the grid-row axis; W stays a list
    of per-segment (L_s, K_s, 6, 3) grids (consumed by _solve_delta_dense's
    matching segment loop). pts must be in grid-row order.
    """
    C = cams.shape[0]
    segs = _seg_views(grouped)
    U = g = y0 = None
    V_l, W_l, h_l = [], [], []
    for sl, seg in segs:
        r, A, B = _linearize_grouped(cams, pts[sl], intr, seg)
        U_s, V_s, W_s, g_s, h_s = _gn_blocks_grouped(
            seg, r, A, B, C, loss, None, precision=precision
        )
        y_s = jnp.sum(r * r)
        U = U_s if U is None else U + U_s
        g = g_s if g is None else g + g_s
        y0 = y_s if y0 is None else y0 + y_s
        V_l.append(V_s)
        W_l.append(W_s)
        h_l.append(h_s)
    V = V_l[0] if len(V_l) == 1 else jnp.concatenate(V_l, axis=0)
    h = h_l[0] if len(h_l) == 1 else jnp.concatenate(h_l, axis=0)
    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        g = jax.lax.psum(g, axis_name)
    return U, V, W_l, g, h, y0


def _chol3x3(A):
    """Closed-form lower Cholesky of a batched SPD 3×3 (textbook column
    recursion, fully unrolled).

    jnp.linalg.cholesky on a (L,3,3) batch dispatches the generic blocked
    factorization per element; this is a handful of fused elementwise
    ops."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = jnp.sqrt(a11)
    i11 = 1.0 / l11
    l21 = a21 * i11
    l31 = a31 * i11
    l22 = jnp.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(a33 - l31 * l31 - l32 * l32)
    zero = jnp.zeros_like(l11)
    return jnp.stack(
        [
            jnp.stack([l11, zero, zero], axis=-1),
            jnp.stack([l21, l22, zero], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ],
        axis=-2,
    )


def _tri_inv_lower(Lmat):
    """Closed-form inverse of a batched 3×3 lower-triangular matrix."""
    a = Lmat[..., 0, 0]
    b = Lmat[..., 1, 0]
    c = Lmat[..., 1, 1]
    d = Lmat[..., 2, 0]
    e = Lmat[..., 2, 1]
    f = Lmat[..., 2, 2]
    ia = 1.0 / a
    ic = 1.0 / c
    if_ = 1.0 / f
    zero = jnp.zeros_like(a)
    row0 = jnp.stack([ia, zero, zero], axis=-1)
    row1 = jnp.stack([-b * ia * ic, ic, zero], axis=-1)
    row2 = jnp.stack(
        [(b * e * ic - d) * ia * if_, -e * ic * if_, if_], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)


def _build_schur(U_d, Vinv_chol, W, grouped, fixed_mask, chunk=512, axis_name=None, precision="highest"):
    """Explicit S = blockdiag(U') − Σ_l Ã_l Ã_lᵀ by blocked matmul accumulation.

    Ã_l = (Σ_k 1[cam=c] W_lk) · Linv_lᵀ where V'⁻¹ = Linvᵀ·Linv. The scan
    materializes only a (chunk, C, 6, 3) camera-incidence tensor at a time;
    each chunk contributes one (6C, 3·chunk)·(3·chunk, 6C) matmul.

    **Permuted camera-space ordering**: S's flat index is i·C + c
    (component-major), NOT the conventional c·6 + i. This makes C the
    LANE dimension of the one-hot incidence contraction — with the
    conventional ordering that einsum's n is 18 (14% of a lane tile) and
    it ran at 182 GFLOP/s, 50 of the stage's 69 ms; permuted it is 2.9 ms
    and the whole S build drops 69 → ~20 ms (micro A/B r3, PERF.md).
    `_solve_delta_dense` permutes the rhs in and the solution out (two
    (C,6) transposes — trivial); the Cholesky solves P·S·Pᵀ, which is SPD
    iff S is.

    axis_name: under shard_map each device scans its landmark shard and the
    partial correction sums psum across devices — S lands replicated, so the
    (6C)² Cholesky can run identically on every device (the "replicated
    camera solve" layout of SURVEY.md §2.3).

    Segment-aware (r5): when `grouped` is valence-segmented, W is the
    per-segment list from _linearize_and_blocks and each segment scans at
    its own slot width K_s — the one-hot fold and G stream skip the
    padding slots the single-K layout would burn.
    """
    C = U_d.shape[0]
    dtype = U_d.dtype

    segs = _seg_views(grouped)
    W_segs = W if isinstance(W, (list, tuple)) else [W]
    if len(W_segs) != len(segs):
        raise ValueError(
            f"W has {len(W_segs)} segment grids but the grouped layout has "
            f"{len(segs)} segments — pass the W list from "
            "_linearize_and_blocks for a valence-segmented grid"
        )

    S0 = jnp.zeros((C * 6, C * 6), dtype)
    if axis_name is not None:
        # per-device partial sums vary over the mesh axis (shard_map VMA)
        S0 = jax.lax.pcast(S0, (axis_name,), to="varying")
    S_corr = S0

    for (sl, seg), W_s in zip(segs, W_segs):
        L, K = seg.cam_ids.shape
        # fold V'^{-1/2}: G_lk = W_lk @ Linv_l^T  (L,K,6,3) — broadcast
        # elementwise over the 3-wide contraction (batched tiny-dot einsum
        # is the slow path, PERF.md finding 2)
        G = jnp.sum(
            W_s[:, :, :, None, :] * Vinv_chol[sl][:, None, None, :, :],
            axis=-1,
        )

        n_chunks = -(-L // chunk)
        pad = n_chunks * chunk - L
        if pad:
            G = jnp.pad(G, ((0, pad), (0, 0), (0, 0), (0, 0)))
            cam_ids = jnp.pad(seg.cam_ids, ((0, pad), (0, 0)))
            mask = jnp.pad(seg.mask, ((0, pad), (0, 0)))
        else:
            cam_ids, mask = seg.cam_ids, seg.mask
        Gc = G.reshape(n_chunks, chunk, K, 6, 3)
        cc = cam_ids.reshape(n_chunks, chunk, K)
        mc = mask.reshape(n_chunks, chunk, K)

        def body(S, args):
            Gk, ck, mk = args
            oh = (ck[..., None] == jnp.arange(C, dtype=ck.dtype)).astype(dtype)
            oh = oh * mk[..., None]  # (chunk,K,C)
            # permuted panel: columns indexed (i, c) with c minor/lanes —
            # see the ordering note in the docstring
            with jax.default_matmul_precision(precision):
                A2 = jnp.einsum("qkim,qkc->qmic", Gk, oh).reshape(chunk * 3, 6 * C)
                return S + A2.T @ A2, None

        S_corr, _ = jax.lax.scan(body, S_corr, (Gc, cc, mc))

    if axis_name is not None:
        S_corr = jax.lax.psum(S_corr, axis_name)

    S = -S_corr
    # Add U' on the camera diagonal blocks via a flat 2-D scatter-add.
    # NOT via a 4-D block view: XLA lays (…,6,6)-minor views out with the
    # 6s as tile dims and pads each to (8,128) — a 21-28× HBM inflation
    # that OOMs at C = 2000 (measured: 15 GB for the 550 MB S;
    # benchmarks/ba_engines_ab.py ceiling run). Permuted ordering: entry
    # (c, i, j) of U' lands at row i·C+c, col j·C+c.
    cidx = jnp.arange(C, dtype=jnp.int32)
    i6 = C * jnp.arange(6, dtype=jnp.int32)
    rows = (cidx[:, None, None] + i6[None, :, None] + jnp.zeros((1, 1, 6), jnp.int32)).reshape(-1)
    cols = (cidx[:, None, None] + jnp.zeros((1, 6, 1), jnp.int32) + i6[None, None, :]).reshape(-1)
    S = S.at[rows, cols].add(U_d.reshape(-1))

    # gauge fixing: identity rows/cols for fixed cameras (permuted:
    # flat index i·C+c belongs to camera c → tile, not repeat)
    free = jnp.tile(fixed_mask, 6)  # (6C,) 1.0 = free
    S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
    return S


def _solve_delta_dense(grouped, C, U, V, W, g, h, lam, fixed_mask, chunk,
                       axis_name=None, schur_solver="auto",
                       schur_precision="highest"):
    """One damped dense-Schur solve → (δcam (C,6), δpt (L,3)).

    Under shard_map (axis_name set) L is the local landmark shard: the
    camera-space reductions (S, rhs) psum over the mesh; the landmark
    back-substitution stays local, so δpt comes back sharded like the grid.
    """
    dtype = U.dtype
    U_d = ba._damp_blocks(U, lam)
    V_d = ba._damp_blocks(V, lam) + 1e-12 * jnp.eye(3, dtype=dtype)
    # V'⁻¹ via Cholesky: V' = L Lᵀ → V'⁻¹ = L⁻ᵀ L⁻¹ ; both in closed form
    # (batched 3×3 — tiny-dot einsums/lapack calls are the slow path here)
    Lv = _chol3x3(V_d)
    Linv = _tri_inv_lower(Lv)  # (L,3,3)
    Vinv = jnp.sum(Linv[..., :, None] * Linv[..., None, :], axis=-3)  # LᵀL

    S = _build_schur(
        U_d, Linv, W, grouped, fixed_mask, chunk=chunk, axis_name=axis_name,
        precision=schur_precision,
    )

    segs = _seg_views(grouped)
    W_segs = W if isinstance(W, (list, tuple)) else [W]
    if len(W_segs) != len(segs):
        raise ValueError(
            f"W has {len(W_segs)} segment grids but the grouped layout has "
            f"{len(segs)} segments — pass the W list from "
            "_linearize_and_blocks for a valence-segmented grid"
        )

    # rhs = −(g − Σ_lk 1[cam=c] W_lk (V'⁻¹ h)_l), gauge rows zeroed
    t = jnp.sum(Vinv * h[:, None, :], axis=-1)  # (L,3)
    red = jnp.zeros_like(g)
    for (sl, seg), W_s in zip(segs, W_segs):
        oh_s = _cam_onehot(seg.cam_ids, seg.mask, C, dtype)
        Wt = jnp.sum(W_s * t[sl][:, None, None, :], axis=-1)  # (L_s,K_s,6)
        red = red + jnp.einsum("lkc,lki->ci", oh_s, Wt)  # (C,6)
    if axis_name is not None:
        red = jax.lax.psum(red, axis_name)
    rhs = -(g - red)
    # permute into _build_schur's component-major flat ordering (i·C+c),
    # and permute the solution back — two (C,6) transposes, trivial next
    # to the (6C)² solve
    rhs = (rhs * fixed_mask[:, None]).T.reshape(-1)

    d_cam = block_cholesky.spd_solve(S, rhs, method=schur_solver).reshape(6, C).T
    d_cam = d_cam * fixed_mask[:, None]

    # back-substitute: δl = V'⁻¹ (−h − Σ_k W_lkᵀ δc[cam(l,k)])
    Wtd_l = []
    for (sl, seg), W_s in zip(segs, W_segs):
        oh_s = _cam_onehot(seg.cam_ids, seg.mask, C, dtype)
        dc_g = jnp.einsum("lkc,ci->lki", oh_s, d_cam)  # gather-as-matmul
        Wtd_l.append(jnp.sum(W_s * dc_g[..., :, None], axis=(1, 2)))  # (L_s,3)
    Wtd = Wtd_l[0] if len(Wtd_l) == 1 else jnp.concatenate(Wtd_l, axis=0)
    d_pt = jnp.sum(Vinv * (-h - Wtd)[:, None, :], axis=-1)
    return d_cam, d_pt


@dataclasses.dataclass(frozen=True)
class DenseBAConfig:
    max_iterations: int = 15
    inner_iterations: int = 3
    init_lambda_factor: float = 1e-9
    schur_chunk: int = 512
    # (6C)² camera-system solver: "xla" (jax.scipy Cholesky), "blocked"
    # (matmul recursion, ops/block_cholesky.py), or "auto" (the XLA solve;
    # benchmarks/cholesky_ab.py times both, PERF.md).
    schur_solver: str = "auto"
    # matmul precision for the S-build panels (the step's dominant matmul
    # cost): "default" lets a GPU run float32 matmuls in TF32 (about 10
    # mantissa bits), "highest" keeps full float32 (the library-wide
    # setting for everything else). Float64 matmuls, as in the f64 oracle
    # tests, ignore the setting. A lower setting perturbs the Gauss-Newton
    # STEP only — costs and the accept/reject ρ test stay in full
    # precision, so LM absorbs the step noise: on an H100 SXM at O=500k the
    # per-iteration costs of 5 iterations agree with "highest" to 5.9e-6
    # relative and with float64 to 1.1e-5 (chip_smoke.py, PERF.md).
    schur_precision: str = "default"
    # matmul precision for the one-hot U/g Gauss-Newton contractions: the
    # same GN-step-only trade as schur_precision (release note in
    # docs/PARITY.md). Set "highest" for full float32 steps.
    gn_precision: str = "default"
    # optional noise-floor stopping (mirrors LMConfig.rel_cost_tol); 0 = off
    rel_cost_tol: float = 0.0


def _dense_outer_step(cams, pts, intr, grouped, loss, n_fixed, lam, config, axis_name=None):
    """One outer LM iteration over explicit state arrays (axis-name aware).

    axis_name=None: single-device. axis_name set: running inside shard_map
    with (pts, grouped) sharded along the landmark axis and (cams, intr,
    lam) replicated — every cross-landmark reduction psums, so the control
    scalars (y0, ρ, λ) are bitwise identical on all devices and the
    while_loops stay uniform.
    """
    dtype = cams.dtype
    eps = jnp.finfo(dtype).eps
    C = cams.shape[0]

    U, V, W, g, h, y0 = _linearize_and_blocks(
        cams, pts, intr, grouped, loss, axis_name,
        precision=config.gn_precision,
    )
    v_diag_max = jnp.max(jnp.abs(jnp.diagonal(V, axis1=-2, axis2=-1)))
    if axis_name is not None:
        y0 = jax.lax.psum(y0, axis_name)
        v_diag_max = jax.lax.pmax(v_diag_max, axis_name)

    converged0 = jnp.abs(y0) < 8 * eps
    max_diag = jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(U, axis1=-2, axis2=-1))), v_diag_max
    )
    lam = jnp.where(lam < 0.0, config.init_lambda_factor * max_diag, lam)

    fixed_mask = (jnp.arange(C) >= n_fixed).astype(dtype)
    state = ba._lm_init_state(cams, pts, lam, y0, dtype)

    def solve_fn(lam_k):
        return _solve_delta_dense(
            grouped, C, U, V, W, g, h, lam_k, fixed_mask, config.schur_chunk,
            axis_name, config.schur_solver, config.schur_precision,
        )

    def cost_fn(cams_i, pts_i):
        return _cost_grouped(cams_i, pts_i, intr, grouped, axis_name)

    if axis_name is None:
        b_flat = jnp.concatenate([g.reshape(-1), h.reshape(-1)])
        metrics_fn = None
    else:
        b_flat = None
        g_flat, h_flat = g.reshape(-1), h.reshape(-1)

        def metrics_fn(d_cam, d_pt, lam_k):
            # δ·(λδ−b): camera part replicated, landmark part psum'd
            dc, dp = d_cam.reshape(-1), d_pt.reshape(-1)
            denom = jnp.dot(dc, lam_k * dc - g_flat) + jax.lax.psum(
                jnp.dot(dp, lam_k * dp - h_flat), axis_name
            )
            max_abs = jnp.maximum(
                jnp.max(jnp.abs(dc)),
                jax.lax.pmax(jnp.max(jnp.abs(dp)), axis_name),
            )
            return denom, max_abs

    state = ba._lm_trials(
        state, y0, b_flat, cams, pts, solve_fn, cost_fn,
        config.inner_iterations, metrics_fn=metrics_fn,
        rel_cost_tol=config.rel_cost_tol,
    )

    terminal = converged0 | state["terminal"]
    status = jnp.where(
        converged0, jnp.asarray(int(Status.CONVERGED), jnp.int32), state["status"]
    )
    record = dict(cost=y0, cost_new=state["y"], rho=state["rho"], lam=state["lam"])
    return state["cams"], state["pts"], state["lam"], terminal, status, record


@partial(jax.jit, static_argnames=("config",))
def ba_step_dense(problem, grouped, lam, config=DenseBAConfig()):
    """One outer LM iteration of the dense-Schur engine.

    Same contract as ba.ba_step: returns (cams, pts, λ', terminal, status,
    record). With a valence-segmented grid the landmark state is permuted
    into grid-row order and back per call (two O(L) gathers); the full-solve
    entry points sort once around the whole loop instead."""
    cams, pts, lam, terminal, status, record = _dense_outer_step(
        problem.camera_params, grouped.sort_points(problem.points),
        problem.intrinsics, grouped, problem.loss, problem.n_fixed_cameras,
        lam, config,
    )
    return cams, grouped.unsort_points(pts), lam, terminal, status, record


@partial(jax.jit, static_argnames=("config",))
def _solve_dense_device(problem, grouped, config=DenseBAConfig()):
    dtype = problem.camera_params.dtype
    n_it = config.max_iterations

    trace0 = dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        cost_new=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
    )
    carry0 = dict(
        cams=problem.camera_params,
        pts=grouped.sort_points(problem.points),  # grid-row order inside
        lam=jnp.asarray(-1.0, dtype),
        it=jnp.zeros((), jnp.int32),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        done=jnp.asarray(False),
        trace=trace0,
    )

    def cond(c):
        return (c["it"] < n_it) & ~c["done"]

    def body(c):
        cams, pts, lam, terminal, status, record = _dense_outer_step(
            c["cams"], c["pts"], problem.intrinsics, grouped,
            problem.loss, problem.n_fixed_cameras, c["lam"], config,
        )
        trace = {k: v.at[c["it"]].set(record[k]) for k, v in c["trace"].items()}
        return dict(
            cams=cams,
            pts=pts,
            lam=lam,
            it=jnp.where(terminal, c["it"], c["it"] + 1),
            status=status,
            done=terminal,
            trace=trace,
        )

    c = jax.lax.while_loop(cond, body, carry0)
    return ba.BAResult(
        camera_params=c["cams"],
        points=grouped.unsort_points(c["pts"]),
        status=c["status"],
        iterations=c["it"],
        cost=_cost_grouped(
            c["cams"], c["pts"], problem.intrinsics, grouped
        ),
        trace=c["trace"],
    )


def solve_ba_dense(problem, config=DenseBAConfig(), grouped=None, host_loop=False):
    """Full LM solve with the dense-Schur engine.

    Groups observations by landmark on the host (once — pass `grouped` to
    reuse across solves of the same incidence), then runs the whole solve in
    one jitted lax.while_loop dispatch.

    host_loop=True drives ba_step_dense from Python — one dispatch per
    outer iteration, same contract as ba.solve_ba(host_loop=True). Use for
    checkpointing/streaming, and for very large problems where a single
    multi-minute dispatch is undesirable.
    """
    if grouped is None:
        grouped = group_by_landmark(problem, segments="auto")
    if host_loop:
        return _solve_dense_host(problem, grouped, config)
    return _solve_dense_device(problem, grouped, config)


def _solve_dense_host(problem, grouped, config):
    dtype = problem.camera_params.dtype
    n_it = config.max_iterations
    lam = jnp.asarray(-1.0, dtype)
    status = jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32)
    records = []
    executed = 0
    # landmark state stays in grid-row order across the whole host loop
    # (sorted once here, unsorted once at the end) — driving ba_step_dense
    # instead would pay its two O(L) sort/unsort gathers EVERY iteration,
    # on exactly the very-large-problem path host_loop exists for
    cams = problem.camera_params
    pts = grouped.sort_points(problem.points)
    step = jax.jit(_dense_outer_step, static_argnames=("n_fixed", "config"))
    for it in range(n_it):
        cams, pts, lam, terminal, status, record = step(
            cams, pts, problem.intrinsics, grouped, problem.loss,
            problem.n_fixed_cameras, lam, config,
        )
        records.append(record)
        if bool(terminal):
            executed = it  # reference: executed_iterations_ not bumped on return
            break
        executed = it + 1
    problem = dataclasses.replace(
        problem, camera_params=cams, points=grouped.unsort_points(pts)
    )

    def _column(key):
        col = np.full((n_it,), np.nan, dtype=np.float64)
        for i, rec in enumerate(records):
            col[i] = float(rec[key])
        return jnp.asarray(col, dtype)

    trace = {k: _column(k) for k in ("cost", "cost_new", "rho", "lam")}
    # the final cost MUST run under jit: eagerly, _cam_onehot materializes
    # the (L, K, C) one-hot per primitive — 43 GB at the C=2000 ceiling
    # (RESOURCE_EXHAUSTED, measured r5) — while jitted XLA fuses the
    # iota-compare into the consuming einsum and never stores it
    return ba.BAResult(
        camera_params=problem.camera_params,
        points=problem.points,
        status=status,
        iterations=jnp.asarray(executed, jnp.int32),
        cost=jax.jit(_cost_grouped)(
            problem.camera_params, grouped.sort_points(problem.points),
            problem.intrinsics, grouped,
        ),
        trace=trace,
    )


def _dense_loop_body(cams0, pts0, intr, grouped, loss, n_fixed, config, axis_name):
    """Full LM while_loop over _dense_outer_step (runs inside shard_map)."""
    dtype = cams0.dtype
    n_it = config.max_iterations
    trace0 = dict(
        cost=jnp.full((n_it,), jnp.nan, dtype),
        cost_new=jnp.full((n_it,), jnp.nan, dtype),
        rho=jnp.full((n_it,), jnp.nan, dtype),
        lam=jnp.full((n_it,), jnp.nan, dtype),
    )
    carry0 = dict(
        cams=cams0,
        pts=pts0,
        lam=jnp.asarray(-1.0, dtype),
        it=jnp.zeros((), jnp.int32),
        status=jnp.asarray(int(Status.MAXIMUM_ITERATIONS_REACHED), jnp.int32),
        done=jnp.asarray(False),
        trace=trace0,
    )

    def cond(c):
        return (c["it"] < n_it) & ~c["done"]

    def body(c):
        cams, pts, lam, terminal, status, record = _dense_outer_step(
            c["cams"], c["pts"], intr, grouped, loss, n_fixed, c["lam"],
            config, axis_name,
        )
        trace = {k: v.at[c["it"]].set(record[k]) for k, v in c["trace"].items()}
        return dict(
            cams=cams,
            pts=pts,
            lam=lam,
            it=jnp.where(terminal, c["it"], c["it"] + 1),
            status=status,
            done=terminal,
            trace=trace,
        )

    c = jax.lax.while_loop(cond, body, carry0)
    final_cost = _cost_grouped(c["cams"], c["pts"], intr, grouped, axis_name)
    return c["cams"], c["pts"], c["status"], c["it"], final_cost, c["trace"]


@partial(jax.jit, static_argnames=("mesh", "axis", "n_fixed", "config"))
def _run_dense_sharded(cams0, pts, intr, grouped, loss, mesh, axis, n_fixed, config):
    """Module-level jit of the shard_map'd LM loop.

    Hoisted out of solve_ba_dense_sharded so repeated solves with the same
    (mesh, axis, n_fixed, config) statics reuse the compiled executable
    instead of re-tracing a per-call closure."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    run = shard_map(
        lambda c, p, i, g, l: _dense_loop_body(c, p, i, g, l, n_fixed, config, axis),
        mesh=mesh,
        in_specs=(P(), P(axis), P(), P(axis), P()),
        out_specs=(P(), P(axis), P(), P(), P(), P()),
    )
    return run(cams0, pts, intr, grouped, loss)


def solve_ba_dense_sharded(problem, mesh, config=DenseBAConfig(), axis="data", grouped=None):
    """Distributed dense-Schur BA: landmark axis sharded over the mesh.

    The (L, K) observation grid and the landmark state are sharded along L
    (data-parallel over the scaling dimension, SURVEY.md §2.3); camera state
    is replicated. Per outer iteration the only collectives are psums of the
    camera-space objects — U (C·36), g (C·6), the Schur correction ((6C)²)
    and the cost scalar — NCCL collectives; the (6C)² Cholesky runs replicated
    on every device. Landmark linearization, V/W/h and back-substitution
    never leave their shard.

    Bitwise-uniform control flow: every λ/ρ/convergence scalar derives from
    psum'd values, so the nested while_loops stay in lockstep by
    construction (contrast: the reference's TBB path is racy, SURVEY §2.4.3).

    Pass `grouped` (from group_by_landmark) to reuse the host-side grouping
    across solves of the same incidence structure.
    """
    n_shards = mesh.shape[axis]
    L = problem.points.shape[0]
    if grouped is None:
        grouped = group_by_landmark(problem)
    if grouped.seg_bounds:
        # valence segments don't align with shard boundaries — flatten the
        # grid back to landmark order / single K for the sharded path (the
        # per-shard L is modest; the padding tax matters at single-chip
        # headline scale, where solve_ba_dense's segmented path applies)
        grouped = GroupedBA(
            pixels=jnp.take(grouped.pixels, grouped.inv_perm, axis=0),
            cam_ids=jnp.take(grouped.cam_ids, grouped.inv_perm, axis=0),
            mask=jnp.take(grouped.mask, grouped.inv_perm, axis=0),
        )

    # pad the landmark axis to a shard multiple; padding rows have mask 0
    # everywhere, V'=1e-12·I (regularizer) and h=0, so δpt_pad ≡ 0.
    Lp = -(-L // n_shards) * n_shards
    pad = Lp - L
    pts = problem.points
    if pad:
        grouped = GroupedBA(
            pixels=jnp.pad(grouped.pixels, ((0, pad), (0, 0), (0, 0))),
            cam_ids=jnp.pad(grouped.cam_ids, ((0, pad), (0, 0))),
            mask=jnp.pad(grouped.mask, ((0, pad), (0, 0))),
        )
        pts = jnp.pad(pts, ((0, pad), (0, 0)), constant_values=1.0)

    cams, pts_out, status, it, cost, trace = _run_dense_sharded(
        problem.camera_params, pts, problem.intrinsics, grouped, problem.loss,
        mesh, axis, problem.n_fixed_cameras, config,
    )
    return ba.BAResult(
        camera_params=cams,
        points=pts_out[:L],
        status=status,
        iterations=it,
        cost=cost,
        trace=trace,
    )
