"""ICP registration driver: correspondence search wired into the LM loop.

Completes the design the reference only sketches: its sequence diagram
reserves `update()` for "nearest neighboor search on data" (docs/Cost.puml)
and `setup()` for the param→transform conversion, but every reference test
uses index-aligned correspondences. Here the two-tier hook structure runs
for real, fully inside the jitted LM while_loop:

* per outer iteration (`update_fn`): warp the source cloud with the current
  estimate, run the NN kernel (Pallas on a GPU) against the target cloud,
  gather matched points, mask matches beyond `max_corr_dist` — the
  reference's bool-validity convention (model.h:33) as a vmapped mask;
* per evaluation (`prepare_fn`): params6 → 4×4 transform.
"""

import functools

import jax
import jax.numpy as jnp

from moptimizer_jax.core.residual import make_block, problem
from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt
from moptimizer_jax.lie import se3
from moptimizer_jax.ops.grid_nn import grid_nearest_neighbors
from moptimizer_jax.ops.nn_search import nearest_neighbors


# Brute-vs-grid routing threshold (benchmarks/grid_nn_bench.py crossover,
# Q = M, LiDAR-density clouds): brute force is O(Q·M), the grid is not, so
# the grid wins past some target count. The threshold was set on the
# accelerator the engine was first built for and has not been measured on
# the GPU yet (PERF.md, open questions).
GRID_AUTO_MIN_TARGETS = 50_000


def default_pipeline_config():
    """Shared pipeline default: parity LM schedule + the practical
    noise-floor stopping rule (LMConfig.rel_cost_tol, r4). Real sensor data
    never trips the reference's cost<8ε / |δ|<√ε criteria, so without it
    every pairwise solve burns all iterations while the cost floors by ~10.
    This is THE config
    ``config=None`` means everywhere in the front-end — PairwiseRegistrar,
    register_pair, scan_odometry/scan_slam (the registrar and
    odometry previously disagreed). Explicit configs are never modified."""
    return LMConfig(
        diff_mode="auto",
        max_iterations=40,
        linear_solver="cholesky",
        rel_cost_tol=1e-6,
    )


COARSE_MAX_POINTS = 4096


def _coarse_subsample(cloud, cap=COARSE_MAX_POINTS):
    """Deterministic stride subsample for coarse seeding passes."""
    n = cloud.shape[0]
    if n <= cap:
        return cloud
    stride = -(-n // cap)
    return cloud[::stride]


def make_searcher(tgt_cloud, nn_backend, max_corr_dist):
    """Correspondence searcher over a fixed target cloud: warped → (idx, d²).

    nn_backend "pallas"/"xla" run the O(Q·M) brute-force kernel; "grid"
    builds a voxel hash grid ONCE here (host-side, outside jit — the target
    never changes across LM iterations) with cell size = max_corr_dist (or
    an estimated point spacing multiple) and queries its 27-cell
    neighborhood per iteration — the HBM-resident-scale path (the
    reference's `update()` hook, docs/Cost.puml).

    "auto" routes to the grid when the target cloud exceeds the measured
    crossover (GRID_AUTO_MIN_TARGETS) AND a correspondence gate is set —
    with cell = max_corr_dist the gated grid returns bit-identical
    correspondence decisions to gated brute force (exact NN within the
    gate, invalid beyond), so routing never changes semantics. Ungated
    searches keep brute force (a grid must bound its search radius;
    request "grid" explicitly to accept radius semantics at scale).
    """
    if nn_backend == "auto":
        on_grid_scale = tgt_cloud.shape[0] >= GRID_AUTO_MIN_TARGETS
        if on_grid_scale and max_corr_dist is not None:
            nn_backend = "grid"
    if nn_backend != "grid":
        return lambda warped: nearest_neighbors(
            warped, tgt_cloud, backend=nn_backend
        )

    from moptimizer_jax.ops.grid_nn import (
        build_hash_grid,
        build_hash_grid_device,
        estimate_spacing,
        grid_nearest_neighbors,
    )

    if max_corr_dist is not None:
        cell = float(max_corr_dist)
    else:
        # no radius given: matches past ~5× the typical spacing are not
        # useful ICP correspondences anyway; they come back invalid
        cell = 5.0 * estimate_spacing(tgt_cloud)
    # large tables: build on device — the host build ships the (S, K) table
    # (~470 MB at 1M points) over the host↔device link, the device build
    # only the cloud (measured 12 s → sub-second at 1M, PERF.md)
    build = build_hash_grid_device if tgt_cloud.shape[0] >= 100_000 else build_hash_grid
    grid = build(tgt_cloud, cell)
    return lambda warped: grid_nearest_neighbors(warped, grid)


def _icp_block_with_searcher(
    src, tgt_cloud, searcher, *, loss=None, max_corr_dist=None, weight_matrix=None
):
    """Build the ICP block around an externally-supplied searcher.

    Shared by icp_block (which builds the searcher from a backend name) and
    PairwiseRegistrar (which traces this with the grid/cloud as jit
    arguments so the closures are created once per compile, not per call).
    """
    src = jnp.asarray(src)
    # tgt_cloud lives in the closure, not the data pytree: only per-residual
    # leaves (src, matched, valid) carry the vmapped leading axis.
    tgt_cloud = jnp.asarray(tgt_cloud)
    n = src.shape[0]

    def prepare_fn(x):
        return se3.transform_from_params6(x)

    def residual_fn(T, d):
        warped = T[:3, :3] @ d["src"] + T[:3, 3]
        return warped - d["matched"], d["valid"]

    def update_fn_closed(x, data):
        T = se3.transform_from_params6(x)
        warped = data["src"] @ T[:3, :3].T + T[:3, 3]
        idx, d2 = searcher(warped)
        matched = tgt_cloud[idx]
        if max_corr_dist is not None:
            valid = d2 < jnp.asarray(max_corr_dist, d2.dtype) ** 2
        else:
            # grid search marks out-of-neighborhood queries with d² = +inf
            valid = jnp.isfinite(d2)
        return dict(data, matched=matched, valid=valid)

    # initial correspondences: placeholder (overwritten by the first update)
    data = dict(
        src=src,
        matched=tgt_cloud[:n] if tgt_cloud.shape[0] >= n else src,
        valid=jnp.ones((n,), bool),
    )
    linearize_fn = None
    if weight_matrix is None:
        from moptimizer_jax.ops.icp_linearize import fused_point2point_linearizer

        linearize_fn = fused_point2point_linearizer
    return make_block(
        residual_fn,
        data=data,
        prepare_fn=prepare_fn,
        update_fn=update_fn_closed,
        loss=loss,
        weight_matrix=weight_matrix,
        linearize_fn=linearize_fn,
        name="icp",
    )


def _point2plane_block_with_searcher(
    src, tgt_cloud, tgt_normals, searcher, *, loss=None, max_corr_dist=None
):
    """Point-to-plane ICP block with per-iteration NN update (the standard
    high-accuracy variant — models/point2plane.py residual, front-end
    wiring): r = n·(T·s − q) with the
    matched target point q and ITS normal n re-gathered per outer
    iteration."""
    src = jnp.asarray(src)
    tgt_cloud = jnp.asarray(tgt_cloud)
    tgt_normals = jnp.asarray(tgt_normals, src.dtype)
    n = src.shape[0]

    def prepare_fn(x):
        return se3.transform_from_params6(x)

    def residual_fn(T, d):
        warped = T[:3, :3] @ d["src"] + T[:3, 3]
        return jnp.array([jnp.dot(d["normal"], warped - d["matched"])]), d["valid"]

    def update_fn(x, data):
        T = se3.transform_from_params6(x)
        warped = data["src"] @ T[:3, :3].T + T[:3, 3]
        idx, d2 = searcher(warped)
        matched = tgt_cloud[idx]
        normal = tgt_normals[idx]
        if max_corr_dist is not None:
            valid = d2 < jnp.asarray(max_corr_dist, d2.dtype) ** 2
        else:
            valid = jnp.isfinite(d2)
        return dict(data, matched=matched, normal=normal, valid=valid)

    big = tgt_cloud.shape[0] >= n
    data = dict(
        src=src,
        matched=tgt_cloud[:n] if big else src,
        normal=tgt_normals[:n] if big else tgt_normals[jnp.zeros((n,), jnp.int32)],
        valid=jnp.ones((n,), bool),
    )
    return make_block(
        residual_fn,
        data=data,
        prepare_fn=prepare_fn,
        update_fn=update_fn,
        loss=loss,
        name="point2plane",
    )


def icp_block(
    src,
    tgt_cloud,
    *,
    loss=None,
    max_corr_dist=None,
    nn_backend="auto",
    weight_matrix=None,
):
    """Point-to-point ICP block with per-iteration correspondence search.

    src: (N, 3) source points; tgt_cloud: (M, 3) target cloud (unaligned).
    """
    tgt_cloud = jnp.asarray(tgt_cloud)
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)
    return _icp_block_with_searcher(
        src,
        tgt_cloud,
        searcher,
        loss=loss,
        max_corr_dist=max_corr_dist,
        weight_matrix=weight_matrix,
    )


class PairwiseRegistrar:
    """Compile-once pairwise ICP for scan streams (the SLAM front-end).

    `icp()` builds fresh Python closures per call; jit keys on their
    identity, so every call retraces and recompiles. This registrar
    creates the traced solve ONCE; per
    pair only ARRAYS (source cloud, target cloud / hash-grid tables, seed)
    cross the jit boundary, so every same-shape pair reuses the executable.
    (Grid table shapes are density-stable by construction: S is a power of
    two, K a multiple of 16 — ops/grid_nn.build_hash_grid.)

    Usage::

        reg = PairwiseRegistrar(max_corr_dist=0.5)
        for k in range(1, len(scans)):
            res = reg.register(scans[k], scans[k-1], x0=prev)
    """

    def __init__(
        self, *, config=None, loss=None, max_corr_dist=None, nn_backend="auto",
        method="icp", k=10, epsilon=1e-3, coarse_multistart="auto",
    ):
        if config is None:
            config = default_pipeline_config()
        if method not in ("icp", "gicp", "point2plane"):
            raise ValueError(f"unknown method {method!r}")
        self.config = config
        self.loss = loss
        self.max_corr_dist = max_corr_dist
        self.nn_backend = nn_backend
        self.method = method
        self.k = k
        self.epsilon = epsilon
        # coarse_multistart > 0: the unseeded (first-pair) coarse pass runs
        # that many yaw-rotated starts BATCHED (levenberg_marquardt_batched)
        # and keeps the lowest-cost one — point-to-point ICP's basin is
        # narrower than one scan step once inter-scan rotation grows past
        # ~10-15°, and a failed first pair poisons every constant-velocity
        # seed after it (measured failure in PERF.md p2plane section).
        # "auto" (default, r5): 8 starts whenever a correspondence gate is
        # set — wide-motion robustness is the PIPELINE default, not an
        # expert flag. Steady-state cost: zero (the
        # multistart solve only runs on UNSEEDED registrations — the first
        # pair of a stream); pass 0 to force the single-start coarse pass.
        if coarse_multistart == "auto":
            coarse_multistart = 8 if max_corr_dist is not None else 0
        self.coarse_multistart = int(coarse_multistart)
        self._coarse = None  # lazily-built ungated registrar (first-pair seed)
        self._coarse_ms = None  # lazily-jitted multistart coarse solve
        # grid capacity policy (r4): running maxima of (n_slots, bucket K,
        # cell occupancy) across the stream. Two jobs: (a) shape STABILITY —
        # the table shape keys the jit cache, and a K flip at a rounding
        # boundary recompiled the solve mid-sequence (measured 22 s/flip);
        # (b) once known, later scans build their grid with the SYNC-FREE
        # fixed-capacity device build (build_hash_grid_fixed) — the
        # adaptive builds pay ~2 blocking host round trips or a multi-MB
        # host-table upload per pair.
        self._grid_policy = None

        def make_block_fn(src, tgt_cloud, searcher, covs):
            if method == "icp":
                return _icp_block_with_searcher(
                    src, tgt_cloud, searcher, loss=loss, max_corr_dist=max_corr_dist
                )
            if method == "point2plane":
                return _point2plane_block_with_searcher(
                    src, tgt_cloud, covs, searcher,
                    loss=loss, max_corr_dist=max_corr_dist,
                )
            from moptimizer_jax.models.gicp import gicp_block

            src_cov, tgt_cov = covs
            n = src.shape[0]

            def update_fn(x, data):
                T = se3.transform_from_params6(x)
                warped = data["src"] @ T[:3, :3].T + T[:3, 3]
                idx, d2 = searcher(warped)
                matched = tgt_cloud[idx]
                matched_cov = tgt_cov[idx]
                if max_corr_dist is not None:
                    valid = d2 < jnp.asarray(max_corr_dist, d2.dtype) ** 2
                else:
                    valid = jnp.isfinite(d2)
                return dict(data, matched=matched, matched_cov=matched_cov, valid=valid)

            big = tgt_cloud.shape[0] >= n
            return gicp_block(
                src,
                tgt_cloud[:n] if big else src,
                src_cov,
                tgt_cov[:n] if big else src_cov,
                loss=loss,
                update_fn=update_fn,
                valid=jnp.ones((n,), bool),
            )

        def solve_grid(src, tgt_cloud, grid, x0, covs):
            searcher = lambda warped: grid_nearest_neighbors(warped, grid)  # noqa: E731
            blk = make_block_fn(src, tgt_cloud, searcher, covs)
            return levenberg_marquardt(problem(blk), x0, config)

        def solve_grid_fused(src, tgt_cloud, x0, covs, S, K, occ):
            # fixed-capacity grid build + solve in ONE dispatch: with known
            # capacities the build is pure static-shape jit ops, so fusing
            # it removes one dispatch per pair. Returns (result, device
            # overflow flag).
            from moptimizer_jax.ops.grid_nn import build_hash_grid_fixed

            grid, overflow = build_hash_grid_fixed(
                tgt_cloud, max_corr_dist, S, K, occ
            )
            searcher = lambda warped: grid_nearest_neighbors(warped, grid)  # noqa: E731
            blk = make_block_fn(src, tgt_cloud, searcher, covs)
            return levenberg_marquardt(problem(blk), x0, config), overflow

        def solve_brute(src, tgt_cloud, x0, covs):
            searcher = lambda warped: nearest_neighbors(  # noqa: E731
                warped, tgt_cloud, backend=nn_backend
            )
            blk = make_block_fn(src, tgt_cloud, searcher, covs)
            return levenberg_marquardt(problem(blk), x0, config)

        self._solve_grid = jax.jit(solve_grid)
        self._solve_grid_fused = jax.jit(
            solve_grid_fused, static_argnames=("S", "K", "occ")
        )
        self._solve_brute = jax.jit(solve_brute)

    def _use_grid(self, m):
        if self.nn_backend == "grid":
            return True
        if self.nn_backend == "auto":
            return m >= GRID_AUTO_MIN_TARGETS and self.max_corr_dist is not None
        return False

    def register(self, src, tgt_cloud, x0=None, *, defer_overflow=False):
        """Align src onto tgt_cloud; returns the LMResult.

        x0=None seeds with the median-centroid offset and, when a
        correspondence gate is set, runs a coarse ungated pass first (the
        register_pair contract — a gate tighter than the initial
        misalignment would reject every correspondence).

        defer_overflow=True returns ``(result, overflow)`` WITHOUT any
        host↔device synchronization: ``overflow`` is the fused grid-build's
        device bool (or None on paths that resolve capacity synchronously).
        The caller checks it LAGGED — pair k's flag fetched while pair k+1
        computes — and calls :meth:`redo_overflow` on the rare True. This
        is the streaming contract: a per-pair ``bool(overflow)`` sync
        would make every pair pay a host round trip for a flag that is
        almost always False."""
        src = jnp.asarray(src)
        tgt_cloud = jnp.asarray(tgt_cloud)
        if x0 is None:
            x0 = jnp.zeros(6, dtype=src.dtype)
            t0 = jnp.median(tgt_cloud.astype(src.dtype), axis=0) - jnp.median(
                src, axis=0
            )
            x0 = x0.at[0:3].set(t0)
            if self.max_corr_dist is not None:
                # coarse seeding runs on DOWNSAMPLED clouds (≤4096 pts,
                # deterministic stride): a seed needs the basin, not the
                # resolution — the full-res gated solve refines it. At 32k
                # this cuts the coarse brute-NN work ~64× and shrinks the
                # cold-start compile.
                src_c = _coarse_subsample(src)
                tgt_c = _coarse_subsample(tgt_cloud)
                if self.coarse_multistart > 0:
                    x0 = self._coarse_multistart_seed(src_c, tgt_c)
                else:
                    if self._coarse is None:
                        self._coarse = PairwiseRegistrar(
                            config=self.config, loss=self.loss,
                            max_corr_dist=None, nn_backend=self.nn_backend,
                            method=self.method, k=self.k, epsilon=self.epsilon,
                        )
                    x0 = self._coarse.register(src_c, tgt_c, x0).x
        covs = self._covs_for(src, tgt_cloud)
        if self._use_grid(tgt_cloud.shape[0]):
            if self._grid_policy is None and self.max_corr_dist is not None:
                # first pair of a stream: one adaptive build LEARNS the
                # capacities (host/device sizing), then the solve itself
                # runs through the same fused program the steady state
                # uses — the separate prebuilt-grid solve never compiles
                # on the cold path (it stays the lazy overflow-redo path)
                self._build_grid(tgt_cloud)
            if self._grid_policy is not None and self.max_corr_dist is not None:
                # steady-state stream: build + solve in one dispatch
                S, K, occ = self._grid_policy
                res, overflow = self._solve_grid_fused(
                    src, tgt_cloud, x0, covs, S=S, K=K, occ=occ
                )
                if defer_overflow:
                    return res, overflow
                if not bool(overflow):
                    return res
                # denser scan outgrew the capacities: rebuild adaptively
                # with the old capacities as floors (monotonic growth)
                return self._redo_overflow(src, tgt_cloud, x0, covs)
            grid = self._build_grid(tgt_cloud)
            res = self._solve_grid(src, tgt_cloud, grid, x0, covs)
            if self._grid_overflow is not None and bool(self._grid_overflow):
                grid = self._build_grid(tgt_cloud, force_adaptive=True)
                res = self._solve_grid(src, tgt_cloud, grid, x0, covs)
            return (res, None) if defer_overflow else res
        res = self._solve_brute(src, tgt_cloud, x0, covs)
        return (res, None) if defer_overflow else res

    def _covs_for(self, src, tgt_cloud):
        if self.method == "gicp":
            from moptimizer_jax.ops.surface import gicp_covariances

            return (
                gicp_covariances(src, k=self.k, epsilon=self.epsilon).astype(src.dtype),
                gicp_covariances(
                    tgt_cloud, k=self.k, epsilon=self.epsilon
                ).astype(src.dtype),
            )
        if self.method == "point2plane":
            from moptimizer_jax.ops.surface import estimate_normals

            return estimate_normals(tgt_cloud, k=self.k).astype(src.dtype)
        return None

    def redo_overflow(self, src, tgt_cloud, x0):
        """Redo a registration whose deferred fused-path overflow flag came
        back True: adaptive grid rebuild (old capacities as floors, so the
        policy grows monotonically) + solve. Returns the LMResult."""
        src = jnp.asarray(src)
        tgt_cloud = jnp.asarray(tgt_cloud)
        covs = self._covs_for(src, tgt_cloud)
        return self._redo_overflow(src, tgt_cloud, x0, covs)

    def _redo_overflow(self, src, tgt_cloud, x0, covs):
        grid = self._build_grid(tgt_cloud, force_adaptive=True)
        return self._solve_grid(src, tgt_cloud, grid, x0, covs)

    def _coarse_multistart_seed(self, src, tgt_cloud):
        """Best-of-B ungated coarse alignment: B yaw-rotated starts about
        the source centroid, solved in ONE batched program (the accept/
        reject control flow vmaps to per-lane masking), lowest healthy
        final cost wins. Always point-to-point (coarse alignment needs the
        basin, not the p2plane/GICP fidelity)."""
        from moptimizer_jax.core.solver import (
            Status,
            levenberg_marquardt_batched,
        )

        if self._coarse_ms is None:
            B = self.coarse_multistart
            config = self.config

            def solve(src, tgt_cloud):
                dt = src.dtype
                c_src = jnp.median(src, axis=0)
                t0 = jnp.median(tgt_cloud.astype(dt), axis=0) - c_src
                ang = 2.0 * jnp.pi * jnp.arange(B, dtype=dt) / B
                ca, sa = jnp.cos(ang), jnp.sin(ang)
                # rotate about the source centroid by yaw θ, then translate
                # by the centroid offset: t = t0 + c − R c, ω = (0, 0, θ)
                Rc = jnp.stack(
                    [ca * c_src[0] - sa * c_src[1],
                     sa * c_src[0] + ca * c_src[1],
                     jnp.broadcast_to(c_src[2], ang.shape)], axis=1)
                t = t0[None, :] + c_src[None, :] - Rc
                w = jnp.stack(
                    [jnp.zeros_like(ang), jnp.zeros_like(ang), ang], axis=1)
                x0s = jnp.concatenate([t, w], axis=1)  # (B, 6)

                searcher = lambda warped: nearest_neighbors(  # noqa: E731
                    warped, tgt_cloud, backend="xla"
                )
                blk = _icp_block_with_searcher(src, tgt_cloud, searcher)
                res = levenberg_marquardt_batched(
                    problem(blk), x0s, config, batch_data=False
                )
                bad = res.status == int(Status.NUMERIC_ERROR)
                cost = jnp.where(bad, jnp.inf, res.cost)
                return res.x[jnp.argmin(cost)]

            self._coarse_ms = jax.jit(solve)
        return self._coarse_ms(src, tgt_cloud)

    def _build_grid(self, tgt_cloud, force_adaptive=False):
        from moptimizer_jax.ops.grid_nn import (
            build_hash_grid,
            build_hash_grid_device,
            build_hash_grid_fixed,
            estimate_spacing,
        )

        if self.max_corr_dist is not None:
            cell = float(self.max_corr_dist)
        else:
            cell = 5.0 * estimate_spacing(tgt_cloud)
        M = tgt_cloud.shape[0]
        if self._grid_policy is not None and not force_adaptive:
            S, K, occ = self._grid_policy
            grid, overflow = build_hash_grid_fixed(tgt_cloud, cell, S, K, occ)
            self._grid_overflow = overflow  # device scalar; checked by caller
            return grid
        self._grid_overflow = None
        floors = {}
        if self._grid_policy is not None:  # monotonic growth on overflow
            S0, K0, occ0 = self._grid_policy
            floors = dict(
                min_slots=S0, min_bucket=K0 + 16, min_cell_occupancy=occ0
            )
        build = build_hash_grid_device if M >= 100_000 else build_hash_grid
        grid = build(tgt_cloud, cell, **floors)
        self._grid_policy = (
            grid.n_slots,
            grid.bucket_size,
            grid.max_cell_occupancy,
        )
        return grid


def icp(
    src,
    tgt_cloud,
    x0=None,
    *,
    config=None,
    loss=None,
    max_corr_dist=None,
    nn_backend="auto",
    init="centroid",
):
    """Full ICP: returns the LMResult whose x is the 6-DoF params
    ([t, ω], reference convention) aligning src onto tgt_cloud.

    init="centroid" (default, when x0 is None): seed the translation with
    median(tgt) − median(src) — NN correspondence search has a small
    convergence basin and cannot swallow large offsets from identity; the
    median keeps the seed robust to outlier points. init="identity" starts
    at zero."""
    src = jnp.asarray(src)
    if x0 is None:
        x0 = jnp.zeros(6, dtype=src.dtype)
        if init == "centroid":
            t0 = jnp.median(
                jnp.asarray(tgt_cloud, src.dtype), axis=0
            ) - jnp.median(src, axis=0)
            x0 = x0.at[0:3].set(t0)
    if config is None:
        config = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    blk = icp_block(
        src,
        tgt_cloud,
        loss=loss,
        max_corr_dist=max_corr_dist,
        nn_backend=nn_backend,
    )
    return levenberg_marquardt(problem(blk), x0, config)


@functools.lru_cache(maxsize=32)
def _batched_icp_jit(config, max_corr_dist):
    """Compile-once batched ICP solve, keyed on the static knobs.

    The loss rides through as a pytree ARGUMENT (losses are registered
    pytree dataclasses), so only genuinely static config forces a new
    entry — repeated same-shape fleet calls reuse one executable
    (a fresh jax.jit per call retraced every invocation)."""

    def run(srcs, tgt_clouds, x0s, loss):
        def one(src, tgt, x0):
            searcher = lambda w: nearest_neighbors(w, tgt, backend="xla")  # noqa: E731
            blk = _icp_block_with_searcher(
                src, tgt, searcher, loss=loss, max_corr_dist=max_corr_dist
            )
            return levenberg_marquardt(problem(blk), x0, config)

        return jax.vmap(one)(srcs, tgt_clouds, x0s)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _batched_icp_sharded_jit(config, max_corr_dist, mesh, axis):
    """Mesh-sharded fleet ICP: the batch axis laid out over devices.

    shard_map over the mesh axis, each device vmapping its local lanes —
    lanes are fully independent (no collectives), so per-lane LM while_loop
    trip counts may diverge across devices without synchronization. This is
    the serving-workload form of the SURVEY §2.3 DP plan: a fleet of B
    same-shape alignment jobs scales across chips at B/n_devices lanes per
    chip."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def run(srcs, tgt_clouds, x0s, loss):
        def one(src, tgt, x0):
            searcher = lambda w: nearest_neighbors(w, tgt, backend="xla")  # noqa: E731
            blk = _icp_block_with_searcher(
                src, tgt, searcher, loss=loss, max_corr_dist=max_corr_dist
            )
            return levenberg_marquardt(problem(blk), x0, config)

        def local(srcs, tgts, x0s, loss):
            return jax.vmap(one)(srcs, tgts, x0s)

        spec = P(axis)
        loss_spec = jax.tree.map(lambda _: P(), loss)
        # check_vma=False: the LM while_loop carry mixes replicated scalars
        # (λ, ν seeds) with lane-dependent values — the per-device program
        # is still purely local (no collectives), so the varying-axis check
        # is over-strict here
        return shard_map(
            local,
            mesh=mesh,
            in_specs=(spec, spec, spec, loss_spec),
            out_specs=spec,
            check_vma=False,
        )(srcs, tgt_clouds, x0s, loss)

    return jax.jit(run)


def icp_batched(
    srcs,
    tgt_clouds,
    x0s=None,
    *,
    config=None,
    loss=None,
    max_corr_dist=None,
    mesh=None,
    mesh_axis=None,
):
    """B full ICP solves (per-iteration NN correspondence update included)
    vmapped into ONE device program — fleet registration.

    srcs (B, N, 3), tgt_clouds (B, M, 3), x0s (B, 6) or None (per-lane
    median-centroid seeding). Uses the XLA brute-force NN per lane (the
    Pallas kernel and the host-built hash grid do not batch); for B
    same-shape pairs solved SEQUENTIALLY with grid search use
    PairwiseRegistrar instead — batching wins when pairs are small and
    latency-bound, the registrar when each pair is large.

    mesh: optional jax.sharding.Mesh — shards the batch axis over the mesh's
    devices (shard_map, no collectives: lanes are independent), B lanes
    becoming B/n_devices per chip. B must divide evenly by the mesh axis
    size (pad the fleet or pick B accordingly). mesh_axis defaults to the
    mesh's first axis name. Per-lane results equal the single-device path
    (tests/test_sharding.py).

    Returns an LMResult with a leading B axis; per-lane results match
    individual icp() solves (tests/test_batched_solver.py).
    """
    srcs = jnp.asarray(srcs)
    tgt_clouds = jnp.asarray(tgt_clouds)
    if config is None:
        config = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    if x0s is None:
        t0 = jnp.median(tgt_clouds.astype(srcs.dtype), axis=1) - jnp.median(
            srcs, axis=1
        )
        x0s = jnp.concatenate(
            [t0, jnp.zeros((srcs.shape[0], 3), srcs.dtype)], axis=1
        )

    mcd = None if max_corr_dist is None else float(max_corr_dist)
    if mesh is not None:
        axis = mesh_axis or mesh.axis_names[0]
        n_dev = mesh.shape[axis]
        if srcs.shape[0] % n_dev != 0:
            raise ValueError(
                f"fleet size B={srcs.shape[0]} must divide the mesh axis "
                f"{axis!r} ({n_dev} devices) — pad the fleet to a multiple"
            )
        return _batched_icp_sharded_jit(config, mcd, mesh, axis)(
            srcs, tgt_clouds, x0s, loss
        )
    return _batched_icp_jit(config, mcd)(srcs, tgt_clouds, x0s, loss)


def point2plane(
    src,
    tgt_cloud,
    x0=None,
    *,
    k=10,
    config=None,
    loss=None,
    max_corr_dist=None,
    nn_backend="auto",
):
    """Point-to-plane ICP: r = n·(T·s − q) with target normals from k-NN
    PCA (ops/surface.estimate_normals), NN correspondence + normal
    re-gather per outer iteration. The standard high-accuracy ICP variant
    (reachable through the pipeline API)."""
    from moptimizer_jax.ops.surface import estimate_normals

    src = jnp.asarray(src)
    tgt_cloud = jnp.asarray(tgt_cloud)
    if x0 is None:
        x0 = jnp.zeros(6, dtype=src.dtype)
        t0 = jnp.median(tgt_cloud.astype(src.dtype), axis=0) - jnp.median(src, axis=0)
        x0 = x0.at[0:3].set(t0)
    if config is None:
        config = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")
    normals = estimate_normals(tgt_cloud, k=k).astype(src.dtype)
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)
    blk = _point2plane_block_with_searcher(
        src, tgt_cloud, normals, searcher, loss=loss, max_corr_dist=max_corr_dist
    )
    return levenberg_marquardt(problem(blk), x0, config)


def gicp(
    src,
    tgt_cloud,
    x0=None,
    *,
    k=10,
    epsilon=1e-3,
    config=None,
    loss=None,
    max_corr_dist=None,
    nn_backend="auto",
):
    """Generalized (plane-to-plane) ICP: per-point GICP covariances from
    k-NN PCA, NN correspondence update per outer iteration, state-dependent
    information Ω = (C_q + R C_s Rᵀ)⁻¹ per match."""
    from moptimizer_jax.models.gicp import gicp_block
    from moptimizer_jax.ops.surface import gicp_covariances

    src = jnp.asarray(src)
    tgt_cloud = jnp.asarray(tgt_cloud)
    if x0 is None:
        x0 = jnp.zeros(6, dtype=src.dtype)
        t0 = jnp.median(tgt_cloud.astype(src.dtype), axis=0) - jnp.median(src, axis=0)
        x0 = x0.at[0:3].set(t0)
    if config is None:
        config = LMConfig(diff_mode="auto", max_iterations=30, linear_solver="cholesky")

    src_cov = gicp_covariances(src, k=k, epsilon=epsilon).astype(src.dtype)
    tgt_cov = gicp_covariances(tgt_cloud, k=k, epsilon=epsilon).astype(src.dtype)
    n = src.shape[0]
    searcher = make_searcher(tgt_cloud, nn_backend, max_corr_dist)

    def update_fn(x, data):
        T = se3.transform_from_params6(x)
        warped = data["src"] @ T[:3, :3].T + T[:3, 3]
        idx, d2 = searcher(warped)
        matched = tgt_cloud[idx]
        matched_cov = tgt_cov[idx]
        if max_corr_dist is not None:
            valid = d2 < jnp.asarray(max_corr_dist, d2.dtype) ** 2
        else:
            valid = jnp.isfinite(d2)
        return dict(data, matched=matched, matched_cov=matched_cov, valid=valid)

    blk = gicp_block(
        src,
        tgt_cloud[:n] if tgt_cloud.shape[0] >= n else src,
        src_cov,
        (tgt_cov[:n] if tgt_cloud.shape[0] >= n else src_cov),
        loss=loss,
        update_fn=update_fn,
        valid=jnp.ones((n,), bool),
    )
    return levenberg_marquardt(problem(blk), x0, config)
