"""Scan odometry + mini-SLAM: sequential registration front-end, pose-graph
back-end.

Composes the engine's pieces into the pipeline the reference's domain points
at (SURVEY.md §7 "scale workloads"): consecutive scans are registered with
ICP/GICP (identical shapes → the jitted solve compiles once and is reused
for every pair), relative transforms are chained into a trajectory, and
optional loop-closure registrations feed a pose-graph optimization that
redistributes drift.

Conventions: world pose of scan k is P_k (params6, reference convention)
with P_0 = I. Registering scan j onto scan i returns T_ij with
p_i ≈ T_ij · p_j, i.e. exactly the pose-graph measurement z_ij for the edge
i → j (pose_graph._edge_residual).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from moptimizer_jax import pose_graph as pgo
from moptimizer_jax.core.solver import LMConfig
from moptimizer_jax.lie import se3, so3
from moptimizer_jax.registration import default_pipeline_config, gicp, icp

# one shared meaning for config=None across register_pair / PairwiseRegistrar
# / scan_odometry (the two entry points previously disagreed)
_default_pipeline_config = default_pipeline_config


def _params6_of(T):
    return jnp.concatenate([T[:3, 3], so3.log(T[:3, :3])])


def _compose(a, b):
    """params6 of T(a)·T(b)."""
    return _params6_of(
        se3.transform_from_params6(a) @ se3.transform_from_params6(b)
    )


@jax.jit
def chain_poses(rels):
    """World poses (K, 6) from relative measurements (K-1, 6), P_0 = I.

    One jitted lax.scan over 4×4 composes instead of K-1 eager per-pair
    `_compose` dispatches — over a remote transport every eager op is its
    own round trip, and the front-end loop must stay sync-free."""
    def step(T, rel):
        Tn = T @ se3.transform_from_params6(rel)
        return Tn, jnp.concatenate([Tn[:3, 3], so3.log(Tn[:3, :3])])

    T0 = jnp.eye(4, dtype=rels.dtype)
    _, ps = jax.lax.scan(step, T0, rels)
    return jnp.concatenate([jnp.zeros((1, 6), rels.dtype), ps], axis=0)


def register_pair(src, tgt, *, x0=None, method="icp", config=None, registrar=None, **kwargs):
    """Align src onto tgt; returns (params6, LMResult).

    x0 seeds the solve (motion-model / loop-closure prior). When no seed is
    given and a correspondence gate (max_corr_dist) is set, a coarse
    ungated pass runs first — a gate tighter than the initial misalignment
    would otherwise reject every correspondence and stall the solve.

    registrar: a registration.PairwiseRegistrar to reuse (compile-once path
    for scan streams — scan_odometry builds one automatically); supports the
    registrar methods ("icp"/"gicp"/"point2plane"). A registrar carries its
    own config/search settings, so passing extra kwargs or a conflicting
    config alongside one raises rather than being silently ignored.
    """
    if registrar is not None:
        if registrar.method != method:
            raise ValueError(
                f"registrar was built for method={registrar.method!r}, got {method!r}"
            )
        if kwargs:
            raise ValueError(
                "registrar=... carries its own search settings; extra kwargs "
                f"{sorted(kwargs)} would be silently ignored — bake them into "
                "the PairwiseRegistrar instead"
            )
        if config is not None and config != registrar.config:
            raise ValueError(
                "registrar=... was built with a different LMConfig than the "
                "one passed; rebuild the registrar with this config"
            )
        res = registrar.register(src, tgt, x0=x0)
        return res.x, res
    if config is None:
        config = _default_pipeline_config()
    if method == "gicp":
        solver = gicp
    elif method == "point2plane":
        from moptimizer_jax.registration import point2plane as solver
    else:
        solver = icp
    if x0 is None and kwargs.get("max_corr_dist") is not None:
        coarse = dict(kwargs, max_corr_dist=None)
        x0 = solver(src, tgt, config=config, **coarse).x
    res = solver(src, tgt, x0, config=config, **kwargs)
    return res.x, res


def make_registrar(method, config, **kwargs):
    """PairwiseRegistrar for scan streams, or None when not applicable."""
    if method not in ("icp", "gicp", "point2plane"):
        return None
    from moptimizer_jax.registration import PairwiseRegistrar

    if config is None:
        config = _default_pipeline_config()
    return PairwiseRegistrar(config=config, method=method, **kwargs)


def scan_odometry(scans, *, method="icp", config=None, seed_motion=True, registrar=None, **kwargs):
    """Sequential odometry over a list of (N, 3) scans.

    Returns (poses (K, 6) world poses, relative (K-1, 6) measurements).
    All scans should share a point count so the jitted registration solve is
    compiled once and reused (static shapes).

    seed_motion: seed each pairwise solve with the previous relative
    transform (constant-velocity motion model) — the standard front-end
    prior that keeps the correspondence search inside its convergence
    basin at realistic inter-scan motion.

    The registrar loop is TRANSPORT-OBLIVIOUS (r5): every pairwise solve
    is dispatched without a host↔device sync — the seed rides forward as
    a device value, the fused grid-build's overflow flag is checked one
    pair LATE (pair k's flag fetched while pair k+1 computes; True, which
    is rare and already implies a redo, redoes both pairs), and world
    poses are chained in ONE jitted scan at the end. Wall time therefore
    tracks device time, not round trips.
    """
    if registrar is None:
        registrar = make_registrar(method, config, **kwargs)
    elif kwargs:
        raise ValueError(
            "registrar=... carries its own search settings; extra kwargs "
            f"{sorted(kwargs)} would be silently ignored — bake them into "
            "the PairwiseRegistrar instead"
        )
    dtype = jnp.asarray(scans[0]).dtype
    K = len(scans)
    if K <= 1:
        return jnp.zeros((K, 6), dtype), jnp.zeros((0, 6), dtype)
    rels = [None] * (K - 1)
    prev_rel = None
    if registrar is not None:
        # Deferred, WINDOWED overflow checking: one bool() per pair is one
        # host round trip per pair; instead the device flags of the last W
        # pairs are stacked and fetched in ONE transfer, amortizing the
        # RTT to ~RTT/W per pair. Overflow is rare and already implies a
        # redo, so on a True flag pair pi is redone adaptively and the
        # pairs dispatched after it (whose seeds chained through the
        # overflowed solve) are re-registered synchronously.
        W = 8
        inflight = []  # [(pair idx, x0 used, device overflow flag), ...]

        def redo_chain(from_idx, last_idx, x0):
            # rare path: pair from_idx outgrew the grid capacities; every
            # later dispatched pair chained its seed through the overflowed
            # solve, so re-register the whole stretch synchronously (the
            # sync register handles overflow internally via adaptive
            # rebuild + capacity growth)
            for k2 in range(from_idx, last_idx + 1):
                r = registrar.register(scans[k2], scans[k2 - 1], x0=x0)
                rels[k2 - 1] = r.x
                x0 = r.x if seed_motion else None
            return rels[last_idx - 1]

        def check(window, last_idx):
            # ONE stacked-flag fetch for the whole window (a per-pair
            # bool() costs a host round trip); returns corrected prev_rel or
            # None when all flags are clean
            flags = [p[2] for p in window if p[2] is not None]
            if not flags or not bool(jnp.stack(flags).any()):
                return None
            flagged = {p[0] for p in window if p[2] is not None and bool(p[2])}
            f0 = min(flagged)
            x0 = window[[p[0] for p in window].index(f0)][1]
            return redo_chain(f0, last_idx, x0)

        for k in range(1, K):
            x0 = prev_rel if seed_motion else None
            # T_{k-1,k}: scan k into frame k-1 — dispatched sync-free
            res, ovf = registrar.register(
                scans[k], scans[k - 1], x0=x0, defer_overflow=True
            )
            rels[k - 1] = res.x
            prev_rel = res.x
            inflight.append((k, x0, ovf))
            if len(inflight) >= 2 * W:
                # lag-W: the oldest window's programs finished long ago
                # (the device holds ≥W newer pairs), so this fetch never
                # stalls the pipeline
                head, inflight = inflight[:W], inflight[W:]
                redone = check(head, k)
                if redone is not None:
                    prev_rel = redone
                    inflight = []
        if inflight:
            redone = check(inflight, inflight[-1][0])
            if redone is not None:
                prev_rel = redone
    else:
        for k in range(1, K):
            x0 = prev_rel if seed_motion else None
            rel, _ = register_pair(
                scans[k], scans[k - 1], x0=x0, method=method, config=config,
                **kwargs,
            )
            rels[k - 1] = rel
            prev_rel = rel
    rels = jnp.stack(rels)
    return chain_poses(rels), rels


def scan_slam(
    scans,
    *,
    method="icp",
    loop_closures=(),
    config=None,
    pgo_config=None,
    information_scale=1.0,
    loop_information_scale=1.0,
    **kwargs,
):
    """Odometry + loop-closure registrations + pose-graph optimization.

    loop_closures: iterable of (i, j) scan-index pairs to register directly
    (scan j onto scan i). Returns the PGOResult plus the odometry-only poses.
    """
    # loop closures share shapes with the odometry pairs — one compiled
    # registrar serves the whole pipeline; kwargs are baked into it here,
    # so they are NOT forwarded further (the strict no-silent-drop check)
    registrar = make_registrar(method, config, **kwargs)
    poses_odo, rels = scan_odometry(
        scans,
        method=method,
        config=config,
        registrar=registrar,
        **({} if registrar else kwargs),
    )
    K = len(scans)

    edge_i = list(range(K - 1))
    edge_j = list(range(1, K))
    meas = [rels[k] for k in range(K - 1)]
    info = [information_scale * np.eye(6) for _ in range(K - 1)]

    for (i, j) in loop_closures:
        # seed from the odometry estimate: z₀ = P_i⁻¹ · P_j — by loop-closure
        # time the accumulated drift is exactly what this prior absorbs
        Ti = se3.transform_from_params6(poses_odo[i])
        Tj = se3.transform_from_params6(poses_odo[j])
        z0 = _params6_of(jnp.linalg.inv(Ti) @ Tj)
        z, _ = register_pair(
            scans[j], scans[i], x0=z0, method=method, config=config,
            registrar=registrar, **({} if registrar else kwargs)
        )
        edge_i.append(i)
        edge_j.append(j)
        meas.append(z)
        info.append(loop_information_scale * np.eye(6))

    graph = pgo.PoseGraph(
        poses=poses_odo,
        edge_i=jnp.asarray(edge_i),
        edge_j=jnp.asarray(edge_j),
        measurements=jnp.stack(meas),
        information=jnp.asarray(np.stack(info), poses_odo.dtype),
        n_fixed=1,
    )
    if pgo_config is None:
        pgo_config = pgo.PGOConfig(max_iterations=30)
    result = pgo.solve_pgo(graph, pgo_config)
    return result, poses_odo


def scan_slam_fixed_lag(
    scans,
    *,
    window=8,
    method="icp",
    config=None,
    pgo_config=None,
    information_scale=1.0,
    **kwargs,
):
    """Streaming fixed-lag SLAM: bounded state, information preserved.

    Per scan: register against the previous scan (compile-once
    PairwiseRegistrar), append the odometry edge to a sliding pose window,
    refine the window with PGO, and once the window exceeds `window` poses
    marginalize the oldest one out (pose_graph.marginalize_oldest) — its
    pose is FINALIZED and its information Schur-complements into a prior
    on the surviving poses instead of being thrown away. Memory and
    per-scan solve cost are O(window), independent of trajectory length —
    the streaming counterpart of batch scan_slam (which keeps every pose).

    Returns (poses (K, 6) — finalized + current window, in order).
    """
    registrar = make_registrar(method, config, **kwargs)
    if pgo_config is None:
        pgo_config = pgo.PGOConfig(max_iterations=15)
    dtype = jnp.asarray(scans[0]).dtype

    finalized = []  # poses marginalized out (world frame)
    graph = pgo.PoseGraph(
        poses=jnp.zeros((1, 6), dtype),
        edge_i=jnp.zeros((0,), jnp.int32),
        edge_j=jnp.zeros((0,), jnp.int32),
        measurements=jnp.zeros((0, 6), dtype),
        information=jnp.zeros((0, 6, 6), dtype),
        n_fixed=1,
    )
    prev_rel = None
    for k in range(1, len(scans)):
        rel, _ = register_pair(
            scans[k], scans[k - 1], x0=prev_rel, method=method, config=config,
            registrar=registrar, **({} if registrar else kwargs)
        )
        prev_rel = rel
        new_pose = _compose(graph.poses[-1], rel)
        W = graph.poses.shape[0]
        graph = dataclasses.replace(
            graph,
            poses=jnp.concatenate([graph.poses, new_pose[None]]),
            edge_i=jnp.concatenate([graph.edge_i, jnp.asarray([W - 1], jnp.int32)]),
            edge_j=jnp.concatenate([graph.edge_j, jnp.asarray([W], jnp.int32)]),
            measurements=jnp.concatenate([graph.measurements, rel[None]]),
            information=jnp.concatenate(
                [graph.information,
                 (information_scale * jnp.eye(6, dtype=dtype))[None]]
            ),
        )
        res = pgo.solve_pgo(graph, pgo_config)
        graph = dataclasses.replace(graph, poses=res.poses)
        if graph.poses.shape[0] > window:
            finalized.append(graph.poses[0])
            graph = pgo.marginalize_oldest(graph, 1)
    return jnp.stack(finalized + list(graph.poses))
