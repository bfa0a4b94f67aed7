"""Sharded linearization + distributed LM.

Two composable mechanisms, both producing H,b reductions across devices:

* ``sharded_linearize`` / ``sharded_compute_cost`` — explicit
  ``shard_map`` over a mesh axis: each device linearizes its shard of the
  residual set, then ``psum``s (c, H, b). Deterministic placement, the
  direct device analogue of the reference's TBB ``parallel_reduce``
  (linearization.h:49-63) — minus its data race (SURVEY.md §2.4.3).

* ``distributed_levenberg_marquardt`` — GSPMD path: block data is
  device_put sharded along the residual axis and the ordinary jitted LM
  (core.solver) runs under those shardings; XLA partitions the vmap and
  inserts the collectives. Zero solver changes — the same compiled loop
  serves one device or a multi-GPU mesh.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from moptimizer_jax.core.linearize import _linearize_block, _batched_residuals
from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt
from moptimizer_jax.parallel.mesh import pad_block_to, shard_block_data


def sharded_linearize(block, x, mesh, axis="data", mode="auto"):
    """(cost, H, b) with per-shard linearization and a psum over the mesh axis.

    The block's residual axis must divide by the axis size (use pad_block_to).
    """
    n_shards = mesh.shape[axis]
    leaves = jax.tree_util.tree_leaves(block.data)
    n = leaves[0].shape[0]
    if n % n_shards != 0:
        block = pad_block_to(block, n_shards)

    data = block.data
    template = dataclasses.replace(block, data=None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), jax.tree_util.tree_map(lambda _: P(axis), data)),
        out_specs=(P(), P(), P()),
    )
    def _lin(x_rep, data_shard):
        blk = dataclasses.replace(template, data=data_shard)
        c, H, b = _linearize_block(blk, x_rep, mode)
        return (
            jax.lax.psum(c, axis),
            jax.lax.psum(H, axis),
            jax.lax.psum(b, axis),
        )

    return _lin(x, data)


def sharded_compute_cost(block, x, mesh, axis="data"):
    """Σ‖r‖² with a psum reduction (reference parallelComputeCost semantics)."""
    n_shards = mesh.shape[axis]
    leaves = jax.tree_util.tree_leaves(block.data)
    if leaves[0].shape[0] % n_shards != 0:
        block = pad_block_to(block, n_shards)
    data = block.data
    template = dataclasses.replace(block, data=None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), jax.tree_util.tree_map(lambda _: P(axis), data)),
        out_specs=P(),
    )
    def _cost(x_rep, data_shard):
        blk = dataclasses.replace(template, data=data_shard)
        r, valid = _batched_residuals(blk, x_rep)
        return jax.lax.psum(
            jnp.sum(valid.astype(x_rep.dtype) * jnp.sum(r * r, axis=-1)), axis
        )

    return _cost(x, data)


def distributed_levenberg_marquardt(
    problem, x0, mesh, config=LMConfig(), manifold=None, axis="data"
):
    """LM with every block's residual data sharded across the mesh.

    GSPMD partitions the linearization matmuls and inserts psums for the
    (P,P) Gauss-Newton reduction; the solve of the tiny damped system runs
    replicated. Residual counts are padded per block to the axis size.
    """
    from moptimizer_jax.core.residual import Problem

    if not isinstance(problem, Problem):
        problem = Problem(blocks=(problem,))
    n_shards = mesh.shape[axis]
    blocks = []
    for blk in problem.blocks:
        if blk.data is not None:
            blk = pad_block_to(blk, n_shards)
            blk = shard_block_data(blk, mesh, axis)
        blocks.append(blk)
    sharded_problem = Problem(blocks=tuple(blocks))
    x0 = jax.device_put(jnp.asarray(x0), NamedSharding(mesh, P()))
    return levenberg_marquardt(sharded_problem, x0, config, manifold)
