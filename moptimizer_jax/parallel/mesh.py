"""Device mesh + residual-sharding helpers.

The reference's only parallelism is a TBB parallel_reduce over residual
indices inside one process (linearization.h:49-63). The scaling axis here is
the same dimension — residual count — but laid out across a device mesh:
every block's data is sharded along its leading (residual) axis and the
Gauss-Newton reduction is a psum, which XLA hands to NCCL over NVLink on a
multi-GPU host (SURVEY.md §2.3). The mesh is 1-D: the cards of a host are
joined all to all, so there is no torus for a mesh shape to follow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis="data"):
    """1-D data-parallel mesh over the first n devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def pad_block_to(block, multiple):
    """Pad a block's residual axis to a multiple (mask keeps padded rows out).

    Static shapes are an XLA requirement; validity masking is how the
    reference's dynamic residual counts (bool return of `f`, model.h:33)
    map to static device shapes. Padded rows reuse row 0's data and are masked invalid via a
    wrapped residual_fn.
    """
    if block.data is None:
        return block
    leaves = jax.tree_util.tree_leaves(block.data)
    n = leaves[0].shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return block
    pad = target - n

    def pad_leaf(leaf):
        return jnp.concatenate([leaf, jnp.broadcast_to(leaf[:1], (pad,) + leaf.shape[1:])])

    data = jax.tree_util.tree_map(pad_leaf, block.data)
    # carry an explicit validity column via a wrapped residual_fn
    data = dict(_inner=data, _valid=jnp.arange(target) < n)
    inner_fn = block.residual_fn

    def wrapped(state, d):
        out = inner_fn(state, d["_inner"])
        if isinstance(out, tuple):
            r, v = out
            return r, v & d["_valid"]
        return out, d["_valid"]

    inner_jac = block.jacobian_fn
    wrapped_jac = None
    if inner_jac is not None:
        def wrapped_jac(state, d):  # noqa: F811
            return inner_jac(state, d["_inner"])

    return dataclasses.replace(
        block, data=data, residual_fn=wrapped, jacobian_fn=wrapped_jac
    )


def shard_block_data(block, mesh, axis="data"):
    """device_put a block's data sharded along the residual axis; everything
    else (loss params, Σ) replicated."""
    if block.data is None:
        return block
    sharding = NamedSharding(mesh, P(axis))

    def place(leaf):
        return jax.device_put(leaf, sharding)

    return dataclasses.replace(block, data=jax.tree_util.tree_map(place, block.data))
