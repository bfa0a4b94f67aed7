"""Residual blocks: the functional replacement for the reference's
model → cost-function object graph.

A reference "cost function" owns a virtual-dispatch model plus a loss and a
weight matrix (cost_function.h:16-59, model.h:12-47). Here a residual block
is a pytree: pure functions (static treedef fields) + data arrays (leaves).
The reference's two-tier hook structure is preserved exactly
(SURVEY.md §2.4.6):

* ``prepare_fn(x) -> state`` — the reference's ``setup`` (cheap param →
  transform conversion, run once per evaluation, hoisted out of the vmap);
* ``update_fn(x, data) -> data`` — the reference's ``update`` (e.g. ICP
  correspondence re-association, run once per outer LM iteration,
  src/levenberg_marquadt_dyn.cpp:54).

``residual_fn(state, data_i)`` returns the per-index residual (O,) — or a
tuple ``(residual, valid)`` mirroring the reference's bool return of
``f`` (model.h:33), which becomes a vmapped validity mask.
"""

import dataclasses
from typing import Any, Callable, Optional

import jax


def _identity_prepare(x):
    return x


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ResidualBlock:
    """One cost block: ``(residual_fn, data, loss, weight_matrix)``.

    Fields
    ------
    residual_fn : (state, data_i) -> (O,) array, or ((O,), valid_bool)
        Per-residual model function (reference model.h `f`). vmapped over the
        leading axis of ``data``; evaluated once if ``data`` is None.
    data : pytree with leading axis N on every leaf, or None
        Per-residual data (points, observations). None means a single
        residual over the whole state (e.g. Powell, reference tst/powell.cpp).
    loss : loss object with .weight(sq_norm)
        IRLS weight on H,b only (reference semantics, linearization.h:108-115).
    weight_matrix : (O, O) array or None
        Per-residual information matrix Σ, sandwiched as JᵀΣJ / JᵀΣr
        (reference covariance, linearization.h:113-114). None = identity.
    prepare_fn : x -> state (static)
        Reference `setup` hook. Default: identity (state is x itself).
    jacobian_fn : (state, data_i) -> (O, P) or None (static)
        Analytic Jacobian (row-major (O,P) as in reference linearization.h:17).
        None: differentiate residual_fn (jacfwd) or finite differences.
    update_fn : (x, data) -> data or None (static)
        Reference `update` hook, run once per outer iteration.
    name : str (static)
    """

    data: Any
    loss: Any
    weight_matrix: Optional[jax.Array] = None
    residual_fn: Callable = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    prepare_fn: Callable = dataclasses.field(
        default=_identity_prepare, metadata=dict(static=True)
    )
    jacobian_fn: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    update_fn: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    linearize_fn: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )  # optional fused fast path: (block, x) -> (cost, H, b); used for mode="auto"
    weight_fn: Optional[Callable] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )  # state-dependent per-residual information: (state, data_i) -> (O, O);
    # overrides weight_matrix (GICP's C_q + R C_s Rᵀ inverse, for example)
    weighted_cost: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # True: cost (and the LM ρ test) uses the Ω-weighted objective Σ rᵀΩr —
    # required when Ω is strongly anisotropic (GICP), where a step that
    # decreases the weighted objective can increase the raw Σ‖r‖² and would
    # otherwise always be rejected. False (default) keeps reference parity:
    # cost is the unweighted Σ‖r‖² (linearization.h:108-115).
    name: str = dataclasses.field(default="block", metadata=dict(static=True))

    def update(self, x):
        """Run the correspondence/update hook, returning a new block."""
        if self.update_fn is None:
            return self
        return dataclasses.replace(self, data=self.update_fn(x, self.data))


def make_block(
    residual_fn,
    data=None,
    *,
    loss=None,
    weight_matrix=None,
    prepare_fn=_identity_prepare,
    jacobian_fn=None,
    update_fn=None,
    linearize_fn=None,
    weight_fn=None,
    weighted_cost=False,
    name="block",
):
    """Convenience constructor with a TrivialLoss default (reference
    cost_function.h:28 installs NoLoss by default)."""
    from moptimizer_jax.core.loss import TrivialLoss

    return ResidualBlock(
        data=data,
        loss=loss if loss is not None else TrivialLoss(),
        weight_matrix=weight_matrix,
        residual_fn=residual_fn,
        prepare_fn=prepare_fn,
        jacobian_fn=jacobian_fn,
        update_fn=update_fn,
        linearize_fn=linearize_fn,
        weight_fn=weight_fn,
        weighted_cost=weighted_cost,
        name=name,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Problem:
    """A set of residual blocks over one parameter vector.

    Replaces the reference Optimizer's cost list (optimizer.h:58,82);
    multiple blocks sum exactly into one Gauss-Newton system (invariant
    pinned by reference tst/multiple_objectives.cpp:102-132).
    """

    blocks: tuple

    def update(self, x):
        """Run every block's update hook (once per outer LM iteration)."""
        return Problem(blocks=tuple(b.update(x) for b in self.blocks))


def problem(*blocks):
    if len(blocks) == 0:
        raise ValueError("No residual block added!")  # reference optimizer.h:48-51
    return Problem(blocks=tuple(blocks))
