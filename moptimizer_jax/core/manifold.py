"""First-class manifolds wired into the LM update.

The reference sketches a Manifold interface (manifold.h:11-41) but never
connects it — its LM update is plain Euclidean ``x + δ`` with a
``// TODO Manifold operation`` (src/levenberg_marquadt_dyn.cpp:82-83).
Here manifolds are real: the solver retracts via ``manifold.retract(x, δ)``
and linearizes in the tangent space. Manifolds are frozen dataclasses
(hashable) so they can be static jit arguments.

State is always a flat parameter vector (matching the reference's
parameterize-then-Exp convention, SURVEY.md §2.4.1); a manifold defines how
a tangent step lands back on that vector.
"""

import dataclasses

import jax.numpy as jnp

from moptimizer_jax.lie import so3


@dataclasses.dataclass(frozen=True)
class Euclidean:
    """x ⊞ δ = x + δ (reference EuclideanManifold, manifold.h:32-41)."""

    dim: int

    @property
    def tangent_dim(self):
        return self.dim

    def retract(self, x, delta):
        return x + delta

    def local(self, x, y):
        return y - x


@dataclasses.dataclass(frozen=True)
class SO3:
    """Rotation-vector state w ∈ R³ for R = exp(w); retraction R·exp(δ)
    (right-multiplicative, the convention of reference tst/manifold.cpp:40-44)."""

    @property
    def dim(self):
        return 3

    @property
    def tangent_dim(self):
        return 3

    def retract(self, x, delta):
        return so3.log(so3.exp(x) @ so3.exp(delta))

    def local(self, x, y):
        return so3.log(so3.exp(x).T @ so3.exp(y))


@dataclasses.dataclass(frozen=True)
class SE3:
    """6-DoF state [t, w] (reference params6 convention, src/so3.cpp:7-19);
    retraction composes transforms: T(x)·T(δ)."""

    @property
    def dim(self):
        return 6

    @property
    def tangent_dim(self):
        return 6

    def retract(self, x, delta):
        from moptimizer_jax.lie import se3 as se3mod

        T = se3mod.transform_from_params6(x) @ se3mod.transform_from_params6(delta)
        w = so3.log(T[:3, :3])
        return jnp.concatenate([T[:3, 3], w])

    def local(self, x, y):
        from moptimizer_jax.lie import se3 as se3mod

        Tx = se3mod.transform_from_params6(x)
        Ty = se3mod.transform_from_params6(y)
        R = Tx[:3, :3]
        D_R = R.T @ Ty[:3, :3]
        D_t = R.T @ (Ty[:3, 3] - Tx[:3, 3])
        return jnp.concatenate([D_t, so3.log(D_R)])


@dataclasses.dataclass(frozen=True)
class Product:
    """Product manifold over contiguous slices of the state vector — e.g. the
    reference's 15-DoF SO(3)×R¹² composite state (tst/state_model.cpp:16-50)."""

    parts: tuple  # tuple of manifolds, applied to consecutive slices

    @property
    def dim(self):
        return sum(p.dim for p in self.parts)

    @property
    def tangent_dim(self):
        return sum(p.tangent_dim for p in self.parts)

    def retract(self, x, delta):
        out, xo, do = [], 0, 0
        for p in self.parts:
            out.append(p.retract(x[xo : xo + p.dim], delta[do : do + p.tangent_dim]))
            xo += p.dim
            do += p.tangent_dim
        return jnp.concatenate(out)

    def local(self, x, y):
        out, xo = [], 0
        for p in self.parts:
            out.append(p.local(x[xo : xo + p.dim], y[xo : xo + p.dim]))
            xo += p.dim
        return jnp.concatenate(out)


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Unit-norm state s ∈ Sⁿ⁻¹ ⊂ Rⁿ (n = dim, tangent_dim = n−1) — the
    "Spherical" parameterization the reference's intended ontology lists
    (docs/Optimizer.puml) but never implements. Quaternions (n = 4) are the
    canonical use.

    Chart: Householder tangent basis B(x) (the Ceres SphereManifold
    construction) + the sphere exponential map
        retract(x, δ) = cos‖δ‖·x + sinc‖δ‖·B(x)δ,
        local(x, y)   = θ·p/‖p‖,  p = B(x)ᵀy,  θ = atan2(‖p‖, x·y),
    with differentiable small-angle guards.
    """

    dim: int

    @property
    def tangent_dim(self):
        return self.dim - 1

    def _basis(self, xn):
        # Householder reflector sending e_{n−1} to ∓xn; its remaining
        # columns are an orthonormal basis of the tangent space at xn
        n = self.dim
        e = jnp.zeros(n, xn.dtype).at[-1].set(1.0)
        sign = jnp.where(xn[-1] >= 0, 1.0, -1.0).astype(xn.dtype)
        v = xn + sign * e
        v = v / jnp.sqrt(jnp.sum(v * v) + jnp.finfo(xn.dtype).tiny)
        H = jnp.eye(n, dtype=xn.dtype) - 2.0 * jnp.outer(v, v)
        return H[:, :-1]  # (n, n−1), columns ⊥ xn

    def retract(self, x, delta):
        eps = jnp.finfo(x.dtype).eps
        xn = x / jnp.sqrt(jnp.sum(x * x) + eps)
        B = self._basis(xn)
        th2 = jnp.sum(delta * delta)
        th = jnp.sqrt(th2 + eps * eps)
        small = th2 < jnp.sqrt(eps)
        sinc = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
        cos = jnp.where(small, 1.0 - th2 / 2.0, jnp.cos(th))
        return cos * xn + sinc * (B @ delta)

    def local(self, x, y):
        eps = jnp.finfo(x.dtype).eps
        xn = x / jnp.sqrt(jnp.sum(x * x) + eps)
        yn = y / jnp.sqrt(jnp.sum(y * y) + eps)
        B = self._basis(xn)
        p = B.T @ yn  # (n−1,)
        pn2 = jnp.sum(p * p)
        pn = jnp.sqrt(pn2 + eps * eps)
        th = jnp.arctan2(pn, jnp.dot(xn, yn))
        scale = jnp.where(pn2 < jnp.sqrt(eps), 1.0, th / pn)
        return scale * p
