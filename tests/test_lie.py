"""Lie-group unit tests: round trips, Jacobian-vs-AD, reference-formula parity.

Mirrors the correctness strategy of reference tst/manifold.cpp and the
so3 usage throughout the reference test suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from moptimizer_jax import lie
from moptimizer_jax.lie import so3


RNG = np.random.default_rng(0)
SAMPLES = [
    np.zeros(3),
    np.array([1e-9, 0, 0]),
    np.array([1e-6, -1e-7, 1e-6]),
    np.array([0.02, 0.0, 0.0]),
    np.array([0.3, 0.4, 0.5]),
    np.array([-1.2, 0.7, 2.0]),
    RNG.normal(size=3),
]


@pytest.mark.parametrize("w", SAMPLES, ids=range(len(SAMPLES)))
def test_exp_log_roundtrip(w):
    w = jnp.asarray(w, dtype=jnp.float64)
    R = so3.exp(w)
    # R is a rotation
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    w_back = so3.log(R)
    np.testing.assert_allclose(w_back, w, atol=1e-9)


NEAR_PI_SAMPLES = [
    np.array([np.pi, 0.0, 0.0]),                       # exactly π about an axis
    np.array([0.0, 0.0, np.pi]),
    (np.pi / np.sqrt(3.0)) * np.ones(3),               # π about a skew axis
    np.array([np.pi - 1e-8, 0.0, 0.0]),                # just inside π
    np.array([0.0, np.pi - 1e-4, 0.0]),
    (np.pi - 1e-6) * np.array([0.6, -0.64, 0.48]) / 0.9977975145171559,
]


@pytest.mark.parametrize("w", NEAR_PI_SAMPLES, ids=range(len(NEAR_PI_SAMPLES)))
def test_exp_log_roundtrip_near_pi(w):
    """log must stay accurate through the θ → π singularity of the classic
    vee(R−Rᵀ) formula (regression: half-turn poses on a loop trajectory got
    ~17° errors before the quaternion-based log)."""
    w = jnp.asarray(w / np.linalg.norm(w) * min(np.linalg.norm(w), np.pi), jnp.float64)
    R = so3.exp(w)
    w_back = so3.log(R)
    # θ = π maps ±axis to the same rotation: compare as rotations
    np.testing.assert_allclose(np.asarray(so3.exp(w_back)), np.asarray(R), atol=1e-12)
    # and the angle must be exact
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(w_back)), np.linalg.norm(np.asarray(w)), atol=1e-12
    )


def test_inverse_left_jacobian_near_pi():
    """J_l⁻¹'s trig factor is 0/0 at θ = π in its textbook form; the
    half-angle rewrite must agree with an explicit matrix inverse there."""
    for w in NEAR_PI_SAMPLES:
        w = jnp.asarray(w, jnp.float64)
        J = so3.left_jacobian(w)
        Jinv = so3.inverse_left_jacobian(w)
        np.testing.assert_allclose(np.asarray(Jinv @ J), np.eye(3), atol=1e-9)
        assert np.all(np.isfinite(np.asarray(Jinv)))


def test_exp_matches_rodrigues_reference_form():
    """Parity with reference so3::Exp (src/so3.cpp:59-75): Rodrigues formula."""
    w = jnp.array([0.3, 0.4, 0.5], dtype=jnp.float64)
    t = float(jnp.linalg.norm(w))
    axis = np.asarray(w) / t
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    expected = np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K
    np.testing.assert_allclose(so3.exp(w), expected, atol=1e-14)


@pytest.mark.parametrize("w", SAMPLES, ids=range(len(SAMPLES)))
def test_left_jacobian_vs_ad(w):
    """d/dw [exp(w)·v] = −hat(exp(w)v)·J_l(w): check J_l against jacfwd."""
    w = jnp.asarray(w, dtype=jnp.float64)
    v = jnp.array([0.0, 0.0, 9.81], dtype=jnp.float64)
    J_ad = jax.jacfwd(lambda x: so3.exp(x) @ v)(w)
    J_formula = -so3.hat(so3.exp(w) @ v) @ so3.left_jacobian(w)
    np.testing.assert_allclose(J_ad, J_formula, atol=1e-9)


@pytest.mark.parametrize("w", SAMPLES, ids=range(len(SAMPLES)))
def test_jacobian_inverses(w):
    w = jnp.asarray(w, dtype=jnp.float64)
    np.testing.assert_allclose(
        so3.left_jacobian(w) @ so3.inverse_left_jacobian(w), np.eye(3), atol=1e-9
    )
    np.testing.assert_allclose(
        so3.right_jacobian(w) @ so3.inverse_right_jacobian(w), np.eye(3), atol=1e-9
    )


def test_right_left_relation():
    w = jnp.asarray([0.3, -0.2, 0.9], dtype=jnp.float64)
    np.testing.assert_allclose(so3.right_jacobian(w), so3.left_jacobian(-w), atol=1e-14)
    # J_r = J_lᵀ
    np.testing.assert_allclose(so3.right_jacobian(w), so3.left_jacobian(w).T, atol=1e-12)


def test_transform_from_params6_reference_convention():
    """Parity with so3::convert6DOFParameterToMatrix (src/so3.cpp:7-19)."""
    x = jnp.array([10.5, 10.2, 0.1, 0.3, 0.4, 0.5], dtype=jnp.float64)
    T = lie.transform_from_params6(x)
    np.testing.assert_allclose(T[:3, 3], x[:3], atol=0)
    np.testing.assert_allclose(T[:3, :3], so3.exp(x[3:]), atol=0)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1], atol=0)


def test_se3_exp_log_roundtrip():
    xi = jnp.array([0.1, -0.4, 2.0, 0.3, 0.4, 0.5], dtype=jnp.float64)
    T = lie.se3_exp(xi)
    np.testing.assert_allclose(lie.se3_log(T), xi, atol=1e-10)


def test_apply_transform():
    x = jnp.array([1.0, 2.0, 3.0, 0.2, 0.2, 0.2], dtype=jnp.float64)
    T = lie.transform_from_params6(x)
    pts = jnp.asarray(RNG.normal(size=(17, 3)))
    expected = (np.asarray(T[:3, :3]) @ np.asarray(pts).T).T + np.asarray(T[:3, 3])
    np.testing.assert_allclose(lie.apply_transform(T, pts), expected, atol=1e-12)


def test_batched_exp():
    ws = jnp.asarray(RNG.normal(size=(32, 3)))
    Rs = so3.exp(ws)
    assert Rs.shape == (32, 3, 3)
    for i in range(4):
        np.testing.assert_allclose(Rs[i], so3.exp(ws[i]), atol=1e-14)


def test_grad_through_exp_at_zero():
    """Small-angle branches must be AD-safe at exactly θ = 0."""
    g = jax.grad(lambda w: jnp.sum(so3.exp(w)))(jnp.zeros(3, dtype=jnp.float64))
    assert np.all(np.isfinite(g))
    g2 = jax.grad(lambda w: jnp.sum(so3.left_jacobian(w)))(jnp.zeros(3, dtype=jnp.float64))
    assert np.all(np.isfinite(g2))


@pytest.mark.parametrize("dt", [0.0, 1e-3, 0.04, 1.0, -0.5])
def test_exp_dt_integrates_angular_velocity(dt):
    """so3.exp_dt(w, dt) == exp(w*dt) == Rodrigues at angle |w|*dt about
    w/|w| — the reference's two-argument overload (so3.cpp:76-93)."""
    w = jnp.asarray([0.3, -0.8, 0.5], jnp.float64)
    R = so3.exp_dt(w, dt)
    np.testing.assert_allclose(
        np.asarray(R), np.asarray(so3.exp(w * dt)), rtol=0, atol=1e-14
    )
    # reference form: axis-normalized Rodrigues at r_ang = |w|*dt
    n = float(jnp.linalg.norm(w))
    K = np.asarray(so3.hat(w / n))
    ang = n * dt
    R_ref = np.eye(3) + np.sin(ang) * K + (1.0 - np.cos(ang)) * K @ K
    np.testing.assert_allclose(np.asarray(R), R_ref, atol=1e-12)
    # round trip: log recovers w*dt (within the principal branch)
    if abs(ang) < np.pi:
        np.testing.assert_allclose(
            np.asarray(so3.log(R)), np.asarray(w) * dt, atol=1e-12
        )


def test_exp_dt_zero_velocity_differentiable():
    """At ω = 0 the reference snaps to identity; here the Taylor branch
    keeps exp_dt differentiable in dt (d/dt Exp(ω t) = hat(ω) at t=0)."""
    w = jnp.asarray([0.2, -0.1, 0.4], jnp.float64)
    np.testing.assert_allclose(
        np.asarray(so3.exp_dt(jnp.zeros(3, jnp.float64), 0.7)), np.eye(3), atol=0
    )
    dR = jax.jacfwd(lambda t: so3.exp_dt(w, t))(jnp.asarray(0.0, jnp.float64))
    np.testing.assert_allclose(np.asarray(dR), np.asarray(so3.hat(w)), atol=1e-12)


def test_exp_dt_batched():
    ws = jnp.asarray(RNG.normal(size=(5, 3)))
    dts = jnp.asarray(RNG.uniform(0.0, 0.1, size=(5,)))
    Rs = so3.exp_dt(ws, dts)
    for i in range(5):
        np.testing.assert_allclose(
            np.asarray(Rs[i]), np.asarray(so3.exp(ws[i] * dts[i])), atol=1e-14
        )
