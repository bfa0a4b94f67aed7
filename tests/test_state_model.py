"""15-DoF product-state (SO(3)×R¹²) smoke + manifold tests
(reference tst/state_model.cpp:83-112, tst/manifold.cpp)."""

import jax.numpy as jnp
import numpy as np

from moptimizer_jax import LMConfig, levenberg_marquardt
from moptimizer_jax.core import manifold
from moptimizer_jax.core.residual import problem
from moptimizer_jax.lie import so3
from moptimizer_jax.models.state import product_state_block


def test_product_state_converges_to_anchor():
    """r = x ⊟ x₀ → LM drives x to the anchor state."""
    anchor_rot = jnp.array([0.1, 0.2, 0.3])
    anchor_lin = jnp.zeros(12)
    blk = product_state_block(anchor_rot, anchor_lin)
    x0 = jnp.concatenate([jnp.array([0.6, 0.8, 0.3]), jnp.zeros(12).at[0].set(-0.4)])
    res = levenberg_marquardt(
        problem(blk), x0, LMConfig(diff_mode="fd", max_iterations=15)
    )
    # rotation part equal as rotations
    R_est = so3.exp(res.x[:3])
    R_anchor = so3.exp(anchor_rot)
    np.testing.assert_allclose(R_est, R_anchor, atol=1e-6)
    np.testing.assert_allclose(res.x[3:], anchor_lin, atol=1e-6)


def test_euclidean_manifold():
    """⊞/⊟ exact (reference tst/manifold.cpp:5-29)."""
    m = manifold.Euclidean(dim=3)
    x = jnp.array([1.0, -2.0, 3.0])
    d = jnp.array([0.5, 0.25, -1.0])
    np.testing.assert_array_equal(m.retract(x, d), x + d)
    np.testing.assert_array_equal(m.local(x, x + d), d)


def test_so3_manifold_matches_quaternion_construction():
    """SO(3) ⊞ via Exp ≈ unit-quaternion construction for small delta
    (reference tst/manifold.cpp:58-81)."""
    m = manifold.SO3()
    x = jnp.zeros(3)
    delta = jnp.array([0.02, 0.0, 0.0])
    R = so3.exp(m.retract(x, delta))
    q = np.array([0.02 / 2.0, 0.0, 0.0])  # small-angle quaternion vector part ≈ w/2
    w = np.sqrt(1 - q @ q)
    # quaternion to rotation
    x_, y_, z_ = q
    R_q = np.array(
        [
            [1 - 2 * (y_**2 + z_**2), 2 * (x_ * y_ - z_ * w), 2 * (x_ * z_ + y_ * w)],
            [2 * (x_ * y_ + z_ * w), 1 - 2 * (x_**2 + z_**2), 2 * (y_ * z_ - x_ * w)],
            [2 * (x_ * z_ - y_ * w), 2 * (y_ * z_ + x_ * w), 1 - 2 * (x_**2 + y_**2)],
        ]
    )
    np.testing.assert_allclose(R, R_q, atol=5e-6)


def test_se3_manifold_roundtrip():
    m = manifold.SE3()
    x = jnp.array([1.0, 2.0, 3.0, 0.3, -0.2, 0.1])
    d = jnp.array([0.1, -0.1, 0.2, 0.05, 0.02, -0.03])
    y = m.retract(x, d)
    np.testing.assert_allclose(m.local(x, y), d, atol=1e-10)


def test_product_manifold():
    m = manifold.Product(parts=(manifold.SO3(), manifold.Euclidean(dim=12)))
    assert m.dim == 15 and m.tangent_dim == 15
    x = jnp.zeros(15)
    d = jnp.concatenate([jnp.array([0.1, 0.2, 0.3]), jnp.ones(12)])
    y = m.retract(x, d)
    np.testing.assert_allclose(y[3:], jnp.ones(12), atol=0)
    np.testing.assert_allclose(m.local(x, y), d, atol=1e-10)


def test_manifold_lm_on_product_state():
    """Solve the product-state problem with a true manifold retraction —
    the wiring the reference left as TODO (src/levenberg_marquadt_dyn.cpp:82)."""
    anchor_rot = jnp.array([0.1, 0.2, 0.3])
    anchor_lin = jnp.zeros(12)
    blk = product_state_block(anchor_rot, anchor_lin)
    man = manifold.Product(parts=(manifold.SO3(), manifold.Euclidean(dim=12)))
    x0 = jnp.concatenate([jnp.array([0.6, 0.8, 0.3]), jnp.zeros(12)])
    res = levenberg_marquardt(
        problem(blk), x0, LMConfig(diff_mode="auto", max_iterations=20), manifold=man
    )
    np.testing.assert_allclose(so3.exp(res.x[:3]), so3.exp(anchor_rot), atol=1e-6)
    np.testing.assert_allclose(res.x[3:], anchor_lin, atol=1e-6)


# ---- Sphere manifold (r4 — the reference ontology's "Spherical"
# parameterization, docs/Optimizer.puml, never implemented there) ----------


def test_sphere_manifold_chart_roundtrip():
    import numpy as np

    from moptimizer_jax.core.manifold import Sphere

    m = Sphere(dim=4)
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = rng.normal(size=4)
        x /= np.linalg.norm(x)
        d = 0.3 * rng.normal(size=3)
        y = np.asarray(m.retract(jnp.asarray(x), jnp.asarray(d)))
        np.testing.assert_allclose(np.linalg.norm(y), 1.0, atol=1e-12)
        d_back = np.asarray(m.local(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(d_back, d, atol=1e-9)
    # zero step is the identity
    x = rng.normal(size=4)
    x /= np.linalg.norm(x)
    y0 = np.asarray(m.retract(jnp.asarray(x), jnp.zeros(3)))
    np.testing.assert_allclose(y0, x, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(m.local(jnp.asarray(x), jnp.asarray(x))), 0.0, atol=1e-9
    )


def test_sphere_manifold_quaternion_fit():
    """Unit-quaternion attitude fit through the LM solver with
    manifold=Sphere(4): tangent dim 3, unit norm preserved exactly."""
    import numpy as np

    from moptimizer_jax.core.manifold import Sphere
    from moptimizer_jax.core.residual import make_block, problem
    from moptimizer_jax.core.solver import LMConfig, levenberg_marquardt

    def quat_rot(q):
        w, x, y, z = q[0], q[1], q[2], q[3]
        return jnp.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    rng = np.random.default_rng(4)
    q_true = rng.normal(size=4)
    q_true /= np.linalg.norm(q_true)
    vs = rng.normal(size=(12, 3))
    ms = np.asarray(jnp.einsum("ij,nj->ni", quat_rot(jnp.asarray(q_true)), jnp.asarray(vs)))

    def residual(q, d):
        return d["m"] - quat_rot(q) @ d["v"]

    blk = make_block(residual, data=dict(v=jnp.asarray(vs), m=jnp.asarray(ms)))
    q0 = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    res = levenberg_marquardt(
        problem(blk),
        q0,
        LMConfig(diff_mode="auto", max_iterations=30),
        manifold=Sphere(dim=4),
    )
    q_est = np.asarray(res.x)
    np.testing.assert_allclose(np.linalg.norm(q_est), 1.0, atol=1e-12)
    # q and −q are the same rotation
    if np.dot(q_est, q_true) < 0:
        q_est = -q_est
    np.testing.assert_allclose(q_est, q_true, atol=1e-8)
    assert float(res.cost) < 1e-20
