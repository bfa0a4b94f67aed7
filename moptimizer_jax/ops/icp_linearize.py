"""Closed-form (moment-based) point-to-point linearization — the fused fast
path for registration.

Key identity: for r_i = R s_i + t − q_i with the params6 convention, the
Jacobian is J_i = [I₃ | −[y_i]ₓ J_l(ω)] with y_i = R s_i, and because
hat(·) is linear the weighted Gauss-Newton sums collapse to *moments*:

    H_tt = (Σ wᵢ) I₃
    H_tω = −hat(Σ wᵢ yᵢ) · J_l
    H_ωω = J_lᵀ (tr(M)·I₃ − M) J_l,   M = Σ wᵢ yᵢ yᵢᵀ
    b_t  = Σ wᵢ rᵢ
    b_ω  = J_lᵀ Σ wᵢ (yᵢ × rᵢ)

so the (N,3,6) Jacobian tensor is never built: one elementwise pass + two
small matmuls produce nine moments and H,b are assembled from them. This is
the speed-of-light formulation — HBM traffic is one read of the two clouds
(the generic AD path materializes J). XLA fuses the whole pipeline; no
hand-written kernel needed once the math is fused at this level.

Loss semantics identical to core.linearize (reference linearization.h:108-115):
w = loss(‖r‖²)·valid hits H,b only; cost is unweighted Σ valid‖r‖².
"""

import jax.numpy as jnp

from moptimizer_jax.lie import so3


def icp_moments(src, tgt, R, t, loss, valid=None):
    """Weighted moments over the cloud. src/tgt: (N, 3); R (3,3), t (3,).

    Deliberately matmul-free: a (N,3)·(3,3) product is a degenerate matmul
    shape (K=3); unrolled component arithmetic keeps
    the whole pass elementwise + lane reductions, which XLA fuses into a
    single HBM-bound sweep.

    Returns dict(Sw, Sy (3,), Sr (3,), Sxr (3,), M (3,3), cost).
    """
    s0, s1, s2 = src[:, 0], src[:, 1], src[:, 2]
    y = [R[j, 0] * s0 + R[j, 1] * s1 + R[j, 2] * s2 for j in range(3)]
    r = [y[j] + t[j] - tgt[:, j] for j in range(3)]
    sq = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    w = loss.weight(sq)
    if valid is not None:
        vf = valid.astype(src.dtype)
        w = w * vf
        cost = jnp.sum(vf * sq)
    else:
        cost = jnp.sum(sq)

    cross = [
        y[1] * r[2] - y[2] * r[1],
        y[2] * r[0] - y[0] * r[2],
        y[0] * r[1] - y[1] * r[0],
    ]
    M = jnp.stack(
        [
            jnp.stack([jnp.sum(w * y[j] * y[k]) for k in range(3)])
            for j in range(3)
        ]
    )
    return dict(
        Sw=jnp.sum(w),
        Sy=jnp.stack([jnp.sum(w * y[j]) for j in range(3)]),
        Sr=jnp.stack([jnp.sum(w * r[j]) for j in range(3)]),
        Sxr=jnp.stack([jnp.sum(w * cross[j]) for j in range(3)]),
        cost=cost,
        M=M,
    )


def assemble_icp_system(m, x):
    """(cost, H (6,6), b (6,)) from moments + state (for J_l(ω))."""
    dtype = x.dtype
    Jl = so3.left_jacobian(x[3:6])
    eye = jnp.eye(3, dtype=dtype)

    H_tt = m["Sw"] * eye
    H_tw = -so3.hat(m["Sy"]) @ Jl
    Mw = jnp.trace(m["M"]) * eye - m["M"]
    H_ww = Jl.T @ Mw @ Jl
    H = jnp.block([[H_tt, H_tw], [H_tw.T, H_ww]])
    b = jnp.concatenate([m["Sr"], Jl.T @ m["Sxr"]])
    return m["cost"], H, b


def icp_linearize(src, tgt, x, loss, valid=None):
    """Fused linearization: equivalent to linearize(point2point_block(src,
    tgt, loss=loss), x, mode="auto") but via moments. src/tgt: (N, 3)."""
    R = so3.exp(x[3:6])
    t = x[0:3]
    m = icp_moments(src, tgt, R, t, loss, valid=valid)
    return assemble_icp_system(m, x)


def fused_point2point_linearizer(block, x):
    """`linearize_fn` override for point2point/icp blocks whose data carries
    src (+ tgt or matched [+ valid]). Handles parallel.mesh.pad_block_to's
    {_inner, _valid} wrapping transparently."""
    d = block.data
    pad_valid = None
    if "_inner" in d:
        pad_valid = d["_valid"]
        d = d["_inner"]
    valid = d.get("valid")
    if pad_valid is not None:
        valid = pad_valid if valid is None else (valid & pad_valid)
    tgt = d.get("tgt", d.get("matched"))
    return icp_linearize(d["src"], tgt, x, block.loss, valid=valid)
