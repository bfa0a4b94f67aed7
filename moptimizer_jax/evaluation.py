"""Trajectory evaluation: ATE / RPE metrics + Umeyama alignment.

The BASELINE north star pins "ATE vs reference within bound on benchmark
sequences"; this module supplies the standard evaluation harness:
absolute trajectory error after optimal SE(3)/Sim(3) alignment (Umeyama),
and relative pose error over a fixed frame delta.
"""

import jax.numpy as jnp

from moptimizer_jax.lie import se3, so3


def umeyama_alignment(src, tgt, with_scale=False):
    """Least-squares similarity transform aligning src → tgt ((N,3) each).

    Returns (s, R, t) with tgt ≈ s·R·src + t (classic Umeyama 1991 closed
    form via SVD — one batched reduction + one tiny SVD).
    """
    mu_s = jnp.mean(src, axis=0)
    mu_t = jnp.mean(tgt, axis=0)
    xs = src - mu_s
    xt = tgt - mu_t
    cov = (xt.T @ xs) / src.shape[0]
    U, D, Vt = jnp.linalg.svd(cov)
    S = jnp.eye(3, dtype=src.dtype)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = S.at[2, 2].set(jnp.where(det < 0, -1.0, 1.0))
    R = U @ S @ Vt
    if with_scale:
        var_s = jnp.mean(jnp.sum(xs * xs, axis=1))
        s = jnp.sum(D * jnp.diag(S)) / var_s
    else:
        s = jnp.asarray(1.0, src.dtype)
    t = mu_t - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated, ground_truth, align=True, with_scale=False):
    """Absolute trajectory error (RMSE of position residuals).

    estimated / ground_truth: (N, 3) positions or (N, 6) params6 poses
    (positions taken from the translation part).
    """
    est = estimated[..., :3]
    gt = ground_truth[..., :3]
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale=with_scale)
        est = s * est @ R.T + t
    err = est - gt
    return jnp.sqrt(jnp.mean(jnp.sum(err * err, axis=-1)))


def rpe(estimated_poses, ground_truth_poses, delta=1):
    """Relative pose error over frame pairs (i, i+delta); returns
    (trans_rmse, rot_rmse_rad). Inputs: (N, 6) params6 poses."""
    def rel(poses):
        Ta = se3.transform_from_params6(poses[:-delta])
        Tb = se3.transform_from_params6(poses[delta:])
        Ra = jnp.swapaxes(Ta[..., :3, :3], -1, -2)
        dt = jnp.einsum("nij,nj->ni", Ra, Tb[..., :3, 3] - Ta[..., :3, 3])
        dR = jnp.einsum("nij,njk->nik", Ra, Tb[..., :3, :3])
        return dt, dR

    dt_e, dR_e = rel(estimated_poses)
    dt_g, dR_g = rel(ground_truth_poses)
    t_err = dt_e - dt_g
    rot_err = jnp.einsum("nij,njk->nik", jnp.swapaxes(dR_g, -1, -2), dR_e)
    ang = jnp.linalg.norm(so3.log(rot_err), axis=-1)
    return (
        jnp.sqrt(jnp.mean(jnp.sum(t_err * t_err, axis=-1))),
        jnp.sqrt(jnp.mean(ang * ang)),
    )
