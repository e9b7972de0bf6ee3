"""Reprojection residuals and analytic Jacobians.

The array-native equivalent of g2o's projection edge types
(Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:80-196:
``EdgeSE3ProjectXYZ``, ``EdgeStereoSE3ProjectXYZ`` and their OnlyPose
variants). One unified 3-row residual covers mono and stereo: row 2 (the
right-image column u_r) is weight-masked out for mono observations, so a
single vmapped kernel serves every optimizer in the system.

Error convention matches g2o: ``e = obs - pred``; the optimizer update is
left-multiplicative ``T <- exp(delta) T`` with tangent ``[omega, upsilon]``
(see ops/lie.py), and the Gauss-Newton step solves ``H delta = b`` with
``b = sum J^T w e`` where ``J = de/ddelta``.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import lie

# chi2 gates at 95%: 2-dof (mono) and 3-dof (stereo)
# (reference src/Optimizer.cc:85-86, 369-370)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2, delta2):
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    return jnp.where(
        chi2 <= delta2, 1.0, jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12))
    )


def residual_and_jacobians(T_cw, K, bf, p_world, obs_uvr):
    """Residual + analytic Jacobians for one (pose, point, obs) triple.

    Args:
      T_cw: [7] pose (world->camera).
      K: [4] intrinsics [fx, fy, cx, cy].
      bf: scalar fx*baseline (ignored by mono rows).
      p_world: [3] point.
      obs_uvr: [3] observation (u, v, u_r).

    Returns:
      e: [3] residual (obs - pred).
      Jc: [3, 6] d e / d pose-tangent [omega, upsilon].
      Jp: [3, 3] d e / d p_world.
      z: scalar depth in the camera frame.
    """
    pc = lie.se3_apply(T_cw, p_world)
    x, y, z = pc[0], pc[1], pc[2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    fx, fy = K[0], K[1]

    u = fx * x * iz + K[2]
    v = fy * y * iz + K[3]
    ur = u - bf * iz
    e = obs_uvr - jnp.stack([u, v, ur])

    # d(pred)/d(pc)
    du = jnp.stack([fx * iz, 0.0 * iz, -fx * x * iz2])
    dv = jnp.stack([0.0 * iz, fy * iz, -fy * y * iz2])
    dur = du + jnp.stack([0.0 * iz, 0.0 * iz, bf * iz2])
    dpred_dpc = jnp.stack([du, dv, dur])  # [3,3]

    # d(pc)/d(tangent): pc' = (I + hat(w)) pc + v  =>  dpc/dw = -hat(pc)
    dpc_dxi = jnp.concatenate([-lie.hat(pc), jnp.eye(3, dtype=pc.dtype)], axis=-1)
    Jc = -dpred_dpc @ dpc_dxi  # [3,6]

    # d(pc)/d(p_world) = R
    R = lie.quat_to_matrix(lie.se3_quat(T_cw))
    Jp = -dpred_dpc @ R

    return e, Jc, Jp, z


def residual_only(T_cw, K, bf, p_world, obs_uvr):
    """Residual + depth without Jacobians — for cost-only evaluations
    (the LM accept/reject test re-evaluates cost at the candidate state;
    computing Jc/Jp there wastes ~3x the work)."""
    pc = lie.se3_apply(T_cw, p_world)
    x, y, z = pc[0], pc[1], pc[2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    u = K[0] * x * iz + K[2]
    v = K[1] * y * iz + K[3]
    ur = u - bf * iz
    return obs_uvr - jnp.stack([u, v, ur]), z


def chi2_of(e, is_stereo, inv_sigma2):
    """Per-observation chi2 with the stereo row masked off for mono."""
    row_w = jnp.stack(
        [jnp.ones_like(e[..., 0]), jnp.ones_like(e[..., 0]), is_stereo], axis=-1
    )
    return jnp.sum(e * e * row_w, axis=-1) * inv_sigma2
