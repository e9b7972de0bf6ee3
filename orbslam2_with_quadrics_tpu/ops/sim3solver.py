"""Sim3 estimation: Horn closed-form alignment + vmapped RANSAC + LM polish.

Array-native rebuild of ``Sim3Solver`` (reference src/Sim3Solver.cc) and
``Optimizer::OptimizeSim3`` (src/Optimizer.cc:1046+):

- Horn 1987 absolute orientation on 3-point minimal sets, quaternion from
  the max eigenvector of the 4x4 N matrix (ComputeSim3,
  src/Sim3Solver.cc:226-272), optional fixed scale for stereo/RGB-D.
- RANSAC is a single vmapped batch of hypotheses scored by two-view
  reprojection like the reference's inlier check (src/Sim3Solver.cc:284-310).
- The polish stage is a Levenberg-Marquardt solve of the 7-dof Sim3 with
  forward+inverse projection residuals (the reference's paired
  EdgeSim3ProjectXYZ/EdgeInverseSim3ProjectXYZ).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import camera, lie


def horn_sim3(p1, p2, w=None, fix_scale: bool = False):
    """Closed-form Sim3 aligning p1 -> p2 ([N,3] each, optional weights).

    Returns S12? No — returns S such that p2 ~ S(p1) = s R p1 + t.
    """
    if w is None:
        w = jnp.ones(p1.shape[:-1], p1.dtype)
    wn = w / jnp.maximum(jnp.sum(w), 1e-9)
    c1 = jnp.sum(p1 * wn[..., None], axis=-2)
    c2 = jnp.sum(p2 * wn[..., None], axis=-2)
    x1 = p1 - c1
    x2 = p2 - c2
    # Horn's correlation matrix S_ab = sum w x1_a x2_b (order matters: the
    # max-eigenvector quaternion then rotates frame-1 vectors into frame 2)
    M = jnp.einsum("...n,...ni,...nj->...ij", wn, x1, x2)
    # Horn's 4x4 symmetric N matrix from M
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., :, -1]  # max eigenvalue eigenvector = [w,x,y,z]
    q = lie.quat_normalize(q * jnp.where(q[..., :1] < 0, -1.0, 1.0))
    # scale: s = sum w <x2, R x1> / sum w |x1|^2  (asymmetric Horn scale)
    Rx1 = lie.quat_rotate(q[..., None, :], x1)
    num = jnp.sum(wn * jnp.sum(x2 * Rx1, axis=-1), axis=-1)
    den = jnp.sum(wn * jnp.sum(x1 * x1, axis=-1), axis=-1)
    s = jnp.where(fix_scale, 1.0, num / jnp.maximum(den, 1e-12))
    t = c2 - s[..., None] * lie.quat_rotate(q, c1)
    return jnp.concatenate([q, t, s[..., None]], axis=-1)


@partial(jax.jit, static_argnames=("n_hyp", "fix_scale"))
def ransac_sim3(
    p1,
    p2,
    valid,
    K1,
    K2,
    uv1,
    uv2,
    sigma2_1,
    sigma2_2,
    key=None,
    n_hyp: int = 128,
    fix_scale: bool = False,
):
    """RANSAC Sim3 from 3D-3D correspondences, scored by reprojection in
    both images (reference Sim3Solver::iterate + CheckInliers,
    src/Sim3Solver.cc:140-207,284-310).

    p1/p2: [M,3] matched map points in camera frames 1/2.
    uv1/uv2: [M,2] their observed pixels; sigma2_*: per-obs variances.
    Returns (S12 [8], inlier_mask [M], n_inliers).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    M = p1.shape[0]
    gum = -jnp.log(
        -jnp.log(jax.random.uniform(key, (n_hyp, M), minval=1e-9, maxval=1.0))
    )
    sel = jax.lax.top_k(jnp.where(valid[None, :], gum, -jnp.inf), 3)[1]

    def hyp(idx):
        S12 = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)
        return S12

    S_all = jax.vmap(hyp)(sel)  # [H,8]

    def score(S12):
        S21 = lie.sim3_inverse(S12)
        # project p2 through S21 into camera 1 and p1 through S12 into cam 2
        q1, _ = camera.project(K1, lie.sim3_apply(S21, p2))
        q2, _ = camera.project(K2, lie.sim3_apply(S12, p1))
        e1 = jnp.sum((q1 - uv1) ** 2, axis=-1) / jnp.maximum(sigma2_1, 1e-9)
        e2 = jnp.sum((q2 - uv2) ** 2, axis=-1) / jnp.maximum(sigma2_2, 1e-9)
        inl = (e1 < 9.210) & (e2 < 9.210) & valid  # th2 from Sim3Solver.cc:82
        return jnp.sum(inl.astype(jnp.int32)), inl

    n_inl, inls = jax.vmap(score)(S_all)
    best = jnp.argmax(n_inl)
    S_best = S_all[best]
    inl_best = inls[best]
    # refit on inliers
    S_ref = horn_sim3(
        p1, p2, w=inl_best.astype(p1.dtype), fix_scale=fix_scale
    )
    n_ref, inl_ref = score(S_ref)
    better = n_ref >= n_inl[best]
    S_out = jnp.where(better, S_ref, S_best)
    inl_out = jnp.where(better, inl_ref, inl_best)
    return S_out, inl_out, jnp.maximum(n_ref, n_inl[best])


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_sim3(
    S12,
    p1,
    p2,
    valid,
    K1,
    K2,
    uv1,
    uv2,
    inv_sigma2_1,
    inv_sigma2_2,
    iters: int = 10,
    fix_scale: bool = False,
):
    """LM polish of a Sim3 with paired forward/inverse projection residuals
    (Optimizer::OptimizeSim3, src/Optimizer.cc:1046+; Huber at chi2=10)."""

    def residuals_fn(S):
        S21 = lie.sim3_inverse(S)
        q1, _ = camera.project(K1, lie.sim3_apply(S21, p2))
        q2, _ = camera.project(K2, lie.sim3_apply(S, p1))
        r1 = (uv1 - q1) * jnp.sqrt(inv_sigma2_1)[:, None]
        r2 = (uv2 - q2) * jnp.sqrt(inv_sigma2_2)[:, None]
        return jnp.concatenate([r1, r2], axis=0)  # [2M,2]

    w_rows = jnp.concatenate([valid, valid]).astype(p1.dtype)

    def cost_of(S):
        r = residuals_fn(S)
        chi2 = jnp.sum(r * r, axis=-1)
        hw = jnp.where(chi2 < 10.0, 1.0, jnp.sqrt(10.0 / jnp.maximum(chi2, 1e-12)))
        return jnp.sum(chi2 * jnp.minimum(hw, 1.0) * w_rows), hw

    def step(_, carry):
        S, lam, cost = carry
        J = jax.jacfwd(
            lambda xi: residuals_fn(lie.sim3_retract(S, xi)).reshape(-1)
        )(jnp.zeros(7))
        r = residuals_fn(S).reshape(-1)
        _, hw = cost_of(S)
        w = (w_rows * hw)  # [2M]
        wf = jnp.repeat(w, 2)
        H = J.T @ (J * wf[:, None])
        g = -J.T @ (r * wf)
        if fix_scale:
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            g = g.at[6].set(0.0)
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7)
        dx = jnp.linalg.solve(Hd, g)
        S_new = lie.sim3_retract(S, dx)
        new_cost, _ = cost_of(S_new)
        ok = (new_cost < cost) & jnp.all(jnp.isfinite(dx))
        return (
            jnp.where(ok, S_new, S),
            jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6),
            jnp.where(ok, new_cost, cost),
        )

    cost0, _ = cost_of(S12)
    S, _, _ = jax.lax.fori_loop(0, iters, step, (S12, jnp.asarray(1e-4), cost0))
    # final inliers at chi2 < 9.210
    S21 = lie.sim3_inverse(S)
    q1, _ = camera.project(K1, lie.sim3_apply(S21, p2))
    q2, _ = camera.project(K2, lie.sim3_apply(S, p1))
    e1 = jnp.sum((uv1 - q1) ** 2, axis=-1) * inv_sigma2_1
    e2 = jnp.sum((uv2 - q2) ** 2, axis=-1) * inv_sigma2_2
    inl = (e1 < 9.210) & (e2 < 9.210) & valid
    return S, inl, jnp.sum(inl.astype(jnp.int32))
