"""Perspective-n-Point RANSAC for relocalization.

Replaces ``PnPsolver`` (reference src/PnPsolver.cc — EPnP inside adaptive
RANSAC). Array-native design: a vmapped batch of EPnP 4-point minimal-set
hypotheses scored in parallel (the reference's minSet=4,
src/PnPsolver.h:67-68), followed by an EPnP refit on the inlier set
(reference PnPsolver::Refine) — fixed hypothesis count instead of adaptive
early exit, since all hypotheses evaluate in one fused batch anyway.

EPnP (Lepetit et al., the algorithm the reference vendors at
src/PnPsolver.cc:31-60 attribution / PnPsolver.h:79-125): 4 control points
(centroid + PCA axes), barycentric coordinates, the 12-dim null space of
the 2n x 12 projection system, beta-cases 1-3 seeded from the inter-control-
point distance constraints and polished by Gauss-Newton, then closed-form
Horn alignment world->camera. All stages are fixed-shape and vmap cleanly
over hypothesis sets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import camera, lie
from .sim3solver import horn_sim3

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def epnp_pose(pw, uv, Kc, w=None, gn_iters: int = 10):
    """EPnP pose from n>=4 2D-3D correspondences (optionally weighted).

    Args:
      pw: [n,3] world points; uv: [n,2] pixels; Kc: [4] intrinsics.
      w: [n] optional weights (0/1 inlier mask for the refit stage).
    Returns: T_cw [7].
    """
    n = pw.shape[0]
    dtype = pw.dtype
    if w is None:
        w = jnp.ones((n,), dtype)
    wn = w / jnp.maximum(jnp.sum(w), 1e-9)

    # --- control points: weighted centroid + principal axes -------------
    c0 = jnp.sum(pw * wn[:, None], axis=0)
    Pc = pw - c0
    Cov = jnp.einsum("n,ni,nj->ij", wn, Pc, Pc)
    ev, evec = jnp.linalg.eigh(Cov)
    sd = jnp.sqrt(jnp.maximum(ev, 1e-10))
    # bound the control-simplex conditioning: a near-coplanar point set
    # collapses one axis, making the barycentric solve singular (EPnP's
    # known planar weakness, shared with the reference implementation)
    sd = jnp.maximum(sd, 1e-3 * sd[-1])
    A = evec * sd[None, :]          # columns = control offsets c_k - c0
    cw = jnp.concatenate([c0[None], c0[None] + A.T], axis=0)  # [4,3]

    # --- barycentric coordinates: p - c0 = A @ alpha_{1:4} --------------
    a123 = jnp.linalg.solve(A, Pc.T).T          # [n,3]
    alpha = jnp.concatenate(
        [1.0 - jnp.sum(a123, axis=1, keepdims=True), a123], axis=1
    )  # [n,4]

    # --- null space of the projection system ----------------------------
    fx, fy, cx, cy = Kc[0], Kc[1], Kc[2], Kc[3]
    du = cx - uv[:, 0]
    dv = cy - uv[:, 1]
    zeros = jnp.zeros_like(alpha)
    Mu = jnp.stack([alpha * fx, zeros, alpha * du[:, None]], axis=-1).reshape(n, 12)
    Mv = jnp.stack([zeros, alpha * fy, alpha * dv[:, None]], axis=-1).reshape(n, 12)
    sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
    M = jnp.concatenate([Mu * sw, Mv * sw], axis=0)  # [2n,12]
    MtM = M.T @ M
    _, V = jnp.linalg.eigh(MtM)
    vs = V[:, :4].T.reshape(4, 4, 3)  # [null_k, ctrl, 3], k=0 = smallest

    # --- inter-control distance constraints -----------------------------
    pi = jnp.asarray([p[0] for p in _PAIRS])
    pj = jnp.asarray([p[1] for p in _PAIRS])
    rho = jnp.sum((cw[pi] - cw[pj]) ** 2, axis=-1)      # [6]
    dvs = vs[:, pi, :] - vs[:, pj, :]                   # [4,6,3]
    lij = jnp.einsum("kpc,lpc->pkl", dvs, dvs)          # [6,4,4] dv_k . dv_l

    # beta seeds (reference find_betas_approx_{1,2,3}, PnPsolver.h:95-103)
    l11, l22, l33 = lij[:, 0, 0], lij[:, 1, 1], lij[:, 2, 2]
    l12, l13, l23 = lij[:, 0, 1], lij[:, 0, 2], lij[:, 1, 2]
    b1_sq = jnp.sum(rho * l11) / jnp.maximum(jnp.sum(l11 * l11), 1e-12)
    seed1 = jnp.asarray(
        [jnp.sqrt(jnp.maximum(b1_sq, 0.0)), 0.0, 0.0, 0.0], dtype
    )

    def _ls(Lcols, k):
        # least squares for the quadratic products; Lcols [6,k]
        H = Lcols.T @ Lcols + 1e-9 * jnp.eye(k, dtype=dtype)
        return jnp.linalg.solve(H, Lcols.T @ rho)

    B2 = _ls(jnp.stack([l11, 2 * l12, l22], axis=1), 3)  # (b11, b12, b22)
    s2 = jnp.where(B2[0] < 0, -1.0, 1.0)  # flip if b11 came out negative
    be1 = jnp.sqrt(jnp.maximum(s2 * B2[0], 0.0))
    be2 = jnp.sqrt(jnp.maximum(s2 * B2[2], 0.0)) * jnp.sign(s2 * B2[1] + 1e-30)
    seed2 = jnp.asarray(0.0, dtype) * jnp.zeros((4,), dtype)
    seed2 = seed2.at[0].set(be1).at[1].set(be2)

    B3 = _ls(
        jnp.stack([l11, 2 * l12, l22, 2 * l13, 2 * l23, l33], axis=1), 6
    )  # (b11,b12,b22,b13,b23,b33)
    s3 = jnp.where(B3[0] < 0, -1.0, 1.0)
    b3_1 = jnp.sqrt(jnp.maximum(s3 * B3[0], 0.0))
    b3_2 = jnp.sqrt(jnp.maximum(s3 * B3[2], 0.0)) * jnp.sign(s3 * B3[1] + 1e-30)
    b3_3 = jnp.sqrt(jnp.maximum(s3 * B3[5], 0.0)) * jnp.sign(s3 * B3[3] + 1e-30)
    seed3 = jnp.zeros((4,), dtype).at[0].set(b3_1).at[1].set(b3_2).at[2].set(b3_3)

    # Gauss-Newton on the full 4-vector beta (reference gauss_newton,
    # PnPsolver.h:105-111)
    def gn(beta):
        def step(_, beta):
            dcam = jnp.einsum("k,kpc->pc", beta, dvs)       # [6,3]
            f = jnp.sum(dcam * dcam, axis=-1) - rho          # [6]
            J = 2.0 * jnp.einsum("pc,kpc->pk", dcam, dvs)    # [6,4]
            H = J.T @ J + 1e-9 * jnp.eye(4, dtype=dtype)
            return beta + jnp.linalg.solve(H, -J.T @ f)
        return jax.lax.fori_loop(0, gn_iters, step, beta)

    def pose_of(beta):
        ccam = jnp.einsum("k,kij->ij", beta, vs)             # [4,3]
        pc = alpha @ ccam                                    # [n,3]
        # cheirality: the null vector's global sign is free
        flip = jnp.where(jnp.sum(wn * pc[:, 2]) < 0, -1.0, 1.0)
        pc = pc * flip
        S = horn_sim3(pw, pc, w=w, fix_scale=True)
        T = lie.se3_make(S[:4], S[4:7])
        uvp, z = camera.project(Kc, lie.se3_apply(T, pw))
        err = jnp.sum(w * jnp.sum((uvp - uv) ** 2, axis=-1))
        return T, err

    # sign ambiguity: only products beta_a beta_b are observed, so the
    # relative signs of the seeds are undetermined — run GN from every
    # sign variant and keep the best reprojection (the reference resolves
    # signs case-by-case inside find_betas_approx_*; a vmapped sweep is
    # branch-free and strictly more robust)
    flips2 = jnp.asarray(
        [[1.0, 1.0, 1.0, 1.0], [1.0, -1.0, 1.0, 1.0]], dtype
    )
    flips3 = jnp.asarray(
        [
            [1.0, 1.0, 1.0, 1.0],
            [1.0, -1.0, 1.0, 1.0],
            [1.0, 1.0, -1.0, 1.0],
            [1.0, -1.0, -1.0, 1.0],
        ],
        dtype,
    )
    cands = jnp.concatenate(
        [seed1[None], seed2[None] * flips2, seed3[None] * flips3], axis=0
    )  # [7,4]
    Ts, errs = jax.vmap(lambda s: pose_of(gn(s)))(cands)
    # degenerate sets can still produce non-finite poses; they must lose
    # the argmin (and never leak NaN into a downstream refit/LM)
    finite = jnp.all(jnp.isfinite(Ts), axis=-1) & jnp.isfinite(errs)
    best = jnp.argmin(jnp.where(finite, errs, jnp.inf))
    return jnp.where(finite[best], Ts[best], lie.se3_identity(dtype=dtype))


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_pnp(
    pw,
    uv,
    valid,
    Kc,
    inv_sigma2,
    key=None,
    n_hyp: int = 256,
    chi2_th: float = 5.991,
):
    """RANSAC pose from 2D-3D matches (reference PnPsolver::iterate,
    src/PnPsolver.cc; minimal sets of 4 through EPnP, fixed hypothesis
    count instead of adaptive early exit — all hypotheses evaluate in
    parallel anyway).

    Returns (T_cw [7], inliers [N] bool, n_inliers).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    N = pw.shape[0]
    gum = -jnp.log(
        -jnp.log(jax.random.uniform(key, (n_hyp, N), minval=1e-9, maxval=1.0))
    )
    sel = jax.lax.top_k(jnp.where(valid[None, :], gum, -jnp.inf), 4)[1]

    T_all = jax.vmap(lambda idx: epnp_pose(pw[idx], uv[idx], Kc))(sel)

    def score(T):
        uvp, z = camera.project(Kc, lie.se3_apply(T, pw))
        e2 = jnp.sum((uvp - uv) ** 2, axis=-1) * inv_sigma2
        inl = (e2 < chi2_th) & (z > 0.05) & valid
        return jnp.sum(inl.astype(jnp.int32)), inl

    n_inl, inls = jax.vmap(score)(T_all)
    best = jnp.argmax(n_inl)
    # refit on inliers (reference PnPsolver::Refine)
    T_ref = epnp_pose(pw, uv, Kc, w=inls[best].astype(pw.dtype))
    n_ref, inl_ref = score(T_ref)
    better = n_ref >= n_inl[best]
    T_out = jnp.where(better, T_ref, T_all[best])
    inl_out = jnp.where(better, inl_ref, inls[best])
    return T_out, inl_out, jnp.maximum(n_ref, n_inl[best])
