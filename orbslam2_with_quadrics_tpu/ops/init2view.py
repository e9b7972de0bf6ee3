"""Two-view monocular initialization: parallel H/F RANSAC + reconstruction.

Array-native rebuild of the reference ``Initializer`` (src/Initializer.cc):
the reference races a homography thread against a fundamental-matrix thread
over 200 shared 8-point RANSAC sets (src/Initializer.cc:78-118); here both
model families are a single vmapped batch of 200 hypothesis solves — the
embarrassing parallelism the reference faked with 2 threads is real on the device.

- 8-point DLT for H and F with Hartley normalization
  (ComputeH21/ComputeF21/Normalize, src/Initializer.cc:266-334,749-778)
- symmetric-transfer scoring with the reference's chi2 gates 5.991 / 3.841
  and score offset th=5.991 (CheckHomography/CheckFundamental,
  src/Initializer.cc:336-520)
- model selection RH = SH/(SH+SF) > 0.40 (src/Initializer.cc:112-118)
- F -> E -> 4-way R|t disambiguation by cheirality+parallax (ReconstructF/
  CheckRT, src/Initializer.cc:522-652,836-929) and Faugeras' 8-motion
  homography decomposition (ReconstructH, src/Initializer.cc:654-732),
  both scored by the same batched CheckRT.

Determinism: hypothesis sampling uses a fixed PRNG key, mirroring the
reference's ``SeedRandOnce(0)`` (src/Initializer.cc:80).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera, lie

N_HYP = 200          # RANSAC sets (src/Initializer.cc:44 mMaxIterations)
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991


class InitResult(NamedTuple):
    ok: jnp.ndarray          # scalar bool
    T_21: jnp.ndarray        # [7] pose of frame2 wrt frame1 (world=frame1)
    points: jnp.ndarray      # [M,3] triangulated in frame1
    good: jnp.ndarray        # [M] bool triangulation validity
    used_h: jnp.ndarray      # scalar bool (homography branch taken)


def _normalize(uv, valid):
    """Hartley normalization over valid points -> (normalized uv, T [3,3])."""
    w = valid.astype(uv.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w[:, None], axis=0) / n
    d = jnp.abs(uv - mean) * w[:, None]
    meandev = jnp.maximum(jnp.sum(d, axis=0) / n, 1e-6)
    s = 1.0 / meandev
    uvn = (uv - mean) * s
    T = jnp.asarray(
        [[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]], [0.0, 0.0, 1.0]]
    )
    return uvn, T


def _solve_h(uv1, uv2, w=None):
    """DLT homography x2 ~ H x1, optional row weights
    (src/Initializer.cc:266-303)."""
    x, y = uv1[:, 0], uv1[:, 1]
    u, v = uv2[:, 0], uv2[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=-1)
    r2 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=False)
    return vt[-1].reshape(3, 3)


def _solve_f(uv1, uv2, w=None):
    """8-point fundamental with rank-2 projection, optional row weights
    (src/Initializer.cc:305-334)."""
    x, y = uv1[:, 0], uv1[:, 1]
    u, v = uv2[:, 0], uv2[:, 1]
    o = jnp.ones_like(x)
    A = jnp.stack(
        [u * x, u * y, u, v * x, v * y, v, x, y, o], axis=-1
    )
    if w is not None:
        A = A * w[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=False)
    F = vt[-1].reshape(3, 3)
    uS, sS, vtS = jnp.linalg.svd(F)
    return uS @ jnp.diag(sS.at[2].set(0.0)) @ vtS


def _score_h(H21, uv1, uv2, valid, sigma2: float = 1.0):
    """Symmetric transfer score (CheckHomography, src/Initializer.cc:336-436)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=-1)
        p = ah @ H.T
        w = jnp.where(jnp.abs(p[:, 2:3]) < 1e-8, 1e-8, p[:, 2:3])
        return jnp.sum((b - p[:, :2] / w) ** 2, axis=-1) / sigma2

    c1 = transfer(H12, uv2, uv1)
    c2 = transfer(H21, uv1, uv2)
    inl = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    score = jnp.sum(
        jnp.where(inl, (SCORE_TH - c1) + (SCORE_TH - c2), 0.0)
    )
    return score, inl


def _score_f(F21, uv1, uv2, valid, sigma2: float = 1.0):
    """Epipolar-distance score both ways (CheckFundamental,
    src/Initializer.cc:438-520)."""
    oh = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, oh], axis=-1)
    x2 = jnp.concatenate([uv2, oh], axis=-1)

    def epi(l, p):
        num = jnp.sum(l[:, :2] * p, axis=-1) + l[:, 2]
        den = jnp.sum(l[:, :2] ** 2, axis=-1)
        return num * num / jnp.maximum(den, 1e-12) / sigma2

    l2 = x1 @ F21.T  # line in image 2
    l1 = x2 @ F21    # line in image 1
    c2 = epi(l2, uv2)
    c1 = epi(l1, uv1)
    inl = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    score = jnp.sum(
        jnp.where(inl, (SCORE_TH - c1) + (SCORE_TH - c2), 0.0)
    )
    return score, inl


def _check_rt(R, t, K, uv1, uv2, valid, sigma2: float = 1.0):
    """Triangulate all matches for candidate (R, t); count cheirality+
    reprojection+parallax survivors (CheckRT, src/Initializer.cc:836-929).

    Returns (n_good, good_mask, median-ish parallax proxy, points3d).
    """
    T1 = lie.se3_identity(dtype=uv1.dtype)
    q = lie.matrix_to_quat(R)
    T2 = lie.se3_make(q, t)
    P1 = camera.projection_matrix(T1, K)
    P2 = camera.projection_matrix(T2, K)
    X = jax.vmap(camera.triangulate_dlt, in_axes=(None, None, 0, 0))(
        P1, P2, uv1, uv2
    )
    z1 = X[:, 2]
    pc2 = lie.se3_apply(T2, X)
    z2 = pc2[:, 2]

    # parallax between the two rays
    c2 = -R.T @ t
    r1 = X
    r2 = X - c2
    cosp = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-12
    )

    uv1p, _ = camera.project(K, X)
    uv2p, _ = camera.project(K, pc2)
    e1 = jnp.sum((uv1p - uv1) ** 2, axis=-1) / sigma2
    e2 = jnp.sum((uv2p - uv2) ** 2, axis=-1) / sigma2

    good = (
        valid
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.99998)
        & (e1 < 4.0 * CHI2_H)
        & (e2 < 4.0 * CHI2_H)
        & jnp.all(jnp.isfinite(X), axis=-1)
    )
    n_good = jnp.sum(good.astype(jnp.int32))
    # large-parallax proxy: 50th-best cos (lower = better), as the reference
    # takes the 50th parallax (src/Initializer.cc:920-926)
    k = jnp.minimum(50, jnp.maximum(n_good, 1)) - 1
    cs = jnp.sort(jnp.where(good, cosp, 2.0))
    parallax_cos = cs[k]
    return n_good, good, parallax_cos, X


def _reconstruct_f(F21, K, uv1, uv2, inliers):
    """E = K^T F K; 4 candidate (R,t); pick by CheckRT
    (ReconstructF, src/Initializer.cc:522-652)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    E = Km.T @ F21 @ Km
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def fix_det(R):
        return R * jnp.sign(jnp.linalg.det(R))

    R1 = fix_det(U @ W @ Vt)
    R2 = fix_det(U @ W.T @ Vt)
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    n_good, good, pcos, X = jax.vmap(
        lambda R, tt: _check_rt(R, tt, K, uv1, uv2, inliers)
    )(Rs, ts)

    best = jnp.argmax(n_good)
    n_best = n_good[best]
    n_sorted = jnp.sort(n_good)
    n_total = jnp.maximum(jnp.sum(inliers.astype(jnp.int32)), 1)
    # winner must dominate (reference: no second hypothesis over 0.7*best,
    # >90% of inliers reconstructed, parallax above ~1deg)
    ok = (
        (n_best.astype(jnp.float32) > 0.75 * n_total.astype(jnp.float32))
        & (n_sorted[2] < 0.7 * n_best)
        & (pcos[best] < jnp.cos(jnp.deg2rad(1.0)))
    )
    return ok, Rs[best], ts[best], good[best], X[best]


def _reconstruct_h(H21, K, uv1, uv2, inliers):
    """Faugeras SVD-based homography decomposition -> 8 motions -> CheckRT
    (ReconstructH, src/Initializer.cc:654-732; math from Faugeras & Lustman
    1988, also OpenCV decomposeHomographyMat)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Kinv = jnp.linalg.inv(Km)
    A = Kinv @ H21 @ Km
    U, s, Vt = jnp.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = jnp.linalg.det(U) * jnp.linalg.det(Vt)

    # x1/x3 magnitudes from singular values
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / denom, 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / denom, 0.0))
    x1s = jnp.asarray([aux1, aux1, -aux1, -aux1])
    x3s = jnp.asarray([aux3, -aux3, aux3, -aux3])

    # case d' = +d2
    st_p = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct_p = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)

    def motion_p(x1, x3, sin_sign):
        st = sin_sign * st_p
        Rp = jnp.asarray(
            [[ct_p, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct_p]]
        )
        tp = (d1 - d3) * jnp.asarray([x1, 0.0, -x3])
        return Rp, tp

    # case d' = -d2
    st_n = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    ct_n = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)

    def motion_n(x1, x3, sin_sign):
        st = sin_sign * st_n
        Rp = jnp.asarray(
            [[ct_n, 0.0, st], [0.0, -1.0, 0.0], [st, 0.0, -ct_n]]
        )
        tp = (d1 + d3) * jnp.asarray([x1, 0.0, x3])
        return Rp, tp

    Rs, ts = [], []
    signs = jnp.asarray([1.0, -1.0, -1.0, 1.0])  # sign(x1*x3) pairing
    for i in range(4):
        Rp, tp = motion_p(x1s[i], x3s[i], signs[i])
        Rs.append(detUV * (U @ Rp @ Vt))
        ts.append(U @ tp)
        Rn, tn = motion_n(x1s[i], x3s[i], signs[i])
        Rs.append(detUV * (U @ Rn @ Vt))
        ts.append(U @ tn)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=-1, keepdims=True), 1e-12)

    n_good, good, pcos, X = jax.vmap(
        lambda R, tt: _check_rt(R, tt, K, uv1, uv2, inliers)
    )(Rs, ts)
    best = jnp.argmax(n_good)
    n_best = n_good[best]
    second = jnp.sort(n_good)[-2]
    n_total = jnp.maximum(jnp.sum(inliers.astype(jnp.int32)), 1)
    ok = (
        (n_best.astype(jnp.float32) > 0.75 * n_total.astype(jnp.float32))
        & (second < 0.75 * n_best)
        & (pcos[best] < jnp.cos(jnp.deg2rad(1.0)))
    )
    return ok, Rs[best], ts[best], good[best], X[best]


@partial(jax.jit, static_argnames=())
def initialize_two_view(K, uv1, uv2, valid, key=None) -> InitResult:
    """Full two-view bootstrap on matched keypoint pairs.

    Args:
      K: [4] intrinsics.
      uv1/uv2: [M,2] undistorted pixel matches frame1/frame2 (padded).
      valid: [M] bool.
      key: PRNG key (defaults to a fixed seed for reference-style
        determinism, src/Initializer.cc:80).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    M = uv1.shape[0]
    w = valid.astype(jnp.float32)

    # sample 200 x 8 indices among valid matches (with replacement across
    # sets, without replacement inside a set via Gumbel top-k)
    gumbel = -jnp.log(
        -jnp.log(jax.random.uniform(key, (N_HYP, M), minval=1e-9, maxval=1.0))
    )
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    sel = jax.lax.top_k(scores, 8)[1]  # [N_HYP, 8]

    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    T2inv = jnp.linalg.inv(T2)

    def per_hyp(idx):
        a = uv1n[idx]
        b = uv2n[idx]
        Hn = _solve_h(a, b)
        Fn = _solve_f(a, b)
        H = T2inv @ Hn @ T1
        F = T2.T @ Fn @ T1
        sh, _ = _score_h(H, uv1, uv2, valid)
        sf, _ = _score_f(F, uv1, uv2, valid)
        return H, F, sh, sf

    Hs, Fs, shs, sfs = jax.vmap(per_hyp)(sel)
    bh = jnp.argmax(shs)
    bf_ = jnp.argmax(sfs)
    H_best, F_best = Hs[bh], Fs[bf_]
    _, h_inl = _score_h(H_best, uv1, uv2, valid)
    _, f_inl = _score_f(F_best, uv1, uv2, valid)

    # refit on the inlier sets (weighted all-point DLT): the 8-point
    # minimal model is noise-limited; one refit recovers the accuracy the
    # reference gets from scoring 200 hypotheses on low-noise data
    H_ref = T2inv @ _solve_h(uv1n, uv2n, h_inl.astype(jnp.float32)) @ T1
    F_ref = T2.T @ _solve_f(uv1n, uv2n, f_inl.astype(jnp.float32)) @ T1
    sh_ref, h_inl_ref = _score_h(H_ref, uv1, uv2, valid)
    sf_ref, f_inl_ref = _score_f(F_ref, uv1, uv2, valid)
    use_h_ref = sh_ref > shs[bh]
    use_f_ref = sf_ref > sfs[bf_]
    H_best = jnp.where(use_h_ref, H_ref, H_best)
    F_best = jnp.where(use_f_ref, F_ref, F_best)
    h_inl = jnp.where(use_h_ref, h_inl_ref, h_inl)
    f_inl = jnp.where(use_f_ref, f_inl_ref, f_inl)
    SH = jnp.maximum(sh_ref, shs[bh])
    SF = jnp.maximum(sf_ref, sfs[bf_])

    use_h = SH / jnp.maximum(SH + SF, 1e-9) > 0.40

    ok_h, R_h, t_h, good_h, X_h = _reconstruct_h(H_best, K, uv1, uv2, h_inl)
    ok_f, R_f, t_f, good_f, X_f = _reconstruct_f(F_best, K, uv1, uv2, f_inl)

    ok = jnp.where(use_h, ok_h, ok_f)
    R = jnp.where(use_h, R_h, R_f)
    t = jnp.where(use_h, t_h, t_f)
    good = jnp.where(use_h, good_h, good_f)
    X = jnp.where(use_h, X_h, X_f)

    # minimum triangulated support (reference requires >=50 good points +
    # >=100 matches, src/Tracking.cc:592,680)
    ok = ok & (jnp.sum(good.astype(jnp.int32)) >= 50)

    T_21 = lie.se3_make(lie.matrix_to_quat(R), t)
    return InitResult(ok=ok, T_21=T_21, points=X, good=good, used_h=use_h)
