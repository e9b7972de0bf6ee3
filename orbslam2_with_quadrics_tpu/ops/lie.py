"""SO3 / SE3 / Sim3 tangent-space operations on quaternion poses.

Array-native replacement for the reference's g2o types layer
(Thirdparty/g2o/g2o/types/se3quat.h, sim3.h and the expmap vertices in
types_six_dof_expmap.h / types_seven_dof_expmap.h): poses are flat arrays,
every op is a pure function that broadcasts over leading batch dimensions,
and optimizer updates are left-multiplicative increments
``T <- exp(delta) * T`` in the same (omega, upsilon) tangent ordering g2o
uses, so chi2/Jacobian structure carries over 1:1.

Conventions
-----------
- Quaternion layout ``[w, x, y, z]``, unit norm, Hamilton convention.
- SE3 pose = 7-vector ``[qw qx qy qz tx ty tz]`` mapping world->camera
  (``p_c = R p_w + t``), like the reference's ``Tcw``.
- SE3 tangent = 6-vector ``[omega(3), upsilon(3)]``.
- Sim3 pose = 8-vector ``[qw qx qy qz tx ty tz s]`` (``p' = s R p + t``).
- Sim3 tangent = 7-vector ``[omega(3), upsilon(3), sigma]``.

All trig uses Taylor fallbacks near theta=0 so the ops are safely
differentiable and float32-stable on an accelerator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def _build_structure_tensors():
    import numpy as np

    # hat(v)_{ij} = sum_k v_k HAT[k,i,j]
    hat_t = np.zeros((3, 3, 3), np.float32)
    hat_t[0, 1, 2], hat_t[0, 2, 1] = -1.0, 1.0
    hat_t[1, 0, 2], hat_t[1, 2, 0] = 1.0, -1.0
    hat_t[2, 0, 1], hat_t[2, 1, 0] = -1.0, 1.0

    # Shepperd candidates as a linear map of [vec(R) row-major; 1]:
    # cands[k, j] = sum_n M2Q[k, j, n] v[n]
    m2q = np.zeros((4, 4, 10), np.float32)

    def E(i, j):
        return 3 * i + j

    # k=0: qw-major  [1+tr, m21-m12, m02-m20, m10-m01]
    m2q[0, 0, [E(0, 0), E(1, 1), E(2, 2), 9]] = [1, 1, 1, 1]
    m2q[0, 1, [E(2, 1), E(1, 2)]] = [1, -1]
    m2q[0, 2, [E(0, 2), E(2, 0)]] = [1, -1]
    m2q[0, 3, [E(1, 0), E(0, 1)]] = [1, -1]
    # k=1: qx-major  [m21-m12, 1+m00-m11-m22, m01+m10, m02+m20]
    m2q[1, 0, [E(2, 1), E(1, 2)]] = [1, -1]
    m2q[1, 1, [E(0, 0), E(1, 1), E(2, 2), 9]] = [1, -1, -1, 1]
    m2q[1, 2, [E(0, 1), E(1, 0)]] = [1, 1]
    m2q[1, 3, [E(0, 2), E(2, 0)]] = [1, 1]
    # k=2: qy-major  [m02-m20, m01+m10, 1-m00+m11-m22, m12+m21]
    m2q[2, 0, [E(0, 2), E(2, 0)]] = [1, -1]
    m2q[2, 1, [E(0, 1), E(1, 0)]] = [1, 1]
    m2q[2, 2, [E(0, 0), E(1, 1), E(2, 2), 9]] = [-1, 1, -1, 1]
    m2q[2, 3, [E(1, 2), E(2, 1)]] = [1, 1]
    # k=3: qz-major  [m10-m01, m02+m20, m12+m21, 1-m00-m11+m22]
    m2q[3, 0, [E(1, 0), E(0, 1)]] = [1, -1]
    m2q[3, 1, [E(0, 2), E(2, 0)]] = [1, 1]
    m2q[3, 2, [E(1, 2), E(2, 1)]] = [1, 1]
    m2q[3, 3, [E(0, 0), E(1, 1), E(2, 2), 9]] = [-1, -1, 1, 1]
    return hat_t, m2q


_HAT_T, _M2Q = _build_structure_tensors()


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_mul(a, b):
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by unit quaternion(s) q."""
    w = q[..., :1]
    xyz = q[..., 1:]
    t = 2.0 * jnp.cross(xyz, v)
    return v + w * t + jnp.cross(xyz, t)


def quat_to_matrix(q):
    """Unit quaternion [w,x,y,z] -> rotation matrix.

    Written as outer/structure-tensor products (R = I + 2w [u]x + 2 [u]x^2
    with [u]x^2 = u u^T - (u.u) I) rather than the 13-product component
    form: per-component scalar extracts + restack become many small ops
    that do not fuse, and this conversion sits at the entry of every pose
    solve.
    """
    w = q[..., :1, None]  # [...,1,1]
    u = q[..., 1:]
    uu = u[..., :, None] * u[..., None, :]
    un = jnp.sum(u * u, axis=-1)[..., None, None]
    W = jnp.tensordot(u, jnp.asarray(_HAT_T, q.dtype), axes=([-1], [0]))
    eye = jnp.eye(3, dtype=q.dtype)
    return eye + 2.0 * w * W + 2.0 * (uu - un * eye)


def matrix_to_quat(m):
    """Rotation matrix -> unit quaternion [w,x,y,z] (Shepperd's method,
    branch-free via selecting the largest of the four candidates).

    The four candidate quaternions are linear in the matrix entries, so
    they are produced by ONE constant [4,4,10] tensor contraction against
    [vec(R); 1] instead of 9 scalar extracts + 16 stacks (same latency
    rationale as quat_to_matrix)."""
    v = jnp.concatenate(
        [
            m.reshape(m.shape[:-2] + (9,)),
            jnp.ones(m.shape[:-2] + (1,), m.dtype),
        ],
        axis=-1,
    )
    cands = jnp.einsum("kjn,...n->...kj", jnp.asarray(_M2Q, m.dtype), v)
    scores = jnp.einsum("...kk->...k", cands)  # 4 q_k^2 of each candidate
    idx = jnp.argmax(scores, axis=-1)
    t = jnp.take_along_axis(scores, idx[..., None], axis=-1)  # [...,1]
    q = jnp.take_along_axis(
        cands, idx[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]
    q = q / (2.0 * jnp.sqrt(jnp.maximum(t, _EPS)))
    # canonical sign: w >= 0
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def hat(w):
    """3-vector -> skew-symmetric matrix."""
    zeros = jnp.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = jnp.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], axis=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp_quat(w):
    """so3 tangent -> unit quaternion."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    # sin(t/2)/t with Taylor fallback 0.5 - t^2/48
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    cw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([cw, k * w], axis=-1))


def so3_log(q):
    """Unit quaternion -> so3 tangent (rotation vector)."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 branch
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    n = jnp.linalg.norm(xyz, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(n, w)
    # angle/n with fallback 2/w for n->0
    k = jnp.where(n < 1e-7, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(n, _EPS))
    return k * xyz


def _so3_left_jacobian(w):
    """Left Jacobian J_l of SO3 (used by se3 exp for the translation part)."""
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    b = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a * W + b * W2


def _so3_left_jacobian_inv(w):
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * jnp.cos(0.5 * theta) / jnp.maximum(jnp.sin(0.5 * theta), _EPS))
        / theta2,
    )
    eye = jnp.eye(3, dtype=w.dtype)
    return eye - 0.5 * W + cot * W2


# ---------------------------------------------------------------------------
# SE3 (7-vector [q, t])
# ---------------------------------------------------------------------------

# plain tuple, NOT a module-level jnp array: that would initialize the
# XLA backend at import time and break jax.distributed.initialize()
SE3_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def se3_quat(T):
    return T[..., :4]


def se3_trans(T):
    return T[..., 4:7]


def se3_make(q, t):
    return jnp.concatenate([q, t], axis=-1)


def se3_identity(batch_shape=(), dtype=jnp.float32):
    return jnp.broadcast_to(
        jnp.asarray(SE3_IDENTITY, dtype), batch_shape + (7,)
    )


def se3_apply(T, p):
    """p_out = R p + t."""
    return quat_rotate(se3_quat(T), p) + se3_trans(T)


def se3_compose(A, B):
    """A * B (apply B first, then A)."""
    q = quat_mul(se3_quat(A), se3_quat(B))
    t = quat_rotate(se3_quat(A), se3_trans(B)) + se3_trans(A)
    return se3_make(quat_normalize(q), t)


def se3_inverse(T):
    qi = quat_conj(se3_quat(T))
    return se3_make(qi, -quat_rotate(qi, se3_trans(T)))


def se3_exp(xi):
    """se3 tangent [omega, upsilon] -> SE3 7-vector."""
    w, v = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(w)
    t = jnp.einsum("...ij,...j->...i", _so3_left_jacobian(w), v)
    return se3_make(q, t)


def se3_log(T):
    w = so3_log(se3_quat(T))
    v = jnp.einsum("...ij,...j->...i", _so3_left_jacobian_inv(w), se3_trans(T))
    return jnp.concatenate([w, v], axis=-1)


def se3_retract(T, xi):
    """Left-multiplicative optimizer update: exp(xi) * T.

    Mathematically identical to ``se3_compose(se3_exp(xi), T)`` but written
    as scalar-indexed arithmetic with a single final stack: the generic
    composition expands to ~50 small stack/cross/einsum HLOs that cannot
    fuse — and retract sits inside every sequential LM chain (pose opt
    runs 20 of them per frame). This form compiles to one fusion. Same
    Taylor fallbacks as
    so3_exp_quat/_so3_left_jacobian.
    """
    wx, wy, wz = xi[..., 0], xi[..., 1], xi[..., 2]
    vx, vy, vz = xi[..., 3], xi[..., 4], xi[..., 5]
    theta2 = wx * wx + wy * wy + wz * wz
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    safe_t2 = jnp.where(small, 1.0, theta2)
    half = 0.5 * theta

    # --- exp(w) as a quaternion d = [dw, dx, dy, dz] ---
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    dw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    dx, dy, dz = k * wx, k * wy, k * wz
    dn = 1.0 / jnp.sqrt(jnp.maximum(dw * dw + dx * dx + dy * dy + dz * dz, _EPS))
    dw, dx, dy, dz = dw * dn, dx * dn, dy * dn, dz * dn

    # --- translation of exp(xi): t_d = J_l(w) v = v + a (w x v) + b (w(w.v) - theta2 v)
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    b = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (safe_t2 * theta),
    )
    cx = wy * vz - wz * vy
    cy = wz * vx - wx * vz
    cz = wx * vy - wy * vx
    wv = wx * vx + wy * vy + wz * vz
    tdx = vx + a * cx + b * (wx * wv - theta2 * vx)
    tdy = vy + a * cy + b * (wy * wv - theta2 * vy)
    tdz = vz + a * cz + b * (wz * wv - theta2 * vz)

    # --- compose with T: q = d * q_T (Hamilton), t = R(d) t_T + t_d ---
    qw, qx, qy, qz = T[..., 0], T[..., 1], T[..., 2], T[..., 3]
    tx, ty, tz = T[..., 4], T[..., 5], T[..., 6]
    rw = dw * qw - dx * qx - dy * qy - dz * qz
    rx = dw * qx + dx * qw + dy * qz - dz * qy
    ry = dw * qy - dx * qz + dy * qw + dz * qx
    rz = dw * qz + dx * qy - dy * qx + dz * qw
    rn = 1.0 / jnp.sqrt(jnp.maximum(rw * rw + rx * rx + ry * ry + rz * rz, _EPS))
    rw, rx, ry, rz = rw * rn, rx * rn, ry * rn, rz * rn

    # rotate t_T by d: t' = t + 2 dw (u x t) + 2 u x (u x t), u = (dx,dy,dz)
    ux = dy * tz - dz * ty
    uy = dz * tx - dx * tz
    uz = dx * ty - dy * tx
    txr = tx + 2.0 * (dw * ux + dy * uz - dz * uy)
    tyr = ty + 2.0 * (dw * uy + dz * ux - dx * uz)
    tzr = tz + 2.0 * (dw * uz + dx * uy - dy * ux)

    return jnp.stack(
        [rw, rx, ry, rz, txr + tdx, tyr + tdy, tzr + tdz], axis=-1
    )


def se3_to_matrix(T):
    R = quat_to_matrix(se3_quat(T))
    t = se3_trans(T)[..., :, None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), T.shape[:-1] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_from_matrix(M):
    return se3_make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


# ---------------------------------------------------------------------------
# Sim3 (8-vector [q, t, s]) — used by loop closing / essential graph
# (reference: Thirdparty/g2o/g2o/types/sim3.h, src/Optimizer.cc:781-1044)
# ---------------------------------------------------------------------------

def sim3_make(q, t, s):
    return jnp.concatenate([q, t, s[..., None] if s.ndim == q.ndim - 1 else s], axis=-1)


def sim3_quat(S):
    return S[..., :4]


def sim3_trans(S):
    return S[..., 4:7]


def sim3_scale(S):
    return S[..., 7]


def sim3_identity(batch_shape=(), dtype=jnp.float32):
    base = jnp.asarray([1.0, 0, 0, 0, 0, 0, 0, 1.0], dtype=dtype)
    return jnp.broadcast_to(base, batch_shape + (8,))


def sim3_apply(S, p):
    return sim3_scale(S)[..., None] * quat_rotate(sim3_quat(S), p) + sim3_trans(S)


def sim3_compose(A, B):
    q = quat_mul(sim3_quat(A), sim3_quat(B))
    t = sim3_scale(A)[..., None] * quat_rotate(sim3_quat(A), sim3_trans(B)) + sim3_trans(A)
    s = sim3_scale(A) * sim3_scale(B)
    return jnp.concatenate([quat_normalize(q), t, s[..., None]], axis=-1)


def sim3_inverse(S):
    qi = quat_conj(sim3_quat(S))
    si = 1.0 / sim3_scale(S)
    t = -si[..., None] * quat_rotate(qi, sim3_trans(S))
    return jnp.concatenate([qi, t, si[..., None]], axis=-1)


def sim3_from_se3(T, s=None):
    if s is None:
        s = jnp.ones(T.shape[:-1], dtype=T.dtype)
    return jnp.concatenate([T, s[..., None]], axis=-1)


def sim3_to_se3(S):
    """Drop scale into translation: T = [q, t/s] (used when mapping corrected
    Sim3 keyframe poses back to SE3, reference src/LoopClosing.cc:488-494)."""
    s = sim3_scale(S)[..., None]
    return se3_make(sim3_quat(S), sim3_trans(S) / s)


def _sim3_W(w, sigma):
    """The Sim3 'W' matrix: integral of exp(sigma u) R(u w) du, used to map
    tangent translation into group translation."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    s = sigma
    es = jnp.exp(s)
    W_ = hat(w)
    W2 = W_ @ W_
    small_s = jnp.abs(s) < 1e-5
    small_t = theta2 < 1e-8

    A_ss = jnp.where(small_t, 0.5, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    B_ss = jnp.where(
        small_t, 1.0 / 6.0, (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, _EPS)
    )
    C_ss = jnp.ones_like(s)

    denom = s * s + theta2
    a_gen = es * jnp.sin(theta)
    b_gen = es * jnp.cos(theta)
    C_gen = (es - 1.0) / jnp.where(small_s, jnp.ones_like(s), s)
    A_gen = (a_gen * s + (1.0 - b_gen) * theta) / jnp.maximum(theta * denom, _EPS)
    B_gen = (
        C_gen
        - ((b_gen - 1.0) * s + a_gen * theta) / jnp.maximum(denom, _EPS)
    ) / jnp.maximum(theta2, _EPS)

    # sigma != 0, theta -> 0 limits
    A_s0 = jnp.where(
        small_s, A_ss, ((s - 1.0) * es + 1.0) / jnp.where(small_s, jnp.ones_like(s), s * s)
    )
    B_s0 = jnp.where(
        small_s,
        B_ss,
        (es * (0.5 * s * s - s + 1.0) - 1.0) / jnp.where(small_s, jnp.ones_like(s), s * s * s),
    )

    A = jnp.where(small_s & small_t, A_ss, jnp.where(small_t, A_s0, jnp.where(small_s, A_ss, A_gen)))
    B = jnp.where(small_s & small_t, B_ss, jnp.where(small_t, B_s0, jnp.where(small_s, B_ss, B_gen)))
    C = jnp.where(small_s, C_ss, C_gen)

    eye = jnp.eye(3, dtype=w.dtype)
    return (
        C[..., None, None] * eye
        + A[..., None, None] * W_
        + B[..., None, None] * W2
    )


def sim3_exp(xi):
    """sim3 tangent [omega(3), upsilon(3), sigma] -> Sim3 8-vector."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    q = so3_exp_quat(w)
    s = jnp.exp(sigma)
    t = jnp.einsum("...ij,...j->...i", _sim3_W(w, sigma), v)
    return jnp.concatenate([q, t, s[..., None]], axis=-1)


def sim3_log(S):
    w = so3_log(sim3_quat(S))
    sigma = jnp.log(jnp.maximum(sim3_scale(S), _EPS))
    Wm = _sim3_W(w, sigma)
    v = jnp.linalg.solve(Wm, sim3_trans(S)[..., None])[..., 0]
    return jnp.concatenate([w, v, sigma[..., None]], axis=-1)


def sim3_retract(S, xi):
    return sim3_compose(sim3_exp(xi), S)
