"""Bundle adjustment: Schur-complement Levenberg-Marquardt, CG-solved.

Array-native replacement for the reference's g2o BlockSolver pipeline
(Thirdparty/g2o/g2o/core/block_solver.hpp + src/Optimizer.cc:41-778):

- The edge list is a flat, fixed-capacity struct-of-arrays
  ``(cam_idx, pnt_idx, uvr, is_stereo, inv_sigma2, valid)`` — masking
  replaces g2o's edge levels/removal.
- Landmarks are marginalized exactly as g2o does with
  ``setMarginalized(true)`` (src/Optimizer.cc:98,579): per-point 3x3 blocks
  are eliminated in closed form and the reduced camera system
  ``S = Hcc - W Hpp^-1 W^T`` is solved.
- Instead of sparse Cholesky, S is applied *implicitly* via two
  segment-sum sweeps over the edge list and solved with block-Jacobi
  preconditioned conjugate gradients — the same sweep parallelizes over a
  device mesh by sharding edges and ``psum``-ing the reduced products
  (see parallel/dist_ba.py), which is the BASELINE.json multi-host target.
- Huber robustness is IRLS weights; LM damping with accept/reject steps.

All shapes static; the entire solve is one jitted ``fori_loop``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import lie, residuals


class BAProblem(NamedTuple):
    poses: jnp.ndarray       # [C,7] T_cw
    points: jnp.ndarray      # [P,3]
    K: jnp.ndarray           # [4]
    bf: jnp.ndarray          # scalar fx*baseline
    cam_idx: jnp.ndarray     # [O] int32
    pnt_idx: jnp.ndarray     # [O] int32
    uvr: jnp.ndarray         # [O,3]
    is_stereo: jnp.ndarray   # [O] float (1.0 stereo row active)
    inv_sigma2: jnp.ndarray  # [O]
    valid: jnp.ndarray       # [O] float mask
    fixed_cam: jnp.ndarray   # [C] float (1.0 = pose constant)
    fixed_pnt: jnp.ndarray   # [P] float


def _edge_terms(prob: BAProblem, huber_delta2, axis_name=None):
    """Residuals, weights and weighted Jacobians for every edge."""
    e, Jc, Jp, z = jax.vmap(
        lambda c, p, o: residuals.residual_and_jacobians(
            prob.poses[c], prob.K, prob.bf, prob.points[p], o
        )
    )(prob.cam_idx, prob.pnt_idx, prob.uvr)

    row_w = jnp.stack(
        [
            jnp.ones_like(prob.is_stereo),
            jnp.ones_like(prob.is_stereo),
            prob.is_stereo,
        ],
        axis=-1,
    )  # [O,3]
    # depth must be positive; kill edges behind the camera
    # (reference checks pKF->IsInImage / positive depth when building edges)
    ok = prob.valid * (z > 0.05).astype(e.dtype)
    chi2 = jnp.sum(e * e * row_w, axis=-1) * prob.inv_sigma2
    hw = jnp.where(
        huber_delta2 > 0,
        residuals.huber_weight(chi2, jnp.where(huber_delta2 > 0, huber_delta2, 1.0)),
        1.0,
    )
    w = ok * prob.inv_sigma2 * hw  # [O]

    # robust cost
    rho = jnp.where(
        (huber_delta2 > 0) & (chi2 > huber_delta2),
        2.0 * jnp.sqrt(huber_delta2 * jnp.maximum(chi2, 1e-12)) - huber_delta2,
        chi2,
    )
    cost = jnp.sum(rho * ok)
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)

    # gauge: fixed cameras/points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam[prob.cam_idx])[:, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[prob.pnt_idx])[:, None, None]

    wr = row_w * w[:, None]  # [O,3] combined row weights
    JcW = Jc * wr[:, :, None]  # [O,3,6]
    JpW = Jp * wr[:, :, None]  # [O,3,3]
    return e, Jc, Jp, JcW, JpW, cost, chi2, ok


def _seg(vals, idx, num, axis_name=None):
    out = jax.ops.segment_sum(vals, idx, num_segments=num)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def _build_system(prob: BAProblem, huber_delta2, lam, axis_name=None):
    C, P = prob.poses.shape[0], prob.points.shape[0]
    e, Jc, Jp, JcW, JpW, cost, _, _ = _edge_terms(prob, huber_delta2, axis_name)

    Hcc = _seg(jnp.einsum("ori,orj->oij", JcW, Jc), prob.cam_idx, C, axis_name)
    # GN normal equations: H delta = b with b = -J^T W e (J = de/dx)
    bc = _seg(-jnp.einsum("ori,or->oi", JcW, e), prob.cam_idx, C, axis_name)
    Hpp = _seg(jnp.einsum("ori,orj->oij", JpW, Jp), prob.pnt_idx, P, axis_name)
    bp = _seg(-jnp.einsum("ori,or->oi", JpW, e), prob.pnt_idx, P, axis_name)
    Wcp = jnp.einsum("ori,orj->oij", JcW, Jp)  # [O,6,3] stays per-edge

    # LM damping (multiplicative on diagonals + small absolute floor);
    # fixed cameras get an identity block so the Jacobi preconditioner
    # stays O(1) and CG directions are not polluted
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    eye3 = jnp.eye(3, dtype=Hpp.dtype)
    Hcc_d = (
        Hcc
        + lam * Hcc * eye6
        + (1e-8 + prob.fixed_cam)[:, None, None] * eye6
    )
    # points with no (free) observations likewise
    pnt_observed = jnp.abs(jnp.einsum("pii->p", Hpp)) > 1e-12
    Hpp_d = (
        Hpp
        + lam * Hpp * eye3
        + jnp.where(pnt_observed, 1e-8, 1.0)[:, None, None] * eye3
    )
    Hpp_inv = jnp.linalg.inv(Hpp_d)

    return Hcc_d, bc, Hpp_inv, bp, Wcp, cost


def _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp, axis_name=None):
    """S x = Hcc_d x - W Hpp^-1 W^T x via two edge sweeps."""
    P = prob.points.shape[0]
    C = prob.poses.shape[0]
    t1 = jnp.einsum("oij,oi->oj", Wcp, x[prob.cam_idx])      # [O,3] W^T x
    y = jnp.einsum("pij,pj->pi", Hpp_inv, _seg(t1, prob.pnt_idx, P, axis_name))
    t2 = jnp.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])      # [O,6]
    coupling = _seg(t2, prob.cam_idx, C, axis_name)
    return jnp.einsum("cij,cj->ci", Hcc_d, x) - coupling


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the reduced camera system."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = jnp.einsum("cij,cj->ci", Minv, r0)
    p0 = z0

    def body(_, st):
        x, r, z, p = st
        Ap = matvec(p)
        rz = jnp.sum(r * z)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r2 = r - alpha * Ap
        z2 = jnp.einsum("cij,cj->ci", Minv, r2)
        beta = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return x, r2, z2, z2 + beta * p

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, p0))
    return x


def ba_iteration(prob: BAProblem, lam, huber_delta2, cg_iters: int, axis_name=None):
    """One damped Gauss-Newton (LM) step. Returns (new_prob, cost, step_ok)."""
    Hcc_d, bc, Hpp_inv, bp, Wcp, cost = _build_system(
        prob, huber_delta2, lam, axis_name
    )
    Minv = jnp.linalg.inv(Hcc_d)
    g = bc - _schur_rhs(prob, Hpp_inv, bp, Wcp, axis_name)
    dc = _pcg(
        g,
        lambda x: _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp, axis_name),
        Minv,
        cg_iters,
    )
    dc = dc * (1.0 - prob.fixed_cam)[:, None]

    # back-substitute points: dp = Hpp^-1 (bp - W^T dc)
    P = prob.points.shape[0]
    t1 = jnp.einsum("oij,oi->oj", Wcp, dc[prob.cam_idx])
    dp = jnp.einsum(
        "pij,pj->pi", Hpp_inv, bp - _seg(t1, prob.pnt_idx, P, axis_name)
    )
    dp = dp * (1.0 - prob.fixed_pnt)[:, None]

    new_poses = jax.vmap(lie.se3_retract)(prob.poses, dc)
    new_points = prob.points + dp
    cand = prob._replace(poses=new_poses, points=new_points)
    _, _, _, _, _, new_cost, _, _ = _edge_terms(cand, huber_delta2, axis_name)

    finite = jnp.all(jnp.isfinite(dc)) & jnp.all(jnp.isfinite(dp))
    ok = (new_cost < cost) & finite
    out = jax.tree.map(
        lambda a, b: jnp.where(ok, a, b), cand, prob
    )
    return out, jnp.where(ok, new_cost, cost), ok


def _schur_rhs(prob, Hpp_inv, bp, Wcp, axis_name=None):
    """W Hpp^-1 bp accumulated per camera."""
    C = prob.poses.shape[0]
    y = jnp.einsum("pij,pj->pi", Hpp_inv, bp)
    t = jnp.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    return _seg(t, prob.cam_idx, C, axis_name)


@partial(jax.jit, static_argnames=("n_iters", "cg_iters", "use_huber", "axis_name"))
def ba_solve(
    prob: BAProblem,
    n_iters: int = 10,
    cg_iters: int = 40,
    use_huber: bool = True,
    axis_name: str | None = None,
):
    """Run ``n_iters`` LM steps. Returns (prob, final_cost).

    Mirrors Optimizer::LocalBundleAdjustment's 5-then-10 schedule when
    called twice with an outlier-mask refresh in between
    (src/Optimizer.cc:653-707); GlobalBundleAdjustemnt's 10/20 iterations
    map to a single call (src/Optimizer.cc:41-64).
    """
    huber_delta2 = jnp.asarray(residuals.CHI2_STEREO if use_huber else 0.0)

    def body(_, carry):
        prob, lam, cost = carry
        prob, cost, ok = ba_iteration(prob, lam, huber_delta2, cg_iters, axis_name)
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        return prob, lam, cost

    _, _, _, _, _, cost0, _, _ = _edge_terms(prob, huber_delta2, axis_name)
    prob, _, cost = jax.lax.fori_loop(
        0, n_iters, body, (prob, jnp.asarray(1e-4, prob.poses.dtype), cost0)
    )
    return prob, cost


@jax.jit
def edge_chi2(prob: BAProblem):
    """Per-edge chi2 + validity under the current estimate (for the
    5-iter -> outlier purge -> 10-iter local BA schedule and the final
    erase step, src/Optimizer.cc:672-744)."""
    _, _, _, _, _, _, chi2, ok = _edge_terms(prob, jnp.asarray(0.0))
    gate = jnp.where(prob.is_stereo > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return chi2, (chi2 < gate) & (ok > 0)


def local_ba(prob: BAProblem, cg_iters: int = 40):
    """Reference LocalBundleAdjustment schedule: 5 robust iters, purge
    outlier edges, 10 more iters (src/Optimizer.cc:653-707)."""
    prob, _ = ba_solve(prob, n_iters=5, cg_iters=cg_iters, use_huber=True)
    _, inl = edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.astype(prob.valid.dtype))
    prob, cost = ba_solve(prob, n_iters=10, cg_iters=cg_iters, use_huber=False)
    return prob, cost


# ----------------------------------------------------------------------
# Dense-Schur direct solver (latency path for local BA)
#
# The PCG path above runs ~40 sequential CG steps per LM iteration, each
# a full edge sweep — right for mesh-sharded problems (dist_ba), but on
# one device the reduced camera system of a LOCAL window is tiny
# (C <= ~50 cameras => <= 300 dims): build S = Hcc - W Hpp^-1 W^T
# DENSELY and solve it exactly with Cholesky (g2o solves the same
# reduced system with sparse Cholesky, g2o/core/block_solver.hpp).
# The local-BA program with this solver took 12.1 ms against 51.2 ms
# with PCG (H100 80GB HBM3 at a 700 W power limit, TUM-shaped map).
# Layout:
#   * every per-edge scalar lives in a [C, N] plane (camera-major edge
#     table), so all residual/Jacobian math is elementwise work over
#     whole planes, unrolled over the 6x3 block components in Python
#     (no tensors whose minor dimension is 3 or 6)
#   * per-point blocks (Hpp, bp, the coupling V) reach the compacted
#     L-slot point space by one segment sum over (camera, slot) pairs
#   * S = Hcc - V Hpi V^T is assembled by 3 [C6, L] x [L, C6] matmuls;
#     Hpp^-1 is a closed-form 3x3 adjugate (elementwise)
# ----------------------------------------------------------------------


def _local_point_table(prob: BAProblem, n_local_pts: int, cam_grid):
    """Compact the point ids that actually couple cameras (valid edge,
    free point) into L local slots; overflow points fall back to
    "treated as fixed this solve" — they keep contributing residuals and
    camera terms but receive no Schur coupling, no RHS term and no
    update, which is self-consistent (dropping their coupling but
    keeping their RHS term would not be). The eligible set is
    fixed for a whole ba_solve_dense call, so this runs once per solve.

    Returns (loc_ids [L] point ids with P=fill, ploc [C, N] local slot
    of each edge's point, L = not local)."""
    C, N = cam_grid
    P = prob.points.shape[0]
    L = n_local_pts
    eligible = (prob.valid > 0) & (prob.fixed_pnt[prob.pnt_idx] < 0.5)
    tagged = jnp.where(eligible, prob.pnt_idx, P)
    loc_ids = jnp.unique(tagged, size=L, fill_value=P)          # [L] sorted
    loc_of = jnp.full((P + 1,), L, jnp.int32)
    loc_of = loc_of.at[loc_ids].set(jnp.arange(L, dtype=jnp.int32))
    loc_of = loc_of.at[P].set(L)  # sentinel / fillers never map back
    return loc_ids, loc_of[tagged].reshape(C, N)                # [C,N]


def _residual_planes(prob: BAProblem, poses, points, cam_grid):
    """Per-edge residual scalars as [C, N] planes.

    Returns (e rows, weight-relevant masks, camera-frame coords) — every
    array is [C, N] so all math is elementwise over whole planes.
    """
    C, N = cam_grid
    R = lie.quat_to_matrix(poses[:, :4])                         # [C,3,3]
    t = poses[:, 4:7]
    pid = prob.pnt_idx.reshape(C, N)
    pw = points[pid]                                             # [C,N,3]
    pw0, pw1, pw2 = pw[..., 0], pw[..., 1], pw[..., 2]

    def rot(i):
        return (
            R[:, i, 0][:, None] * pw0
            + R[:, i, 1][:, None] * pw1
            + R[:, i, 2][:, None] * pw2
            + t[:, i][:, None]
        )

    x, y, z = rot(0), rot(1), rot(2)
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    fx, fy, cx, cy = prob.K[0], prob.K[1], prob.K[2], prob.K[3]
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    obs = prob.uvr.reshape(C, N, 3)
    e0 = obs[..., 0] - u
    e1 = obs[..., 1] - v
    e2 = obs[..., 2] - (u - prob.bf * iz)
    return e0, e1, e2, x, y, z, iz, R, pid


def _cost_grid(prob: BAProblem, poses, points, huber_delta2, cam_grid):
    """Robust cost in the planar layout (the LM accept/reject test)."""
    C, N = cam_grid
    e0, e1, e2, _, _, z, _, _, _ = _residual_planes(prob, poses, points, cam_grid)
    s = prob.is_stereo.reshape(C, N)
    is2 = prob.inv_sigma2.reshape(C, N)
    ok = prob.valid.reshape(C, N) * (z > 0.05)
    chi2 = (e0 * e0 + e1 * e1 + e2 * e2 * s) * is2
    rho = jnp.where(
        (huber_delta2 > 0) & (chi2 > huber_delta2),
        2.0 * jnp.sqrt(huber_delta2 * jnp.maximum(chi2, 1e-12)) - huber_delta2,
        chi2,
    )
    return jnp.sum(rho * ok)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant) — pure
    elementwise math; jnp.linalg.inv lowers to a batched LU with pivoting
    control flow."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    idet = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack([
        jnp.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        jnp.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * idet[..., None, None]


def _dense_schur_step(prob: BAProblem, poses, points, lam, huber_delta2,
                      loc_ids, ploc, cam_grid):
    """One LM step solving the reduced camera system exactly, entirely in
    the [C, N]-planar layout (see section comment)."""
    C, N = cam_grid
    P = prob.points.shape[0]
    L = loc_ids.shape[0]
    e0, e1, e2, x, y, z, iz, R, pid = _residual_planes(
        prob, poses, points, cam_grid
    )
    s = prob.is_stereo.reshape(C, N)
    is2 = prob.inv_sigma2.reshape(C, N)
    ok = prob.valid.reshape(C, N) * (z > 0.05)
    chi2 = (e0 * e0 + e1 * e1 + e2 * e2 * s) * is2
    hw = jnp.where(
        huber_delta2 > 0,
        residuals.huber_weight(
            chi2, jnp.where(huber_delta2 > 0, huber_delta2, 1.0)
        ),
        1.0,
    )
    w = ok * is2 * hw
    rho = jnp.where(
        (huber_delta2 > 0) & (chi2 > huber_delta2),
        2.0 * jnp.sqrt(huber_delta2 * jnp.maximum(chi2, 1e-12)) - huber_delta2,
        chi2,
    )
    cost = jnp.sum(rho * ok)

    # Jacobian rows, unrolled to [C, N] planes. dpred rows (a0,a1,a2):
    #   u:  (fx iz, 0, -fx x iz^2)   v: (0, fy iz, -fy y iz^2)
    #   ur: u-row + (0, 0, bf iz^2)
    # Jc_row = -(dpred @ [-hat(pc) | I]) with
    #   -hat(pc) = [[0, z, -y], [-z, 0, x], [y, -x, 0]]
    # Jp_row = -(dpred @ R)
    fx, fy = prob.K[0], prob.K[1]
    iz2 = iz * iz
    fc = (1.0 - prob.fixed_cam)[:, None]                        # [C,1]
    fp = 1.0 - prob.fixed_pnt[pid]                              # [C,N]

    def row_jacs(a0, a1, a2):
        jc = (
            -(a1 * (-z) + a2 * y) * fc,
            -(a0 * z + a2 * (-x)) * fc,
            -(a0 * (-y) + a1 * x) * fc,
            -a0 * fc,
            -a1 * fc,
            -a2 * fc,
        )
        jp = tuple(
            -(
                a0 * R[:, 0, j][:, None]
                + a1 * R[:, 1, j][:, None]
                + a2 * R[:, 2, j][:, None]
            ) * fp
            for j in range(3)
        )
        return jc, jp

    zero = jnp.zeros_like(iz)
    rows = (
        (row_jacs(fx * iz, zero, -fx * x * iz2), w, e0),
        (row_jacs(zero, fy * iz, -fy * y * iz2), w, e1),
        (row_jacs(fx * iz, zero, -fx * x * iz2 + prob.bf * iz2), w * s, e2),
    )

    # accumulate block components as [C, N] planes (Hcc/Hpp symmetric)
    hcc = [[zero] * 6 for _ in range(6)]
    bc_c = [zero] * 6
    hpp = [[zero] * 3 for _ in range(3)]
    bp_c = [zero] * 3
    wcp = [[zero] * 3 for _ in range(6)]
    for (jc, jp), wr, er in rows:
        jcw = [wr * c for c in jc]
        jpw = [wr * p for p in jp]
        for i in range(6):
            bc_c[i] = bc_c[i] - jcw[i] * er
            for j in range(i, 6):
                hcc[i][j] = hcc[i][j] + jcw[i] * jc[j]
            for j in range(3):
                wcp[i][j] = wcp[i][j] + jcw[i] * jp[j]
        for i in range(3):
            bp_c[i] = bp_c[i] - jpw[i] * er
            for j in range(i, 3):
                hpp[i][j] = hpp[i][j] + jpw[i] * jp[j]

    # camera blocks: reduce over each camera's row
    Hcc = jnp.stack(
        [
            jnp.stack(
                [hcc[min(i, j)][max(i, j)].sum(1) for j in range(6)], -1
            )
            for i in range(6)
        ],
        -2,
    )                                                           # [C,6,6]
    bc = jnp.stack([b.sum(1) for b in bc_c], -1)                # [C,6]
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    Hcc_d = (
        Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6
    )

    # point blocks into L-space: one segment sum over (camera, local
    # slot) pairs; slot L collects edges whose point is not local
    X = jnp.stack(
        [hpp[i][j] for i in range(3) for j in range(i, 3)]
        + bp_c
        + [wcp[i][j] for i in range(6) for j in range(3)],
        axis=-1,
    )                                                           # [C,N,27]
    seg = jnp.arange(C, dtype=jnp.int32)[:, None] * (L + 1) + ploc
    red = jax.ops.segment_sum(
        X.reshape(C * N, 27), seg.reshape(-1), num_segments=C * (L + 1)
    ).reshape(C, L + 1, 27)[:, :L].transpose(0, 2, 1)           # [C,27,L]
    HppL = [[red[:, i * 3 - i * (i - 1) // 2 + (j - i)].sum(0)
             for j in range(i, 3)] for i in range(3)]
    bpL = [red[:, 6 + j].sum(0) for j in range(3)]              # 3 x [L]
    Vg = [[red[:, 9 + i * 3 + j] for j in range(3)] for i in range(6)]

    # damped 3x3 point blocks -> closed-form inverse (components [L])
    def Hd(i, j):
        v = HppL[min(i, j)][abs(j - i)] if j >= i else HppL[j][i - j]
        if i == j:
            trace = HppL[0][0] + HppL[1][0] + HppL[2][0]
            v = v * (1.0 + lam) + jnp.where(
                jnp.abs(trace) > 1e-12, 1e-8, 1.0
            )
        return v

    Hpp_mat = jnp.stack(
        [jnp.stack([Hd(i, j) for j in range(3)], -1) for i in range(3)], -2
    )                                                           # [L,3,3]
    Hpi_mat = _inv3x3(Hpp_mat)
    Hpi = [[Hpi_mat[:, i, j] for j in range(3)] for i in range(3)]

    # VH[i][k] = sum_j V[i][j] Hpi[j][k]  ([C,L] planes)
    VH = [
        [
            sum(Vg[i][j] * Hpi[j][k][None, :] for j in range(3))
            for k in range(3)
        ]
        for i in range(6)
    ]
    # S_cross = sum_k A_k B_k^T with A_k,B_k : [C*6, L]
    def pack(mat, k):
        return jnp.stack(
            [mat[i][k] for i in range(6)], axis=1
        ).reshape(C * 6, L)

    S_cross = sum(
        jax.lax.dot_general(
            pack(VH, k), pack(Vg, k),
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        for k in range(3)
    )
    S = (-S_cross).reshape(C, 6, C, 6)
    S = S.at[jnp.arange(C), :, jnp.arange(C), :].add(Hcc_d)
    S_flat = S.reshape(C * 6, C * 6)

    # g = bc - V Hpi bp
    yL = [
        sum(Hpi[j][k] * bpL[k] for k in range(3)) for j in range(3)
    ]                                                           # 3 x [L]
    rhs = jnp.stack(
        [
            sum((Vg[i][j] * yL[j][None, :]).sum(1) for j in range(3))
            for i in range(6)
        ],
        -1,
    )                                                           # [C,6]
    g = bc - rhs

    dc = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(
            S_flat + 1e-10 * jnp.eye(C * 6, dtype=S_flat.dtype)
        ),
        g.reshape(-1),
    ).reshape(C, 6)
    dc = dc * (1.0 - prob.fixed_cam)[:, None]

    # back-substitute local points: dp = Hpi (bp - V^T dc), then one
    # [L]->[P] scatter
    wt = [
        sum((Vg[i][j] * dc[:, i][:, None]).sum(0) for i in range(6))
        for j in range(3)
    ]                                                           # 3 x [L]
    dp_L = jnp.stack(
        [
            sum(Hpi[j][k] * (bpL[k] - wt[k]) for k in range(3))
            for j in range(3)
        ],
        -1,
    )                                                           # [L,3]
    new_points = points.at[loc_ids].add(dp_L, mode="drop")

    new_poses = jax.vmap(lie.se3_retract)(poses, dc)
    new_cost = _cost_grid(prob, new_poses, new_points, huber_delta2, cam_grid)
    finite = jnp.all(jnp.isfinite(dc)) & jnp.all(jnp.isfinite(dp_L))
    acc = (new_cost < cost) & finite
    poses_out = jnp.where(acc, new_poses, poses)
    points_out = jnp.where(acc, new_points, points)
    return poses_out, points_out, jnp.where(acc, new_cost, cost), acc


@partial(jax.jit, static_argnames=("n_iters", "n_local_pts", "use_huber",
                                   "cam_grid"))
def ba_solve_dense(
    prob: BAProblem,
    n_iters: int = 10,
    n_local_pts: int = 8192,
    use_huber: bool = True,
    cam_grid=None,
):
    """ba_solve with the dense-Schur direct step (single chip, local-BA
    problem sizes). Same LM damping/accept schedule as ba_solve.

    cam_grid: static (C, N) declaring the edge table cam-major [C, N]
    (cam_idx = arange(C) repeated). Required — the planar step depends on
    per-camera contiguity; pass a cam-major table (every in-repo caller
    builds one from the [K,N] observation table)."""
    assert cam_grid is not None, (
        "ba_solve_dense requires a cam-major edge table (cam_grid=(C, N)); "
        "use ba_solve for arbitrary edge layouts"
    )
    huber_delta2 = jnp.asarray(residuals.CHI2_STEREO if use_huber else 0.0)

    loc_ids, ploc = _local_point_table(prob, n_local_pts, cam_grid)

    def body(_, carry):
        poses, points, lam, cost = carry
        poses, points, cost, ok = _dense_schur_step(
            prob, poses, points, lam, huber_delta2, loc_ids, ploc, cam_grid
        )
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        return poses, points, lam, cost

    cost0 = _cost_grid(prob, prob.poses, prob.points, huber_delta2, cam_grid)
    poses, points, _, cost = jax.lax.fori_loop(
        0, n_iters, body,
        (prob.poses, prob.points, jnp.asarray(1e-4, prob.poses.dtype), cost0),
    )
    return prob._replace(poses=poses, points=points), cost
