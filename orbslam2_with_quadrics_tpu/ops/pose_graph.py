"""Sim3 pose-graph (essential graph) optimization.

Array-native rebuild of ``Optimizer::OptimizeEssentialGraph``
(reference src/Optimizer.cc:781-1044): keyframe poses are lifted to Sim3,
relative-pose edges (spanning tree, loop edges, strong covisibility) are
optimized with Levenberg-Marquardt. Edge residual matches g2o's EdgeSim3:
``e = log(S_ji * S_iw * S_wj)`` with measurement ``S_ji`` frozen at its
pre-loop value; Jacobians come from jacfwd on the retraction (exact, and
free of hand-derived adjoint bookkeeping).

The normal equations are solved MATRIX-FREE: the Hessian is never
materialized — ``H x`` is two edge sweeps (gather endpoint blocks,
per-edge 7x7 products, segment-sum back), preconditioned CG with the
block-diagonal [K,7,7] inverse. Memory is O(K*49 + E*98) instead of the
dense O(49*K^2), so KITTI-00-scale graphs (K ~ 2000, where a dense
[7K,7K] Hessian would be ~800 MB and an O(K^3) solve) stay cheap; at
small K the edge sweeps are still a handful of fused matmuls.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import lie


def edge_residual(S_i, S_j, S_meas_ji):
    """e = log( S_meas_ji * S_i * S_j^-1 )  [7]."""
    err = lie.sim3_compose(
        S_meas_ji, lie.sim3_compose(S_i, lie.sim3_inverse(S_j))
    )
    return lie.sim3_log(err)


def _edge_terms(Sp, edge_i, edge_j, S_meas_ji, edge_w, fixed):
    """Per-edge residuals + endpoint Jacobians, gauge-masked."""

    def per_edge(i, j, meas):
        Si, Sj = Sp[i], Sp[j]
        r = edge_residual(Si, Sj, meas)
        Ji = jax.jacfwd(
            lambda xi: edge_residual(lie.sim3_retract(Si, xi), Sj, meas)
        )(jnp.zeros(7, Sp.dtype))
        Jj = jax.jacfwd(
            lambda xj: edge_residual(Si, lie.sim3_retract(Sj, xj), meas)
        )(jnp.zeros(7, Sp.dtype))
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(per_edge)(edge_i, edge_j, S_meas_ji)
    Ji = Ji * (1.0 - fixed[edge_i])[:, None, None]
    Jj = Jj * (1.0 - fixed[edge_j])[:, None, None]
    cost = jnp.sum(jnp.sum(r * r, axis=-1) * edge_w)
    return r, Ji, Jj, cost


def _graph_cost(Sp, edge_i, edge_j, S_meas_ji, edge_w):
    r = jax.vmap(lambda i, j, meas: edge_residual(Sp[i], Sp[j], meas))(
        edge_i, edge_j, S_meas_ji
    )
    return jnp.sum(jnp.sum(r * r, axis=-1) * edge_w)


def _hess_matvec(x, Ji, Jj, edge_i, edge_j, edge_w, D_lam_only, K):
    """(H + lam*diag(H) + fix) x via edge sweeps; the lam/fix part is
    applied through the precomputed block diagonal difference."""
    u = jnp.einsum("eri,ei->er", Ji, x[edge_i]) + jnp.einsum(
        "eri,ei->er", Jj, x[edge_j]
    )  # [E,7] J x in residual space
    wu = u * edge_w[:, None]
    yi = jnp.einsum("eri,er->ei", Ji, wu)
    yj = jnp.einsum("eri,er->ei", Jj, wu)
    y = jax.ops.segment_sum(yi, edge_i, num_segments=K)
    y = y + jax.ops.segment_sum(yj, edge_j, num_segments=K)
    # add the damping/fixing part (D_lam_only = damped block diag minus the
    # undamped block diag, i.e. exactly the lam*diag + identity-row term)
    return y + jnp.einsum("kij,kj->ki", D_lam_only, x)


@partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimize_pose_graph(
    S_poses,
    edge_i,
    edge_j,
    S_meas_ji,
    edge_w,
    fixed,
    iters: int = 20,
    cg_iters: int = 60,
):
    """Optimize Sim3 keyframe poses over relative-pose edges.

    Args:
      S_poses: [K,8] Sim3 world->keyframe.
      edge_i/edge_j: [E] int32 endpoints.
      S_meas_ji: [E,8] measured S_j->S_i relative Sim3 (S_i * S_j^-1).
      edge_w: [E] weights (0 = padding).
      fixed: [K] 1.0 where pose held (the loop-origin KF,
        src/Optimizer.cc:855).
      iters: LM iterations (reference uses 20, src/Optimizer.cc:987).
      cg_iters: preconditioned-CG iterations per LM step.

    Returns optimized [K,8] poses.
    """
    K = S_poses.shape[0]

    def step(_, carry):
        Sp, lam, cost = carry
        r, Ji, Jj, _ = _edge_terms(Sp, edge_i, edge_j, S_meas_ji, edge_w, fixed)
        wr = r * edge_w[:, None]
        b = -jax.ops.segment_sum(
            jnp.einsum("eri,er->ei", Ji, wr), edge_i, num_segments=K
        )
        b = b - jax.ops.segment_sum(
            jnp.einsum("eri,er->ei", Jj, wr), edge_j, num_segments=K
        )
        # undamped block diagonal, then the damped/fixed version; their
        # difference is exactly the lam*diag + identity-row term the
        # matrix-free matvec must add on top of the pure J^T J sweeps
        Hii = jnp.einsum("e,eri,erj->eij", edge_w, Ji, Ji)
        Hjj = jnp.einsum("e,eri,erj->eij", edge_w, Jj, Jj)
        Hblk = jax.ops.segment_sum(Hii, edge_i, num_segments=K)
        Hblk = Hblk + jax.ops.segment_sum(Hjj, edge_j, num_segments=K)
        eye = jnp.eye(7, dtype=Sp.dtype)
        deg = jnp.abs(jnp.einsum("kii->k", Hblk))
        D = Hblk + lam * Hblk * eye + jnp.where(
            (deg < 1e-12) | (fixed > 0.5), 1.0, 1e-8
        )[:, None, None] * eye
        D_extra = D - Hblk
        Minv = jnp.linalg.inv(D)

        matvec = lambda x: _hess_matvec(
            x, Ji, Jj, edge_i, edge_j, edge_w, D_extra, K
        )
        dx = _pcg(b, matvec, Minv, cg_iters)
        dx = dx * (1.0 - fixed)[:, None]
        S_new = jax.vmap(lie.sim3_retract)(Sp, dx)
        new_cost = _graph_cost(S_new, edge_i, edge_j, S_meas_ji, edge_w)
        ok = (new_cost < cost) & jnp.all(jnp.isfinite(dx))
        Sp = jnp.where(ok, S_new, Sp)
        return (
            Sp,
            jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e6),
            jnp.where(ok, new_cost, cost),
        )

    cost0 = _graph_cost(S_poses, edge_i, edge_j, S_meas_ji, edge_w)
    Sp, _, _ = jax.lax.fori_loop(
        0, iters, step, (S_poses, jnp.asarray(1e-6, S_poses.dtype), cost0)
    )
    return Sp


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on [K,7] unknowns."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = jnp.einsum("kij,kj->ki", Minv, r0)
    p0 = z0

    def body(_, st):
        x, r, z, p = st
        Ap = matvec(p)
        rz = jnp.sum(r * z)
        denom = jnp.sum(p * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r2 = r - alpha * Ap
        z2 = jnp.einsum("kij,kj->ki", Minv, r2)
        beta = jnp.sum(r2 * z2) / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
        return x, r2, z2, z2 + beta * p

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, z0, p0))
    return x


@partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph_dense(
    S_poses,
    edge_i,
    edge_j,
    S_meas_ji,
    edge_w,
    fixed,
    iters: int = 20,
):
    """Dense-Hessian reference implementation (the round-1 solver): builds
    the full [7K,7K] system and jnp.linalg.solve's it. O(K^3) — kept as the
    ground truth the matrix-free solver is validated against in tests; use
    :func:`optimize_pose_graph` in the pipeline."""
    K = S_poses.shape[0]

    def build(Sp):
        r, Ji, Jj, cost = _edge_terms(Sp, edge_i, edge_j, S_meas_ji, edge_w, fixed)
        w = edge_w
        H = jnp.zeros((K, 7, K, 7), S_poses.dtype)
        Hii = jnp.einsum("e,eri,erj->eij", w, Ji, Ji)
        Hjj = jnp.einsum("e,eri,erj->eij", w, Jj, Jj)
        Hij = jnp.einsum("e,eri,erj->eij", w, Ji, Jj)
        H = H.at[edge_i, :, edge_i, :].add(Hii)
        H = H.at[edge_j, :, edge_j, :].add(Hjj)
        H = H.at[edge_i, :, edge_j, :].add(Hij)
        H = H.at[edge_j, :, edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 7), S_poses.dtype)
        b = b.at[edge_i].add(-jnp.einsum("e,eri,er->ei", w, Ji, r))
        b = b.at[edge_j].add(-jnp.einsum("e,eri,er->ei", w, Jj, r))
        return H.reshape(K * 7, K * 7), b.reshape(K * 7), cost

    def step(_, carry):
        Sp, lam, cost = carry
        H, b, _ = build(Sp)
        diag_fix = jnp.repeat(fixed, 7)
        H = H + jnp.diag(diag_fix + 1e-8)
        Hd = H + lam * jnp.diag(jnp.diag(H))
        dx = jnp.linalg.solve(Hd, b).reshape(K, 7)
        dx = dx * (1.0 - fixed)[:, None]
        S_new = jax.vmap(lie.sim3_retract)(Sp, dx)
        new_cost = _graph_cost(S_new, edge_i, edge_j, S_meas_ji, edge_w)
        ok = (new_cost < cost) & jnp.all(jnp.isfinite(dx))
        Sp = jnp.where(ok, S_new, Sp)
        return (
            Sp,
            jnp.clip(jnp.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e6),
            jnp.where(ok, new_cost, cost),
        )

    cost0 = _graph_cost(S_poses, edge_i, edge_j, S_meas_ji, edge_w)
    Sp, _, _ = jax.lax.fori_loop(
        0, iters, step, (S_poses, jnp.asarray(1e-6, S_poses.dtype), cost0)
    )
    return Sp
