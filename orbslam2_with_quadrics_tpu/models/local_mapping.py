"""Keyframe-rate mapping: triangulate, fuse, cull, local BA.

Array-native rebuild of the LocalMapping thread's pipeline
(reference src/LocalMapping.cc:47-112): each stage is a pure jitted
function MapState -> MapState; the host orchestrator calls them in the
same order the reference's thread loop does (ProcessNewKeyFrame ->
MapPointCulling -> CreateNewMapPoints -> SearchInNeighbors -> LocalBA ->
KeyFrameCulling).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import ba, camera, lie, matching, orb
from . import map_state as ms


def _relative_fundamental(T1w, T2w, Kc):
    """F21 with x2^T F21 x1 = 0 (ComputeF12, src/LocalMapping.cc:536-554)."""
    T21 = lie.se3_compose(T2w, lie.se3_inverse(T1w))
    R = lie.quat_to_matrix(T21[:4])
    t = T21[4:7]
    E = lie.hat(t) @ R
    fx, fy, cx, cy = Kc[0], Kc[1], Kc[2], Kc[3]
    Km = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Kinv = jnp.linalg.inv(Km)
    return Kinv.T @ E @ Kinv


def _epipolar_dist2(F21, uv1, uv2):
    """Squared point-line distance of uv2 to the epipolar line of uv1
    (CheckDistEpipolarLine, src/ORBmatcher.cc:140-157)."""
    a = F21[0, 0] * uv1[:, 0] + F21[0, 1] * uv1[:, 1] + F21[0, 2]
    b = F21[1, 0] * uv1[:, 0] + F21[1, 1] * uv1[:, 1] + F21[1, 2]
    c = F21[2, 0] * uv1[:, 0] + F21[2, 1] * uv1[:, 1] + F21[2, 2]
    num = a[:, None] * uv2[None, :, 0] + b[:, None] * uv2[None, :, 1] + c[:, None]
    den = jnp.maximum(a * a + b * b, 1e-12)
    return num * num / den[:, None]


@partial(jax.jit, static_argnames=("n_neighbors", "n_levels", "scale"))
def create_new_points(
    m: ms.MapState,
    kf_id,
    Kc,
    bf,
    n_neighbors: int = 10,
    n_levels: int = 8,
    scale: float = 1.2,
    W=None,
):
    """Triangulate new map points between the newest keyframe and its
    covisible neighbors (CreateNewMapPoints, src/LocalMapping.cc:207-452).

    Per neighbor: epipolar-gated descriptor match on *unmatched* keypoints,
    then DLT triangulation + cheirality/reprojection/scale checks; the best
    neighbor (min Hamming) wins per keypoint; survivors are appended to the
    point pool and wired into both keyframes' observation rows.
    """
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    sf, sigma2_tab, _ = orb.scale_factors(n_levels, scale)

    if W is None:
        W = ms.covisibility(m)
    n_nb = min(n_neighbors, K)
    nb_w, nb_ids = jax.lax.top_k(W[kf_id], n_nb)
    nb_ok = nb_w > 0

    T1 = m.kf_pose[kf_id]
    uv1 = m.kf_uv[kf_id]
    d1 = m.kf_desc[kf_id]
    lvl1 = m.kf_level[kf_id]
    free1 = m.kf_kp_valid[kf_id] & (m.kf_obs_point[kf_id] < 0)
    c1 = -lie.quat_rotate(lie.quat_conj(T1[:4]), T1[4:7])

    def per_neighbor(nb, ok_nb):
        T2 = m.kf_pose[nb]
        uv2 = m.kf_uv[nb]
        free2 = m.kf_kp_valid[nb] & (m.kf_obs_point[nb] < 0)
        F21 = _relative_fundamental(T1, T2, Kc)
        # epipolar gate in the *neighbor* image at the kp's octave sigma
        ed2 = _epipolar_dist2(F21, uv1, uv2)
        gate = 3.84 * sigma2_tab[jnp.clip(m.kf_level[nb], 0, n_levels - 1)]
        mask = free1[:, None] & free2[None, :] & (ed2 < gate[None, :]) & ok_nb

        # baseline check: skip neighbor if baseline/median-depth tiny
        # (src/LocalMapping.cc:232-252) — proxy: baseline > 1cm
        c2 = -lie.quat_rotate(lie.quat_conj(T2[:4]), T2[4:7])
        baseline_ok = jnp.linalg.norm(c2 - c1) > 0.01
        mask = mask & baseline_ok

        dist = matching.hamming_matrix(d1, m.kf_desc[nb])
        bi, bd, b2 = matching.best_two(dist, mask)
        okm = (bd <= matching.TH_LOW) & (
            bd.astype(jnp.float32) <= 0.9 * b2.astype(jnp.float32)
        )
        return jnp.where(okm, bi, -1), jnp.where(okm, bd, 1 << 20)

    nb_match, nb_dist = jax.vmap(per_neighbor)(nb_ids, nb_ok)  # [T,N]

    # choose best neighbor per keypoint
    tbest = jnp.argmin(nb_dist, axis=0)  # [N]
    rows = jnp.arange(N)
    match_kp = nb_match[tbest, rows]          # [N] kp idx in chosen neighbor
    match_nb = nb_ids[tbest]                  # [N] neighbor kf id
    have = match_kp >= 0

    # triangulate
    T2s = m.kf_pose[match_nb]
    P1 = camera.projection_matrix(T1, Kc)
    P2s = jax.vmap(camera.projection_matrix, in_axes=(0, None))(T2s, Kc)
    uv2m = m.kf_uv[match_nb, jnp.clip(match_kp, 0, N - 1)]
    X = jax.vmap(camera.triangulate_dlt, in_axes=(None, 0, 0, 0))(
        P1, P2s, uv1, uv2m
    )

    # checks (src/LocalMapping.cc:299-431)
    pc1 = lie.se3_apply(T1, X)
    pc2 = jax.vmap(lie.se3_apply)(T2s, X)
    uv1p, z1 = camera.project(Kc, pc1)
    uv2p, z2 = camera.project(Kc, pc2)
    s2_1 = sigma2_tab[jnp.clip(lvl1, 0, n_levels - 1)]
    lvl2 = m.kf_level[match_nb, jnp.clip(match_kp, 0, N - 1)]
    s2_2 = sigma2_tab[jnp.clip(lvl2, 0, n_levels - 1)]
    e1 = jnp.sum((uv1p - uv1) ** 2, axis=-1) / s2_1
    e2 = jnp.sum((uv2p - uv2m) ** 2, axis=-1) / s2_2

    c2s = -jax.vmap(lambda T: lie.quat_rotate(lie.quat_conj(T[:4]), T[4:7]))(T2s)
    r1 = X - c1[None, :]
    r2 = X - c2s
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    cosp = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
    # scale consistency: distance ratio vs octave ratio (src/LocalMapping.cc:410-427)
    ratio_d = n1 / jnp.maximum(n2, 1e-9)
    ratio_o = sf[jnp.clip(lvl1, 0, n_levels - 1)] / sf[jnp.clip(lvl2, 0, n_levels - 1)]
    scale_ok = (ratio_d < ratio_o * 1.5 * scale) & (ratio_d > ratio_o / (1.5 * scale))

    good = (
        have
        & (z1 > 0.05)
        & (z2 > 0.05)
        & (cosp < 0.9998)
        & (e1 < 5.991)
        & (e2 < 5.991)
        & scale_ok
        & jnp.all(jnp.isfinite(X), axis=-1)
    )

    m2, pids = ms.insert_points(
        m, X, d1, jnp.full((N,), kf_id, jnp.int32), good
    )

    # wire observations into both keyframes
    obs_row1 = m2.kf_obs_point[kf_id]
    obs_row1 = jnp.where(pids >= 0, pids, obs_row1)
    kf_obs = m2.kf_obs_point.at[kf_id].set(obs_row1)
    # neighbor rows: scatter per (match_nb, match_kp)
    flat = kf_obs.reshape(-1)
    tgt = match_nb * N + jnp.clip(match_kp, 0, N - 1)
    flat = flat.at[jnp.where(pids >= 0, tgt, K * N)].set(
        jnp.where(pids >= 0, pids, -1), mode="drop"
    )
    m2 = m2._replace(kf_obs_point=flat.reshape(K, N))
    return m2, jnp.sum((pids >= 0).astype(jnp.int32))


@jax.jit
def cull_points(m: ms.MapState):
    """MapPointCulling (src/LocalMapping.cc:170-205): drop points with a
    poor found/visible ratio or too few observations soon after creation.

    BOTH tests apply only to RECENTLY created points: the reference
    iterates mlpRecentAddedMapPoints and ERASES a point from that list
    once it survives ~3 keyframes — a mature point is never found-ratio
    culled again. An unbounded ratio cull (the pre-r05 behavior) eats the
    old map exactly when a trajectory revisits it: every mature point
    that drifts outside the projection-match radius stays in-frustum
    (visible++ with found stagnant), collapses its ratio, and is deleted
    — measured on the out-and-back eval as inliers decaying 200 -> 59
    along the return leg until tracking was lost."""
    obs_cnt = ms.point_obs_count(m)
    age = m.n_kf - 1 - m.pt_first_kf  # keyframes since creation
    ratio = m.pt_found.astype(jnp.float32) / jnp.maximum(
        m.pt_visible.astype(jnp.float32), 1.0
    )
    recent = age <= 4
    bad = recent & (ratio < 0.25) & (m.pt_visible > 3)
    bad = bad | ((age >= 2) & (age <= 4) & (obs_cnt <= 2))
    valid = m.pt_valid & ~bad
    # detach culled points from keyframes
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point
    obs_ok = (obs >= 0) & valid[jnp.clip(obs, 0, P - 1)]
    return m._replace(
        pt_valid=valid, kf_obs_point=jnp.where(obs_ok, obs, -1)
    )


@partial(jax.jit, static_argnames=("n_neighbors", "n_levels", "scale"))
def fuse_neighbors(
    m: ms.MapState,
    kf_id,
    Kc,
    height: int = 480,
    width: int = 640,
    n_neighbors: int = 10,
    n_levels: int = 8,
    scale: float = 1.2,
    W=None,
):
    """SearchInNeighbors / ORBmatcher::Fuse (src/LocalMapping.cc:454-534,
    src/ORBmatcher.cc:825-975), BOTH directions like the reference
    (forward :489, reverse :514): project the new keyframe's points into
    its neighbors AND each neighbor's points into the new keyframe; where
    a projection lands on a keypoint that already has a different point,
    merge (keep the more-observed one); where it lands on a free
    keypoint, add the observation. The reverse pass is what merges the
    fresh depth-seeded duplicates of stereo/RGB-D keyframes into the
    already-mature originals the tracker failed to re-match."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    sf, sigma2_tab, _ = orb.scale_factors(n_levels, scale)

    if W is None:
        W = ms.covisibility(m)
    n_nb = min(n_neighbors, K)
    nb_w, nb_ids = jax.lax.top_k(W[kf_id], n_nb)
    nb_ok = nb_w > 0

    src_pts = m.kf_obs_point[kf_id]  # [N] point ids of the new KF
    src_ok = src_pts >= 0
    pid = jnp.clip(src_pts, 0, P - 1)
    pos = m.pt_pos[pid]
    desc = m.pt_desc[pid]
    obs_cnt = ms.point_obs_count(m)

    def _pred_level(pid_arr, dist):
        # MapPoint::PredictScale (src/MapPoint.cc:385-417): the octave is
        # predicted from the point's scale band and its CURRENT distance,
        # not copied from whichever keypoint first saw it — a point seen
        # at octave 2 here may sit at octave 0 in the other view, and the
        # level-gated matcher would never merge the duplicate otherwise
        ratio = jnp.maximum(
            m.pt_max_dist[pid_arr] / jnp.maximum(dist, 1e-6), 1e-6
        )
        return jnp.clip(
            jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32),
            0, n_levels - 1,
        )

    def _fuse_vis_gates(pid_arr, pc, T_obs):
        # reference Fuse visibility gates (src/ORBmatcher.cc:846-876):
        # distance inside the point's scale band and viewing angle within
        # 60 deg of the stored normal — without them the projection sweep
        # merges points that merely LOOK similar from an invalid viewpoint
        dist = jnp.linalg.norm(pc, axis=-1)
        band = (dist >= m.pt_min_dist[pid_arr]) & (
            dist <= m.pt_max_dist[pid_arr]
        )
        c_obs = -lie.quat_rotate(lie.quat_conj(T_obs[:4]), T_obs[4:7])
        vec = m.pt_pos[pid_arr] - c_obs[None, :]
        view = (
            jnp.sum(vec * m.pt_normal[pid_arr], axis=-1)
            / jnp.maximum(jnp.linalg.norm(vec, axis=-1), 1e-6)
        ) > 0.5
        return band & view, dist

    def per_neighbor(nb, ok_nb, carry):
        remap, obs_flat = carry
        T2 = m.kf_pose[nb]
        pc2 = lie.se3_apply(T2, pos)
        uv_p, z = camera.project(Kc, pc2)
        gates, _ = _fuse_vis_gates(pid, pc2, T2)
        vis = (
            src_ok
            & ok_nb
            & gates
            & (z > 0.05)
            & (uv_p[:, 0] >= 0) & (uv_p[:, 0] < width)
            & (uv_p[:, 1] >= 0) & (uv_p[:, 1] < height)
        )
        mi, md = matching.match_by_projection(
            proj_uv=uv_p,
            proj_valid=vis,
            pred_level=_pred_level(pid, jnp.linalg.norm(pc2, axis=-1)),
            query_desc=desc,
            query_angle=jnp.zeros((N,)),
            feats_uv=m.kf_uv[nb],
            feats_level=m.kf_level[nb],
            feats_desc=m.kf_desc[nb],
            feats_angle=m.kf_angle[nb],
            feats_valid=m.kf_kp_valid[nb],
            radius=3.0,
            scale_factors=sf,
            th=matching.TH_LOW,
            ratio=1.0,
        )
        hit = mi >= 0
        tgt_kp = jnp.clip(mi, 0, N - 1)
        existing = obs_flat[nb * N + tgt_kp]  # current point at that kp
        # case 1: free keypoint -> add observation, but never a SECOND
        # observation of a point this keyframe already sees elsewhere
        # (reference Fuse gates on pMP->IsInKeyFrame, src/ORBmatcher.cc:
        # 900-906; a double observation inflates covisibility weights
        # and duplicates BA edges)
        nb_row = jax.lax.dynamic_slice_in_dim(obs_flat, nb * N, N)
        seen_in_nb = jnp.zeros((P + 1,), bool).at[
            jnp.where(nb_row >= 0, nb_row, P)
        ].set(True)[:P]
        add = hit & (existing < 0) & ~seen_in_nb[pid]
        obs_flat = obs_flat.at[
            jnp.where(add, nb * N + tgt_kp, K * N)
        ].set(jnp.where(add, src_pts, -1), mode="drop")
        # case 2: occupied by another point -> merge into more-observed
        dup = hit & (existing >= 0) & (existing != src_pts)
        keep_src = obs_cnt[pid] >= obs_cnt[jnp.clip(existing, 0, P - 1)]
        loser = jnp.where(keep_src, existing, src_pts)
        winner = jnp.where(keep_src, src_pts, existing)
        remap = remap.at[jnp.where(dup, jnp.clip(loser, 0, P - 1), P)].set(
            jnp.where(dup, winner, 0), mode="drop"
        )
        return remap, obs_flat

    T1 = m.kf_pose[kf_id]

    def per_neighbor_reverse(nb, ok_nb, carry):
        # neighbor's points -> the NEW keyframe (reference reverse Fuse,
        # src/LocalMapping.cc:496-514)
        remap, obs_flat = carry
        src_nb = m.kf_obs_point[nb]
        nb_src_ok = src_nb >= 0
        pid_nb = jnp.clip(src_nb, 0, P - 1)
        pc1 = lie.se3_apply(T1, m.pt_pos[pid_nb])
        uv_p, z = camera.project(Kc, pc1)
        gates, _ = _fuse_vis_gates(pid_nb, pc1, T1)
        vis = (
            nb_src_ok
            & ok_nb
            & gates
            & (z > 0.05)
            & (uv_p[:, 0] >= 0) & (uv_p[:, 0] < width)
            & (uv_p[:, 1] >= 0) & (uv_p[:, 1] < height)
        )
        mi, _ = matching.match_by_projection(
            proj_uv=uv_p,
            proj_valid=vis,
            pred_level=_pred_level(pid_nb, jnp.linalg.norm(pc1, axis=-1)),
            query_desc=m.pt_desc[pid_nb],
            query_angle=jnp.zeros((N,)),
            feats_uv=m.kf_uv[kf_id],
            feats_level=m.kf_level[kf_id],
            feats_desc=m.kf_desc[kf_id],
            feats_angle=m.kf_angle[kf_id],
            feats_valid=m.kf_kp_valid[kf_id],
            radius=3.0,
            scale_factors=sf,
            th=matching.TH_LOW,
            ratio=1.0,
        )
        hit = mi >= 0
        tgt_kp = jnp.clip(mi, 0, N - 1)
        existing = obs_flat[kf_id * N + tgt_kp]
        # IsInKeyFrame gate (src/ORBmatcher.cc:900-906): the new KF may
        # already observe this neighbor point at another keypoint —
        # adding a second row would double-count it
        kf_row = jax.lax.dynamic_slice_in_dim(obs_flat, kf_id * N, N)
        seen_in_kf = jnp.zeros((P + 1,), bool).at[
            jnp.where(kf_row >= 0, kf_row, P)
        ].set(True)[:P]
        add = hit & (existing < 0) & ~seen_in_kf[pid_nb]
        obs_flat = obs_flat.at[
            jnp.where(add, kf_id * N + tgt_kp, K * N)
        ].set(jnp.where(add, src_nb, -1), mode="drop")
        # merge only when one side is IMMATURE (<=2 observations): the
        # reverse sweep exists to kill the fresh depth-seeded duplicates;
        # letting it merge two mature points occasionally fuses distinct
        # landmarks under drift and collapses tracking (observed: a
        # 500-frame orbit went LOST mid-run with unrestricted merging)
        ex_cnt = obs_cnt[jnp.clip(existing, 0, P - 1)]
        immature = (ex_cnt <= 2) | (obs_cnt[pid_nb] <= 2)
        dup = hit & (existing >= 0) & (existing != src_nb) & immature
        keep_nb = obs_cnt[pid_nb] >= ex_cnt
        loser = jnp.where(keep_nb, existing, src_nb)
        winner = jnp.where(keep_nb, src_nb, existing)
        remap = remap.at[jnp.where(dup, jnp.clip(loser, 0, P - 1), P)].set(
            jnp.where(dup, winner, 0), mode="drop"
        )
        return remap, obs_flat

    remap = jnp.arange(P, dtype=jnp.int32)
    obs_flat = m.kf_obs_point.reshape(-1)
    for i in range(n_nb):
        remap, obs_flat = per_neighbor(nb_ids[i], nb_ok[i], (remap, obs_flat))
        remap, obs_flat = per_neighbor_reverse(
            nb_ids[i], nb_ok[i], (remap, obs_flat)
        )

    # resolve merge chains (a->b, b->c  =>  a->c) by pointer jumping
    # before applying, or a's observations would be remapped onto the
    # invalidated b (same fix as loop_closing.fuse_loop_points). A tied
    # 2-cycle (equal obs counts merging into each other) jumps back to
    # the identity after 8 compositions, leaving both points live.
    for _ in range(3):
        remap = remap[remap]

    # apply merges: remap the whole observation table, invalidate losers
    lost = remap != jnp.arange(P, dtype=jnp.int32)
    obs = obs_flat.reshape(K, N)
    obs = jnp.where(obs >= 0, remap[jnp.clip(obs, 0, P - 1)], obs)
    pt_valid = m.pt_valid & ~lost
    obs_ok = (obs >= 0) & pt_valid[jnp.clip(obs, 0, P - 1)]
    return m._replace(
        kf_obs_point=jnp.where(obs_ok, obs, -1), pt_valid=pt_valid
    )


@partial(jax.jit, static_argnames=("n_levels",))
def cull_keyframes(m: ms.MapState, kf_id, protect=None, W=None,
                   n_levels: int = 8):
    """KeyFrameCulling (src/LocalMapping.cc:632-696): a covisible keyframe
    is redundant if >=90% of its points are observed by >=3 other KFs
    *at the same or finer scale* (the reference's scaleLevel <=
    scaleLevel+1 condition at src/LocalMapping.cc:661-668 — without it,
    far-away coarse observations count as replacements for close
    fine-scale ones and culling runs far too hot; r03's 444-created/
    12-live churn traced to exactly this).

    ``protect`` [K] bool: keyframes that must never be culled — the
    reference pins loop-closure keyframes forever (KeyFrame::AddLoopEdge
    sets mbNotErase=true, src/KeyFrame.cc:424-435); culling one would
    drop its persistent loop edge from every later essential graph."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    if W is None:
        W = ms.covisibility(m)
    cand = (W[kf_id] > 0) & m.kf_valid
    # never cull slot 0 (gauge origin) or the newest two keyframes
    cand = cand & (jnp.arange(K) != 0) & (jnp.arange(K) < m.n_kf - 2)
    if protect is not None:
        cand = cand & ~protect

    obs = m.kf_obs_point
    # kf_valid mask: culled rows are cleared to -1 today, but the
    # histogram must not depend on that invariant holding forever: a
    # stale invalid row would inflate n_others
    has = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    # per-(point, level) observation histogram -> cumulative over level:
    # cum[p, l] = #observations of p at octave <= l (any keyframe)
    cum = ms.obs_level_cum(m, n_levels)  # [P, n_levels]
    # for this KF's observation at octave l: others at octave <= l+1
    lvl_self = jnp.clip(m.kf_level, 0, n_levels - 1)
    lvl_gate = jnp.minimum(lvl_self + 1, n_levels - 1)
    n_others = (
        jnp.take_along_axis(
            cum[jnp.clip(obs, 0, P - 1).reshape(-1)],
            lvl_gate.reshape(-1)[:, None],
            axis=1,
        )[:, 0].reshape(K, N)
        - 1.0  # exclude the candidate's own observation
    )
    redundant_obs = has & (n_others >= 3)
    n_has = jnp.sum(has, axis=1)
    n_red = jnp.sum(redundant_obs, axis=1)
    redundant = cand & (
        n_red.astype(jnp.float32) >= 0.9 * jnp.maximum(n_has, 1).astype(jnp.float32)
    )
    # cull at most one per call (like the sequential reference, keeps the
    # covisibility recomputation honest)
    first = jnp.argmax(redundant)
    do = redundant[first]
    kf_valid = m.kf_valid.at[first].set(jnp.where(do, False, m.kf_valid[first]))
    row = jnp.where(do, jnp.full((N,), -1, jnp.int32), obs[first])
    # freeze T_child_parent for trajectory re-anchoring (reference mTcp,
    # KeyFrame::SetBadFlag src/KeyFrame.cc:515-517)
    parent = m.kf_parent[first]
    pc = jnp.clip(parent, 0, K - 1)
    tcp = lie.se3_compose(m.kf_pose[first], lie.se3_inverse(m.kf_pose[pc]))
    kf_tcp = m.kf_tcp.at[first].set(jnp.where(do & (parent >= 0), tcp, m.kf_tcp[first]))
    # reparent LIVE children of the culled keyframe to its parent
    # (grandparent) — the reference picks the best covisible
    # parent-candidate (src/KeyFrame.cc:459-514); the grandparent is
    # always in that set and keeps the spanning tree connected for GBA
    # propagation and savers. Already-culled keyframes whose parent is
    # `first` must KEEP that pointer: their frozen kf_tcp is relative to
    # `first`, and the trajectory walk (System.full_trajectory) composes
    # Tcp(child->first) . Tcp(first->grandparent) along the chain —
    # reparenting them would skip first's Tcp and corrupt their poses.
    child = do & (m.kf_parent == first) & (jnp.arange(K) != first) & m.kf_valid
    kf_parent = jnp.where(child, parent, m.kf_parent)
    return m._replace(
        kf_valid=kf_valid, kf_obs_point=obs.at[first].set(row),
        kf_tcp=kf_tcp, kf_parent=kf_parent,
    )


@partial(jax.jit, static_argnames=("n_iters",))
def run_global_ba(m: ms.MapState, Kc, bf, inv_sigma2_tab, n_iters: int = 10):
    """Global bundle adjustment: EVERY valid keyframe free (keyframe 0
    fixed as gauge) and every valid point free
    (Optimizer::GlobalBundleAdjustemnt / BundleAdjustment,
    src/Optimizer.cc:41-237, KF0 fixed at :79; invoked post-loop from
    src/LoopClosing.cc:645-749 and at mono init src/Tracking.cc:686).

    Unlike :func:`run_local_ba` there is no covisibility-window gather:
    the edge table is the full [K,N] observation table, so keyframes
    sharing zero points with any particular keyframe are still
    re-optimized — the property the post-loop GBA exists for.
    """
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]

    obs = m.kf_obs_point
    okobs = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pnt = jnp.clip(obs, 0, P - 1)
    okobs = okobs & m.pt_valid[pnt.reshape(-1)].reshape(K, N)

    uvr = jnp.concatenate(
        [m.kf_uv, jnp.where(m.kf_ur > 0, m.kf_ur, 0.0)[..., None]], axis=-1
    ).reshape(-1, 3)
    is_stereo = (m.kf_ur > 0).reshape(-1).astype(jnp.float32)
    is2 = inv_sigma2_tab[
        jnp.clip(m.kf_level, 0, inv_sigma2_tab.shape[0] - 1)
    ].reshape(-1)
    cam_idx = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, N)
    ).reshape(-1)

    fixed_cam = (
        (~m.kf_valid) | (jnp.arange(K) == 0)
    ).astype(jnp.float32)
    prob = ba.BAProblem(
        poses=m.kf_pose,
        points=m.pt_pos,
        K=Kc,
        bf=bf,
        cam_idx=cam_idx,
        pnt_idx=pnt.reshape(-1),
        uvr=uvr,
        is_stereo=is_stereo,
        inv_sigma2=is2,
        valid=okobs.reshape(-1).astype(jnp.float32),
        fixed_cam=fixed_cam,
        fixed_pnt=(~m.pt_valid).astype(jnp.float32),
    )
    prob, _ = ba.ba_solve(prob, n_iters=5, cg_iters=40, use_huber=True)
    _, inl = ba.edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.astype(jnp.float32))
    prob, cost = ba.ba_solve(prob, n_iters=n_iters, cg_iters=40, use_huber=False)

    kf_pose = jnp.where(
        (m.kf_valid & (jnp.arange(K) != 0))[:, None], prob.poses, m.kf_pose
    )
    pt_pos = jnp.where(m.pt_valid[:, None], prob.points, m.pt_pos)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos), cost


@partial(jax.jit, static_argnames=("window", "n_iters", "boundary"))
def run_local_ba(m: ms.MapState, kf_id, Kc, bf, inv_sigma2_tab, window: int = 16,
                 n_iters: int = 10, boundary: int = 32, W=None):
    """Local BA over the covisibility window of ``kf_id``
    (Optimizer::LocalBundleAdjustment, src/Optimizer.cc:453-778).

    The problem is gathered to a compact camera set — the free window
    (top-``window`` covisible + self) plus up to ``boundary`` fixed
    keyframes that co-observe the window's points (the reference's fixed
    boundary, src/Optimizer.cc:490-504) — so edge count is O(C*N), not
    O(K*N), and cost is independent of total map size. Only points seen
    by the window are free.
    """
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]

    if W is None:
        W = ms.covisibility(m)
    n_w = min(window, K)
    w_w, w_ids = jax.lax.top_k(W[kf_id], n_w)
    in_window = jnp.zeros((K,), bool).at[w_ids].set(w_w > 0).at[kf_id].set(True)
    in_window = in_window & m.kf_valid

    obs = m.kf_obs_point
    okobs = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    pnt_full = jnp.clip(obs, 0, P - 1)
    okobs = okobs & m.pt_valid[pnt_full.reshape(-1)].reshape(K, N)

    # free points = observed by a window keyframe
    seen = jnp.zeros((P + 1,), bool)
    seen = seen.at[
        jnp.where(okobs & in_window[:, None], obs, P).reshape(-1)
    ].set(True)[:P]
    fixed_pnt = ~seen

    # boundary = non-window KFs observing window points, ranked by overlap
    overlap = jnp.sum(
        jnp.where(okobs, seen[pnt_full.reshape(-1)].reshape(K, N), False),
        axis=1,
    )
    overlap = jnp.where(in_window | ~m.kf_valid, -1, overlap)
    n_b = min(boundary, K)
    b_w, b_ids = jax.lax.top_k(overlap, n_b)

    # compact camera set: window slots then boundary slots (invalid ones
    # keep harmless gathered rows but are masked out of all edges)
    cams = jnp.concatenate([w_ids, jnp.asarray([kf_id]), b_ids])  # [C]
    C = cams.shape[0]
    cam_ok = jnp.concatenate(
        [(w_w > 0) & (w_ids != kf_id), jnp.asarray([True]), b_w > 0]
    ) & m.kf_valid[cams]
    # dedupe among VALID rows only (top_k pads sparse covisibility rows
    # with arbitrary slot ids — a masked filler must never shadow the
    # real entry for the same slot)
    first_hit = jnp.full((K + 1,), -1, jnp.int32)
    first_hit = first_hit.at[
        jnp.flip(jnp.where(cam_ok, cams, K))
    ].set(jnp.flip(jnp.arange(C, dtype=jnp.int32)), mode="drop")
    cam_ok = cam_ok & (first_hit[jnp.clip(cams, 0, K)] == jnp.arange(C))
    fixed_cam = jnp.concatenate(
        [jnp.zeros((n_w + 1,)), jnp.ones((n_b,))]
    ) + (cams == 0)  # global gauge: keyframe 0 fixed (src/Optimizer.cc:79)
    # masked rows (invalid slots / dedupe losers) have no edges — they must
    # be "fixed" so their Hessian block is the identity, not epsilon
    # (an epsilon block explodes the block-Jacobi CG preconditioner)
    fixed_cam = jnp.clip(fixed_cam + (~cam_ok), 0.0, 1.0)

    # gather compact edge table [C,N]
    g_obs = obs[cams]
    g_ok = okobs[cams] & cam_ok[:, None]
    g_pnt = jnp.clip(g_obs, 0, P - 1)
    g_uvr = jnp.concatenate(
        [m.kf_uv[cams], jnp.where(m.kf_ur[cams] > 0, m.kf_ur[cams], 0.0)[..., None]],
        axis=-1,
    ).reshape(-1, 3)
    g_stereo = (m.kf_ur[cams] > 0).reshape(-1).astype(jnp.float32)
    g_is2 = inv_sigma2_tab[
        jnp.clip(m.kf_level[cams], 0, inv_sigma2_tab.shape[0] - 1)
    ].reshape(-1)
    cam_idx = jnp.broadcast_to(
        jnp.arange(C, dtype=jnp.int32)[:, None], (C, N)
    ).reshape(-1)

    prob = ba.BAProblem(
        poses=m.kf_pose[cams],
        points=m.pt_pos,
        K=Kc,
        bf=bf,
        cam_idx=cam_idx,
        pnt_idx=g_pnt.reshape(-1),
        uvr=g_uvr,
        is_stereo=g_stereo,
        inv_sigma2=g_is2,
        valid=g_ok.reshape(-1).astype(jnp.float32),
        fixed_cam=fixed_cam.astype(jnp.float32),
        fixed_pnt=fixed_pnt.astype(jnp.float32),
    )
    # dense-Schur direct solve: the reduced camera system here is tiny
    # (C = window+1+boundary <= ~50 cameras), so building S densely and
    # Cholesky-solving replaces ~40 sequential CG sweeps per LM iteration
    # (ops/ba.py ba_solve_dense). Exact solves converge in far fewer LM
    # steps than g2o's damped-CG 5+10 schedule needed; the edge table is
    # cam-major [C, N], so per-camera reductions are scatter-free (cam_grid)
    n_loc = min(P, 8192)
    prob, _ = ba.ba_solve_dense(
        prob, n_iters=4, n_local_pts=n_loc, use_huber=True, cam_grid=(C, N),
    )
    _, inl = ba.edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.astype(jnp.float32))
    prob, cost = ba.ba_solve_dense(
        prob, n_iters=min(n_iters, 6), n_local_pts=n_loc, use_huber=False,
        cam_grid=(C, N),
    )

    # scatter back: window poses (free, deduped cams only — masked rows
    # are dropped so duplicate slots cannot race), all points
    upd = cam_ok & (fixed_cam < 0.5)
    kf_pose = m.kf_pose.at[jnp.where(upd, cams, K)].set(
        prob.poses, mode="drop"
    )

    # drop outlier observations among the gathered rows
    # (src/Optimizer.cc:746-777)
    _, inl2 = ba.edge_chi2(
        prob._replace(valid=g_ok.reshape(-1).astype(jnp.float32))
    )
    g_obs_new = jnp.where(g_ok & ~inl2.reshape(C, N), -1, g_obs)
    obs_new = obs.at[jnp.where(cam_ok, cams, K)].set(g_obs_new, mode="drop")
    return m._replace(
        kf_pose=kf_pose, pt_pos=prob.points, kf_obs_point=obs_new
    ), cost
