"""Per-frame tracking: motion-model match -> pose opt -> local-map track.

Array-native rebuild of the reference Tracking thread's per-frame work
(src/Tracking.cc:267-506): the whole frame update — two guided matching
passes and two pose optimizations — is a single jitted call on fixed-shape
arrays. The reference's UpdateLocalKeyFrames/UpdateLocalPoints pointer
walk (src/Tracking.cc:1195-1339) becomes a covisibility vote (one gather +
segment-sum) and a fixed-size local point window.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera, lie, matching, orb, pose_opt
from . import map_state as ms


class TrackResult(NamedTuple):
    T_cw: jnp.ndarray        # [7] optimized pose
    obs_point: jnp.ndarray   # [N] kp -> map point id (-1)
    n_inliers: jnp.ndarray   # scalar int32
    n_matches: jnp.ndarray   # scalar int32 (pre-opt matches)
    visible_pt: jnp.ndarray  # [P] bool — in-frustum local points (for stats)
    found_pt: jnp.ndarray    # [P] bool — inlier-tracked points


def _predict_scale(dist, max_dist, scale: float, n_levels: int):
    """Scale prediction from distance (reference MapPoint::PredictScale,
    src/MapPoint.cc:385-417)."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1e-6)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def select_local_points(
    m: ms.MapState, obs_point, n_local_kf: int, n_local_pt: int, obs_A=None
):
    """Covisibility vote -> top-K keyframes -> their points, fixed size.

    Replaces UpdateLocalKeyFrames/UpdateLocalPoints
    (src/Tracking.cc:1195-1339; cap of 80 KFs at :1285).
    Returns (pt_ids [n_local_pt] int32 with P=pad, kf_mask [K] bool).

    ``obs_A``: optional precomputed [K,P] binary observation matrix
    (``map_state.observation_matrix``). With it, both the keyframe vote and
    the point union are single matvecs; without it they fall back to a
    gather-sum + a K*N-element scatter — the matrix only changes at
    keyframe rate, so the caller should maintain it across frames.
    """
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    matched = jnp.zeros((P + 1,), bool).at[jnp.where(obs_point >= 0, obs_point, P)].set(
        True
    )[:P]
    k_eff = min(n_local_kf, K)
    if obs_A is not None:
        # vote: one [K,P] @ [P] matvec (0/1 values in bf16 accumulate
        # exactly into f32)
        votes = jax.lax.dot_general(
            obs_A, matched.astype(obs_A.dtype),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
        )
        top_v, top_i = jax.lax.top_k(votes, k_eff)
        kf_mask = jnp.zeros((K,), bool).at[top_i].set(top_v > 0)
        pmask = (
            jax.lax.dot_general(
                kf_mask.astype(obs_A.dtype), obs_A,
                (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32,
            )
            > 0
        ) & m.pt_valid
    else:
        obs_ok = (m.kf_obs_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
        votes = jnp.sum(
            jnp.where(obs_ok, matched[jnp.clip(m.kf_obs_point, 0, P - 1)], False),
            axis=1,
        )  # [K]
        top_v, top_i = jax.lax.top_k(votes, k_eff)
        kf_mask = jnp.zeros((K,), bool).at[top_i].set(top_v > 0)

        # union of their observed points
        pmask = jnp.zeros((P + 1,), bool)
        sel_obs = jnp.where(
            obs_ok & kf_mask[:, None], m.kf_obs_point, P
        ).reshape(-1)
        pmask = pmask.at[sel_obs].set(True)[:P] & m.pt_valid
    # indices of the selected points as a fixed-size list: top_k over a
    # key that ranks selected points by ascending index (jnp.nonzero with
    # a size= pad lowers to a scatter chain; top_k over [P] is a single
    # kernel and yields the same ascending order)
    key = jnp.where(pmask, jnp.float32(2 * P) - jnp.arange(P, dtype=jnp.float32),
                    -jnp.arange(P, dtype=jnp.float32))
    topv, topi = jax.lax.top_k(key, min(n_local_pt, P))
    pt_ids = jnp.where(topv > 0, topi, P).astype(jnp.int32)
    return pt_ids, kf_mask


def _project_points(T_cw, Kc, pts, pt_valid):
    pc = lie.se3_apply(T_cw, pts)
    uv, z = camera.project(Kc, pc)
    return uv, z, pc


@partial(
    jax.jit,
    static_argnames=("n_levels", "scale", "n_local_kf", "n_local_pt", "height", "width"),
)
def track_frame(
    m: ms.MapState,
    feats,
    T_pred,
    prev_obs_point,
    Kc,
    bf,
    height: int,
    width: int,
    n_levels: int = 8,
    scale: float = 1.2,
    n_local_kf: int = 64,
    n_local_pt: int = 4096,
    motion_radius: float = 15.0,
    local_radius: float = 4.0,
    obs_A=None,
) -> TrackResult:
    """One full tracking update (TrackWithMotionModel + TrackLocalMap,
    src/Tracking.cc:867-974)."""
    P = m.pt_pos.shape[0]
    N = feats.uv.shape[0]
    sf, sigma2, inv_sigma2_tab = orb.scale_factors(n_levels, scale)

    # ---------------- stage A: motion-model matching --------------------
    # queries = previous frame's tracked points
    qa_ids = jnp.where(prev_obs_point >= 0, prev_obs_point, P - 1)
    qa_ok = (prev_obs_point >= 0) & m.pt_valid[qa_ids]
    pa = m.pt_pos[qa_ids]
    uv_a, z_a, _ = _project_points(T_pred, Kc, pa, qa_ok)
    in_img_a = (
        (uv_a[:, 0] >= 0) & (uv_a[:, 0] < width)
        & (uv_a[:, 1] >= 0) & (uv_a[:, 1] < height) & (z_a > 0.1)
    )
    dist_a = jnp.linalg.norm(
        pa - (-lie.quat_rotate(lie.quat_conj(T_pred[:4]), T_pred[4:7]))[None, :],
        axis=-1,
    )
    lvl_a = _predict_scale(dist_a, m.pt_max_dist[qa_ids], scale, n_levels)

    def match_a(radius):
        return matching.match_by_projection(
            proj_uv=uv_a,
            proj_valid=qa_ok & in_img_a,
            pred_level=lvl_a,
            query_desc=m.pt_desc[qa_ids],
            query_angle=jnp.zeros((N,)),
            feats_uv=feats.uv_und,
            feats_level=feats.level,
            feats_desc=feats.desc,
            feats_angle=feats.angle,
            feats_valid=feats.valid,
            radius=radius,
            scale_factors=sf,
            th=matching.TH_HIGH,
        )

    mi, md = match_a(motion_radius)
    # widened retry only when matches are scarce (reference doubles th
    # and retries, src/Tracking.cc:888-896); lax.cond skips the second
    # matching sweep on the common path
    scarce = jnp.sum((mi >= 0).astype(jnp.int32)) < 20
    mi = jax.lax.cond(
        scarce,
        lambda: match_a(2.0 * motion_radius)[0],
        lambda: mi,
    )
    # kp -> point map from stage A
    obs_a = jnp.full((N,), -1, jnp.int32)
    obs_a = obs_a.at[jnp.where(mi >= 0, mi, N)].set(
        jnp.where(mi >= 0, qa_ids, -1), mode="drop"
    )

    # stage A's pose only seeds the local-map projection window; the final
    # pose accuracy comes from the stage-B optimization below, so a short
    # schedule suffices here (the reference runs the full 4-round
    # PoseOptimization twice; 2x3 measured: same inliers, half the
    # sequential LM latency)
    T_a, _, n_a = _pose_opt_from_obs(
        m, feats, T_pred, obs_a, Kc, bf, inv_sigma2_tab, rounds=2, iters=3
    )

    # ---------------- stage B: local-map tracking -----------------------
    pt_ids, kf_mask = select_local_points(m, obs_a, n_local_kf, n_local_pt, obs_A)
    pt_ok = pt_ids < P
    pid = jnp.clip(pt_ids, 0, P - 1)
    pb = m.pt_pos[pid]
    uv_b, z_b, _ = _project_points(T_a, Kc, pb, pt_ok)
    cam_c = -lie.quat_rotate(lie.quat_conj(T_a[:4]), T_a[4:7])
    vec = pb - cam_c[None, :]
    dist_b = jnp.linalg.norm(vec, axis=-1)
    # frustum test (reference Frame::isInFrustum, src/Frame.cc:269-325):
    # in-image, depth>0, distance within scale band, viewing angle < 60 deg
    view_cos = jnp.sum(vec * m.pt_normal[pid], axis=-1) / jnp.maximum(dist_b, 1e-6)
    in_frustum = (
        pt_ok
        & m.pt_valid[pid]
        & (z_b > 0.1)
        & (uv_b[:, 0] >= 0) & (uv_b[:, 0] < width)
        & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < height)
        & (dist_b >= m.pt_min_dist[pid]) & (dist_b <= m.pt_max_dist[pid])
        & (view_cos > 0.5)
    )
    lvl_b = _predict_scale(dist_b, m.pt_max_dist[pid], scale, n_levels)
    mib, mdb = matching.match_by_projection(
        proj_uv=uv_b,
        proj_valid=in_frustum,
        pred_level=lvl_b,
        query_desc=m.pt_desc[pid],
        query_angle=jnp.zeros_like(dist_b),
        feats_uv=feats.uv_und,
        feats_level=feats.level,
        feats_desc=feats.desc,
        feats_angle=feats.angle,
        feats_valid=feats.valid,
        radius=local_radius,
        scale_factors=sf,
        th=matching.TH_HIGH,
        ratio=0.8,
    )
    obs_b = jnp.full((N,), -1, jnp.int32)
    obs_b = obs_b.at[jnp.where(mib >= 0, mib, N)].set(
        jnp.where(mib >= 0, pid, -1), mode="drop"
    )
    # merge: stage-A assignment wins (it came from a tighter prior)
    obs = jnp.where(obs_a >= 0, obs_a, obs_b)
    n_matches = jnp.sum((obs >= 0).astype(jnp.int32))

    T_f, inlier, n_inl = _pose_opt_from_obs(
        m, feats, T_a, obs, Kc, bf, inv_sigma2_tab
    )
    obs = jnp.where(inlier, obs, -1)

    # tracking statistics (reference mnVisible/mnFound,
    # src/MapPoint.cc:224-240, updated in SearchLocalPoints/TrackLocalMap)
    visible = jnp.zeros((P + 1,), bool).at[
        jnp.where(in_frustum, pt_ids, P)
    ].set(True)[:P]
    found = jnp.zeros((P + 1,), bool).at[
        jnp.where(obs >= 0, obs, P)
    ].set(True)[:P]

    return TrackResult(
        T_cw=T_f,
        obs_point=obs,
        n_inliers=n_inl,
        n_matches=n_matches,
        visible_pt=visible,
        found_pt=found,
    )


def _pose_opt_from_obs(
    m, feats, T_init, obs_point, Kc, bf, inv_sigma2_tab, rounds=4, iters=5
):
    """Motion-only LM on the kp->point assignment."""
    P = m.pt_pos.shape[0]
    pid = jnp.where(obs_point >= 0, obs_point, 0)
    valid = (obs_point >= 0) & m.pt_valid[jnp.clip(pid, 0, P - 1)] & feats.valid
    pts = m.pt_pos[jnp.clip(pid, 0, P - 1)]
    has_stereo = feats.ur > 0
    obs_uvr = jnp.concatenate(
        [feats.uv_und, jnp.where(has_stereo, feats.ur, 0.0)[:, None]], axis=-1
    )
    inv_s2 = inv_sigma2_tab[jnp.clip(feats.level, 0, inv_sigma2_tab.shape[0] - 1)]
    return pose_opt.pose_optimization(
        T_init,
        Kc,
        bf,
        pts,
        obs_uvr,
        has_stereo.astype(jnp.float32),
        inv_s2,
        valid.astype(jnp.float32),
        rounds=rounds,
        iters=iters,
    )
