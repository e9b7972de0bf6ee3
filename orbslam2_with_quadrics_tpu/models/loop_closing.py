"""Loop closing: BoW retrieval, Sim3 computation, graph correction.

Array-native rebuild of ``LoopClosing`` + ``KeyFrameDatabase``
(reference src/LoopClosing.cc, src/KeyFrameDatabase.cc): the inverted
file becomes a dense [K, V] BoW matrix scored in one vectorized sweep;
loop geometric verification is the vmapped Horn/Sim3 RANSAC
(ops/sim3solver.py); the essential graph solve is ops/pose_graph.py.
The 3-consecutive-keyframe consistency check
(src/LoopClosing.cc:152-211) is host-side bookkeeping over tiny sets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import camera, lie, matching, orb, pose_graph, sim3solver, vocab
from . import map_state as ms


@partial(jax.jit, static_argnames=("n_nb", "budget"))
def gather_loop_points(m: ms.MapState, cand, n_nb: int = 10, budget: int = 4096):
    """Fixed-size id list of the loop side's map points: everything
    observed by the candidate keyframe and its top covisible neighbors
    (the reference's mvpLoopMapPoints, src/LoopClosing.cc:340-352).
    Returns [budget] int32 point ids, P = padding."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    W = ms.covisibility(m)
    nb_w, nb_ids = jax.lax.top_k(W[cand], min(n_nb, K))
    kf_mask = (
        jnp.zeros((K,), bool).at[nb_ids].set(nb_w > 0).at[cand].set(True)
        & m.kf_valid
    )
    obs_ok = (m.kf_obs_point >= 0) & m.kf_kp_valid & kf_mask[:, None]
    pmask = jnp.zeros((P + 1,), bool).at[
        jnp.where(obs_ok, m.kf_obs_point, P).reshape(-1)
    ].set(True)[:P] & m.pt_valid
    key = jnp.where(
        pmask,
        jnp.float32(2 * P) - jnp.arange(P, dtype=jnp.float32),
        -jnp.arange(P, dtype=jnp.float32),
    )
    topv, topi = jax.lax.top_k(key, min(budget, P))
    return jnp.where(topv > 0, topi, P).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_levels", "scale", "height", "width"))
def project_loop_points(
    m: ms.MapState,
    slot,
    S_cur_w_corr,
    loop_ids,
    Kc,
    n_levels: int = 8,
    scale: float = 1.2,
    height: int = 480,
    width: int = 640,
    radius: float = 10.0,
):
    """SearchByProjection of the loop side's points into the current
    keyframe through the CORRECTED Sim3 pose (reference
    src/LoopClosing.cc:355-385 -> ORBmatcher::SearchByProjection overload
    at src/ORBmatcher.cc:290). Scale in Scw cancels in the perspective
    divide, exactly as the reference projects with Scw directly.

    Returns (match_kp [L] int32 keypoint idx in the current KF or -1)."""
    P = m.pt_pos.shape[0]
    L = loop_ids.shape[0]
    sf, _, _ = orb.scale_factors(n_levels, scale)
    pid = jnp.clip(loop_ids, 0, P - 1)
    ok = (loop_ids < P) & m.pt_valid[pid]
    pw = m.pt_pos[pid]
    pc = lie.sim3_apply(S_cur_w_corr, pw)
    uv, z = camera.project(Kc, pc)
    dist = jnp.linalg.norm(pc, axis=-1)
    vis = (
        ok
        & (z > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    )
    # scale prediction from (unscaled) distance band
    s = lie.sim3_scale(S_cur_w_corr)
    ratio = jnp.maximum(
        m.pt_max_dist[pid] / jnp.maximum(dist / jnp.maximum(s, 1e-9), 1e-6),
        1e-6,
    )
    lvl = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32),
        0, n_levels - 1,
    )
    mi, _ = matching.match_by_projection(
        proj_uv=uv,
        proj_valid=vis,
        pred_level=lvl,
        query_desc=m.pt_desc[pid],
        query_angle=jnp.zeros((L,)),
        feats_uv=m.kf_uv[slot],
        feats_level=m.kf_level[slot],
        feats_desc=m.kf_desc[slot],
        feats_angle=m.kf_angle[slot],
        feats_valid=m.kf_kp_valid[slot],
        radius=radius,
        scale_factors=sf,
        th=matching.TH_LOW,
        ratio=1.0,
    )
    return mi


@partial(jax.jit, static_argnames=("n_group", "n_levels", "scale", "height", "width"))
def fuse_loop_points(
    m: ms.MapState,
    slot,
    loop_ids,
    Kc,
    n_group: int = 12,
    n_levels: int = 8,
    scale: float = 1.2,
    height: int = 480,
    width: int = 640,
):
    """SearchAndFuse (reference src/LoopClosing.cc:518-542, 587-613 ->
    ORBmatcher::Fuse with 'replace' semantics, src/ORBmatcher.cc:977):
    project the loop side's map points into the corrected covisible group
    of the current keyframe; where the projection lands on a keypoint
    already holding a different point, the LOOP point always wins (the
    duplicate triangulated on the way back is merged away); free keypoints
    gain an observation.

    Call AFTER the essential-graph correction so group poses/points are in
    the corrected frame (the reference equivalently uses CorrectedSim3)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    sf, _, _ = orb.scale_factors(n_levels, scale)

    W = ms.covisibility(m)
    n_nb = min(n_group, K)
    nb_w, nb_ids = jax.lax.top_k(W[slot], n_nb)
    group = jnp.concatenate([jnp.asarray([slot], jnp.int32), nb_ids.astype(jnp.int32)])
    group_ok = jnp.concatenate([jnp.asarray([True]), nb_w > 0]) & m.kf_valid[group]

    pid = jnp.clip(loop_ids, 0, P - 1)
    src_ok = (loop_ids < P) & m.pt_valid[pid]
    pw = m.pt_pos[pid]
    desc = m.pt_desc[pid]
    L = loop_ids.shape[0]

    def per_kf(g, ok_g, carry):
        remap, obs_flat = carry
        T = m.kf_pose[g]
        pc = lie.se3_apply(T, pw)
        uv, z = camera.project(Kc, pc)
        dist = jnp.linalg.norm(pc, axis=-1)
        vis = (
            src_ok
            & ok_g
            & (z > 0.05)
            & (uv[:, 0] >= 0) & (uv[:, 0] < width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        )
        ratio = jnp.maximum(
            m.pt_max_dist[pid] / jnp.maximum(dist, 1e-6), 1e-6
        )
        lvl = jnp.clip(
            jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32),
            0, n_levels - 1,
        )
        mi, _ = matching.match_by_projection(
            proj_uv=uv,
            proj_valid=vis,
            pred_level=lvl,
            query_desc=desc,
            query_angle=jnp.zeros((L,)),
            feats_uv=m.kf_uv[g],
            feats_level=m.kf_level[g],
            feats_desc=m.kf_desc[g],
            feats_angle=m.kf_angle[g],
            feats_valid=m.kf_kp_valid[g],
            radius=4.0,
            scale_factors=sf,
            th=matching.TH_LOW,
            ratio=1.0,
        )
        hit = mi >= 0
        tgt_kp = jnp.clip(mi, 0, N - 1)
        src_pt = pid  # the loop point each query row represents
        existing = obs_flat[g * N + tgt_kp]
        # free keypoint -> add observation of the loop point
        add = hit & (existing < 0)
        obs_flat = obs_flat.at[
            jnp.where(add, g * N + tgt_kp, K * N)
        ].set(jnp.where(add, src_pt, -1), mode="drop")
        # occupied by a different point -> the loop point replaces it
        dup = hit & (existing >= 0) & (existing != src_pt)
        remap = remap.at[jnp.where(dup, jnp.clip(existing, 0, P - 1), P)].set(
            jnp.where(dup, src_pt, 0), mode="drop"
        )
        return remap, obs_flat

    remap = jnp.arange(P, dtype=jnp.int32)
    obs_flat = m.kf_obs_point.reshape(-1)
    for i in range(group.shape[0]):
        remap, obs_flat = per_kf(group[i], group_ok[i], (remap, obs_flat))

    # resolve merge chains (a->b, b->c  =>  a->c) by pointer jumping
    for _ in range(3):
        remap = remap[remap]

    lost = remap != jnp.arange(P, dtype=jnp.int32)
    obs = obs_flat.reshape(K, N)
    obs = jnp.where(obs >= 0, remap[jnp.clip(obs, 0, P - 1)], obs)
    pt_valid = m.pt_valid & ~lost
    obs_ok2 = (obs >= 0) & pt_valid[jnp.clip(obs, 0, P - 1)]
    n_merged = jnp.sum(lost.astype(jnp.int32))
    return m._replace(
        kf_obs_point=jnp.where(obs_ok2, obs, -1), pt_valid=pt_valid
    ), n_merged


@partial(jax.jit, static_argnames=())
def score_database(bow_mat, query_bow, kf_valid):
    """L1 similarity of the query against every keyframe's BoW vector +
    common-word counts (KeyFrameDatabase::DetectLoopCandidates word pass,
    src/KeyFrameDatabase.cc:83-144)."""
    scores = 1.0 - 0.5 * jnp.sum(jnp.abs(bow_mat - query_bow[None, :]), axis=-1)
    common = jnp.sum(
        ((bow_mat > 0) & (query_bow > 0)[None, :]).astype(jnp.int32), axis=-1
    )
    scores = jnp.where(kf_valid, scores, -1.0)
    common = jnp.where(kf_valid, common, 0)
    return scores, common


def _accumulate_covis_groups(scores, cand, W, retain: float = 0.75):
    """Covisibility-group score accumulation shared by loop detection
    (KeyFrameDatabase::DetectLoopCandidates, src/KeyFrameDatabase.cc:142-197)
    and relocalization (DetectRelocalizationCandidates, :199-309): each
    candidate's similarity score is summed over the candidates inside its
    top-10 covisible group; groups within ``retain`` of the best
    accumulated score contribute their best-scoring member."""
    is_cand = np.zeros(len(scores), bool)
    is_cand[cand] = True
    groups = []
    for c in cand:
        nb = np.argsort(-W[c])[:10]
        members = np.concatenate([[c], nb[W[c][nb] > 0]])
        memb = members[is_cand[members]]
        acc = float(scores[memb].sum())
        best = int(memb[np.argmax(scores[memb])])
        groups.append((acc, best))
    best_acc = max(a for a, _ in groups)
    return {b for a, b in groups if a >= retain * best_acc}


# above this vocabulary size, per-KF sparse BoW lists replace the dense
# [K, V] matrix (the standard ORBvoc has 1M words)
SPARSE_WORDS_THRESHOLD = 65536


# keyframe-rate database updates as single jitted programs: each eager
# .at[] set / gather would be a separate dispatch
@jax.jit
def _gather_kf_rows(kf_desc, kf_kp_valid, slot):
    return kf_desc[slot], kf_kp_valid[slot]


@jax.jit
def _db_update_sparse(kf_wid, kf_wval, words, wid, wval, word, slot):
    return (
        kf_wid.at[slot].set(wid),
        kf_wval.at[slot].set(wval),
        words.at[slot].set(word),
    )


@jax.jit
def _db_update_dense(bow, words, bv, word, slot):
    return bow.at[slot].set(bv), words.at[slot].set(word)


@jax.jit
def _detect_prep_sparse(m, kf_wid, kf_wval, words, idf, slot):
    W = ms.covisibility(m)
    q_wid, q_wval = vocab.sparse_bow(words[slot], idf)
    scores, common = vocab.sparse_l1_scores(
        kf_wid, kf_wval, q_wid, q_wval, m.kf_valid
    )
    return W, scores, common


@partial(jax.jit, static_argnames=("n_words",))
def _detect_prep_dense(m, bow, words, idf, slot, n_words: int):
    W = ms.covisibility(m)
    qbow = vocab.bow_vector(words[slot], n_words, idf)
    scores, common = score_database(bow, qbow, m.kf_valid)
    return W, scores, common


@partial(
    jax.jit,
    static_argnames=("n_levels", "scale", "height", "width", "fix_scale"),
)
def _sim3_geometry(
    m: ms.MapState, words, slot, cand, Kc,
    n_levels: int = 8, scale: float = 1.2,
    height: int = 480, width: int = 640, fix_scale: bool = False,
):
    """ComputeSim3's geometric chain as one device program
    (src/LoopClosing.cc:231-399): BoW pairing, Horn RANSAC, Sim3 LM,
    and the corrected-projection expansion gate. Returns
    (gates[4] = [n_pairs, n_ransac, n_lm, n_total], S_cur_w_corr,
    loop_ids) — the host reads the 4 gate counts in one fetch."""
    N = m.kf_obs_point.shape[1]
    P = m.pt_pos.shape[0]
    _, sigma2_tab, _ = orb.scale_factors(n_levels, scale)

    # 1. descriptor pairing between the two keyframes (>=20,
    # LoopClosing.cc:262-270). The reference's SearchByBoW buckets
    # candidate pairs by FeatureVector nodes FOUR LEVELS ABOVE the
    # leaves (levelsup=4, src/Frame.cc:400 -> ~10^2 coarse buckets over
    # ~10^3 features) — a CPU pruning heuristic that barely constrains
    # the match. Exact leaf-word equality (the earlier implementation)
    # is ~10^3x stricter and starved the >=20 gate on true loops
    # (measured: 2-10 pairs where the corrected-projection expansion
    # found 260 matches). On the device the dense mutual-best Hamming matrix
    # is the same cost as any bucketing, so pair densely.
    mi, _ = matching.mutual_match(
        m.kf_desc[slot], m.kf_kp_valid[slot],
        m.kf_desc[cand], m.kf_kp_valid[cand],
        th=matching.TH_LOW, ratio=0.75,
    )
    p_cur = m.kf_obs_point[slot]
    p_cnd = m.kf_obs_point[cand, jnp.clip(mi, 0, N - 1)]
    pair_ok = (mi >= 0) & (p_cur >= 0) & (p_cnd >= 0)
    n_pairs = jnp.sum(pair_ok)

    pts_cur_w = m.pt_pos[jnp.clip(p_cur, 0, P - 1)]
    pts_cnd_w = m.pt_pos[jnp.clip(p_cnd, 0, P - 1)]
    T_cur = m.kf_pose[slot]
    T_cnd = m.kf_pose[cand]
    p2 = lie.se3_apply(T_cur, pts_cur_w)   # current-camera coords
    p1 = lie.se3_apply(T_cnd, pts_cnd_w)   # candidate-camera coords
    uv2 = m.kf_uv[slot]
    uv1 = m.kf_uv[cand, jnp.clip(mi, 0, N - 1)]
    s2_2 = sigma2_tab[jnp.clip(m.kf_level[slot], 0, n_levels - 1)]
    s2_1 = sigma2_tab[
        jnp.clip(m.kf_level[cand, jnp.clip(mi, 0, N - 1)], 0, n_levels - 1)
    ]

    # 2. Horn RANSAC: S maps candidate-camera -> current-camera
    #    (stereo/RGB-D fix the scale, reference mbFixScale,
    #    src/LoopClosing.cc:56,267)
    S, inl, n_ransac = sim3solver.ransac_sim3(
        p1, p2, pair_ok, Kc, Kc, uv1, uv2, s2_1, s2_2, fix_scale=fix_scale,
    )
    # 3. LM polish (>=20 inliers, LoopClosing.cc:326-336)
    S, inl, n_lm = sim3solver.optimize_sim3(
        S, p1, p2, pair_ok & inl, Kc, Kc, uv1, uv2,
        1.0 / jnp.maximum(s2_1, 1e-9), 1.0 / jnp.maximum(s2_2, 1e-9),
        fix_scale=fix_scale,
    )

    # 4. corrected current pose: S_cur_w = S_cur_cand * S_cand_w
    S_cur_w_corr = lie.sim3_compose(S, lie.sim3_from_se3(T_cnd))

    # 5. loop-point expansion gate (src/LoopClosing.cc:355-385)
    loop_ids = gather_loop_points(m, cand)
    proj_kp = project_loop_points(
        m, slot, S_cur_w_corr, loop_ids, Kc,
        n_levels=n_levels, scale=scale, height=height, width=width,
    )
    matched_kp = jnp.zeros((N,), bool).at[
        jnp.where(proj_kp >= 0, proj_kp, N)
    ].set(True, mode="drop")
    matched_kp = matched_kp | (pair_ok & inl)
    n_total = jnp.sum(matched_kp)

    gates = jnp.stack([n_pairs, n_ransac, n_lm, n_total]).astype(jnp.int32)
    return gates, S_cur_w_corr, loop_ids


@jax.jit
def _graph_arrays(m, slot, cand, S_cur_w_corr, group_mask, ei, ej, is_loop):
    """Sim3 lift + covisible-group propagation + edge measurements as ONE
    device program (the Sim3 propagation of CorrectLoop,
    src/LoopClosing.cc:443-486, and the edge measurements of
    OptimizeEssentialGraph, src/Optimizer.cc:860-905)."""
    T_cur = m.kf_pose[slot]
    S_old = jax.vmap(lie.sim3_from_se3)(m.kf_pose)  # [K,8]

    def corr(pose, g):
        T_g_cur = lie.se3_compose(pose, lie.se3_inverse(T_cur))
        S_g = lie.sim3_compose(lie.sim3_from_se3(T_g_cur), S_cur_w_corr)
        return jnp.where(g, S_g, lie.sim3_from_se3(pose))

    S_new_init = jax.vmap(corr)(m.kf_pose, group_mask)
    # measurements from pre-correction poses, except the loop edge which
    # uses the Sim3-corrected relative (Optimizer.cc:860-905)
    meas = jax.vmap(
        lambda i, j: lie.sim3_compose(S_old[j], lie.sim3_inverse(S_old[i]))
    )(ei, ej)
    loop_meas = lie.sim3_compose(
        lie.sim3_from_se3(m.kf_pose[cand]), lie.sim3_inverse(S_cur_w_corr)
    )
    meas = jnp.where(is_loop[:, None], loop_meas[None, :], meas)
    return S_old, S_new_init, meas


@jax.jit
def _apply_graph(m, S_old, S_opt):
    """Post-solve writeback: remap points through their first-observing
    keyframe's correction (Optimizer.cc:1010-1032): p' = S_new^-1(S_old(p)),
    and store the optimized keyframe poses."""
    K = m.kf_valid.shape[0]
    ref = jnp.clip(m.pt_first_kf, 0, K - 1)
    S_o = S_old[ref]
    S_n = S_opt[ref]
    p_corr = jax.vmap(
        lambda so, sn, p: lie.sim3_apply(
            lie.sim3_inverse(sn), lie.sim3_apply(so, p)
        )
    )(S_o, S_n, m.pt_pos)
    pt_pos = jnp.where(m.pt_valid[:, None], p_corr, m.pt_pos)
    kf_pose = jax.vmap(lie.sim3_to_se3)(S_opt)
    kf_pose = jnp.where(m.kf_valid[:, None], kf_pose, m.kf_pose)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos)


class LoopCloser:
    """Host orchestrator for detection + correction."""

    def __init__(self, voc, map_cfg: ms.MapConfig):
        """voc: trained :class:`vocab.Vocabulary` or a
        :class:`vocab.TreeVocabulary` loaded from the DBoW2 text format.
        Large vocabularies (> 2^16 words, e.g. the standard 1M-word
        ORBvoc) use sparse per-keyframe BoW lists instead of a dense
        [K, V] matrix."""
        self.voc = voc
        K, N = map_cfg.max_keyframes, map_cfg.n_features
        self.sparse = voc.n_words > SPARSE_WORDS_THRESHOLD
        if self.sparse:
            self.bow = None
            self.kf_wid = jnp.full((K, N), -1, jnp.int32)
            self.kf_wval = jnp.zeros((K, N), jnp.float32)
        else:
            self.bow = jnp.zeros((K, voc.n_words), jnp.float32)
        self.words = jnp.full((K, N), -1, jnp.int32)
        self.consistency: list[tuple[set, int]] = []  # (group KFs, count)
        self.covis_th = 3  # mnCovisibilityConsistencyTh (LoopClosing.cc:43)
        self.last_loop_kf = -999
        # persistent loop edges (reference KeyFrame::AddLoopEdge,
        # src/KeyFrame.cc:424-435, re-used by every later essential-graph
        # solve at src/Optimizer.cc:828-858) — a second closure must not
        # undo the first
        self.loop_edges: list[tuple[int, int]] = []

    def grow(self, new_K: int):
        """Extend the per-keyframe database rows after the map's keyframe
        pool grows (map_state.grow_map preserves slot ids)."""
        K_old = self.words.shape[0]
        if new_K <= K_old:
            return

        def pad(a, fill):
            ext = jnp.full((new_K - K_old,) + a.shape[1:], fill, a.dtype)
            return jnp.concatenate([a, ext], axis=0)

        if self.sparse:
            self.kf_wid = pad(self.kf_wid, -1)
            self.kf_wval = pad(self.kf_wval, 0.0)
        else:
            self.bow = pad(self.bow, 0.0)
        self.words = pad(self.words, -1)

    def add_keyframe_from_map(self, m: ms.MapState, slot: int):
        """Index a keyframe straight from the map (one jitted gather +
        the jitted transform/update path — no eager device ops)."""
        desc, valid = _gather_kf_rows(
            m.kf_desc, m.kf_kp_valid, np.int32(slot)
        )
        self.add_keyframe(slot, desc, valid)

    def add_keyframe(self, slot: int, desc, valid):
        slot = np.int32(slot)
        word, _ = vocab.transform_any(self.voc, desc, valid)
        if self.sparse:
            wid, wval = vocab.sparse_bow(word, self.voc.idf)
            self.kf_wid, self.kf_wval, self.words = _db_update_sparse(
                self.kf_wid, self.kf_wval, self.words, wid, wval, word, slot
            )
        else:
            bv = vocab.bow_vector(word, self.voc.n_words, self.voc.idf)
            self.bow, self.words = _db_update_dense(
                self.bow, self.words, bv, word, slot
            )

    def score_query(self, word, kf_valid):
        """Database similarity of one frame's word ids against every
        keyframe (KeyFrameDatabase::Detect* word pass)."""
        if self.sparse:
            qw, qv = vocab.sparse_bow(word, self.voc.idf)
            return vocab.sparse_l1_scores(
                self.kf_wid, self.kf_wval, qw, qv, kf_valid
            )
        qbow = vocab.bow_vector(word, self.voc.n_words, self.voc.idf)
        return score_database(self.bow, qbow, kf_valid)

    def detect_reloc_candidates(
        self, m: ms.MapState, word, max_groups: int = 5
    ) -> list[int]:
        """DetectRelocalizationCandidates (reference
        src/KeyFrameDatabase.cc:199-309): keyframes sharing words with the
        lost frame, gated at 0.8x the max common-word count, then each
        candidate's similarity score is ACCUMULATED over its top-10
        covisible group; groups within 0.75 of the best accumulated score
        return their best-scoring member. Unlike loop detection there is
        no minimum-score floor (the lost frame has no covisible
        neighborhood to derive one from)."""
        scores, common = self.score_query(word, m.kf_valid)
        scores = np.asarray(scores)
        common = np.asarray(common)
        if common.max(initial=0) <= 0:
            return []
        min_common = 0.8 * float(common.max())
        cand = np.where((common > min_common) & (scores > 0))[0]
        if len(cand) == 0:
            return []
        W = np.asarray(ms.covisibility(m))
        keep = _accumulate_covis_groups(scores, cand, W)
        return sorted(keep, key=lambda k: -scores[k])[:max_groups]

    def prepare_detect(self, m: ms.MapState, slot: int, n_live: int):
        """Dispatch the device work DetectLoop needs (database scores +
        covisibility) and prefetch it, without blocking. The caller holds
        the returned handle and passes it to :meth:`finish_detect` later
        (System consumes it at the NEXT keyframe — the reference's loop
        thread likewise lags its queue, src/LoopClosing.cc:57-95).
        Returns None when detection is structurally skipped."""
        if n_live < 8 or slot - self.last_loop_kf < 10:
            return None
        if self.sparse:
            W, scores, common = _detect_prep_sparse(
                m, self.kf_wid, self.kf_wval, self.words, self.voc.idf,
                np.int32(slot),
            )
        else:
            W, scores, common = _detect_prep_dense(
                m, self.bow, self.words, self.voc.idf, np.int32(slot),
                self.voc.n_words,
            )
        for a in (W, scores, common):
            try:
                a.copy_to_host_async()
            except Exception:
                pass
        return (slot, W, scores, common)

    def finish_detect(self, prep) -> list[int]:
        """Host half of DetectLoop: score gates + covisibility-group
        accumulation + the 3-consecutive-keyframe consistency check, on
        the prefetched arrays."""
        if prep is None:
            return []
        slot, W_dev, scores_dev, common_dev = prep
        return self._detect_host(
            slot, np.asarray(W_dev), np.asarray(scores_dev),
            np.asarray(common_dev),
        )

    def detect(self, m: ms.MapState, slot: int) -> list[int]:
        """DetectLoop (src/LoopClosing.cc:103-229): query the database,
        gate by min covisible score, 0.8*max common words, and temporal
        consistency over 3 consecutive keyframes. Synchronous wrapper
        over prepare_detect/finish_detect."""
        # live keyframes, not the insertion high-water mark: the reference
        # gates on Map::KeyFramesInMap() (LoopClosing.cc:110-115) and
        # culling keeps the live count far below the counter
        n_live = int(np.asarray(m.kf_valid).sum())
        return self.finish_detect(self.prepare_detect(m, slot, n_live))

    def _detect_host(self, slot: int, W, scores, common) -> list[int]:
        import os as _os

        dbg = _os.environ.get("ORB_DEBUG_LOOPS")
        if dbg:
            import sys as _sys

            def _log(msg):
                print(f"[detect] slot={slot} {msg}", file=_sys.stderr,
                      flush=True)
        else:
            _log = lambda msg: None
        return self._detect_host_inner(slot, W, scores, common, _log)

    def _detect_host_inner(self, slot, W, scores, common, _log):
        # the reference's covisible set is the *connected graph* (weight
        # >= 15, KeyFrame::UpdateConnections src/KeyFrame.cc:295-385) —
        # weakly re-observed places must stay eligible as loop candidates
        covis = W[slot] >= 15
        # min score among covisible neighbors (LoopClosing.cc:121-138)
        nb = np.where(covis & (np.arange(len(covis)) != slot))[0]
        # no >=15-weight neighbor: the reference's minScore stays at its
        # initial 1.0 (LoopClosing.cc:121 `float minScore = 1;`), making
        # candidates require a perfect score — match that, don't invent
        # a softer floor
        min_score = float(scores[nb].min()) if len(nb) else 1.0
        # candidates: not covisible, above the covisible-score floor
        # (the reference's only structural exclusions: connected KFs and
        # the post-closure cooldown handled above)
        cand_mask = (
            (~covis)
            & (np.arange(len(scores)) != slot)
            & (scores >= max(min_score, 0.0))
        )
        if not cand_mask.any():
            _log(f"no candidates above min_score={min_score:.3f} "
                 f"(covis={int(covis.sum())})")
            self.consistency = []
            return []
        max_common = common[cand_mask].max()
        cand_mask &= common > 0.8 * max_common
        cands = np.where(cand_mask)[0]
        if len(cands) == 0:
            _log("all candidates below 0.8*max_common")
            self.consistency = []
            return []

        # covisibility-group score accumulation with 0.75-of-best
        # retention (DetectLoopCandidates, src/KeyFrameDatabase.cc:142-197
        # — the same shape the reloc path uses): a lone weak candidate is
        # rejected unless its covisible group collectively scores within
        # 0.75x of the best group; each kept group contributes its
        # best-scoring member
        cands = np.asarray(
            sorted(_accumulate_covis_groups(scores, cands, W)), dtype=np.int64
        )
        if len(cands) == 0:
            _log("group accumulation emptied the candidate set")
            self.consistency = []
            return []

        # consistency groups (LoopClosing.cc:152-211)
        consistent_enough = []
        new_groups = []
        for c in cands:
            group = set(np.where(W[c] >= 15)[0].tolist()) | {int(c)}
            best = 0
            for prev_group, cnt in self.consistency:
                if group & prev_group:
                    best = max(best, cnt + 1)
            new_groups.append((group, best))
            if best >= self.covis_th:
                consistent_enough.append(int(c))
        _log(f"cands={[int(c) for c in cands]} consistency="
             f"{[b for _, b in new_groups]} -> {consistent_enough}")
        self.consistency = new_groups
        return consistent_enough

    def attempt_close(
        self, m: ms.MapState, slot: int, cand: int, Kc, n_levels=8, scale=1.2,
        height=480, width=640, fix_scale: bool = False,
    ):
        """ComputeSim3 + CorrectLoop (src/LoopClosing.cc:231-585).

        Returns (new_map, ok). On success keyframe poses are pose-graph
        corrected, points remapped, and duplicated landmarks from the
        revisited place fused into the loop side's originals.

        The whole geometric verification chain (BoW match -> Sim3 RANSAC
        -> LM polish -> corrected-projection gate) runs as ONE jitted
        program with a single packed-scalar fetch instead of a blocking
        fetch per stage plus eager sim3 ops per candidate."""
        gates, S_cur_w_corr, loop_ids = _sim3_geometry(
            m, self.words, np.int32(slot), np.int32(cand), Kc,
            n_levels=n_levels, scale=scale, height=height, width=width,
            fix_scale=fix_scale,
        )
        g = np.asarray(gates)
        import os as _os
        # [n_pairs, n_ransac_inl, n_lm_inl, n_total] — the reference's
        # staged >=20 / >=20 / >=20 / >=40 gates (LoopClosing.cc:262-385)
        if g[0] < 20 or g[1] < 20 or g[2] < 20 or g[3] < 40:
            if _os.environ.get("ORB_DEBUG_LOOPS"):
                import sys as _sys
                print(
                    f"[loop-rej] slot={slot} cand={cand} gates={g.tolist()}",
                    file=_sys.stderr, flush=True,
                )
            return m, False
        if _os.environ.get("ORB_DEBUG_LOOPS"):
            import sys as _sys
            s_scale = float(np.asarray(S_cur_w_corr)[7]) if np.asarray(
                S_cur_w_corr).shape[0] > 7 else 1.0
            print(
                f"[loop] slot={slot} cand={cand} gates={g.tolist()} "
                f"sim3_scale={s_scale:.4f}",
                file=_sys.stderr, flush=True,
            )

        m = self._correct_graph(m, slot, cand, S_cur_w_corr)
        # 6. SearchAndFuse: merge the duplicated landmarks of the revisited
        #    place into the loop side's originals (src/LoopClosing.cc:518-542)
        m, _ = fuse_loop_points(
            m, jnp.asarray(slot, jnp.int32), loop_ids, Kc,
            n_levels=n_levels, scale=scale, height=height, width=width,
        )
        self.loop_edges.append((int(slot), int(cand)))
        self.last_loop_kf = slot
        return m, True

    def _correct_graph(self, m: ms.MapState, slot, cand, S_cur_w_corr):
        """Sim3 propagation + essential-graph optimization + point remap
        (CorrectLoop src/LoopClosing.cc:402-585 +
        OptimizeEssentialGraph src/Optimizer.cc:781-1044).

        Host work is ONE covisibility fetch + vectorized numpy edge
        assembly; the rest is 3 jitted dispatches (Sim3 lift/propagation +
        measurements, pose-graph LM, writeback) instead of one eager
        .at[].set per covisible-group member plus eager Sim3 ops per edge.
        Edge arrays are padded to power-of-two buckets so the pose-graph
        jit compiles O(log E) times per run."""
        K = m.kf_valid.shape[0]
        W = np.asarray(ms.covisibility(m))
        kf_valid = np.asarray(m.kf_valid)
        parents = np.asarray(m.kf_parent)

        group_mask = np.zeros((K,), bool)
        group_mask |= (W[slot] > 0) & kf_valid
        group_mask[slot] = True

        # --- edges: spanning tree + strong covisibility + loop edges ---
        ks = np.where(kf_valid)[0]
        pk = parents[ks]
        tree_ok = (pk >= 0) & kf_valid[np.clip(pk, 0, K - 1)]
        ei = [ks[tree_ok]]
        ej = [pk[tree_ok]]
        w = [np.ones(int(tree_ok.sum()), np.float32)]
        cov_i, cov_j = np.where(
            np.triu(W >= 100, 1) & kf_valid[:, None] & kf_valid[None, :]
        )
        ei.append(cov_i)
        ej.append(cov_j)
        w.append(np.ones(len(cov_i), np.float32))
        # previously-closed loops stay as constraints so a later closure
        # cannot re-open them (reference pKF->GetLoopEdges() at
        # src/Optimizer.cc:828-858); their measurements come from the
        # CURRENT (already-corrected) poses, which satisfy those loops
        prev = [
            (pi, pj) for pi, pj in self.loop_edges
            if kf_valid[pi] and kf_valid[pj]
        ]
        if prev:
            pi, pj = np.asarray(prev, np.int64).T
            ei.append(pi)
            ej.append(pj)
            w.append(np.full(len(prev), 5.0, np.float32))
        ei.append(np.asarray([slot]))
        ej.append(np.asarray([cand]))
        w.append(np.asarray([5.0], np.float32))  # the new loop edge
        ei = np.concatenate(ei).astype(np.int32)
        ej = np.concatenate(ej).astype(np.int32)
        w = np.concatenate(w)
        is_loop = np.zeros(len(ei), bool)
        is_loop[-1] = True
        # pad to a power-of-two bucket (weight-0 self edges are inert)
        E = max(64, 1 << int(np.ceil(np.log2(len(ei)))))
        pad = E - len(ei)
        ei = np.concatenate([ei, np.zeros(pad, np.int32)])
        ej = np.concatenate([ej, np.zeros(pad, np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
        is_loop = np.concatenate([is_loop, np.zeros(pad, bool)])

        S_old, S_new_init, meas = _graph_arrays(
            m, np.int32(slot), np.int32(cand), S_cur_w_corr,
            jnp.asarray(group_mask), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(is_loop),
        )
        fixed = jnp.zeros((K,), jnp.float32).at[cand].set(1.0)
        S_opt = pose_graph.optimize_pose_graph(
            S_new_init, jnp.asarray(ei), jnp.asarray(ej), meas,
            jnp.asarray(w), fixed,
        )
        return _apply_graph(m, S_old, S_opt)
