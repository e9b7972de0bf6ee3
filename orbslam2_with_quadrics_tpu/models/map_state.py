"""Struct-of-arrays SLAM map state (the array replacement for the reference's
pointer graph of Frame/KeyFrame/MapPoint/Map objects).

The reference's map is a heap of mutually-referencing objects guarded by
per-object mutexes (src/KeyFrame.h, src/MapPoint.h, src/Map.h). Here the
map is one immutable pytree of fixed-capacity padded arrays; "insert" bumps
a counter and scatters a row, "erase" clears a validity bit
(SetBadFlag -> mask, src/KeyFrame.cc:459-551, src/MapPoint.cc:151-215),
and every cross-reference is an integer index:

- keyframe k's keypoint n observes map point ``kf_obs_point[k, n]`` (-1 if
  none) — this one table IS the observation graph both directions
  (replaces MapPoint::mObservations + KeyFrame::mvpMapPoints).
- the covisibility graph is never stored: it is one matmul
  ``A @ A.T`` over the binary observation matrix, recomputed on demand
  (replaces KeyFrame::UpdateConnections, src/KeyFrame.cc:295-385).

Concurrency becomes trivial: tracking reads snapshot v while mapping
produces v+1; the version swap replaces the reference's entire
mMutexMapUpdate protocol (SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    n_features: int = 1024      # keypoint capacity per keyframe
    n_levels: int = 8
    scale_factor: float = 1.2


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: jnp.ndarray       # [K,7] T_cw
    kf_valid: jnp.ndarray      # [K] bool
    kf_frame_id: jnp.ndarray   # [K] int32 source frame index
    kf_parent: jnp.ndarray     # [K] int32 spanning-tree parent (-1 root)
    kf_tcp: jnp.ndarray        # [K,7] T_child_parent frozen when the KF is
                               # culled (reference mTcp, KeyFrame.cc:515-517)
                               # so trajectories re-anchored on a culled KF
                               # can walk the spanning tree to a live one
                               # (System::SaveTrajectoryTUM, System.cc:361-368)
    kf_uv: jnp.ndarray         # [K,N,2] undistorted keypoints
    kf_ur: jnp.ndarray         # [K,N] right-image u (<0 = mono)
    kf_level: jnp.ndarray      # [K,N] int32
    kf_angle: jnp.ndarray      # [K,N]
    kf_desc: jnp.ndarray       # [K,N,8] uint32
    kf_kp_valid: jnp.ndarray   # [K,N] bool
    kf_obs_point: jnp.ndarray  # [K,N] int32 map point id or -1
    # --- map points ---
    pt_pos: jnp.ndarray        # [P,3]
    pt_valid: jnp.ndarray      # [P] bool
    pt_desc: jnp.ndarray       # [P,8] uint32 representative descriptor
    pt_normal: jnp.ndarray     # [P,3] mean viewing direction
    pt_min_dist: jnp.ndarray   # [P] scale-invariance band
    pt_max_dist: jnp.ndarray   # [P]
    pt_found: jnp.ndarray      # [P] int32 (tracking found count)
    pt_visible: jnp.ndarray    # [P] int32 (tracking visible count)
    pt_first_kf: jnp.ndarray   # [P] int32 creating keyframe
    # --- counters ---
    n_kf: jnp.ndarray          # scalar int32 next free keyframe slot
    n_pt: jnp.ndarray          # scalar int32 next free point slot


def empty_map(cfg: MapConfig) -> MapState:
    K, P, N = cfg.max_keyframes, cfg.max_points, cfg.n_features
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_pose=jnp.tile(
            jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], f32), (K, 1)
        ),
        kf_valid=jnp.zeros((K,), bool),
        kf_frame_id=jnp.full((K,), -1, i32),
        kf_parent=jnp.full((K,), -1, i32),
        kf_tcp=jnp.tile(jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], f32), (K, 1)),
        kf_uv=jnp.zeros((K, N, 2), f32),
        kf_ur=jnp.full((K, N), -1.0, f32),
        kf_level=jnp.zeros((K, N), i32),
        kf_angle=jnp.zeros((K, N), f32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_obs_point=jnp.full((K, N), -1, i32),
        pt_pos=jnp.zeros((P, 3), f32),
        pt_valid=jnp.zeros((P,), bool),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), f32),
        pt_min_dist=jnp.zeros((P,), f32),
        pt_max_dist=jnp.full((P,), 1e9, f32),
        pt_found=jnp.zeros((P,), i32),
        pt_visible=jnp.zeros((P,), i32),
        pt_first_kf=jnp.full((P,), -1, i32),
        n_kf=jnp.asarray(0, i32),
        n_pt=jnp.asarray(0, i32),
    )


# ---------------------------------------------------------------------------
# derived structure
# ---------------------------------------------------------------------------

def observation_matrix(m: MapState, dtype=jnp.bfloat16):
    """Binary [K,P] observation matrix A: A[k,p]=1 iff keyframe k observes
    point p. Built by scatter from the obs table."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point
    mask = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    rows = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], (K, N))
    flat_idx = rows * P + jnp.where(mask, obs, 0)
    A = jnp.zeros((K * P,), dtype)
    A = A.at[flat_idx.reshape(-1)].max(mask.reshape(-1).astype(dtype))
    return A.reshape(K, P)


def covisibility(m: MapState):
    """[K,K] int32 covisibility weights (shared-point counts) as one
    matmul — replaces KeyFrame::UpdateConnections (src/KeyFrame.cc:295-385)."""
    A = observation_matrix(m)
    W = jax.lax.dot_general(
        A, A, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    ).astype(jnp.int32)
    W = W * (1 - jnp.eye(W.shape[0], dtype=jnp.int32))
    return W


def point_obs_count(m: MapState):
    """[P] number of keyframes observing each point."""
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point
    mask = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    return jax.ops.segment_sum(
        mask.reshape(-1).astype(jnp.int32),
        jnp.where(mask, obs, P).reshape(-1),
        num_segments=P + 1,
    )[:P]


def obs_level_cum(m: MapState, n_levels: int):
    """[P, n_levels] cum[p, l] = #keyframe observations of point p at
    octave <= l — the KeyFrameCulling same-or-finer-scale redundancy
    histogram (src/LocalMapping.cc:661-668) factored out so the
    frame-rate redundancy gate (System._need_kf_fast) and the cull share
    one implementation. float32 so downstream gathers feed comparisons
    without casts."""
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point
    has = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat_p = jnp.where(has, obs, P).reshape(-1)
    lvl_flat = jnp.clip(m.kf_level, 0, n_levels - 1).reshape(-1)
    hist = jax.ops.segment_sum(
        jax.nn.one_hot(lvl_flat, n_levels, dtype=jnp.float32)
        * has.reshape(-1)[:, None],
        flat_p,
        num_segments=P + 1,
    )[:P]
    return jnp.cumsum(hist, axis=1)


# ---------------------------------------------------------------------------
# insertion / mutation (all pure: return a new MapState)
# ---------------------------------------------------------------------------

@jax.jit
def insert_keyframe(
    m: MapState,
    pose,
    frame_id,
    uv,
    ur,
    level,
    angle,
    desc,
    kp_valid,
    obs_point,
    parent,
):
    """Append one keyframe at slot n_kf (no-op if the pool is full)."""
    k = m.n_kf
    K = m.kf_valid.shape[0]
    ok = k < K
    kc = jnp.clip(k, 0, K - 1)

    def put(arr, row):
        new = arr.at[kc].set(jnp.where(ok, row, arr[kc]))
        return new

    return m._replace(
        kf_pose=put(m.kf_pose, pose),
        kf_valid=m.kf_valid.at[kc].set(jnp.where(ok, True, m.kf_valid[kc])),
        kf_frame_id=put(m.kf_frame_id, frame_id),
        kf_parent=put(m.kf_parent, parent),
        kf_uv=put(m.kf_uv, uv),
        kf_ur=put(m.kf_ur, ur),
        kf_level=put(m.kf_level, level),
        kf_angle=put(m.kf_angle, angle),
        kf_desc=put(m.kf_desc, desc),
        kf_kp_valid=put(m.kf_kp_valid, kp_valid),
        kf_obs_point=put(m.kf_obs_point, obs_point),
        n_kf=k + ok.astype(jnp.int32),
    ), kc


@jax.jit
def insert_points(m: MapState, pos, desc, first_kf, want):
    """Allocate a batch of map points; returns (map, slot_ids [B] or -1).

    ``want`` [B] bool marks rows to actually allocate. Slots are assigned
    compactly from n_pt; overflow rows get -1 (dropped, like the reference
    dropping points when... it never does — capacity is the fixed-shape trade).
    """
    P = m.pt_pos.shape[0]
    B = pos.shape[0]
    offs = jnp.cumsum(want.astype(jnp.int32)) - 1
    slots = m.n_pt + offs
    ok = want & (slots < P)
    slots_c = jnp.where(ok, slots, P - 1)

    def put(arr, rows, fill_ok):
        return arr.at[slots_c].set(
            jnp.where(fill_ok[:, None] if arr.ndim > 1 else fill_ok, rows, arr[slots_c])
        )

    m = m._replace(
        pt_pos=put(m.pt_pos, pos, ok),
        pt_desc=put(m.pt_desc, desc, ok),
        pt_valid=m.pt_valid.at[slots_c].set(
            jnp.where(ok, True, m.pt_valid[slots_c])
        ),
        pt_first_kf=m.pt_first_kf.at[slots_c].set(
            jnp.where(ok, first_kf, m.pt_first_kf[slots_c])
        ),
        pt_found=m.pt_found.at[slots_c].set(jnp.where(ok, 1, m.pt_found[slots_c])),
        pt_visible=m.pt_visible.at[slots_c].set(
            jnp.where(ok, 1, m.pt_visible[slots_c])
        ),
        n_pt=jnp.minimum(m.n_pt + jnp.sum(want.astype(jnp.int32)), P),
    )
    return m, jnp.where(ok, slots_c, -1)


@jax.jit
def update_point_stats(m: MapState, scale_factors):
    """Refresh representative descriptors, normals and scale bands from the
    observation table (batched ComputeDistinctiveDescriptors +
    UpdateNormalAndDepth, src/MapPoint.cc:242-371).

    Representative descriptor: the observation minimizing the max... the
    reference takes min *median* Hamming to the others; we take the
    observation closest to the bitwise majority descriptor — same intent
    (a medoid), one pass, and exact for <=2 observations.
    """
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point
    mask = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    flat_p = jnp.where(mask, obs, P).reshape(-1)
    w = mask.reshape(-1).astype(jnp.float32)

    # --- majority descriptor per point (bitwise vote) ---
    desc = m.kf_desc.reshape(K * N, 8)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)).astype(
        jnp.float32
    )  # [KN, 8, 32]
    votes = jax.ops.segment_sum(bits * w[:, None, None], flat_p, num_segments=P + 1)[
        :P
    ]
    cnt = jax.ops.segment_sum(w, flat_p, num_segments=P + 1)[:P]
    maj = votes > 0.5 * jnp.maximum(cnt, 1.0)[:, None, None]
    maj_desc = jnp.sum(
        maj.astype(jnp.uint32) << shifts[None, None, :], axis=-1, dtype=jnp.uint32
    )  # [P,8]

    # medoid: among observations, pick min Hamming to majority
    pcl = jnp.clip(flat_p, 0, P - 1)
    d2maj = jnp.sum(
        jax.lax.population_count(jnp.bitwise_xor(desc, maj_desc[pcl])),
        axis=-1,
    ).astype(jnp.float32)
    d2maj = jnp.where(w > 0, d2maj, 1e9)
    best = jax.ops.segment_min(d2maj, flat_p, num_segments=P + 1)[:P]
    is_best = (d2maj <= best[pcl] + 0.5) & (w > 0)
    # scatter the winning descriptor (ties: last writer wins; non-winners
    # and padding are dropped via an out-of-bounds index)
    pt_desc = m.pt_desc.at[jnp.where(is_best, flat_p, P + 1)].set(
        desc, mode="drop"
    )
    pt_desc = jnp.where(cnt[:, None] > 0, pt_desc, m.pt_desc)

    # --- normals & scale band ---
    centers = jnp.repeat(camera_centers(m), N, axis=0)  # [KN,3]
    vec = m.pt_pos[pcl] - centers
    dist = jnp.linalg.norm(vec, axis=-1, keepdims=True)
    nrm = vec / jnp.maximum(dist, 1e-9)
    normal = jax.ops.segment_sum(nrm * w[:, None], flat_p, num_segments=P + 1)[:P]
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9
    )

    # reference band: from the *reference KF* observation level
    # (src/MapPoint.cc:330-371); approximate with the mean log-distance and
    # the max level among observations
    lvl = m.kf_level.reshape(K * N).astype(jnp.float32)
    mean_lvl = (
        jax.ops.segment_sum(lvl * w, flat_p, num_segments=P + 1)[:P]
        / jnp.maximum(cnt, 1.0)
    )
    mean_dist = (
        jax.ops.segment_sum(dist[:, 0] * w, flat_p, num_segments=P + 1)[:P]
        / jnp.maximum(cnt, 1.0)
    )
    sf = scale_factors[jnp.clip(mean_lvl.astype(jnp.int32), 0, scale_factors.shape[0] - 1)]
    max_dist = mean_dist * sf
    n_levels = scale_factors.shape[0]
    min_dist = max_dist / scale_factors[n_levels - 1]

    has = cnt > 0
    return m._replace(
        pt_desc=pt_desc,
        pt_normal=jnp.where(has[:, None], normal, m.pt_normal),
        pt_max_dist=jnp.where(has, 1.2 * max_dist, m.pt_max_dist),
        pt_min_dist=jnp.where(has, 0.8 * min_dist, m.pt_min_dist),
    )


@jax.jit
def compact_points(m: MapState):
    """Reclaim culled point slots: stable-compact valid points to the low
    end of the pool and remap the observation table.

    The reference has no pool at all (MapPoints are heap objects freed on
    SetBadFlag, src/Map.cc); with fixed-capacity arrays, compaction is how
    a long sequence (KITTI 00 is 4,541 frames) keeps allocating after
    point culling without growing the arrays. Returns
    ``(new_map, new_idx [P])`` where ``new_idx[old_id]`` is the point's
    new slot (only meaningful where the old slot was valid) so callers can
    remap ids they hold (frame observations, quadric landmark members)."""
    P = m.pt_pos.shape[0]
    valid = m.pt_valid
    new_idx = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # perm[r] = old index of the r-th valid point (stable)
    perm = jnp.argsort(jnp.where(valid, 0, 1), stable=True)

    def g(a):
        return a[perm]

    obs = m.kf_obs_point
    ok = (obs >= 0) & valid[jnp.clip(obs, 0, P - 1)]
    obs2 = jnp.where(ok, new_idx[jnp.clip(obs, 0, P - 1)], -1)
    m2 = m._replace(
        pt_pos=g(m.pt_pos),
        pt_valid=g(m.pt_valid),
        pt_desc=g(m.pt_desc),
        pt_normal=g(m.pt_normal),
        pt_min_dist=g(m.pt_min_dist),
        pt_max_dist=g(m.pt_max_dist),
        pt_found=g(m.pt_found),
        pt_visible=g(m.pt_visible),
        pt_first_kf=g(m.pt_first_kf),
        n_pt=n_valid,
        kf_obs_point=obs2,
    )
    return m2, new_idx


@jax.jit
def compact_keyframes(m: MapState, perm, new_idx):
    """Pack valid keyframes to the low end of the pool (the keyframe
    analogue of :func:`compact_points`; the reference frees culled
    KeyFrame objects outright, src/KeyFrame.cc:459-551, so its "pool"
    never fragments). ``perm[r]`` = old slot stored at new slot r and
    ``new_idx[old]`` = new slot of a (valid) old keyframe — both computed
    by the caller, which must FIRST re-anchor every id it holds outside
    the MapState (trajectory references, loop database rows, loop edges,
    quadric views; see System._compact_keyframes)."""
    K = m.kf_valid.shape[0]

    def g(a):
        return a[perm]

    valid_new = g(m.kf_valid)
    parent = g(m.kf_parent)
    # live keyframes' parents are live (culling reparents children), so a
    # plain id remap suffices; invalid rows clear to -1
    parent = jnp.where(
        valid_new & (parent >= 0), new_idx[jnp.clip(parent, 0, K - 1)], -1
    )
    first = m.pt_first_kf
    first_new = jnp.where(
        first >= 0, new_idx[jnp.clip(first, 0, K - 1)], -1
    )
    return m._replace(
        kf_pose=g(m.kf_pose),
        kf_valid=valid_new,
        kf_frame_id=jnp.where(valid_new, g(m.kf_frame_id), -1),
        kf_parent=parent,
        kf_tcp=g(m.kf_tcp),
        kf_uv=g(m.kf_uv),
        kf_ur=g(m.kf_ur),
        kf_level=g(m.kf_level),
        kf_angle=g(m.kf_angle),
        kf_desc=g(m.kf_desc),
        kf_kp_valid=g(m.kf_kp_valid) & valid_new[:, None],
        kf_obs_point=jnp.where(valid_new[:, None], g(m.kf_obs_point), -1),
        pt_first_kf=first_new,
        n_kf=jnp.sum(valid_new.astype(jnp.int32)),
    )


def grow_map(m: MapState, new_K: int | None = None, new_P: int | None = None):
    """Grow the keyframe and/or point pools by zero-padding at the high
    end (ids are preserved, so nothing needs remapping). Shape-specialized
    jits recompile once per growth — callers should double capacity so
    growth is O(log) over a run. Host-side (unjitted): runs at most a
    handful of times per sequence."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    new_K = new_K or K
    new_P = new_P or P
    assert new_K >= K and new_P >= P

    def pad(a, n_new, fill):
        if a.shape[0] == n_new:
            return a
        pad_shape = (n_new - a.shape[0],) + a.shape[1:]
        return jnp.concatenate([a, jnp.full(pad_shape, fill, a.dtype)], axis=0)

    ident = jnp.asarray([1.0, 0, 0, 0, 0, 0, 0], jnp.float32)
    kf_pose = m.kf_pose
    kf_tcp = m.kf_tcp
    if new_K > K:
        ext = jnp.tile(ident, (new_K - K, 1))
        kf_pose = jnp.concatenate([kf_pose, ext], axis=0)
        kf_tcp = jnp.concatenate([kf_tcp, ext], axis=0)
    return m._replace(
        kf_pose=kf_pose,
        kf_valid=pad(m.kf_valid, new_K, False),
        kf_frame_id=pad(m.kf_frame_id, new_K, -1),
        kf_parent=pad(m.kf_parent, new_K, -1),
        kf_tcp=kf_tcp,
        kf_uv=pad(m.kf_uv, new_K, 0.0),
        kf_ur=pad(m.kf_ur, new_K, -1.0),
        kf_level=pad(m.kf_level, new_K, 0),
        kf_angle=pad(m.kf_angle, new_K, 0.0),
        kf_desc=pad(m.kf_desc, new_K, 0),
        kf_kp_valid=pad(m.kf_kp_valid, new_K, False),
        kf_obs_point=pad(m.kf_obs_point, new_K, -1),
        pt_pos=pad(m.pt_pos, new_P, 0.0),
        pt_valid=pad(m.pt_valid, new_P, False),
        pt_desc=pad(m.pt_desc, new_P, 0),
        pt_normal=pad(m.pt_normal, new_P, 0.0),
        pt_min_dist=pad(m.pt_min_dist, new_P, 0.0),
        pt_max_dist=pad(m.pt_max_dist, new_P, 1e9),
        pt_found=pad(m.pt_found, new_P, 0),
        pt_visible=pad(m.pt_visible, new_P, 0),
        pt_first_kf=pad(m.pt_first_kf, new_P, -1),
    )


def camera_centers(m: MapState):
    """[K,3] camera centers C = -R^T t."""
    from ..ops import lie

    R = lie.quat_to_matrix(m.kf_pose[:, :4])
    t = m.kf_pose[:, 4:7]
    return -jnp.einsum("kij,ki->kj", R, t)
