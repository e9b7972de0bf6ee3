"""Descriptor matching kernels (Hamming popcount + masked dense search).

Array-native rebuild of ``ORBmatcher`` (reference src/ORBmatcher.cc). The
reference accelerates candidate lookup with a 64x48 feature grid
(src/Frame.cc:230-245) and BoW feature-vector buckets because scalar CPUs
must avoid O(N*M) work; on an accelerator the dense masked distance matrix
is the fast path (a few million popcounts per frame), so every search
variant is one masked argmin over a [queries x keypoints] matrix:

- DescriptorDistance -> ``hamming_matrix`` via lax.population_count
  (reference's SSE popcount bithack, src/ORBmatcher.cc:1647-1663), and
  the same distances as a bit matmul (``hamming_matrix_matmul``) for the
  guided search
- SearchByProjection (all 4 overloads) -> ``match_by_projection``
  (src/ORBmatcher.cc:45-129, 1328-1470)
- SearchForInitialization -> ``match_windowed`` (src/ORBmatcher.cc:405-520)
- rotation-consistency histogram -> ``rotation_consistency``
  (ComputeThreeMaxima, src/ORBmatcher.cc:1601-1643)
- best/second-best ratio test (src/ORBmatcher.cc:117-125)

Thresholds TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 match the reference
(src/ORBmatcher.cc:37-41).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

# plain int, NOT jnp.int32(...): a module-level device array would
# initialize the XLA backend at import time, breaking
# jax.distributed.initialize() in multi-host entry points
_BIG = 1 << 20


def hamming_matrix(desc_a, desc_b):
    """[Na,8]x[Nb,8] uint32 -> [Na,Nb] int32 Hamming distances."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def hamming_matrix_matmul(desc_a, desc_b):
    """:func:`hamming_matrix` as a matrix product: unpack to 0/1 bits, then
    dist = |a| + |b| - 2 a.b as one [Na,256]x[256,Nb] bf16 matmul with f32
    accumulation plus rank-1 corrections (exact: 0/1 operands, sums <= 256).
    """
    def unpack(d):
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bits = (d[..., None] >> shifts) & jnp.uint32(1)
        return bits.reshape(d.shape[0], 256).astype(jnp.bfloat16)

    a = unpack(desc_a)
    b = unpack(desc_b)
    ab = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    na = jnp.sum(a.astype(jnp.float32), axis=1, keepdims=True)
    nb = jnp.sum(b.astype(jnp.float32), axis=1, keepdims=True)
    dist = na + nb.T - 2.0 * ab
    return dist.astype(jnp.int32)


def best_two(dist, valid_mask):
    """Masked row-wise best + second-best.

    Args:
      dist: [Q, N] distances.
      valid_mask: [Q, N] bool — candidate admissibility.
    Returns: (best_idx [Q], best [Q], second [Q]) with invalid rows = _BIG.
    """
    d = jnp.where(valid_mask, dist, _BIG)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(_BIG)
    second = jnp.min(d2, axis=1)
    return best_idx, best, second


def masked_hamming_best2(
    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid, level_tol: int = 1
):
    """Best and second-best Hamming distance of each query over the
    targets inside its projection window: |du|,|dv| <= qrad and
    |level difference| <= level_tol. Same contract as ``best_two``.
    Returns (best_idx [Q], best [Q], second [Q]).

    The distances come from the bit matmul, which ran faster than the
    popcount form inside the tracking program on the H100."""
    du = jnp.abs(quv[:, 0:1] - tuv[None, :, 0])
    dv = jnp.abs(quv[:, 1:2] - tuv[None, :, 1])
    mask = (
        (du <= qrad[:, None])
        & (dv <= qrad[:, None])
        & (jnp.abs(tlvl[None, :] - qlvl[:, None]) <= level_tol)
        & qvalid[:, None].astype(bool)
        & tvalid[None, :].astype(bool)
    )
    return best_two(hamming_matrix_matmul(qdesc, tdesc), mask)


def _resolve_one_to_one(ok, best_idx, best, n_targets):
    """Each target keypoint keeps exactly one winning query: min over
    (distance, query-index) keys — strict tie-break, unlike the
    reference's last-writer-wins overwrite."""
    q = jnp.arange(best_idx.shape[0], dtype=jnp.int32)
    key = (jnp.clip(best, 0, (1 << 18) - 1) << 12) | (q & 0xFFF)
    kp_best = jnp.full((n_targets,), jnp.int32(2147483647))
    kp_best = kp_best.at[jnp.where(ok, best_idx, n_targets)].min(
        jnp.where(ok, key, jnp.int32(2147483647)), mode="drop"
    )
    return ok & (key == kp_best[best_idx])


def rotation_consistency(angle_q, angle_t, valid):
    """Keep only matches whose q-t angle difference falls in the 3 dominant
    30-bin histogram bins (reference src/ORBmatcher.cc:1601-1643 + callers).

    Args: angle_q/angle_t [Q] radians; valid [Q] bool. Returns [Q] bool.
    """
    two_pi = 2.0 * jnp.pi
    rot = jnp.mod(angle_q - angle_t, two_pi)
    binf = rot * (HISTO_LENGTH / two_pi)
    b = jnp.clip(jnp.round(binf).astype(jnp.int32), 0, HISTO_LENGTH) % HISTO_LENGTH
    hist = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[b].add(valid.astype(jnp.int32))
    top_v, top_i = jax.lax.top_k(hist, 3)
    # reference drops bins 2/3 when below 0.1x max (src/ORBmatcher.cc:1630-1640)
    keep = top_v.astype(jnp.float32) >= 0.1 * top_v[0].astype(jnp.float32)
    keep = keep.at[0].set(True)
    keep_bin = jnp.zeros((HISTO_LENGTH,), bool).at[top_i].max(keep)
    return valid & keep_bin[b]


def match_by_projection(
    proj_uv,
    proj_valid,
    pred_level,
    query_desc,
    query_angle,
    feats_uv,
    feats_level,
    feats_desc,
    feats_angle,
    feats_valid,
    radius,
    scale_factors,
    th=TH_HIGH,
    ratio=0.9,
    level_tol=1,
    check_rotation=False,
):
    """Guided matching: project map points, search nearby keypoints.

    Args:
      proj_uv: [Q,2] projected pixel of each query map point.
      proj_valid: [Q] bool (in frustum, positive depth ...).
      pred_level: [Q] int32 predicted octave (scale prediction,
        reference src/MapPoint.cc:385-417).
      query_desc: [Q,8] uint32 representative descriptors.
      query_angle: [Q] viewing angle proxy for rotation check (pass zeros +
        check_rotation=False to disable, as SearchByProjection(local map)).
      feats_*: frame keypoints (padded+masked).
      radius: scalar or [Q] search window in level-0 pixels; multiplied by
        the scale factor of the predicted level (src/ORBmatcher.cc:86-94).
      scale_factors: [L] per-level scale table.
      th: Hamming acceptance gate.
      ratio: best/second ratio test.
      level_tol: accepted |kp.octave - pred_level|.

    Returns:
      (match_idx [Q] int32 keypoint index or -1,
       match_dist [Q] int32)
    One-to-one resolution: each keypoint keeps only its best query.
    """
    Q = proj_uv.shape[0]
    r = radius * scale_factors[jnp.clip(pred_level, 0, scale_factors.shape[0] - 1)]
    if r.ndim == 0:
        r = jnp.full((Q,), r)

    best_idx, best, second = masked_hamming_best2(
        query_desc, proj_uv, r, pred_level, proj_valid,
        feats_desc, feats_uv, feats_level, feats_valid,
        level_tol=level_tol,
    )

    ok = (best <= th) & (
        best.astype(jnp.float32) <= ratio * second.astype(jnp.float32)
    )
    if check_rotation:
        ok = rotation_consistency(query_angle, feats_angle[best_idx], ok)

    ok = _resolve_one_to_one(ok, best_idx, best, feats_uv.shape[0])
    return jnp.where(ok, best_idx, -1), jnp.where(ok, best, _BIG)


def match_windowed(
    uv_a,
    desc_a,
    angle_a,
    valid_a,
    uv_b,
    desc_b,
    angle_b,
    valid_b,
    window: float,
    th=TH_LOW,
    ratio=0.9,
    check_rotation=True,
    level_a=None,
    level_b=None,
    level0_only=True,
):
    """SearchForInitialization-style windowed matching between two frames
    (reference src/ORBmatcher.cc:405-520; level-0 keypoints only there).

    Returns (match_idx [Na] into B or -1, match_dist [Na]).
    """
    mask = valid_a[:, None] & valid_b[None, :]
    if level0_only and level_a is not None:
        mask = mask & (level_a[:, None] == 0) & (level_b[None, :] == 0)
    du = jnp.abs(uv_a[:, 0:1] - uv_b[None, :, 0])
    dv = jnp.abs(uv_a[:, 1:2] - uv_b[None, :, 1])
    mask = mask & (du <= window) & (dv <= window)

    dist = hamming_matrix(desc_a, desc_b)
    best_idx, best, second = best_two(dist, mask)
    ok = (best <= th) & (
        best.astype(jnp.float32) <= ratio * second.astype(jnp.float32)
    )
    if check_rotation:
        ok = rotation_consistency(angle_a, angle_b[best_idx], ok)

    ok = _resolve_one_to_one(ok, best_idx, best, uv_b.shape[0])
    return jnp.where(ok, best_idx, -1), jnp.where(ok, best, _BIG)


def mutual_match(desc_a, valid_a, desc_b, valid_b, th=TH_LOW, ratio=0.9):
    """Unconstrained mutual best match (stand-in for SearchByBoW when both
    sets are full frames; BoW-bucketed variant lives in ops/vocab.py)."""
    mask = valid_a[:, None] & valid_b[None, :]
    dist = hamming_matrix(desc_a, desc_b)
    best_idx, best, second = best_two(dist, mask)
    back_idx, _, _ = best_two(dist.T, mask.T)
    ok = (
        (best <= th)
        & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))
        & (back_idx[best_idx] == jnp.arange(desc_a.shape[0]))
    )
    return jnp.where(ok, best_idx, -1), jnp.where(ok, best, _BIG)
