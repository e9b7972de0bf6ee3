"""Binary bag-of-words vocabulary: hierarchical k-medians, transform, score.

Array-native replacement for DBoW2's ``TemplatedVocabulary`` + ``FORB``
(reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:135-241,
FORB.h:38-47): the vocabulary is a per-level array of binary centers; the
image->BoW transform is a batched tree descent where each level is one
masked Hamming argmin over gathered child centers (vectorized popcount,
not pointer chasing); BoW vectors are **dense** tf-idf arrays so database
scoring is one vectorized L1 sweep (see models/keyframe_db.py) instead of
an inverted file.

The reference expects a pretrained 1M-leaf ORBvoc.txt which is absent from
the repo (SURVEY.md §5-checkpoint); vocabularies here are trained on the
fly from descriptors (k-medians with bitwise-majority centroids), which is
what DBoW2's ``create`` does (TemplatedVocabulary.h HKmeansStep).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    centers: Sequence[jnp.ndarray]  # per level l: [k^(l+1), 8] uint32
    idf: jnp.ndarray                # [V] inverse document frequency
    k: int
    levels: int

    @property
    def n_words(self) -> int:
        return self.k ** self.levels


def _unpack_bits(desc):
    """[D,8] uint32 -> [D,256] float32 bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], 256).astype(jnp.float32)


def _pack_bits(bits):
    """[D,256] bool -> [D,8] uint32."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = bits.reshape(bits.shape[0], 8, 32).astype(jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _hamming(a, b):
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_nodes", "k", "iters"))
def _kmedians_level(desc, assign, n_nodes: int, k: int, key, iters: int = 8):
    """Split each node's descriptors into k children by Hamming k-medians.

    assign: [D] current node id in [0, n_nodes). Returns
    (child_centers [n_nodes*k, 8], new_assign [D] in [0, n_nodes*k)).
    """
    D = desc.shape[0]
    bits = _unpack_bits(desc)  # [D,256]

    # init: per node pick k random member descriptors as seeds
    noise = jax.random.uniform(key, (D,))
    order = jnp.argsort(assign.astype(jnp.float32) * 10.0 + noise)
    # first k of each node along the sorted order
    sorted_assign = assign[order]
    rank = jnp.arange(D) - jnp.searchsorted(sorted_assign, sorted_assign, side="left")
    seed_slot = sorted_assign * k + jnp.minimum(rank, k - 1)
    centers = jnp.zeros((n_nodes * k, 8), jnp.uint32).at[seed_slot].set(desc[order])

    def step(_, centers):
        # distances to own node's k children
        child_ids = assign[:, None] * k + jnp.arange(k)[None, :]  # [D,k]
        cc = centers[child_ids]  # [D,k,8]
        dist = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(desc[:, None, :], cc)),
            axis=-1,
        )
        sub = jnp.argmin(dist, axis=-1)  # [D]
        newa = assign * k + sub
        # bitwise majority per child
        votes = jax.ops.segment_sum(bits, newa, num_segments=n_nodes * k)
        cnt = jax.ops.segment_sum(jnp.ones((D,)), newa, num_segments=n_nodes * k)
        maj = votes > 0.5 * jnp.maximum(cnt, 1.0)[:, None]
        new_centers = _pack_bits(maj)
        # keep seed for empty clusters
        return jnp.where((cnt > 0)[:, None], new_centers, centers)

    centers = jax.lax.fori_loop(0, iters, step, centers)
    child_ids = assign[:, None] * k + jnp.arange(k)[None, :]
    dist = jnp.sum(
        jax.lax.population_count(
            jnp.bitwise_xor(desc[:, None, :], centers[child_ids])
        ),
        axis=-1,
    )
    newa = assign * k + jnp.argmin(dist, axis=-1)
    return centers, newa


def train(desc, k: int = 10, levels: int = 4, seed: int = 0) -> Vocabulary:
    """Train a k^levels-word vocabulary from [D,8] uint32 descriptors."""
    desc = jnp.asarray(desc)
    D = desc.shape[0]
    assign = jnp.zeros((D,), jnp.int32)
    key = jax.random.PRNGKey(seed)
    centers_all = []
    n_nodes = 1
    for l in range(levels):
        key, sub = jax.random.split(key)
        centers, assign = _kmedians_level(desc, assign, n_nodes, k, sub)
        centers_all.append(centers)
        n_nodes *= k
    # idf from training corpus: log(D / (1 + df))
    V = n_nodes
    df = jax.ops.segment_sum(jnp.ones((D,)), assign, num_segments=V)
    idf = jnp.log(jnp.maximum(D, 1.0) / (1.0 + df))
    return Vocabulary(centers=tuple(centers_all), idf=idf, k=k, levels=levels)


@partial(jax.jit, static_argnames=("k", "levels"))
def _transform_impl(centers, desc, valid, k: int, levels: int):
    N = desc.shape[0]
    node = jnp.zeros((N,), jnp.int32)
    mid = jnp.zeros((N,), jnp.int32)
    for l in range(levels):
        child_ids = node[:, None] * k + jnp.arange(k)[None, :]
        cc = centers[l][child_ids]
        dist = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(desc[:, None, :], cc)),
            axis=-1,
        )
        node = node * k + jnp.argmin(dist, axis=-1).astype(jnp.int32)
        if l == max(levels - 3, 0):
            mid = node  # feature-grouping node (DBoW2 levelsup semantics,
            # reference src/Frame.cc:400 uses leaves-4; scaled to our depth)
    word = jnp.where(valid, node, -1)
    return word, jnp.where(valid, mid, -1)


class TreeVocabulary(NamedTuple):
    """Explicit-tree vocabulary loaded from the DBoW2 text format
    (reference TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338-1422).

    Unlike the implicit complete k-ary tree of :class:`Vocabulary`,
    DBoW2-trained trees can be ragged (nodes with < k children, leaves
    above the bottom level). Early leaves are extended to the bottom with
    single-child virtual chains so the descent stays a fixed ``levels``-step
    loop; missing children are masked out of the argmin.
    """

    centers: Sequence[jnp.ndarray]   # level l: [n_l, 8] uint32
    children: Sequence[jnp.ndarray]  # level l: [n_{l-1}, k] int32 into level l (-1 pad); n_{-1}=1 (root)
    word_id: jnp.ndarray             # [n_last] int32 word id of bottom-level nodes
    idf: jnp.ndarray                 # [V] word weights (idf component under TF_IDF)
    k: int
    levels: int
    n_words: int


@partial(jax.jit, static_argnames=("k", "levels"))
def _transform_tree_impl(centers, children, word_id, desc, valid, k, levels):
    N = desc.shape[0]
    node = jnp.zeros((N,), jnp.int32)  # index into the previous level (root)
    mid = jnp.zeros((N,), jnp.int32)
    mid_level = max(levels - 4, 0)  # DBoW2 levelsup=4 (src/Frame.cc:400)
    for l in range(levels):
        ch = children[l][node]                       # [N,k]
        cc = centers[l][jnp.clip(ch, 0, centers[l].shape[0] - 1)]
        dist = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(desc[:, None, :], cc)),
            axis=-1,
        ).astype(jnp.int32)
        dist = jnp.where(ch >= 0, dist, 1 << 30)
        node = jnp.take_along_axis(
            ch, jnp.argmin(dist, axis=-1)[:, None], axis=-1
        )[:, 0]
        if l == mid_level:
            mid = node
    word = word_id[jnp.clip(node, 0, word_id.shape[0] - 1)]
    return jnp.where(valid, word, -1), jnp.where(valid, mid, -1)


def transform_tree(voc: TreeVocabulary, desc, valid):
    return _transform_tree_impl(
        tuple(voc.centers), tuple(voc.children), voc.word_id,
        desc, valid, voc.k, voc.levels,
    )


def transform_any(voc, desc, valid):
    """Dispatch over the two vocabulary representations."""
    if isinstance(voc, TreeVocabulary):
        return transform_tree(voc, desc, valid)
    return transform(voc, desc, valid)


def _parse_dbow2_text(path: str):
    """Parse the DBoW2 text format into flat arrays.

    Uses the native C++ parser when available (the reference's
    loadFromTextFile is its slowest init step, System.cc:64-71; the
    standard ORBvoc.txt is ~140 MB / 1M lines), falling back to numpy.
    Returns (k, L, scoring, weighting, parent [M], is_leaf [M],
    desc [M,32] uint8, weight [M] f64); node ids are 1..M in file order,
    root = 0.
    """
    try:
        from ..native import parse_vocab_text

        return parse_vocab_text(path)
    except Exception:
        pass
    with open(path, "r") as f:
        header = f.readline().split()
        k, L, scoring, weighting = (int(x) for x in header[:4])
        body = np.fromfile(f, sep=" ")
    assert body.size % 35 == 0, "malformed DBoW2 text vocabulary"
    rows = body.reshape(-1, 35)
    parent = rows[:, 0].astype(np.int64)
    is_leaf = rows[:, 1] > 0
    desc = rows[:, 2:34].astype(np.uint8)
    weight = rows[:, 34].astype(np.float64)
    return k, L, scoring, weighting, parent, is_leaf, desc, weight


def pack_descriptor_bytes(desc_bytes):
    """[M,32] uint8 -> [M,8] uint32, little-endian within each word —
    bit b of byte i lands at bit position (i%4)*8+b of word i//4, matching
    this repo's BRIEF packing (FORB stores raw cv::Mat bytes; any fixed
    bijection preserves Hamming distances)."""
    b = desc_bytes.reshape(-1, 8, 4).astype(np.uint32)
    return (
        b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    )


def unpack_descriptor_bytes(desc_words):
    """[M,8] uint32 -> [M,32] uint8 (inverse of pack_descriptor_bytes)."""
    w = np.asarray(desc_words, np.uint32)
    out = np.zeros((w.shape[0], 32), np.uint8)
    for j in range(4):
        out[:, j::4] = (w >> (8 * j)).astype(np.uint32) & 0xFF
    return out


def load_dbow2_text(path: str) -> TreeVocabulary:
    """Load a DBoW2 text vocabulary (the reference's ORBvoc.txt format,
    TemplatedVocabulary.h:1338-1422) into a level-batched tree.

    Word ids match DBoW2's (leaf order of appearance in the file), so BoW
    vectors are comparable with the reference's.
    """
    k, L, _scoring, _weighting, parent, is_leaf, desc_b, weight = (
        _parse_dbow2_text(path)
    )
    M = len(parent)
    desc = pack_descriptor_bytes(desc_b)
    # depth of each node (root=0 has depth 0; parents precede children)
    depth = np.zeros(M + 1, np.int32)
    nid = np.arange(1, M + 1)
    for _ in range(L):  # propagate one level per pass (depth <= L)
        depth[nid] = depth[parent] + 1
    # word ids in file order of leaves (loadFromTextFile wid assignment)
    word_of = np.full(M + 1, -1, np.int64)
    leaf_nids = nid[is_leaf]
    word_of[leaf_nids] = np.arange(len(leaf_nids))
    n_words = len(leaf_nids)
    idf = np.zeros(n_words, np.float64)
    idf[word_of[leaf_nids]] = weight[is_leaf]

    # per-level node tables; early leaves get virtual single-child chains
    level_nodes = [nid[depth[nid] == l + 1] for l in range(L)]
    local = np.full(M + 1, -1, np.int64)  # node id -> level-local index
    centers, children, chain = [], [], {}  # chain: nid -> local idx at cur level
    prev_count = 1
    prev_local = {0: 0}
    for l in range(L):
        nodes_l = level_nodes[l]
        n_real = len(nodes_l)
        # virtual continuations of leaves that ended above this level
        virt = sorted(chain.keys())
        n_l = n_real + len(virt)
        cen = np.zeros((n_l, 8), np.uint32)
        local_l = {}
        for i, nd in enumerate(nodes_l):
            cen[i] = desc[nd - 1]
            local_l[int(nd)] = i
        for j, nd in enumerate(virt):
            cen[n_real + j] = desc[nd - 1]
            local_l[int(nd)] = n_real + j  # same node id, deeper copy
        # children table of the previous level
        ch = np.full((prev_count, k), -1, np.int32)
        fill = np.zeros(prev_count, np.int32)
        for nd in nodes_l:
            p = int(parent[nd - 1])
            pl = prev_local[p] if p in prev_local else chain[p]
            ch[pl, fill[pl]] = local_l[int(nd)]
            fill[pl] += 1
        for nd in virt:
            pl = chain[nd]
            ch[pl, 0] = local_l[int(nd)]
        centers.append(jnp.asarray(cen))
        children.append(jnp.asarray(ch))
        # set up next level: leaves at this level start/continue chains
        new_chain = {}
        if l < L - 1:
            for nd in nodes_l:
                if is_leaf[nd - 1]:
                    new_chain[int(nd)] = local_l[int(nd)]
            for nd in virt:
                new_chain[int(nd)] = local_l[int(nd)]
        chain = new_chain
        prev_local = {int(nd): local_l[int(nd)] for nd in nodes_l}
        prev_count = n_l
    # bottom-level word ids (real bottom leaves + virtual chain carriers)
    bottom = np.full(prev_count, -1, np.int64)
    for nd, i in local_l.items():
        bottom[i] = word_of[nd]
    return TreeVocabulary(
        centers=tuple(centers), children=tuple(children),
        word_id=jnp.asarray(bottom, jnp.int32),
        idf=jnp.asarray(idf, jnp.float32),
        k=k, levels=L, n_words=n_words,
    )


def save_dbow2_text(path: str, voc: Vocabulary) -> None:
    """Write a trained (complete-tree) vocabulary in the DBoW2 text format
    (TemplatedVocabulary::saveToTextFile), loadable by the reference."""
    k, L = voc.k, voc.levels
    lines = [f"{k} {L} 0 0"]  # L1_NORM, TF_IDF (reference ORBvoc defaults)
    idf = np.asarray(voc.idf)
    # file node ids: root=0 implicit; levels written in order so parents
    # precede children. Level l node n has parent node n//k of level l-1.
    offset = [1]  # file id of the first node of each level
    for l in range(L):
        offset.append(offset[-1] + voc.centers[l].shape[0])
    for l in range(L):
        cen = unpack_descriptor_bytes(np.asarray(voc.centers[l]))
        n_l = cen.shape[0]
        is_leaf = 1 if l == L - 1 else 0
        for n in range(n_l):
            pid = 0 if l == 0 else offset[l - 1] + n // k
            w = float(idf[n]) if is_leaf else 0.0
            dtxt = " ".join(str(int(x)) for x in cen[n])
            lines.append(f"{pid} {is_leaf} {dtxt} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def save(path: str, voc: Vocabulary) -> None:
    """Persist a trained vocabulary (replaces the reference's ORBvoc.txt
    text format, TemplatedVocabulary::loadFromTextFile)."""
    import numpy as np

    np.savez_compressed(
        path,
        k=voc.k,
        levels=voc.levels,
        idf=np.asarray(voc.idf),
        **{f"centers_{i}": np.asarray(c) for i, c in enumerate(voc.centers)},
    )


def load(path: str) -> Vocabulary:
    import numpy as np

    data = np.load(path)
    k = int(data["k"])
    levels = int(data["levels"])
    centers = tuple(
        jnp.asarray(data[f"centers_{i}"]) for i in range(levels)
    )
    return Vocabulary(
        centers=centers, idf=jnp.asarray(data["idf"]), k=k, levels=levels
    )


def transform(voc: Vocabulary, desc, valid):
    """[N,8] descriptors -> (word ids [N], mid-level node ids [N]); -1 pad."""
    return _transform_impl(voc.centers, desc, valid, voc.k, voc.levels)


@partial(jax.jit, static_argnames=("n_words",))
def bow_vector(word, n_words: int, idf):
    """Dense L1-normalized tf-idf vector [V] from word ids [N]."""
    ok = word >= 0
    v = jnp.zeros((n_words,), jnp.float32).at[
        jnp.where(ok, word, n_words)
    ].add(jnp.where(ok, 1.0, 0.0), mode="drop")
    v = v * idf
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-9)


@jax.jit
def sparse_bow(word, idf):
    """Compact L1-normalized tf-idf representation of one frame's words:
    (word ids [N] sorted unique, -1 pad; values [N]). The sparse analogue
    of :func:`bow_vector` for vocabularies too large for dense [V] vectors
    (the standard ORBvoc has 1M words; a dense [K,V] database would be
    ~1 GB of device memory for nothing — frames carry <= N distinct words)."""
    N = word.shape[0]
    big = jnp.iinfo(jnp.int32).max
    # map pads (-1) to +inf so unique's end-padding keeps uid sorted
    # (searchsorted below requires a sorted array)
    w = jnp.where(word >= 0, word, big)
    uid = jnp.unique(w, size=N, fill_value=big)
    inv = jnp.searchsorted(uid, w)
    tf = jnp.zeros((N,), jnp.float32).at[inv].add(
        (word >= 0).astype(jnp.float32)
    )
    ok = uid < big
    val = tf * idf[jnp.clip(uid, 0, idf.shape[0] - 1)] * ok
    return jnp.where(ok, uid, -1), val / jnp.maximum(
        jnp.sum(jnp.abs(val)), 1e-9
    )


@jax.jit
def sparse_l1_scores(kf_wid, kf_wval, q_wid, q_wval, kf_valid):
    """L1 similarity + common-word counts of a sparse query against every
    keyframe's sparse BoW. Identity used: for L1-normalized a, b,
    1 - 0.5*|a-b|_1 = 0.5 * sum_{w in both} (|a_w| + |b_w| - |a_w - b_w|),
    so only the word intersection matters (what DBoW2's inverted file
    exploits). Both sides come from :func:`sparse_bow`, whose word ids are
    sorted-unique with -1 end pads, so the intersection is a sort-merge
    join: one searchsorted per keyframe word, O(K*Nw*log Nq) time and
    O(K*Nw) memory (the previous dense [K,Nw,Nq] equality mask was ~0.5 GB
    at K=512, Nq=1024 — it does not survive KITTI-00 scale)."""
    nq = q_wid.shape[0]
    big = jnp.iinfo(jnp.int32).max
    # restore sortedness: sparse_bow pads with -1 AFTER the sorted ids
    q = jnp.where(q_wid >= 0, q_wid, big)

    def row(wid, wval):
        # kf pads -> big-1: never equals a real q word (ids < big-1 in
        # practice) nor the q pad sentinel big
        w = jnp.where(wid >= 0, wid, big - 1)
        pos = jnp.clip(jnp.searchsorted(q, w), 0, nq - 1)
        hit = (q[pos] == w) & (wid >= 0)
        qv = q_wval[pos]
        inter = jnp.where(
            hit, jnp.abs(wval) + jnp.abs(qv) - jnp.abs(wval - qv), 0.0
        )
        return 0.5 * jnp.sum(inter), jnp.sum(hit).astype(jnp.int32)

    scores, common = jax.vmap(row)(kf_wid, kf_wval)
    scores = jnp.where(kf_valid, scores, -1.0)
    common = jnp.where(kf_valid, common, 0)
    return scores, common


def l1_score(a, b):
    """DBoW2 L1 similarity: 1 - 0.5*|a-b|_1 for L1-normalized vectors
    (ScoringObject.cpp L1Scoring; range [0,1], 1 = identical)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b), axis=-1)


def match_by_words(
    word_a, desc_a, valid_a, word_b, desc_b, valid_b, th=50, ratio=0.7
):
    """SearchByBoW equivalent (reference src/ORBmatcher.cc:159-288): only
    descriptor pairs sharing a vocabulary word compete — here a dense
    masked argmin with word-equality mask (the reference walks aligned
    FeatureVector buckets; equality masking is the same constraint)."""
    from . import matching

    mask = (
        valid_a[:, None]
        & valid_b[None, :]
        & (word_a[:, None] == word_b[None, :])
        & (word_a >= 0)[:, None]
    )
    dist = matching.hamming_matrix(desc_a, desc_b)
    bi, bd, b2 = matching.best_two(dist, mask)
    ok = (bd <= th) & (bd.astype(jnp.float32) <= ratio * b2.astype(jnp.float32))
    ok = matching._resolve_one_to_one(ok, bi, bd, desc_b.shape[0])
    return jnp.where(ok, bi, -1), jnp.where(ok, bd, 1 << 20)
