import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_with_quadrics_tpu.ops import matching


def rand_desc(key, n):
    return jax.random.randint(
        key, (n, 8), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32
    ).astype(jnp.uint32)


def test_hamming_matrix_against_numpy():
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a, b = rand_desc(ka, 17), rand_desc(kb, 23)
    d = np.asarray(matching.hamming_matrix(a, b))
    an = np.ascontiguousarray(np.asarray(a)).view(np.uint8).reshape(17, 32)
    bn = np.ascontiguousarray(np.asarray(b)).view(np.uint8).reshape(23, 32)
    ref = np.zeros((17, 23), np.int32)
    for i in range(17):
        for j in range(23):
            ref[i, j] = np.unpackbits(np.bitwise_xor(an[i], bn[j])).sum()
    np.testing.assert_array_equal(d, ref)


def test_hamming_mxu_matches_popcount():
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    a, b = rand_desc(ka, 64), rand_desc(kb, 96)
    np.testing.assert_array_equal(
        np.asarray(matching.hamming_matrix(a, b)),
        np.asarray(matching.hamming_matrix_matmul(a, b)),
    )


def test_hamming_identity_zero():
    a = rand_desc(jax.random.PRNGKey(2), 5)
    d = matching.hamming_matrix(a, a)
    assert np.all(np.diag(np.asarray(d)) == 0)


def _corrupt(key, desc, nbits):
    """Flip nbits random bits in each descriptor."""
    n = desc.shape[0]
    out = np.asarray(desc).copy()
    rng = np.random.RandomState(int(jax.random.randint(key, (), 0, 1 << 30)))
    for i in range(n):
        for _ in range(nbits):
            w, b = rng.randint(8), rng.randint(32)
            out[i, w] ^= np.uint32(1 << b)
    return jnp.asarray(out)


def test_match_windowed_recovers_permutation():
    key = jax.random.PRNGKey(3)
    n = 64
    desc_a = rand_desc(key, n)
    perm = np.random.RandomState(0).permutation(n)
    desc_b = _corrupt(jax.random.PRNGKey(4), desc_a, 5)[perm]
    uv_a = jax.random.uniform(jax.random.PRNGKey(5), (n, 2), maxval=300.0)
    uv_b = uv_a[perm] + 3.0  # small drift within window
    valid = jnp.ones((n,), bool)
    zeros = jnp.zeros((n,))
    idx, dist = matching.match_windowed(
        uv_a, desc_a, zeros, valid, uv_b, desc_b, zeros, valid,
        window=25.0, check_rotation=False, level0_only=False,
    )
    idx = np.asarray(idx)
    matched = idx >= 0
    assert matched.mean() > 0.9
    # recovered permutation correct
    assert (idx[matched] == np.argsort(perm)[matched]).all()


def test_match_windowed_rejects_far_candidates():
    n = 16
    desc = rand_desc(jax.random.PRNGKey(6), n)
    uv_a = jnp.zeros((n, 2))
    uv_b = jnp.full((n, 2), 500.0)  # all outside window
    valid = jnp.ones((n,), bool)
    zeros = jnp.zeros((n,))
    idx, _ = matching.match_windowed(
        uv_a, desc, zeros, valid, uv_b, desc, zeros, valid,
        window=50.0, check_rotation=False, level0_only=False,
    )
    assert (np.asarray(idx) == -1).all()


def test_match_by_projection_levels_and_one_to_one():
    key = jax.random.PRNGKey(7)
    n = 32
    desc = rand_desc(key, n)
    uv = jax.random.uniform(jax.random.PRNGKey(8), (n, 2), maxval=200.0)
    sf = jnp.asarray([1.2 ** i for i in range(8)], jnp.float32)
    idx, dist = matching.match_by_projection(
        proj_uv=uv,
        proj_valid=jnp.ones((n,), bool),
        pred_level=jnp.zeros((n,), jnp.int32),
        query_desc=desc,
        query_angle=jnp.zeros((n,)),
        feats_uv=uv,
        feats_level=jnp.zeros((n,), jnp.int32),
        feats_desc=desc,
        feats_angle=jnp.zeros((n,)),
        feats_valid=jnp.ones((n,), bool),
        radius=4.0,
        scale_factors=sf,
    )
    idx = np.asarray(idx)
    assert (idx == np.arange(n)).all()
    # duplicates resolved: inject two queries pointing at same keypoint
    desc2 = desc.at[1].set(desc[0])
    uv2 = uv.at[1].set(uv[0])
    idx2, _ = matching.match_by_projection(
        uv2, jnp.ones((n,), bool), jnp.zeros((n,), jnp.int32), desc2,
        jnp.zeros((n,)), uv, jnp.zeros((n,), jnp.int32), desc, jnp.zeros((n,)),
        jnp.ones((n,), bool), 4.0, sf, ratio=1.0,
    )
    idx2 = np.asarray(idx2)
    assert (idx2 == 0).sum() <= 1  # keypoint 0 claimed at most once


def test_match_by_projection_equals_popcount_best_two():
    """match_by_projection (bit-matmul distances) gives the matches that
    popcount distances + best_two + the th/ratio gates + one keypoint per
    query give, with the one-to-one resolution done in numpy."""
    rng = np.random.RandomState(11)
    Q, N, th, ratio = 96, 64, matching.TH_HIGH, 0.9
    td = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    tuv = (rng.rand(N, 2) * 120).astype(np.float32)
    tlvl = rng.randint(0, 3, N).astype(np.int32)
    src = rng.randint(0, N, Q)  # most queries are noisy copies of a target
    qd = td[src] ^ (1 << rng.randint(0, 32, (Q, 8))).astype(np.uint32)
    qd[Q - 16:] = rng.randint(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    quv = tuv[src] + rng.randn(Q, 2).astype(np.float32)
    qlvl = tlvl[src]
    qv, tv = rng.rand(Q) < 0.95, rng.rand(N) < 0.95
    sf = np.asarray([1.2 ** i for i in range(3)], np.float32)
    radius = 6.0

    idx, dist = matching.match_by_projection(
        jnp.asarray(quv), jnp.asarray(qv), jnp.asarray(qlvl), jnp.asarray(qd),
        jnp.zeros((Q,)), jnp.asarray(tuv), jnp.asarray(tlvl), jnp.asarray(td),
        jnp.zeros((N,)), jnp.asarray(tv), radius, jnp.asarray(sf),
        th=th, ratio=ratio,
    )

    r = radius * sf[qlvl]
    mask = (
        (np.abs(quv[:, :1] - tuv[None, :, 0]) <= r[:, None])
        & (np.abs(quv[:, 1:] - tuv[None, :, 1]) <= r[:, None])
        & (np.abs(qlvl[:, None] - tlvl[None, :]) <= 1)
        & qv[:, None] & tv[None, :]
    )
    bi, b1, b2 = (np.asarray(a) for a in matching.best_two(
        matching.hamming_matrix(jnp.asarray(qd), jnp.asarray(td)),
        jnp.asarray(mask)))
    ok = (b1 <= th) & (b1 <= ratio * b2)
    want = np.full(Q, -1)
    for t in range(N):
        qs = np.flatnonzero(ok & (bi == t))
        if len(qs):
            q = qs[np.lexsort((qs, b1[qs]))[0]]
            want[q] = t
    np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_array_equal(np.asarray(dist)[want >= 0], b1[want >= 0])
    assert (want >= 0).sum() > Q // 3  # most copies matched
    assert (np.bincount(bi[ok], minlength=N) > 1).any()  # one-to-one had work


def test_rotation_consistency_keeps_dominant_rotation():
    n = 100
    rng = np.random.RandomState(1)
    ang_a = jnp.asarray(rng.uniform(0, 2 * np.pi, n).astype(np.float32))
    # 80 matches share rotation 0.5 rad, 20 are random
    ang_b = np.asarray(ang_a) - 0.5
    ang_b[80:] = rng.uniform(0, 2 * np.pi, 20)
    keep = matching.rotation_consistency(
        ang_a, jnp.asarray(ang_b.astype(np.float32)), jnp.ones((n,), bool)
    )
    keep = np.asarray(keep)
    assert keep[:80].mean() > 0.95
    assert keep[80:].mean() < 0.4


@pytest.mark.parametrize("level_tol", [0, 1, 2])
def test_masked_best_two_matches_popcount_reference(level_tol):
    """match_by_projection's windowed search (masked_hamming_best2) equals
    popcount distances + best_two under the same window mask."""
    rng = np.random.RandomState(level_tol)
    Q, N = 96, 64
    qd = jnp.asarray(rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32))
    td = jnp.asarray(rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32))
    quv = jnp.asarray(rng.rand(Q, 2).astype(np.float32) * 100)
    tuv = jnp.asarray(rng.rand(N, 2).astype(np.float32) * 100)
    qrad = jnp.asarray(rng.rand(Q).astype(np.float32) * 40)
    qlvl = jnp.asarray(rng.randint(0, 4, Q).astype(np.int32))
    tlvl = jnp.asarray(rng.randint(0, 4, N).astype(np.int32))
    qv = jnp.asarray(rng.rand(Q) < 0.9)
    tv = jnp.asarray(rng.rand(N) < 0.9)
    got = matching.masked_hamming_best2(
        qd, quv, qrad, qlvl, qv, td, tuv, tlvl, tv, level_tol=level_tol
    )
    mask = (
        (jnp.abs(quv[:, :1] - tuv[None, :, 0]) <= qrad[:, None])
        & (jnp.abs(quv[:, 1:] - tuv[None, :, 1]) <= qrad[:, None])
        & (jnp.abs(qlvl[:, None] - tlvl[None, :]) <= level_tol)
        & qv[:, None] & tv[None, :]
    )
    want = matching.best_two(matching.hamming_matrix(qd, td), mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(jnp.sum(want[1] < (1 << 20))) > Q // 4  # windows not empty
