import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_with_quadrics_tpu.models import local_mapping as lm
from orbslam2_with_quadrics_tpu.models import map_state as ms
from orbslam2_with_quadrics_tpu.ops import camera, lie, orb

K = jnp.asarray([300.0, 300.0, 160.0, 120.0])
CFG = ms.MapConfig(max_keyframes=8, max_points=256, n_features=64, n_levels=4)


def rand_desc(key, n):
    return jax.random.randint(key, (n, 8), 0, 2**31 - 1, dtype=jnp.int32).astype(
        jnp.uint32
    )


def make_two_kf_map(key=jax.random.PRNGKey(0), n_pts=48):
    """Two keyframes observing a shared point cloud; some kps unmatched."""
    m = ms.empty_map(CFG)
    N = CFG.n_features
    pts = jax.random.uniform(
        key, (n_pts, 3),
        minval=jnp.asarray([-1.5, -1.0, 4.0]), maxval=jnp.asarray([1.5, 1.0, 8.0]),
    )
    desc = rand_desc(jax.random.PRNGKey(1), N)
    T0 = lie.se3_identity()
    T1 = lie.se3_exp(jnp.asarray([0.01, -0.02, 0.005, 0.4, 0.02, 0.03]))

    for Ti, fid in ((T0, 0), (T1, 1)):
        uv, z = camera.project(K, lie.se3_apply(Ti, pts))
        uv_full = jnp.zeros((N, 2)).at[:n_pts].set(uv)
        obs = jnp.full((N,), -1, jnp.int32)
        m, slot = ms.insert_keyframe(
            m, Ti, jnp.asarray(fid, jnp.int32), uv_full,
            jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
            desc, jnp.ones((N,), bool), obs,
            jnp.asarray(fid - 1, jnp.int32),
        )
    # register half the points as already-known observations in both KFs
    half = n_pts // 2
    m, pids = ms.insert_points(
        m, pts[:half], desc[:half], jnp.zeros((half,), jnp.int32),
        jnp.ones((half,), bool),
    )
    obs_rows = m.kf_obs_point
    obs_rows = obs_rows.at[0, :half].set(pids)
    obs_rows = obs_rows.at[1, :half].set(pids)
    m = m._replace(kf_obs_point=obs_rows)
    return m, pts, desc, T0, T1, half, n_pts


def test_insert_and_counters():
    m, pts, desc, T0, T1, half, n_pts = make_two_kf_map()
    assert int(m.n_kf) == 2
    assert int(m.n_pt) == half
    assert bool(m.kf_valid[0]) and bool(m.kf_valid[1])


def test_covisibility_counts_shared_points():
    m, *_, half, n_pts = make_two_kf_map()
    W = np.asarray(ms.covisibility(m))
    assert W[0, 1] == half and W[1, 0] == half
    assert W[0, 0] == 0


def test_point_obs_count():
    m, *_, half, n_pts = make_two_kf_map()
    cnt = np.asarray(ms.point_obs_count(m))
    assert (cnt[:half] == 2).all()


def test_insert_points_overflow_drops():
    m = ms.empty_map(CFG)
    P = CFG.max_points
    big = P + 10
    pos = jnp.zeros((big, 3))
    desc = jnp.zeros((big, 8), jnp.uint32)
    m, pids = ms.insert_points(
        m, pos, desc, jnp.zeros((big,), jnp.int32), jnp.ones((big,), bool)
    )
    assert int(m.n_pt) == P
    assert int(jnp.sum(pids >= 0)) == P


def test_create_new_points_triangulates_unmatched():
    m, pts, desc, T0, T1, half, n_pts = make_two_kf_map()
    m2, n_new = lm.create_new_points(
        m, jnp.asarray(1), K, jnp.asarray(0.0), n_neighbors=4, n_levels=4
    )
    n_new = int(n_new)
    assert n_new > (n_pts - half) // 2  # most unmatched kps triangulated
    # new points near ground truth
    new_ids = np.arange(half, half + n_new)
    est = np.asarray(m2.pt_pos)[new_ids]
    # each new point should be close to SOME true point
    d = np.linalg.norm(est[:, None, :] - np.asarray(pts)[None, :, :], axis=-1)
    assert np.median(d.min(axis=1)) < 0.1


def test_update_point_stats_sets_descriptor_and_band():
    m, pts, desc, *_ = make_two_kf_map()
    sf, _, _ = orb.scale_factors(4, 1.2)
    m2 = ms.update_point_stats(m, sf)
    # representative descriptor equals the (identical) observation desc
    assert (np.asarray(m2.pt_desc[0]) == np.asarray(desc[0])).all()
    assert float(m2.pt_max_dist[0]) > float(m2.pt_min_dist[0]) > 0


def test_cull_points_drops_low_ratio():
    m, *_ , half, n_pts = make_two_kf_map()
    m = m._replace(
        pt_visible=m.pt_visible.at[0].set(20),
        pt_found=m.pt_found.at[0].set(1),
    )
    m2 = lm.cull_points(m)
    assert not bool(m2.pt_valid[0])
    assert bool(m2.pt_valid[1])
    # detached from keyframes
    assert int(m2.kf_obs_point[0, 0]) == -1


def test_local_ba_reduces_cost_on_perturbed_map():
    m, pts, desc, T0, T1, half, n_pts = make_two_kf_map()
    # perturb points
    m = m._replace(
        pt_pos=m.pt_pos + 0.03 * jax.random.normal(jax.random.PRNGKey(5), m.pt_pos.shape)
    )
    _, _, inv_s2 = orb.scale_factors(4, 1.2)
    m2, cost = lm.run_local_ba(
        m, jnp.asarray(1), K, jnp.asarray(0.0), inv_s2, window=4, n_iters=8
    )
    # reprojection after BA is small
    pid = np.asarray(m2.kf_obs_point[0, :half])
    est = np.asarray(m2.pt_pos)[pid]
    uv, _ = camera.project(K, lie.se3_apply(m2.kf_pose[0], jnp.asarray(est)))
    err = np.linalg.norm(np.asarray(uv) - np.asarray(m2.kf_uv[0, :half]), axis=-1)
    assert np.median(err) < 0.5


def test_select_local_points_matmul_matches_scatter():
    """The obs_A (matvec) fast path of tracking.select_local_points
    must select the same local window as the scatter fallback."""
    from orbslam2_with_quadrics_tpu.models import tracking as tr

    m, pts, desc, T0, T1, half, n_pts = make_two_kf_map()
    # a plausible frame->point assignment: track the first third of points
    obs_point = jnp.full((CFG.n_features,), -1, jnp.int32)
    obs_point = obs_point.at[: half // 2].set(jnp.arange(half // 2))

    ids_ref, kf_ref = tr.select_local_points(m, obs_point, 4, 64, None)
    obs_A = ms.observation_matrix(m)
    ids_fast, kf_fast = tr.select_local_points(m, obs_point, 4, 64, obs_A)

    np.testing.assert_array_equal(np.asarray(kf_ref), np.asarray(kf_fast))
    np.testing.assert_array_equal(np.asarray(ids_ref), np.asarray(ids_fast))


def _chain_kf_map(n_kf=5, n_pts=48):
    """n_kf keyframes in a parent chain, ALL observing the same points —
    middle keyframes are redundant by the >=90% rule."""
    m = ms.empty_map(CFG)
    N = CFG.n_features
    pts = jax.random.uniform(
        jax.random.PRNGKey(2), (n_pts, 3),
        minval=jnp.asarray([-1.5, -1.0, 4.0]), maxval=jnp.asarray([1.5, 1.0, 8.0]),
    )
    desc = rand_desc(jax.random.PRNGKey(1), N)
    m, ids = ms.insert_points(
        m, pts, desc[:n_pts], jnp.zeros((n_pts,), jnp.int32),
        jnp.ones((n_pts,), bool),
    )
    for k in range(n_kf):
        T = lie.se3_exp(jnp.asarray([0.0, 0.0, 0.0, 0.12 * k, 0.0, 0.0]))
        uv, z = camera.project(K, lie.se3_apply(T, pts))
        uv_full = jnp.zeros((N, 2)).at[:n_pts].set(uv)
        obs = jnp.full((N,), -1, jnp.int32).at[:n_pts].set(ids)
        m, _ = ms.insert_keyframe(
            m, T, jnp.asarray(k, jnp.int32), uv_full,
            jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
            desc, jnp.ones((N,), bool), obs, jnp.asarray(k - 1, jnp.int32),
        )
    return m


def test_cull_keyframes_reparents_children_and_freezes_tcp():
    """KeyFrame::SetBadFlag reconnects children and records mTcp
    (reference src/KeyFrame.cc:459-551); culling must not orphan the
    spanning tree or lose the relative pose needed by trajectory savers."""
    m = _chain_kf_map()
    m2 = lm.cull_keyframes(m, jnp.asarray(4))
    culled = np.where(~np.asarray(m2.kf_valid)[:5] & np.asarray(m.kf_valid)[:5])[0]
    assert len(culled) == 1, "exactly one redundant KF culled per call"
    c = int(culled[0])
    assert 0 < c < 4
    # child reparented to grandparent
    parents = np.asarray(m2.kf_parent)
    assert parents[c + 1] == c - 1
    # frozen Tcp reproduces the culled pose from its parent's pose
    T_rec = lie.se3_compose(m2.kf_tcp[c], m2.kf_pose[c - 1])
    np.testing.assert_allclose(
        np.asarray(T_rec), np.asarray(m.kf_pose[c]), atol=1e-5
    )


def test_trajectory_walks_past_culled_reference():
    """SaveTrajectory* must produce identical poses after its reference KF
    is culled (reference System.cc:361-368 spanning-tree walk)."""
    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.models import system as sysm

    m = _chain_kf_map()
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=240, width=320, n_features=CFG.n_features, n_levels=4,
            fx=300.0, fy=300.0, cx=160.0, cy=120.0,
        ),
        map=CFG,
    )
    slam = sysm.System(cfg)
    slam.map = m
    m2 = lm.cull_keyframes(m, jnp.asarray(4))
    c = int(
        np.where(~np.asarray(m2.kf_valid)[:5] & np.asarray(m.kf_valid)[:5])[0][0]
    )
    # two frames anchored on the (about to be culled) KF c
    T_rel = lie.se3_exp(jnp.asarray([0.01, 0.02, -0.01, 0.05, 0.0, 0.1]))
    slam.trajectory = [
        (0, 0.0, c, np.asarray(lie.se3_identity())),
        (1, 0.1, c, np.asarray(T_rel)),
    ]
    before = [T for _, _, T in slam.full_trajectory()]

    slam.map = m2
    after = [T for _, _, T in slam.full_trajectory()]
    for b, a in zip(before, after):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_compact_points_preserves_observations():
    """compact_points reclaims culled slots; observations remap so every
    keyframe still sees the same 3D positions."""
    m, *_ = make_two_kf_map()
    P = m.pt_pos.shape[0]
    # cull every third point
    kill = np.zeros((P,), bool)
    kill[::3] = True
    valid = np.asarray(m.pt_valid) & ~kill
    obs = np.asarray(m.kf_obs_point)
    obs_ok = (obs >= 0) & valid[np.clip(obs, 0, P - 1)]
    m = m._replace(
        pt_valid=jnp.asarray(valid),
        kf_obs_point=jnp.asarray(np.where(obs_ok, obs, -1)),
    )
    pos_before = {}
    for k in range(int(m.n_kf)):
        row = np.asarray(m.kf_obs_point[k])
        for i, p in enumerate(row):
            if p >= 0:
                pos_before[(k, i)] = np.asarray(m.pt_pos[p])

    m2, new_idx = ms.compact_points(m)
    assert int(m2.n_pt) == int(valid.sum())
    # valid points are packed at the low end
    v2 = np.asarray(m2.pt_valid)
    assert v2[: int(m2.n_pt)].all() and not v2[int(m2.n_pt):].any()
    for (k, i), pos in pos_before.items():
        p2 = int(m2.kf_obs_point[k, i])
        assert p2 >= 0
        np.testing.assert_allclose(np.asarray(m2.pt_pos[p2]), pos, rtol=1e-6)
    # remap table agrees with the observation remap
    obs_old = np.asarray(m.kf_obs_point)
    obs_new = np.asarray(m2.kf_obs_point)
    ni = np.asarray(new_idx)
    sel = obs_old >= 0
    np.testing.assert_array_equal(obs_new[sel], ni[obs_old[sel]])


def test_grow_map_preserves_ids():
    m, *_ = make_two_kf_map()
    K0, N = m.kf_obs_point.shape
    P0 = m.pt_pos.shape[0]
    m2 = ms.grow_map(m, new_K=2 * K0, new_P=2 * P0)
    assert m2.kf_obs_point.shape == (2 * K0, N)
    assert m2.pt_pos.shape[0] == 2 * P0
    np.testing.assert_array_equal(
        np.asarray(m2.kf_obs_point[:K0]), np.asarray(m.kf_obs_point)
    )
    np.testing.assert_allclose(
        np.asarray(m2.pt_pos[:P0]), np.asarray(m.pt_pos)
    )
    assert not np.asarray(m2.kf_valid[K0:]).any()
    assert not np.asarray(m2.pt_valid[P0:]).any()
    assert int(m2.n_kf) == int(m.n_kf) and int(m2.n_pt) == int(m.n_pt)
    # inserting still works after growth
    n_before = int(m2.n_pt)
    m3, pids = ms.insert_points(
        m2,
        jnp.ones((4, 3)),
        jnp.zeros((4, 8), jnp.uint32),
        jnp.zeros((4,), jnp.int32),
        jnp.ones((4,), bool),
    )
    assert int(m3.n_pt) == n_before + 4
    assert (np.asarray(pids) >= 0).all()


def test_compact_keyframes_remaps_graph():
    """compact_keyframes packs valid KFs low and remaps parent links and
    the point reference keyframes."""
    m, *_ = make_two_kf_map()
    N = CFG.n_features
    # third keyframe parented on #1
    m, s2 = ms.insert_keyframe(
        m, lie.se3_identity(), jnp.asarray(2, jnp.int32),
        jnp.zeros((N, 2)), jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32),
        jnp.zeros((N,)), rand_desc(jax.random.PRNGKey(5), N),
        jnp.ones((N,), bool), jnp.full((N,), -1, jnp.int32),
        jnp.asarray(1, jnp.int32),
    )
    # cull keyframe 1 (children already reparented in the real pipeline:
    # emulate by pointing s2 at 0) and mark points' ref as live slot 0
    m = m._replace(
        kf_valid=m.kf_valid.at[1].set(False),
        kf_parent=m.kf_parent.at[int(s2)].set(0),
        kf_obs_point=m.kf_obs_point.at[1].set(jnp.full((N,), -1, jnp.int32)),
        pt_first_kf=jnp.where(m.pt_first_kf == 1, 0, m.pt_first_kf),
    )
    K = m.kf_valid.shape[0]
    kf_valid = np.asarray(m.kf_valid)
    order = np.argsort(np.where(kf_valid, 0, 1), kind="stable").astype(np.int32)
    new_idx = np.cumsum(kf_valid.astype(np.int32)) - 1
    new_idx = np.where(kf_valid, new_idx, -1).astype(np.int32)

    m2 = ms.compact_keyframes(m, jnp.asarray(order), jnp.asarray(new_idx))
    assert int(m2.n_kf) == 2
    v2 = np.asarray(m2.kf_valid)
    assert v2[:2].all() and not v2[2:].any()
    # old slot 2 -> new slot 1, parent old 0 -> new 0
    assert int(m2.kf_frame_id[1]) == 2
    assert int(m2.kf_parent[1]) == 0
    # observations and points unchanged (point ids are untouched)
    np.testing.assert_array_equal(
        np.asarray(m2.kf_obs_point[0]), np.asarray(m.kf_obs_point[0])
    )
    np.testing.assert_allclose(np.asarray(m2.pt_pos), np.asarray(m.pt_pos))


def test_fuse_neighbors_resolves_chained_merges():
    """a->b while b->c in one fuse call must leave a's observation on c
    (pointer-jumped remap, reference MapPoint::Replace chains through
    ORBmatcher::Fuse, src/ORBmatcher.cc:825-975)."""
    cfg = ms.MapConfig(max_keyframes=8, max_points=256, n_features=64, n_levels=4)
    m = ms.empty_map(cfg)
    N = cfg.n_features
    key = jax.random.PRNGKey(7)
    desc = rand_desc(key, N)  # row 0 = the shared landmark descriptor

    p_main = jnp.asarray([[0.0, 0.0, 5.0]])
    n_fa, n_fb = 20, 5  # covis fillers KF0<->KF1 (weight 20) and KF0<->KF2 (5)
    fillerA = jnp.stack(
        [jnp.linspace(-1.0, 1.0, n_fa), jnp.full((n_fa,), 0.5),
         jnp.full((n_fa,), 6.0)], axis=1
    )
    fillerB = jnp.stack(
        [jnp.linspace(-1.0, 1.0, n_fb), jnp.full((n_fb,), -0.5),
         jnp.full((n_fb,), 6.0)], axis=1
    )
    T = lie.se3_identity()

    def kf_rows(pts3, rows, base_desc):
        uv, _ = camera.project(K, pts3)
        uv_full = jnp.full((N, 2), -100.0).at[jnp.asarray(rows)].set(uv)
        valid = jnp.zeros((N,), bool).at[jnp.asarray(rows)].set(True)
        return uv_full, valid

    # five keyframes, all at identity
    for fid in range(5):
        m, _ = ms.insert_keyframe(
            m, T, jnp.asarray(fid, jnp.int32), jnp.full((N, 2), -100.0),
            jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
            desc, jnp.zeros((N,), bool), jnp.full((N,), -1, jnp.int32),
            jnp.asarray(-1, jnp.int32),
        )

    # points: s (the new KF's), x (KF1's), y (KF2's) — same 3D spot and
    # descriptor; fillers give the covisibility weights their order
    m, s_id = ms.insert_points(m, p_main, desc[:1], jnp.zeros((1,), jnp.int32),
                               jnp.ones((1,), bool))
    m, x_id = ms.insert_points(m, p_main, desc[:1], jnp.ones((1,), jnp.int32),
                               jnp.ones((1,), bool))
    m, y_id = ms.insert_points(m, p_main, desc[:1],
                               jnp.full((1,), 2, jnp.int32), jnp.ones((1,), bool))
    m, fa = ms.insert_points(m, fillerA, desc[1:1 + n_fa],
                             jnp.zeros((n_fa,), jnp.int32), jnp.ones((n_fa,), bool))
    m, fb = ms.insert_points(m, fillerB, desc[1 + n_fa:1 + n_fa + n_fb],
                             jnp.zeros((n_fb,), jnp.int32), jnp.ones((n_fb,), bool))
    s, x, y = int(s_id[0]), int(x_id[0]), int(y_id[0])

    uv_main, _ = camera.project(K, p_main)
    uv_a, _ = camera.project(K, fillerA)
    uv_b, _ = camera.project(K, fillerB)

    Kpool = m.kf_obs_point.shape[0]
    kf_uv = np.full((Kpool, N, 2), -100.0, np.float32)
    kp_ok = np.zeros((Kpool, N), bool)
    obs = np.full((Kpool, N), -1, np.int32)
    # KF0 (the "new" keyframe): s + all fillers
    kf_uv[0, 0] = np.asarray(uv_main)[0]; obs[0, 0] = s
    kf_uv[0, 1:1 + n_fa] = np.asarray(uv_a); obs[0, 1:1 + n_fa] = np.asarray(fa)
    kf_uv[0, 1 + n_fa:1 + n_fa + n_fb] = np.asarray(uv_b)
    obs[0, 1 + n_fa:1 + n_fa + n_fb] = np.asarray(fb)
    kp_ok[0, :1 + n_fa + n_fb] = True
    # KF1: x at the landmark + fillerA (weight 20 with KF0)
    kf_uv[1, 0] = np.asarray(uv_main)[0]; obs[1, 0] = x
    kf_uv[1, 1:1 + n_fa] = np.asarray(uv_a); obs[1, 1:1 + n_fa] = np.asarray(fa)
    kp_ok[1, :1 + n_fa] = True
    # KF2: y at the landmark + fillerB (weight 5 with KF0)
    kf_uv[2, 0] = np.asarray(uv_main)[0]; obs[2, 0] = y
    kf_uv[2, 1:1 + n_fb] = np.asarray(uv_b); obs[2, 1:1 + n_fb] = np.asarray(fb)
    kp_ok[2, 0] = True
    kp_ok[2, 1:1 + n_fb] = True
    # KF2 filler rows reuse fillerB's descriptors
    kf_desc = np.asarray(m.kf_desc).copy()
    kf_desc[2, 1:1 + n_fb] = np.asarray(desc[1 + n_fa:1 + n_fa + n_fb])
    # KF3 observes s and y (obs counts: x=1, s=2, y=3), far from the spot
    obs[3, 0] = s; obs[3, 1] = y
    kp_ok[3, :2] = True
    # KF4 observes y
    obs[4, 0] = y
    kp_ok[4, 0] = True

    m = m._replace(
        kf_uv=jnp.asarray(kf_uv), kf_kp_valid=jnp.asarray(kp_ok),
        kf_obs_point=jnp.asarray(obs), kf_desc=jnp.asarray(kf_desc),
    )
    # realistic scale bands (fresh-point sentinel max_dist would predict
    # the top octave and the level gate would reject every level-0 kp —
    # the pipeline refreshes stats before fuse, mirror that here)
    sf0, _, _ = orb.scale_factors(4, 1.2)
    m = ms.update_point_stats(m, sf0)
    cnt = np.asarray(ms.point_obs_count(m))
    assert cnt[x] == 1 and cnt[s] == 2 and cnt[y] == 3

    m2 = lm.fuse_neighbors(m, jnp.asarray(0), K, height=240, width=320,
                           n_levels=4)
    pv = np.asarray(m2.pt_valid)
    ob = np.asarray(m2.kf_obs_point)
    # x merged into s (s more observed), s merged into y: both gone
    assert not pv[x] and not pv[s] and pv[y]
    # x's observation (KF1 row 0) must point at y, NOT at the dead s
    assert ob[1, 0] == y
    # the new keyframe's own row follows the chain too
    assert ob[0, 0] == y
