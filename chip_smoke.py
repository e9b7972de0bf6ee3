"""Run the SLAM main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py             # one GPU: device, parity, mono, stereo, RGB-D
    python chip_smoke.py --dist-ba   # four GPUs: distributed BA against one-card BA

    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse [--dist-ba]
        # CPU rehearsal of the same code at a tiny size; never reports ok
        # (for --dist-ba also set
        #  XLA_FLAGS=--xla_force_host_platform_device_count=4)

Each phase prints one line. Any failed check raises, so the script exits
non-zero. On success the last line is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}. The script drives
the device from this one process; frames are rendered beforehand by
worker processes that never import JAX's device runtime.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# TUM-shaped deployment (examples/mono_tum.py): 640x480, 1000 features,
# 8 levels at 1.2, a 512-keyframe / 65,536-point pool, loop closing with
# the shipped vocabulary. Sequence: the seeded orbit_big orbit of
# scripts/eval_full.py, one full loop with a home dwell, in 1000 frames:
# on the H100 the loop closed at 750 and 1000 frames and not at 500, and
# keyframe decisions depend on when the mapping program finishes, so the
# length keeps a 2x margin over the one that failed. Stereo and RGB-D run
# the first short_frames of the orbit at its 1500-frame pace.
FULL = dict(
    h=480, w=640, features=1000, levels=8, max_kf=512, max_pts=65536,
    mono_frames=1000, short_frames=200, short_orbit=1500, plane_half=12.0,
    tex_size=6000,
    n_local_kf=24, noise=4.0, seed=3, baseline=0.2,
    # dist BA at the KITTI-00 map scale parallel/dist_ba.py quotes
    ba_cams=1400, ba_pts=140_000, ba_obs=5_000_000,
)
# CPU rehearsal: the organic-loop test's scale (tests/test_organic_loops.py)
TINY = dict(
    h=240, w=320, features=512, levels=4, max_kf=64, max_pts=16384,
    mono_frames=500, short_frames=60, short_orbit=500, plane_half=6.0,
    tex_size=2048,
    n_local_kf=8, noise=3.0, seed=3, baseline=0.2,
    ba_cams=64, ba_pts=4096, ba_obs=65536,
)
ATE_BOUND = 0.02  # of trajectory span (scripts/eval_full.py gate)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


# ---------------------------------------------------------------------------
# frame rendering (worker processes; numpy only)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def _textures(tex_size: int, seed: int):
    from orbslam2_with_quadrics_tpu.utils import synthetic

    return synthetic._texture(tex_size, seed), synthetic._texture(512, seed + 77)


def _render_chunk(job):
    """Render frames ``idx`` of the orbit: (imgs uint8, aux, T_cw list).
    aux is the right image (stereo), uint16 depth at 5000/m (rgbd) or
    None. Each frame's sensor noise has its own seed, so the chunking does
    not change the sequence."""
    from orbslam2_with_quadrics_tpu.utils import synthetic

    sensor, idx, n_total, c = job
    h, w, fx = c["h"], c["w"], _fx(c)
    tex, relief = _textures(c["tex_size"], c["seed"])
    K3 = np.array([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1.0]])
    imgs, auxs, poses = [], [], []
    for t in idx:
        T = synthetic.planar_pose(t, n_total, "orbit_big", c["plane_half"])
        rng = np.random.RandomState(c["seed"] * 100_003 + t)

        def render(T_cw):
            return np.clip(synthetic.render_plane(
                tex, T_cw, K3, h, w, plane_half=c["plane_half"],
                relief_tex=relief, noise=c["noise"], noise_rng=rng,
            ), 0, 255).astype(np.uint8)

        imgs.append(render(T))
        if sensor == "stereo":
            auxs.append(render(synthetic.stereo_right_pose(T, c["baseline"])))
        elif sensor == "rgbd":
            d = synthetic.planar_depth(
                T, np.array([fx, fx, w / 2.0, h / 2.0]), h, w, relief=True
            )
            auxs.append(np.clip(d * 5000.0, 0, 65535).astype(np.uint16))
        poses.append(T)
    return imgs, (auxs if auxs else None), poses


def _fx(c):
    return 520.9 * c["w"] / 640.0  # TUM1 intrinsics scaled to the frame


def render_sequence(sensor, n_frames, n_total, c, workers):
    """Render frames [0, n_frames) of an n_total-frame orbit in bulk."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    chunks = np.array_split(np.arange(n_frames), max(1, 4 * workers))
    jobs = [(sensor, list(ch), n_total, c) for ch in chunks if len(ch)]
    imgs, auxs, poses = [], [], []
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        for i, a, p in pool.map(_render_chunk, jobs):
            imgs += i
            auxs += a or []
            poses += p
    return imgs, (auxs if auxs else None), poses


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(rehearse: bool, n_expected: int):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log("device", devices=[str(d) for d in devs], platform=d0.platform,
        kind=d0.device_kind, count=len(devs))
    if not rehearse:
        check(d0.platform == "gpu", f"platform is {d0.platform!r}, not 'gpu'")
    check(len(devs) >= n_expected,
          f"{len(devs)} devices visible, {n_expected} needed")
    return d0


def _ref_best_two(qd, qv, quv, qrad, qlvl, td, tv, tuv, tlvl, level_tol):
    """numpy masked best/second Hamming distance (popcount via unpackbits)."""
    qb = np.unpackbits(qd.view(np.uint8), axis=1).astype(np.float32)
    tb = np.unpackbits(td.view(np.uint8), axis=1).astype(np.float32)
    # 0/1 products summed in f32 are exact integers (< 2^24)
    dist = (qb.sum(1)[:, None] + tb.sum(1)[None, :] - 2 * (qb @ tb.T)).astype(np.int64)
    mask = (
        (np.abs(quv[:, :1] - tuv[None, :, 0]) <= qrad[:, None])
        & (np.abs(quv[:, 1:2] - tuv[None, :, 1]) <= qrad[:, None])
        & (np.abs(tlvl[None, :] - qlvl[:, None]) <= level_tol)
        & qv[:, None] & tv[None, :]
    )
    d = np.where(mask, dist, 1 << 20)
    srt = np.sort(d, axis=1)
    return srt[:, 0], srt[:, 1]


def phase_parity(c):
    """Each formulation the hot path runs, on the device at TUM widths,
    against the repo's plain reference."""
    import jax
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.ops import ba, camera, lie, matching, orb

    h, w, nf, nl = c["h"], c["w"], c["features"], c["levels"]

    # --- ORB: production extract (patch slice + in-patch tap gather) vs
    # the per-level reference path (ic_angle + brief_descriptors over the
    # whole blurred level), on a seeded image without flat areas (equal
    # blurred values would make the BRIEF comparisons ties)
    rng = np.random.RandomState(c["seed"])
    yy, xx = np.mgrid[0:h, 0:w]
    img = jnp.asarray(((np.sin(yy * 0.3) * np.cos(xx * 0.23) + rng.rand(h, w))
                       * 127).astype(np.float32))
    f = jax.jit(lambda im: orb.extract(im, nf, nl, 1.2))(img)
    pyr = orb.build_pyramid(img, orb.pyramid_shapes(h, w, nl, 1.2))
    v = np.asarray(f.valid)
    lv = np.asarray(f.level)
    ang_err, same, total = 0.0, 0, 0
    for l in range(nl):
        sel = v & (lv == l)
        if not sel.any():
            continue
        uv = np.asarray(f.uv)[sel] / 1.2 ** l
        yx = jnp.asarray(np.stack([uv[:, 1], uv[:, 0]], -1).round().astype(np.int32))
        ok = jnp.ones((yx.shape[0],), bool)
        a_ref = orb.ic_angle(pyr[l], yx, ok)
        d_ref = orb.brief_descriptors(orb.gaussian_blur7(pyr[l]), yx, a_ref, ok)
        da = np.angle(np.exp(1j * (np.asarray(f.angle)[sel] - np.asarray(a_ref))))
        ang_err = max(ang_err, float(np.abs(da).max()))
        same += int(np.all(np.asarray(f.desc)[sel] == np.asarray(d_ref), axis=1).sum())
        total += int(sel.sum())
    share = same / max(total, 1)
    log("parity", form="orb.extract vs per-level ic_angle+brief_descriptors",
        keypoints=total, max_angle_err_rad=ang_err, angle_tol=1e-3,
        identical_descriptor_share=share, share_tol=0.99,
        reason="moment sums run in another order than the reference's, so "
               "an angle may differ in its last bits and move a rounded tap")
    check(total > nf // 2, "too few keypoints for the ORB parity check")
    check(ang_err <= 1e-3 and share >= 0.99, "ORB parity")

    # --- matching: masked best-two over the projection window at the
    # tracking shape (n_local_pt queries x features) vs numpy popcount
    Q = 4096
    qd = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    td = rng.randint(0, 2**32, (nf, 8), dtype=np.uint64).astype(np.uint32)
    td[: nf // 2] = qd[: nf // 2] ^ (1 << rng.randint(0, 32, (nf // 2, 8))).astype(np.uint32)
    quv = (rng.rand(Q, 2) * [w, h]).astype(np.float32)
    tuv = np.concatenate([quv[: nf // 2] + rng.randn(nf // 2, 2).astype(np.float32),
                          (rng.rand(nf - nf // 2, 2) * [w, h]).astype(np.float32)])
    qlvl = rng.randint(0, nl, Q).astype(np.int32)
    tlvl = np.concatenate([qlvl[: nf // 2], rng.randint(0, nl, nf - nf // 2)]).astype(np.int32)
    qrad = (15.0 * 1.2 ** qlvl).astype(np.float32)
    qv = rng.rand(Q) < 0.9
    tv = rng.rand(nf) < 0.95
    bi, b1, b2 = jax.jit(matching.masked_hamming_best2)(
        qd, quv, qrad, qlvl, qv, td, tuv, tlvl, tv)
    r1, r2 = _ref_best_two(qd, qv, quv, qrad, qlvl, td, tv, tuv, tlvl, 1)
    bi, b1, b2 = np.asarray(bi), np.asarray(b1), np.asarray(b2)
    qb = np.unpackbits(qd.view(np.uint8), axis=1)
    tb = np.unpackbits(td.view(np.uint8), axis=1)
    has = b1 < (1 << 20)
    idx_d = (qb[has] != tb[bi[has]]).sum(1)
    n_bad = int((b1 != r1).sum() + (b2 != r2).sum() + (idx_d != b1[has]).sum())
    log("parity", form="matching.masked_hamming_best2 vs numpy popcount",
        queries=Q, targets=nf, matched=int(has.sum()), mismatches=n_bad, tol=0,
        reason="integer distances: exact")
    check(n_bad == 0 and has.sum() > nf // 4, "matching parity")

    # --- map-point statistics over a full TUM-sized pool: device vs the
    # same program on the host CPU backend
    K, N, P = c["max_kf"], nf, c["max_pts"]
    m = ms.empty_map(ms.MapConfig(K, P, N, nl))
    obs = np.where(rng.rand(K, N) < 0.6, rng.randint(0, P, (K, N)), -1)
    m = m._replace(
        kf_pose=lie.se3_exp(jnp.asarray(
            rng.randn(K, 6) * np.array([0.05] * 3 + [1.0] * 3), jnp.float32)),
        kf_valid=jnp.ones((K,), bool),
        kf_kp_valid=jnp.ones((K, N), bool),
        kf_obs_point=jnp.asarray(obs, jnp.int32),
        kf_level=jnp.asarray(rng.randint(0, nl, (K, N)), jnp.int32),
        kf_desc=jnp.asarray(rng.randint(0, 2**32, (K, N, 8), dtype=np.uint64)
                            .astype(np.uint32)),
        pt_pos=jnp.asarray(rng.randn(P, 3) * 3 + [0, 0, 8], jnp.float32),
        pt_valid=jnp.ones((P,), bool),
    )
    sf = orb.scale_factors(nl, 1.2)[0]
    got = jax.jit(ms.update_point_stats)(m, sf)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = jax.jit(ms.update_point_stats)(jax.device_put(m, cpu),
                                             jax.device_put(sf, cpu))
    nrm_err = float(np.abs(np.asarray(got.pt_normal) - np.asarray(ref.pt_normal)).max())
    band = np.asarray(ref.pt_max_dist)
    band_err = float((np.abs(np.asarray(got.pt_max_dist) - band)
                      / np.maximum(np.abs(band), 1e-6)).max())
    dsame = float(np.all(np.asarray(got.pt_desc) == np.asarray(ref.pt_desc), 1).mean())
    log("parity", form="map_state.update_point_stats device vs host CPU",
        keyframes=K, features=N, points=P, max_normal_err=nrm_err,
        normal_tol=1e-4, max_band_rel_err=band_err, band_tol=1e-4,
        identical_descriptor_share=dsame, share_tol=0.9,
        reason="segment sums run in another order; observations equally "
               "close to the majority descriptor tie, and the scatter keeps "
               "whichever writes last")
    check(nrm_err <= 1e-4 and band_err <= 1e-4 and dsame >= 0.9,
          "point-stats parity")

    # --- local BA at the mapping shape: dense reduced solve vs the PCG
    # solver on the same problem
    C, Pl = 16 + 1 + 32, 20000
    key = jax.random.PRNGKey(c["seed"])
    Kc = jnp.asarray([_fx(c), _fx(c), w / 2.0, h / 2.0])
    bf = jnp.asarray(c["baseline"] * _fx(c))
    pts = jax.random.uniform(key, (Pl, 3), minval=jnp.asarray([-6.0, -4.0, 4.0]),
                             maxval=jnp.asarray([6.0, 4.0, 16.0]))
    poses = lie.se3_exp(jax.random.normal(key, (C, 6))
                        * jnp.asarray([0.005] * 3 + [0.3, 0.1, 0.3]))
    ci = jnp.repeat(jnp.arange(C, dtype=jnp.int32), N)
    pi = jnp.asarray(np.concatenate(
        [rng.permutation(Pl)[:N] for _ in range(C)]), jnp.int32)
    uvr, _ = camera.project_stereo(Kc, bf, lie.se3_apply(poses[ci], pts[pi]))
    O = C * N
    prob = ba.BAProblem(
        poses=poses, points=pts + 0.03, K=Kc, bf=bf, cam_idx=ci, pnt_idx=pi,
        uvr=uvr + 0.5 * jax.random.normal(key, uvr.shape),
        is_stereo=jnp.ones((O,)), inv_sigma2=jnp.ones((O,)), valid=jnp.ones((O,)),
        fixed_cam=jnp.zeros((C,)).at[0].set(1.0), fixed_pnt=jnp.zeros((Pl,)),
    )
    p_ref, c_ref = ba.ba_solve(prob, n_iters=8, cg_iters=100, use_huber=False)
    p_got, c_got = ba.ba_solve_dense(prob, n_iters=8, n_local_pts=8192 * 4,
                                     use_huber=False, cam_grid=(C, N))
    rel = abs(float(c_got) - float(c_ref)) / max(float(c_ref), 1.0)
    dpose = float(jnp.abs(p_got.poses - p_ref.poses).max())
    log("parity", form="ba.ba_solve_dense vs ba.ba_solve (PCG)", cams=C,
        edges=O, points=Pl, rel_cost_diff=rel, cost_tol=1e-3,
        max_pose_diff=dpose, pose_tol=1e-3,
        reason="both solve the same LM steps; PCG stops after a fixed "
               "number of CG sweeps instead of an exact solve")
    check(rel <= 1e-3 and dpose <= 1e-3, "local BA parity")


def _make_system(sensor, c):
    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm

    fx = _fx(c)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=c["h"], width=c["w"], n_features=c["features"],
            n_levels=c["levels"], fx=fx, fy=fx, cx=c["w"] / 2.0,
            cy=c["h"] / 2.0, bf=0.0 if sensor == "mono" else c["baseline"] * fx,
        ),
        map=ms.MapConfig(
            max_keyframes=c["max_kf"], max_points=c["max_pts"],
            n_features=c["features"], n_levels=c["levels"],
        ),
        sensor=sensor,
        depth_factor=1.0 / 5000.0,
        max_frames_between_kf=30,
        # mapping occupancy and close-point constants of scripts/eval_full.py
        kf_idle_frames=9,
        kf_close_tracked_th=int(100 * c["features"] / 2000),
        kf_close_untracked_th=int(70 * c["features"] / 2000),
        enable_loop_closing=True,
        async_gba=True,
        n_local_kf=c["n_local_kf"],
    )
    return sysm.System(cfg)


class CompileCounter:
    """Counts XLA compilations (fresh or from the persistent cache)."""

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.n += 1


def run_sequence(sensor, n_frames, n_total, c, workers, compiles):
    """Render, warm up, track every frame through System.track_*, and
    return the phase's numbers."""
    import jax

    from orbslam2_with_quadrics_tpu.utils import metrics

    t0 = time.perf_counter()
    imgs, auxs, poses_gt = render_sequence(sensor, n_frames, n_total, c, workers)
    t_render = time.perf_counter() - t0

    slam = _make_system(sensor, c)
    t0 = time.perf_counter()
    slam.warmup()
    t_warm = time.perf_counter() - t0
    n_comp0 = compiles.n

    track = {"mono": slam.track_monocular, "stereo": slam.track_stereo,
             "rgbd": slam.track_rgbd}[sensor]
    times = []
    for i in range(n_frames):
        args = (imgs[i],) if sensor == "mono" else (imgs[i], auxs[i])
        t0 = time.perf_counter()
        track(*args, timestamp=i / 30.0)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    slam.shutdown()
    times[-1] += time.perf_counter() - t0

    est, gt = [], []
    for fid, _, T7 in slam.full_trajectory():
        est.append(metrics.se3_vec_to_mat(T7))
        gt.append(poses_gt[fid])
    ce = metrics.camera_centers_from_Tcw(est)
    cg = metrics.camera_centers_from_Tcw(gt)
    ate = metrics.ate_rmse(ce, cg, with_scale=sensor == "mono")
    span = float(np.linalg.norm(cg.max(0) - cg.min(0)))
    ft = np.asarray(times) * 1e3
    stats = jax.devices()[0].memory_stats() or {}
    out = dict(
        sensor=sensor, frames=n_frames, render_s=t_render, warmup_s=t_warm,
        frames_tracked=len(est), state_ok=slam.state == slam.OK,
        ate=float(ate), span=span, ate_pct_of_span=100.0 * ate / span,
        loops_closed=int(slam.n_loops_closed),
        keyframes_created=int(slam.n_kfs_created),
        frame_ms_p50=float(np.median(ft)), frame_ms_p99=float(np.percentile(ft, 99)),
        frame_ms_max=float(ft.max()), frames_per_s=n_frames / (ft.sum() / 1e3),
        compiles_after_warmup=compiles.n - n_comp0,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
    )
    log(sensor, **out)
    return out


def phase_main_path(c, workers, compiles):
    mono = run_sequence("mono", c["mono_frames"], c["mono_frames"], c,
                        workers, compiles)
    check(mono["state_ok"], "mono run did not end in state OK")
    check(mono["ate"] < ATE_BOUND * mono["span"], "mono ATE over 2% of span")
    check(mono["loops_closed"] >= 1, "mono run closed no loop")
    for sensor in ("stereo", "rgbd"):
        r = run_sequence(sensor, c["short_frames"], c["short_orbit"], c,
                         workers, compiles)
        check(r["state_ok"], f"{sensor} run did not end in state OK")
        check(r["keyframes_created"] >= 2, f"{sensor} inserted no keyframes")
        check(r["ate"] < ATE_BOUND * r["span"], f"{sensor} ATE over 2% of span")


def _ba_problem(c):
    """Seeded stereo BA problem at the configured map scale: random
    camera-point edges with pixel noise and perturbed points."""
    import jax
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import ba, camera, lie

    C, P, O = c["ba_cams"], c["ba_pts"], c["ba_obs"]
    k = jax.random.split(jax.random.PRNGKey(c["seed"]), 5)
    Kc = jnp.asarray([718.856, 718.856, 607.19, 185.2])  # KITTI 00-02
    bf = jnp.asarray(386.1448)
    pts = jax.random.uniform(k[0], (P, 3), minval=jnp.asarray([-20.0, -5.0, 5.0]),
                             maxval=jnp.asarray([20.0, 5.0, 60.0]))
    poses = lie.se3_exp(jax.random.normal(k[1], (C, 6))
                        * jnp.asarray([0.01] * 3 + [0.5, 0.1, 0.5]))
    ci = jax.random.randint(k[2], (O,), 0, C)
    pi = jax.random.randint(k[3], (O,), 0, P)
    uvr, _ = camera.project_stereo(Kc, bf, lie.se3_apply(poses[ci], pts[pi]))
    return ba.BAProblem(
        poses=poses, points=pts + 0.05, K=Kc, bf=bf, cam_idx=ci, pnt_idx=pi,
        uvr=uvr + 0.3 * jax.random.normal(k[4], uvr.shape),
        is_stereo=jnp.ones((O,)), inv_sigma2=jnp.ones((O,)), valid=jnp.ones((O,)),
        fixed_cam=jnp.zeros((C,)).at[0].set(1.0), fixed_pnt=jnp.zeros((P,)),
    )


def phase_dist_ba(c):
    """dist_ba_solve over a 4-device ("ba",) mesh against one-device
    ba.ba_solve on the same seeded problem."""
    import jax

    from orbslam2_with_quadrics_tpu.ops import ba
    from orbslam2_with_quadrics_tpu.parallel import dist_ba

    n_iters, cg_iters = 10, 40
    prob = _ba_problem(c)
    one = jax.device_put(prob, jax.devices()[0])
    t0 = time.perf_counter()
    p1, c1 = jax.block_until_ready(
        ba.ba_solve(one, n_iters=n_iters, cg_iters=cg_iters))
    t_one_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1, c1 = jax.block_until_ready(
        ba.ba_solve(one, n_iters=n_iters, cg_iters=cg_iters))
    t_one = time.perf_counter() - t0

    mesh = dist_ba.make_ba_mesh(4)
    sh = dist_ba.shard_problem(prob, mesh)
    t0 = time.perf_counter()
    p4, c4 = jax.block_until_ready(
        dist_ba.dist_ba_solve(sh, mesh, n_iters=n_iters, cg_iters=cg_iters))
    t_four_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    p4, c4 = jax.block_until_ready(
        dist_ba.dist_ba_solve(sh, mesh, n_iters=n_iters, cg_iters=cg_iters))
    t_four = time.perf_counter() - t0

    cost0 = float(ba._edge_terms(one, np.float32(0.0))[5])
    rel = abs(float(c4) - float(c1)) / max(abs(float(c1)), 1e-12)
    dpose = float(np.abs(np.asarray(p4.poses) - np.asarray(p1.poses)).max())
    log("dist_ba", cams=c["ba_cams"], points=c["ba_pts"], edges=c["ba_obs"],
        devices=4, lm_iters=n_iters, cg_iters=cg_iters, cost0=cost0,
        cost_one=float(c1), cost_four=float(c4), rel_cost_diff=rel,
        cost_tol=1e-4, max_pose_diff=dpose, pose_tol=1e-3,
        one_device_s=t_one, four_device_s=t_four,
        one_device_first_call_s=t_one_first, four_device_first_call_s=t_four_first,
        reason="psum adds the four devices' partial sums in another order "
               "than one device's segment sums; CG amplifies the last-bit "
               "differences slightly")
    check(float(c1) < cost0, "one-device BA did not reduce the cost")
    check(rel <= 1e-4 and dpose <= 1e-3, "distributed BA parity")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dist-ba", action="store_true",
                    help="run only distributed BA on four devices")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at a tiny size; never reports ok")
    args = ap.parse_args(argv)

    # the card's name and power limit, read before JAX touches the card
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        smi = (q.stdout or q.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(f"[device] nvidia-smi: {smi}", flush=True)

    sys.path.insert(0, REPO)
    c = TINY if args.rehearse else FULL
    n_dev = 4 if args.dist_ba else 1
    d0 = phase_device(args.rehearse, n_dev)
    workers = max(1, min(16, (os.cpu_count() or 2) - 1))
    if args.rehearse:
        workers = min(workers, 2)

    if args.dist_ba:
        phase_dist_ba(c)
    else:
        compiles = CompileCounter()
        t0 = time.perf_counter()
        phase_parity(c)
        log("parity", seconds=time.perf_counter() - t0)
        phase_main_path(c, workers, compiles)

    if args.rehearse:
        print("[rehearsal] all phases ran; no result on a rehearsal", flush=True)
        return 3
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
