"""Benchmark: tracking frames/sec on one NVIDIA GPU vs the reference baseline.

    python bench.py

Needs a GPU whose device_kind is in PEAKS (it fails on any other
platform); prints the card's name and power limit, then ONE JSON line.

Baseline justification: the reference prints median tracking time per run
(mono_tum.cc:120-129) and stores no number; the ORB-SLAM2 paper (T-RO
2017, cited at README.md.bk:22) reports ~22 ms mean tracking on an
i7-4790 for TUM mono workloads => ~45 fps. That measured figure — not the
30 fps camera-rate pacing claim — is the baseline the >=5x target is
computed against.

Reported metrics (all in the one JSON line):
- tracking_fps_per_device: steady-state per-frame hot path (ORB extract +
  guided matching + two pose optimizations) at TUM workload size
  (640x480, 1000 features, 8 levels), timed as a device-side scan so the
  number is device throughput, not host dispatch latency.
- fps_amortized: includes the inline mapping pipeline (triangulate +
  fuse + local BA + cull) every KF_EVERY frames — the reference overlaps
  mapping on a second core; this repo runs it inline on the tracking
  path (models/system.py _insert_keyframe), so the honest end-to-end
  number charges it to the frame budget.
- per-stage ms + achieved TFLOP/s + MFU estimate for the tracking step.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASELINE_FPS = 45.0  # measured-i7 median tracking (~22 ms), see docstring
KF_EVERY = 5         # amortization: 1 keyframe per 5 frames (TUM-typical)

# published peaks by device_kind: NVIDIA H100 SXM data sheet, dense
# rates without sparsity, at the full 700 W power limit. A device kind not
# in this table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "f32_tflops": 67.0, "hbm_gbps": 3350.0,
    },
}


def _power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return q.stdout.strip()


def _timed(fn, *args, reps=3):
    out = fn(*args)
    import jax

    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    card = _power_limit()
    print(f"[bench] {card}", file=sys.stderr, flush=True)
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; found {dev.platform!r}")
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}")
    peak = PEAKS[dev.device_kind]

    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import tracking as tr
    from orbslam2_with_quadrics_tpu.ops import camera, lie, orb

    H, W, NFEAT, NLEV = 480, 640, 1024, 8
    NPTS, NKF = 8192, 64

    cfg = fe.FrontendConfig(
        height=H, width=W, n_features=NFEAT, n_levels=NLEV,
        fx=520.9, fy=521.0, cx=325.1, cy=249.7,
    )
    rng = np.random.RandomState(0)
    img = jnp.asarray(rng.rand(H, W).astype(np.float32) * 255.0)

    # synthetic populated map for the tracking stage
    mcfg = ms.MapConfig(
        max_keyframes=NKF, max_points=NPTS, n_features=NFEAT, n_levels=NLEV
    )
    m = ms.empty_map(mcfg)
    key = jax.random.PRNGKey(0)
    pts = jax.random.uniform(
        key, (NPTS, 3),
        minval=jnp.asarray([-3.0, -2.0, 2.0]), maxval=jnp.asarray([3.0, 2.0, 10.0]),
    )
    desc = jax.random.randint(key, (NPTS, 8), 0, 2**31 - 1, dtype=jnp.int32).astype(
        jnp.uint32
    )
    obs0 = jnp.arange(NFEAT, dtype=jnp.int32)
    uv_all, _ = camera.project(cfg.K, pts)
    kf_uv = jnp.tile(uv_all[None, :NFEAT], (NKF, 1, 1))
    m = m._replace(
        pt_pos=pts, pt_valid=jnp.ones((NPTS,), bool), pt_desc=desc,
        pt_max_dist=jnp.full((NPTS,), 100.0),
        pt_normal=jnp.tile(jnp.asarray([0.0, 0.0, -1.0]), (NPTS, 1)),
        n_pt=jnp.asarray(NPTS, jnp.int32),
        kf_valid=jnp.zeros((NKF,), bool).at[:16].set(True),
        kf_kp_valid=m.kf_kp_valid.at[:16].set(True),
        kf_uv=kf_uv,
        kf_desc=m.kf_desc.at[:16].set(desc[:NFEAT]),
        kf_obs_point=m.kf_obs_point.at[:16].set(
            (jnp.arange(NFEAT)[None, :] + 13 * jnp.arange(16)[:, None]) % NPTS
        ),
        n_kf=jnp.asarray(16, jnp.int32),
    )
    T = lie.se3_identity()
    prev_obs = obs0
    # keyframe-rate cached observation matrix (System._get_obs_A)
    obs_A = ms.observation_matrix(m)
    _, _, inv_sigma2 = orb.scale_factors(NLEV, 1.2)

    def frame_step(m, img, T, prev_obs):
        feats = fe.extract_mono(cfg, img)
        res = tr.track_frame(
            m, feats, T, prev_obs, cfg.K, jnp.asarray(0.0),
            height=H, width=W, n_levels=NLEV,
            n_local_kf=NKF, n_local_pt=4096, obs_A=obs_A,
        )
        return res.T_cw, res.obs_point, res.n_inliers

    # Device-side loop over frames: one dispatch for the whole batch, so
    # the measurement is device throughput, not host per-call latency
    # (tracking at camera rate is a throughput problem: frames arrive
    # continuously and JAX dispatch is asynchronous).
    n_it = 50

    def seq(m, img, T, prev_obs):
        def body(carry, _):
            T, po = carry
            # make the image depend on the carry: with a loop-invariant
            # image XLA hoists the entire ORB extraction out of the scan
            # and the benchmark silently measures tracking without its
            # front-end (~2.2 ms/frame of real work)
            img_i = img + T[0] * 1e-7
            T2, po2, n = frame_step(m, img_i, T, po)
            return (T2, po), n

        (_, _), ns = jax.lax.scan(body, (T, prev_obs), None, length=n_it)
        return ns

    def _prog(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    def _cost(f, *args):
        """(flops, bytes) of ONE call by XLA's compiled cost analysis. The
        analysis counts a loop body once whatever its trip count, so
        costs come from one-call programs (not the timed scans) and are
        lower bounds wherever the call itself loops (LM iterations)."""
        ca = jax.jit(f).lower(*args).compile().cost_analysis() or {}
        return (float(ca.get("flops", 0.0) or 0.0),
                float(ca.get("bytes accessed", 0.0) or 0.0))

    _prog("compiling tracking scan...")
    seq_j = jax.jit(seq)
    # FLOPs per frame for the MFU estimate
    frame_flops, _ = _cost(frame_step, m, img, T, prev_obs)
    jax.block_until_ready(seq_j(m, img, T, prev_obs))
    _prog("timing tracking scan...")
    t0 = time.perf_counter()
    jax.block_until_ready(seq_j(m, img, T, prev_obs))
    dt = time.perf_counter() - t0
    fps = n_it / dt
    t_frame = dt / n_it

    # ---- per-stage breakdown (each stage timed alone, warm) ----
    _prog("stage: extract")
    extract_j = jax.jit(lambda im: fe.extract_mono(cfg, im))
    t_extract, feats = _timed(extract_j, img)

    _prog("stage: track")
    track_j = jax.jit(
        lambda m, f, T, po: tr.track_frame(
            m, f, T, po, cfg.K, jnp.asarray(0.0), height=H, width=W,
            n_levels=NLEV, n_local_kf=NKF, n_local_pt=4096, obs_A=obs_A,
        ).T_cw
    )
    t_track, _ = _timed(track_j, m, feats, T, prev_obs)

    # ---- mapping pipeline (inline keyframe-rate work) ----
    _prog("stage: triangulate")
    slot = jnp.asarray(2)
    tri_j = jax.jit(
        lambda m: lm.create_new_points(
            m, slot, cfg.K, jnp.asarray(0.0), n_levels=NLEV, scale=1.2
        )[0]
    )
    t_tri, m_tri = _timed(tri_j, m)
    _prog("stage: fuse")
    fuse_j = jax.jit(
        lambda m: lm.fuse_neighbors(
            m, slot, cfg.K, height=H, width=W, n_levels=NLEV, scale=1.2
        )
    )
    t_fuse, _ = _timed(fuse_j, m_tri)
    _prog("stage: local BA")
    lba_j = jax.jit(
        lambda m: lm.run_local_ba(
            m, slot, cfg.K, jnp.asarray(0.0), inv_sigma2, window=16
        )[0].kf_pose
    )
    t_lba, _ = _timed(lba_j, m_tri)
    _prog("stage: kf cull")
    cull_j = jax.jit(lambda m: lm.cull_keyframes(m, slot).kf_valid)
    t_cull, _ = _timed(cull_j, m_tri)

    # the whole keyframe-rate pipeline as ONE dispatch: per-stage numbers
    # above each pay a host->device round trip, which would
    # quadruple-count dispatch latency in the amortized figure. This is
    # the REAL program the System dispatches per keyframe
    # (insert + depth spawn + cull + triangulate + stats + fuse + stats +
    # local BA + KF cull, models/system.py _insert_and_map).
    _prog("stage: mapping pipeline (fused)")
    from orbslam2_with_quadrics_tpu.models import system as sysm

    bench_feats = fe.FrameFeatures(
        uv=uv_all[:NFEAT], uv_und=uv_all[:NFEAT],
        level=jnp.zeros((NFEAT,), jnp.int32), angle=jnp.zeros((NFEAT,)),
        score=jnp.ones((NFEAT,)), desc=desc[:NFEAT],
        valid=jnp.ones((NFEAT,), bool), ur=jnp.full((NFEAT,), -1.0),
        depth=jnp.zeros((NFEAT,)),
    )
    protect = np.zeros((NKF,), bool)

    def map_pipeline(m):
        m2, aux, _red = sysm._insert_and_map(
            m, bench_feats, lie.se3_identity(), np.int32(100), np.int32(2),
            jnp.full((NFEAT,), -1, jnp.int32), protect, inv_sigma2,
            cfg, "mono", 16,
        )
        return aux

    t_map, _ = _timed(jax.jit(map_pipeline), m)

    fps_amortized = 1.0 / (t_frame + t_map / KF_EVERY)

    # ---- speed-of-light table ----
    # per-stage DEVICE time via scan-length slope (two scan lengths; the
    # host->device dispatch round-trip cancels in the difference),
    # with FLOPs/bytes per call from XLA's compiled cost_analysis and the
    # roofline bound max(flops/peak_flops, bytes/peak_bw). Stage bodies
    # cycle over 8 distinct images — a loop-invariant image lets XLA
    # hoist stage work out of the scan and the slope reads ~0.
    _prog("speed-of-light table")
    kind = dev.device_kind
    peak_tf = peak["bf16_tflops"]
    peak_bw = peak["hbm_gbps"]
    imgs8 = jnp.stack([img + 0.37 * i for i in range(8)])

    def _slope_time(body, lens=(20, 120)):
        def seq(x0, n):
            def b(c, i):
                return body(imgs8[i % 8], c), jnp.float32(0)

            c, _ = jax.lax.scan(b, x0, jnp.arange(n, dtype=jnp.int32))
            return c

        walls = {}
        for n in lens:
            f = jax.jit(lambda x0, n=n: seq(x0, n))
            np.asarray(f(jnp.float32(0)))
            best = 1e9
            for _ in range(2):
                t0 = time.perf_counter()
                np.asarray(f(jnp.float32(0)))
                best = min(best, time.perf_counter() - t0)
            walls[n] = best
        n0, n1 = lens
        dt = (walls[n1] - walls[n0]) / (n1 - n0)
        fl, by = _cost(lambda x0: body(imgs8[0], x0), jnp.float32(0))
        return dt, fl, by

    def _dep(x):
        return jnp.mod(jnp.float32(x), 3.0) * 1e-5

    def _b_extract(im, c):
        f = fe.extract_mono(cfg, im + c)
        return c + _dep(
            jnp.sum(f.desc.astype(jnp.float32)) + jnp.sum(f.uv)
            + jnp.sum(f.angle)
        )

    def _b_frame(im, c):
        f = fe.extract_mono(cfg, im + c)
        res = tr.track_frame(
            m, f, T + c * 1e-6, prev_obs, cfg.K, jnp.asarray(0.0),
            height=H, width=W, n_levels=NLEV, n_local_kf=NKF,
            n_local_pt=4096, obs_A=obs_A,
        )
        return c + _dep(jnp.sum(res.T_cw))

    sol = {}
    for name, body in (("extract", _b_extract), ("frame", _b_frame)):
        dt_s, fl_s, by_s = _slope_time(body)
        bound_flops = fl_s / (peak_tf * 1e12)
        bound_bw = by_s / (peak_bw * 1e9)
        bound = max(bound_flops, bound_bw) or None
        sol[name] = {
            "device_ms": round(dt_s * 1e3, 3),
            "gflops": round(fl_s / 1e9, 2),
            "mbytes": round(by_s / 1e6, 1),
            "cost_basis": "xla_cost_analysis_one_call_lower_bound",
            "sol_ms": round(bound * 1e3, 4) if bound else None,
            "sol_bound": "bandwidth" if bound_bw >= bound_flops else "compute",
            "pct_of_sol": (
                round(100.0 * bound / dt_s, 1) if bound and dt_s > 0 else None
            ),
        }
    sol["tracking_minus_extract_ms"] = round(
        (sol["frame"]["device_ms"] - sol["extract"]["device_ms"]), 3
    )
    sol["note"] = (
        "device_ms from scan-length slope (dispatch excluded); sol_ms = "
        "max(flops/peak_bf16, bytes/peak_hbm); pose-opt's 26 sequential "
        "LM steps are latency-bound, so 'frame' sits structurally above "
        "its roofline bound"
    )

    _prog("cost analysis")
    # ---- MFU estimate for the tracking step ----
    achieved_tflops = (frame_flops * fps) / 1e12 if frame_flops else None
    mfu = (
        round(achieved_tflops / peak_tf, 4)
        if achieved_tflops is not None
        else None
    )

    print(
        json.dumps(
            {
                "metric": "tracking_fps_per_device",
                "value": round(fps, 2),
                "unit": "frames/sec",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "baseline_fps": BASELINE_FPS,
                "baseline_basis": "measured-i7 ~22ms median tracking "
                                  "(ORB-SLAM2 T-RO'17, README.md.bk:22)",
                "fps_amortized": round(fps_amortized, 2),
                "amortized_vs_baseline": round(fps_amortized / BASELINE_FPS, 3),
                "kf_every": KF_EVERY,
                "stage_ms": {
                    "extract": round(t_extract * 1e3, 3),
                    "track": round(t_track * 1e3, 3),
                    "map_triangulate": round(t_tri * 1e3, 3),
                    "map_fuse": round(t_fuse * 1e3, 3),
                    "map_local_ba": round(t_lba * 1e3, 3),
                    "map_kf_cull": round(t_cull * 1e3, 3),
                    "map_pipeline_fused": round(t_map * 1e3, 3),
                    "note": "singleton stages each include one "
                            "host->device dispatch round-trip; "
                            "map_pipeline_fused is the one-dispatch "
                            "keyframe-rate cost used for fps_amortized",
                },
                "tracking_achieved_tflops": (
                    round(achieved_tflops, 3) if achieved_tflops else None
                ),
                "speed_of_light": sol,
                "device_kind": kind,
                "device_count": len(jax.devices()),
                "card": card,
                "peaks": peak,
                "mfu_estimate": mfu,
                "platform": dev.platform,
            }
        )
    )


if __name__ == "__main__":
    main()
