"""Stereo end-to-end smoke at KITTI-like scale.

    python scripts/smoke_stereo.py [n_frames] [--kitti-scale]

Default: 320x240 quick check. --kitti-scale runs 1226x370 with 2000
features (the reference KITTI00-02.yaml workload) to validate shapes and
throughput at full size.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np


def main(n_frames=16, kitti_scale=False):
    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.utils import metrics, synthetic

    if kitti_scale:
        H, W, FX, NF, NL = 370, 1226, 718.9, 2048, 8
        mcfg = ms.MapConfig(
            max_keyframes=128, max_points=32768, n_features=NF, n_levels=NL
        )
    else:
        H, W, FX, NF, NL = 240, 320, 260.0, 512, 4
        mcfg = ms.MapConfig(
            max_keyframes=32, max_points=8192, n_features=NF, n_levels=NL
        )

    b = 0.2
    imgs_l, imgs_r, poses_gt, K = synthetic.planar_sequence_stereo(
        n_frames=n_frames, h=H, w=W, fx=FX, fy=FX, baseline=b, seed=5
    )
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=H, width=W, n_features=NF, n_levels=NL,
            fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=b * FX,
        ),
        map=mcfg,
        sensor="stereo",
        max_frames_between_kf=5,
    )
    slam = sysm.System(cfg)
    t0 = time.time()
    for i in range(n_frames):
        slam.track_stereo(imgs_l[i], imgs_r[i], timestamp=i / 10.0)
        if i % 4 == 0:
            print(
                f"frame {i} state={slam.state} kfs={int(slam.map.n_kf)} "
                f"pts={int(slam.map.n_pt)} t={time.time()-t0:.1f}s",
                flush=True,
            )
    est = [metrics.se3_vec_to_mat(T7) for _, _, T7 in slam.full_trajectory()]
    gt = [poses_gt[fid] for fid, _, _ in slam.full_trajectory()]
    ate = metrics.ate_rmse(
        metrics.camera_centers_from_Tcw(est),
        metrics.camera_centers_from_Tcw(gt),
        with_scale=False,
    )
    print(f"stereo ATE (metric, no scale align): {ate:.4f}")
    ok = ate < 0.15
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 16
    raise SystemExit(main(n, kitti_scale="--kitti-scale" in sys.argv))
