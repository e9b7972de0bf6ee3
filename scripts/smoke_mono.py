"""End-to-end smoke drive: mono SLAM on a synthetic planar sequence.

Used by /verify and as a quick manual sanity check:
    python scripts/smoke_mono.py [n_frames]
Prints per-frame tracking state and final ATE RMSE vs ground truth.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

from orbslam2_with_quadrics_tpu.models import frontend as fe
from orbslam2_with_quadrics_tpu.models import map_state as ms
from orbslam2_with_quadrics_tpu.models import system as sysm
from orbslam2_with_quadrics_tpu.utils import metrics, synthetic

import numpy as np


def main(n_frames=30, h=240, w=320):
    imgs, poses_gt, K = synthetic.planar_sequence(
        n_frames=n_frames, h=h, w=w, fx=260.0, fy=260.0, seed=3
    )
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=h, width=w, n_features=512, n_levels=4,
            fx=float(K[0]), fy=float(K[1]), cx=float(K[2]), cy=float(K[3]),
        ),
        map=ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512,
                         n_levels=4),
        max_frames_between_kf=10,
    )
    slam = sysm.System(cfg)
    t0 = time.time()
    for i in range(n_frames):
        T = slam.track_monocular(imgs[i], timestamp=i / 30.0)
        st = {0: "INIT", 1: "OK", 2: "LOST"}[slam.state]
        if i % 5 == 0 or st != "OK":
            inl = slam.metrics[-1]["inliers"] if slam.metrics else -1
            print(
                f"frame {i:3d} state={st} kfs={int(slam.map.n_kf)} "
                f"pts={int(slam.map.n_pt)} inliers={inl} "
                f"t={time.time()-t0:.1f}s"
            )
    traj = slam.full_trajectory()
    est, gt = [], []
    for fid, ts, T7 in traj:
        if slam.state != sysm.System.NOT_INITIALIZED:
            est.append(metrics.se3_vec_to_mat(T7))
            gt.append(poses_gt[fid])
    if len(est) < 10:
        print("FAIL: tracked <10 frames")
        return 1
    ate = metrics.ate_rmse(
        metrics.camera_centers_from_Tcw(est), metrics.camera_centers_from_Tcw(gt)
    )
    span = np.linalg.norm(
        metrics.camera_centers_from_Tcw(gt).max(0)
        - metrics.camera_centers_from_Tcw(gt).min(0)
    )
    print(f"tracked {len(est)}/{n_frames} frames  ATE RMSE={ate:.4f} (span {span:.2f})")
    ok = ate < 0.05 * span
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    raise SystemExit(main(n))
