"""Stereo KITTI driver (reference Examples/Stereo/stereo_kitti.cc).

Usage: python examples/stereo_kitti.py <settings.yaml> <sequence_dir> [out]
Writes the KITTI-format trajectory for the odometry devkit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, traj_out="trajectory_kitti.txt"):
    import cv2
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader
    from orbslam2_with_quadrics_tpu.utils import config, datasets, metrics, trajectory

    settings = config.load_settings(settings_path)
    times_arr, lefts, rights = datasets.load_kitti_stereo(seq_dir)
    probe = cv2.imread(lefts[0], cv2.IMREAD_GRAYSCALE)
    h, w = probe.shape
    fcfg = config.frontend_config_from_settings(settings, h, w)
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(
            max_keyframes=1024, max_points=131072,
            n_features=fcfg.n_features, n_levels=fcfg.n_levels,
        ),
        sensor="stereo",
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
    )
    slam = sysm.System(cfg)

    times = []
    with AsyncImageLoader(lefts, n_threads=1) as ll, AsyncImageLoader(
        rights, n_threads=1
    ) as rl:
        for ts, (il, _), (ir, _) in zip(times_arr, ll, rl):
            t0 = time.perf_counter()
            slam.track_stereo(il, ir, timestamp=float(ts))
            times.append(time.perf_counter() - t0)

    out = [
        (ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in slam.full_trajectory()
    ]
    trajectory.save_kitti(traj_out, out)
    times = np.asarray(times)
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"keyframes: {int(slam.map.n_kf)} loops: {slam.n_loops_closed}")
    print(f"trajectory saved to {traj_out}")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    main(*sys.argv[1:4])
