"""Monocular KITTI driver (reference Examples/Monocular/mono_kitti.cc).

Usage: python examples/mono_kitti.py <settings.yaml> <sequence_dir> [out] [vocab]
Writes the TUM-format keyframe trajectory (monocular is up-to-scale, so the
full KITTI-format saver is reserved for stereo, as in the reference).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, traj_out="keyframes_mono_kitti.txt", vocab=None):
    import cv2
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader
    from orbslam2_with_quadrics_tpu.utils import config, datasets, metrics, trajectory

    settings = config.load_settings(settings_path)
    times_arr, paths = datasets.load_kitti_mono(seq_dir)
    probe = cv2.imread(paths[0], cv2.IMREAD_GRAYSCALE)
    h, w = probe.shape
    fcfg = config.frontend_config_from_settings(settings, h, w)
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(
            max_keyframes=1024, max_points=131072,
            n_features=fcfg.n_features, n_levels=fcfg.n_levels,
        ),
        sensor="mono",
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
        vocab_path=vocab,
    )
    slam = sysm.System(cfg)

    times = []
    with AsyncImageLoader(paths, n_threads=2) as loader:
        for ts, (img, _) in zip(times_arr, loader):
            t0 = time.perf_counter()
            slam.track_monocular(img, timestamp=float(ts))
            times.append(time.perf_counter() - t0)

    slam.shutdown()
    slam.save_keyframe_trajectory_tum(traj_out)
    times = np.asarray(times)
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"keyframes: {int(slam.map.n_kf)} loops: {slam.n_loops_closed}")
    print(f"trajectory saved to {traj_out}")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    main(*sys.argv[1:5])
