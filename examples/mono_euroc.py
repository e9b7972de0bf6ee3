"""Monocular EuRoC driver (reference Examples/Monocular/mono_euroc.cc).

Usage: python examples/mono_euroc.py <settings.yaml> <mav_seq_dir> [traj_out]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, traj_out="trajectory_tum.txt"):
    import cv2
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader
    from orbslam2_with_quadrics_tpu.utils import config, datasets, metrics, trajectory, viz

    settings = config.load_settings(settings_path)
    items = datasets.load_euroc_mono(seq_dir)
    probe = cv2.imread(items[0][1], cv2.IMREAD_GRAYSCALE)
    h, w = probe.shape
    fcfg = config.frontend_config_from_settings(settings, h, w)
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(
            max_keyframes=512, max_points=65536,
            n_features=fcfg.n_features, n_levels=fcfg.n_levels,
        ),
        sensor="mono",
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
    )
    slam = sysm.System(cfg)

    times = []
    with AsyncImageLoader([p for _, p in items], n_threads=2) as loader:
        for (ts, _), (img, _) in zip(items, loader):
            t0 = time.perf_counter()
            slam.track_monocular(img, timestamp=ts)
            times.append(time.perf_counter() - t0)

    out = [
        (ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in slam.full_trajectory()
    ]
    trajectory.save_tum(traj_out, out)
    viz.save_metrics_jsonl(traj_out + ".metrics.jsonl", slam.metrics)
    times = np.asarray(times)
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"trajectory saved to {traj_out}")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    main(*sys.argv[1:4])
