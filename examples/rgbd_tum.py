"""RGB-D TUM driver (reference Examples/RGB-D/rgbd_tum.cc).

Usage: python examples/rgbd_tum.py <settings.yaml> <sequence_dir> \
          <associations.txt> [traj_out]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, assoc, traj_out="trajectory_tum.txt"):
    import cv2
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.utils import config, datasets, metrics, trajectory

    settings = config.load_settings(settings_path)
    items_in = datasets.load_tum_associations(seq_dir, assoc)
    probe = cv2.imread(items_in[0][1], cv2.IMREAD_GRAYSCALE)
    h, w = probe.shape
    fcfg = config.frontend_config_from_settings(settings, h, w)
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(
            max_keyframes=512, max_points=65536,
            n_features=fcfg.n_features, n_levels=fcfg.n_levels,
        ),
        sensor="rgbd",
        depth_factor=config.depth_map_factor(settings),
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
    )
    slam = sysm.System(cfg)

    times = []
    for ts, rgb_p, d_p in items_in:
        img = datasets.load_gray(rgb_p)
        # raw uint16 depth counts: DepthMapFactor scaling happens on device
        # (cfg.depth_factor), and the uint16 upload is 2x smaller
        depth = cv2.imread(d_p, cv2.IMREAD_UNCHANGED)
        t0 = time.perf_counter()
        slam.track_rgbd(img, depth, timestamp=ts)
        times.append(time.perf_counter() - t0)

    out = [
        (ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in slam.full_trajectory()
    ]
    trajectory.save_tum(traj_out, out)
    times = np.asarray(times)
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"trajectory saved to {traj_out}")


if __name__ == "__main__":
    if len(sys.argv) < 4:
        print(__doc__)
        raise SystemExit(1)
    main(*sys.argv[1:5])
