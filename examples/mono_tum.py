"""Monocular TUM driver (reference Examples/Monocular/mono_tum.cc).

Usage: python examples/mono_tum.py <settings.yaml> <sequence_dir>
           [traj_out] [detections_dir]

The reference CLI is `mono_tum vocab settings sequence`; the vocabulary
argument is gone because a pretrained vocabulary asset ships with the
package (assets/vocab_100k.npz, see models/system.py).

``detections_dir``: optional per-frame object-detection files (the
reference's dead "offline detection" stub, mono_tum.cc:74-78, made
real): one `<frame_basename>.txt` per image in the
read_obj_detection_txt format (x y w h prob class per line,
matrix_utils.h:49-54) enables the dual-quadric landmark pipeline
(BASELINE config #4).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, traj_out="trajectory_tum.txt",
         detections_dir=None):
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader
    from orbslam2_with_quadrics_tpu.utils import config, datasets, metrics, trajectory

    settings = config.load_settings(settings_path)
    rgb = datasets.load_tum_rgb_list(seq_dir)
    import cv2

    probe = cv2.imread(rgb[0][1], cv2.IMREAD_GRAYSCALE)
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
        enable_quadrics=detections_dir is not None,
    )
    slam = sysm.System(cfg)

    def dets_for(img_path):
        if detections_dir is None:
            return None
        base = os.path.splitext(os.path.basename(img_path))[0]
        det_path = os.path.join(detections_dir, base + ".txt")
        if not os.path.exists(det_path):
            return None
        return datasets.read_obj_detection_txt(det_path)

    times = []
    with AsyncImageLoader([p for _, p in rgb], n_threads=2) as loader:
        for (ts, path), (img, _) in zip(rgb, loader):
            t0 = time.perf_counter()
            slam.track_monocular(img, timestamp=ts, detections=dets_for(path))
            times.append(time.perf_counter() - t0)

    from orbslam2_with_quadrics_tpu.utils import viz

    items = [
        (ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in slam.full_trajectory()
    ]
    trajectory.save_tum(traj_out, items)
    viz.save_metrics_jsonl(traj_out + ".metrics.jsonl", slam.metrics)
    times = np.asarray(times)
    # median/mean tracking time report, like the reference driver
    # (Examples/Monocular/mono_tum.cc:120-129)
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"keyframes: {int(slam.map.n_kf)} points: {int(slam.map.n_pt)} "
          f"loops: {slam.n_loops_closed}")
    print(f"trajectory saved to {traj_out}")


if __name__ == "__main__":
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    main(*sys.argv[1:5])
