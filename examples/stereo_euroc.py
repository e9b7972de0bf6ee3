"""Stereo EuRoC driver (reference Examples/Stereo/stereo_euroc.cc).

EuRoC images are unrectified; like the reference, this pre-rectifies each
pair on the host with the LEFT.*/RIGHT.* calibration blocks from the
settings file (stereo_euroc.cc:60-98), then tracks the rectified pair.

Usage: python examples/stereo_euroc.py <settings.yaml> <sequence_dir> [out] [vocab]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(settings_path, seq_dir, traj_out="trajectory_euroc.txt", vocab=None):
    import cv2
    import numpy as np

    from orbslam2_with_quadrics_tpu.models import map_state as ms
    from orbslam2_with_quadrics_tpu.models import system as sysm
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader
    from orbslam2_with_quadrics_tpu.utils import config, datasets

    settings = config.load_settings(settings_path)
    maps = config.euroc_rectify_maps(settings)
    if maps is None:
        raise SystemExit(
            "settings file carries no LEFT.*/RIGHT.* rectification blocks "
            "(stereo_euroc.cc:66-70 aborts identically)"
        )
    (M1l, M2l), (M1r, M2r) = maps
    times_arr, lefts, rights = datasets.load_euroc_stereo(seq_dir)
    h, w = int(settings["LEFT.height"]), int(settings["LEFT.width"])
    fcfg = config.frontend_config_from_settings(settings, h, w)
    # rectified input: distortion already removed by the remap
    import dataclasses

    fcfg = dataclasses.replace(fcfg, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    cfg = sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(
            max_keyframes=1024, max_points=131072,
            n_features=fcfg.n_features, n_levels=fcfg.n_levels,
        ),
        sensor="stereo",
        max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True,
        vocab_path=vocab,
    )
    slam = sysm.System(cfg)

    times = []
    with AsyncImageLoader(lefts, n_threads=1) as ll, AsyncImageLoader(
        rights, n_threads=1
    ) as rl:
        for ts, (il, _), (ir, _) in zip(times_arr, ll, rl):
            il = cv2.remap(il, M1l, M2l, cv2.INTER_LINEAR)
            ir = cv2.remap(ir, M1r, M2r, cv2.INTER_LINEAR)
            t0 = time.perf_counter()
            slam.track_stereo(il, ir, timestamp=float(ts))
            times.append(time.perf_counter() - t0)

    slam.shutdown()
    slam.save_trajectory_tum(traj_out)
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
