"""End-to-end example-driver tests on a generated on-disk TUM sequence.

The reference's example binaries are its only integration surface
(Examples/Monocular/mono_tum.cc:36-132, Examples/RGB-D/rgbd_tum.cc):
this exercises the full driver contract — reference-format YAML parsing
(utils/config.py), TUM dataset listers (utils/datasets.py), image
decode, per-frame tracking, and TUM trajectory export — then scores ATE
against the written groundtruth.txt exactly as TUM's evaluate_ate.py
would.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_driver(script, args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=1500,
    )
    assert r.returncode == 0, (
        f"{script} failed\nstdout:{r.stdout[-3000:]}\nstderr:{r.stderr[-3000:]}"
    )
    return r


def _load_tum(path):
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.split()])
    return np.asarray(rows)


def _ate_vs_groundtruth(traj_path, gt_path, with_scale):
    from orbslam2_with_quadrics_tpu.utils import metrics

    est = _load_tum(traj_path)
    gt = {round(r[0], 4): r[1:4] for r in _load_tum(gt_path)}
    pairs = [
        (r[1:4], gt[round(r[0], 4)]) for r in est if round(r[0], 4) in gt
    ]
    assert len(pairs) >= 50, f"only {len(pairs)} matched timestamps"
    e = np.asarray([p[0] for p in pairs])
    g = np.asarray([p[1] for p in pairs])
    # TUM files store camera CENTERS (T_wc translation) on both sides
    ate = metrics.ate_rmse(e, g, with_scale=with_scale)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return ate, span


@pytest.mark.slow
def test_mono_tum_driver_end_to_end(tmp_path):
    from orbslam2_with_quadrics_tpu.utils import synthetic

    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_tum_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=1, motion="strafe",
        sensor="mono", n_features=600,
    )
    traj = str(tmp_path / "traj.txt")
    r = _run_driver("examples/mono_tum.py", [settings, seq, traj], str(tmp_path))
    assert "median tracking time" in r.stdout
    ate, span = _ate_vs_groundtruth(
        traj, os.path.join(seq, "groundtruth.txt"), with_scale=True
    )
    assert ate < 0.05 * span, f"mono driver ATE {ate} vs span {span}"


@pytest.mark.slow
def test_stereo_kitti_driver_end_to_end(tmp_path):
    """examples/stereo_kitti.py on a generated KITTI-layout sequence,
    checking the KITTI trajectory-export format (3x4 T_wc rows,
    src/System.cc:419-472) against the written poses.txt ground truth."""
    from orbslam2_with_quadrics_tpu.utils import synthetic

    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_kitti_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=5, motion="strafe",
        n_features=600,
    )
    traj = str(tmp_path / "traj_kitti.txt")
    r = _run_driver("examples/stereo_kitti.py", [settings, seq, traj],
                    str(tmp_path))
    assert "median tracking time" in r.stdout
    est = _load_tum(traj)           # 12 floats/row (KITTI format)
    gt = _load_tum(os.path.join(seq, "poses.txt"))
    assert est.shape[1] == 12, "KITTI rows must be 3x4 row-major"
    assert len(est) == len(gt)
    e = est[:, [3, 7, 11]]          # T_wc translation column
    g = gt[:, [3, 7, 11]]
    from orbslam2_with_quadrics_tpu.utils import metrics

    # metric sensor: rigid alignment only
    ate = metrics.ate_rmse(e, g, with_scale=False)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert ate < 0.05 * span, f"stereo driver ATE {ate} vs span {span}"


@pytest.mark.slow
def test_rgbd_tum_driver_end_to_end(tmp_path):
    from orbslam2_with_quadrics_tpu.utils import synthetic

    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_tum_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=2, motion="strafe",
        sensor="rgbd", n_features=600,
    )
    traj = str(tmp_path / "traj.txt")
    r = _run_driver(
        "examples/rgbd_tum.py",
        [settings, seq, os.path.join(seq, "associations.txt"), traj],
        str(tmp_path),
    )
    assert "median tracking time" in r.stdout
    ate, span = _ate_vs_groundtruth(
        traj, os.path.join(seq, "groundtruth.txt"), with_scale=False
    )
    # metric sensor: no scale alignment; depth noise-free -> tight
    assert ate < 0.05 * span, f"rgbd driver ATE {ate} vs span {span}"
