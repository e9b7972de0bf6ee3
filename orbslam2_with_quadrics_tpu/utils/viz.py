"""Visualization: frame overlays + map snapshots (reference L6).

Host-side, off the hot path — replaces the reference's Pangolin GUI thread
(src/Viewer.cc, src/FrameDrawer.cc, src/MapDrawer.cc) with render-to-image
utilities usable headless (the accelerator build targets servers, not desktops):

- ``draw_frame``: keypoint + track overlay with the reference's
  "KFs / MPs / Matches" HUD line (FrameDrawer::DrawFrame,
  src/FrameDrawer.cc:129-166)
- ``draw_map``: top-down map-point / keyframe / covisibility render
  (MapDrawer::Draw*, src/MapDrawer.cc:44-228), including the quadric
  ellipses the reference left as a todo (include/MapDrawer.h:47)
"""

from __future__ import annotations

import numpy as np


def draw_frame(img, feats, obs_point, state_text=""):
    """Overlay keypoints on a grayscale frame -> uint8 BGR image."""
    import cv2

    vis = cv2.cvtColor(
        np.clip(np.asarray(img), 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR
    )
    uv = np.asarray(feats.uv)
    valid = np.asarray(feats.valid)
    matched = np.asarray(obs_point) >= 0
    for i in range(len(uv)):
        if not valid[i]:
            continue
        p = (int(uv[i, 0]), int(uv[i, 1]))
        if matched[i]:
            cv2.rectangle(
                vis, (p[0] - 3, p[1] - 3), (p[0] + 3, p[1] + 3), (0, 255, 0), 1
            )
        else:
            cv2.circle(vis, p, 1, (120, 120, 120), -1)
    if state_text:
        cv2.putText(
            vis, state_text, (8, vis.shape[0] - 8), cv2.FONT_HERSHEY_PLAIN,
            0.9, (255, 255, 255), 1,
        )
    return vis


def draw_map(m, quadric_landmarks=None, size=800, axes=(0, 1)):
    """Orthographic map render (points, keyframe frusta, quadric ellipses)
    -> uint8 BGR image. ``axes`` picks the two world axes to plot."""
    import cv2

    from ..models import map_state as ms

    vis = np.full((size, size, 3), 20, np.uint8)
    pts = np.asarray(m.pt_pos)[np.asarray(m.pt_valid)]
    centers = np.asarray(ms.camera_centers(m))[np.asarray(m.kf_valid)]
    if len(pts) == 0:
        return vis
    a, b = axes
    allxy = np.concatenate([pts[:, [a, b]], centers[:, [a, b]]], axis=0)
    lo = allxy.min(0) - 0.3
    hi = allxy.max(0) + 0.3
    scale = (size - 20) / max(float((hi - lo).max()), 1e-6)

    def to_px(xy):
        return ((xy - lo) * scale + 10).astype(np.int32)

    for p in to_px(pts[:, [a, b]]):
        cv2.circle(vis, tuple(p), 1, (180, 180, 180), -1)
    for c in to_px(centers[:, [a, b]]):
        cv2.circle(vis, tuple(c), 3, (0, 200, 0), -1)
    if quadric_landmarks:
        for lm in quadric_landmarks:
            if not getattr(lm, "initialized", False):
                continue
            ctr = np.asarray(lm.pose[4:7])[[a, b]]
            sc = np.asarray(lm.scale)[[a, b]]
            cv2.ellipse(
                vis, tuple(to_px(ctr)),
                (max(int(sc[0] * scale), 2), max(int(sc[1] * scale), 2)),
                0, 0, 360, (0, 120, 255), 1,
            )
    return vis


def save_metrics_jsonl(path, metrics_list):
    """Structured per-frame metrics (inliers, state...) to JSONL
    (rebuild of the reference's cout logging per SURVEY.md §5)."""
    import json

    with open(path, "w") as f:
        for row in metrics_list:
            f.write(json.dumps(row) + "\n")
