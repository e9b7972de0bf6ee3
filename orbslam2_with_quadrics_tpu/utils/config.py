"""Reference-compatible YAML configuration loader.

Accepts the exact key set the reference parses with cv::FileStorage
(src/Tracking.cc:53-147, src/Viewer.cc:33-51): ``Camera.*``,
``ORBextractor.*``, ``ThDepth``, ``DepthMapFactor`` — so the stock
Examples/*/[TUM1|KITTI00-02|EuRoC].yaml files port verbatim (modulo the
%YAML directive OpenCV requires, which is stripped here).
"""

from __future__ import annotations

import dataclasses

from ..models.frontend import FrontendConfig


def load_settings(path: str) -> dict:
    import re

    import yaml  # optional dependency: settings files only

    with open(path) as f:
        text = f.read()

    # strip OpenCV's "%YAML:1.0" directive and !!opencv-matrix tags which
    # PyYAML rejects (matrices become plain {rows, cols, dt, data} dicts);
    # cv::FileStorage tolerates "key:value" without a space (e.g.
    # "data:[..." in EuRoC.yaml LEFT.D, "Viewer.PointSize:2") — normalize
    lines = [
        re.sub(r"^(\s*[A-Za-z0-9_.]+):(?=\S)", r"\1: ",
               l.replace("!!opencv-matrix", ""))
        for l in text.splitlines()
        if not l.startswith("%YAML")
    ]
    return yaml.safe_load("\n".join(lines)) or {}


def opencv_matrix(settings: dict, key: str):
    """An OpenCV-matrix YAML node as a numpy array (cv::FileStorage '>>'
    semantics, reference Examples/Stereo/stereo_euroc.cc:72-95)."""
    import numpy as np

    node = settings.get(key)
    if node is None:
        return None
    return np.asarray(node["data"], np.float64).reshape(
        int(node["rows"]), int(node["cols"])
    )


def euroc_rectify_maps(settings: dict):
    """Stereo rectification maps from the LEFT.*/RIGHT.* settings blocks
    (reference stereo_euroc.cc:60-98 pre-rectifies EuRoC's unrectified
    images with cv::initUndistortRectifyMap before tracking). Host-side
    preprocessing, exactly as the reference does it. Returns
    ((M1l, M2l), (M1r, M2r)) or None if the settings carry no blocks."""
    import cv2

    K_l, K_r = opencv_matrix(settings, "LEFT.K"), opencv_matrix(settings, "RIGHT.K")
    if K_l is None or K_r is None:
        return None
    P_l, P_r = opencv_matrix(settings, "LEFT.P"), opencv_matrix(settings, "RIGHT.P")
    R_l, R_r = opencv_matrix(settings, "LEFT.R"), opencv_matrix(settings, "RIGHT.R")
    D_l, D_r = opencv_matrix(settings, "LEFT.D"), opencv_matrix(settings, "RIGHT.D")
    size_l = (int(settings["LEFT.width"]), int(settings["LEFT.height"]))
    size_r = (int(settings["RIGHT.width"]), int(settings["RIGHT.height"]))
    M1l, M2l = cv2.initUndistortRectifyMap(
        K_l, D_l, R_l, P_l[:3, :3], size_l, cv2.CV_32F
    )
    M1r, M2r = cv2.initUndistortRectifyMap(
        K_r, D_r, R_r, P_r[:3, :3], size_r, cv2.CV_32F
    )
    return (M1l, M2l), (M1r, M2r)


def frontend_config_from_settings(
    settings: dict, height: int, width: int
) -> FrontendConfig:
    g = settings.get
    return FrontendConfig(
        height=height,
        width=width,
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        th_fast=float(g("ORBextractor.iniThFAST", 20)),
        th_fast_min=float(g("ORBextractor.minThFAST", 7)),
        fx=float(g("Camera.fx", 500.0)),
        fy=float(g("Camera.fy", 500.0)),
        cx=float(g("Camera.cx", width / 2)),
        cy=float(g("Camera.cy", height / 2)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        bf=float(g("Camera.bf", 0.0)),
        depth_th=float(g("ThDepth", 40.0)),
    )


def camera_fps(settings: dict) -> float:
    return float(settings.get("Camera.fps", 30.0))


def depth_map_factor(settings: dict) -> float:
    f = float(settings.get("DepthMapFactor", 1.0))
    return 1.0 / f if abs(f) > 1e-5 else 1.0
