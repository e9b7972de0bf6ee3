"""Per-frame perception frontend: ORB extraction + undistortion as one jit.

Replaces Frame's construction work (reference src/Frame.cc:61-228):
extraction, undistortion and (for stereo) left-right matching, producing a
fixed-capacity ``FrameFeatures``. The reference's 64x48 occupancy grid
(AssignFeaturesToGrid) has no equivalent here because matching is a dense
masked argmin (see ops/matching.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import camera, orb


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    height: int
    width: int
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast: float = 20.0
    th_fast_min: float = 7.0
    # intrinsics
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # fx * baseline (0 = mono)
    depth_th: float = 40.0   # ThDepth close/far gate (reference Tracking.cc:134)

    @property
    def K(self):
        return jnp.asarray([self.fx, self.fy, self.cx, self.cy])

    @property
    def dist(self):
        return jnp.asarray([self.k1, self.k2, self.p1, self.p2, self.k3])


class FrameFeatures(NamedTuple):
    uv: jnp.ndarray       # [N,2] raw keypoint pixels (level-0)
    uv_und: jnp.ndarray   # [N,2] undistorted pixels
    level: jnp.ndarray    # [N] int32
    angle: jnp.ndarray    # [N]
    score: jnp.ndarray    # [N]
    desc: jnp.ndarray     # [N,8] uint32
    valid: jnp.ndarray    # [N] bool
    ur: jnp.ndarray       # [N] right-image u (<0 where unavailable)
    depth: jnp.ndarray    # [N] depth (<=0 where unavailable)


@partial(jax.jit, static_argnames=("cfg",))
def extract_mono(cfg: FrontendConfig, img) -> FrameFeatures:
    # accept any integer camera dtype: the uint8 frame uploads 4x less
    # link bandwidth than float32; the cast runs on device
    img = img.astype(jnp.float32)
    f = orb.extract(
        img,
        n_features=cfg.n_features,
        n_levels=cfg.n_levels,
        scale=cfg.scale_factor,
        th_fast=cfg.th_fast,
        th_fast_min=cfg.th_fast_min,
    )
    und = camera.undistort_points(cfg.K, cfg.dist, f.uv)
    n = f.uv.shape[0]
    return FrameFeatures(
        uv=f.uv,
        uv_und=und,
        level=f.level,
        angle=f.angle,
        score=f.score,
        desc=f.desc,
        valid=f.valid,
        ur=jnp.full((n,), -1.0),
        depth=jnp.zeros((n,)),
    )


@partial(jax.jit, static_argnames=("cfg",))
def extract_rgbd(cfg: FrontendConfig, img, depth) -> FrameFeatures:
    """RGB-D: depth lookup at keypoints -> pseudo right coordinate
    (reference ComputeStereoFromRGBD, src/Frame.cc:643-664)."""
    f = extract_mono(cfg, img)
    yx = jnp.stack(
        [
            jnp.clip(jnp.round(f.uv[:, 1]).astype(jnp.int32), 0, depth.shape[0] - 1),
            jnp.clip(jnp.round(f.uv[:, 0]).astype(jnp.int32), 0, depth.shape[1] - 1),
        ],
        axis=-1,
    )
    d = depth[yx[:, 0], yx[:, 1]]
    has = d > 0
    ur = jnp.where(has, f.uv_und[:, 0] - cfg.bf / jnp.maximum(d, 1e-6), -1.0)
    return f._replace(ur=ur, depth=jnp.where(has, d, 0.0))


@partial(jax.jit, static_argnames=("cfg",))
def extract_stereo(cfg: FrontendConfig, img_l, img_r) -> FrameFeatures:
    """Stereo: extract both images, row-constrained descriptor match + SAD
    subpixel refinement (reference ComputeStereoMatches,
    src/Frame.cc:466-640)."""
    from ..ops import stereo as stereo_ops

    img_l = img_l.astype(jnp.float32)
    img_r = img_r.astype(jnp.float32)
    fl = extract_mono(cfg, img_l)
    fr = orb.extract(
        img_r,
        n_features=cfg.n_features,
        n_levels=cfg.n_levels,
        scale=cfg.scale_factor,
        th_fast=cfg.th_fast,
        th_fast_min=cfg.th_fast_min,
    )
    ur, depth = stereo_ops.stereo_match(cfg, img_l, img_r, fl, fr)
    return fl._replace(ur=ur, depth=depth)
