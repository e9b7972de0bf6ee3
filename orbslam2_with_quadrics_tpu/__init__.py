"""orbslam2_with_quadrics_tpu — a visual SLAM engine for one NVIDIA H100.

A from-scratch JAX/XLA re-design of the capabilities of
yxqc/ORBSLAM2_with_quadrics (ORB-SLAM2 + dual-quadric object landmarks):

- ``ops``      — device compute kernels: Lie groups, camera models, ORB
                 feature pyramid (FAST/orientation/BRIEF), Hamming matching,
                 RANSAC solvers, Levenberg-Marquardt, Schur-complement bundle
                 adjustment, Sim3 pose graphs, dual quadrics, binary BoW.
- ``models``   — the SLAM pipelines built from those ops: frontend, tracking,
                 local mapping, loop closing, the System facade, and the
                 struct-of-arrays map state.
- ``parallel`` — multi-device/multi-host sharding: mesh helpers, distributed
                 Schur BA over ``shard_map``, sharded loop retrieval.
- ``utils``    — configs (reference-compatible YAML keys), dataset loaders
                 (TUM/KITTI/synthetic), trajectory export, metrics.

Design stance (vs the C++/pthread reference): fixed-capacity padded
struct-of-arrays map state, pure jitted functions with ``vmap``/``lax`` control
flow, masking instead of deletion, and a thin host orchestrator instead of the
reference's four mutex-coupled threads (reference: src/System.cc:89-103).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compile cache: JAX itself reads JAX_COMPILATION_CACHE_DIR when
# it is set; otherwise the cache lives at one fixed path next to the
# package (the path is part of the cache key, so it must not move).
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

# Geometry (Lie ops, Jacobians, Schur solves) needs true f32 matmuls. On
# the H100 the default precision computes f32 products in TF32 (about 10
# mantissa bits), which breaks pose and BA convergence in 3x3 products.
# Products that are exact at lower precision ask for it explicitly via
# preferred_element_type / dtype casts.
_jax.config.update("jax_default_matmul_precision", "highest")
