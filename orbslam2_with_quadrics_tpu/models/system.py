"""System facade: the full SLAM state machine.

Array-native rebuild of ``System`` + the Tracking state machine
(reference src/System.cc, src/Tracking.cc:267-506). The reference's four
mutex-coupled threads become a host orchestrator over jitted device
functions operating on an immutable MapState snapshot; mapping work runs
inline after keyframe insertion (async dispatch is a later optimization —
JAX dispatch is already asynchronous, so extraction/tracking/mapping
pipeline naturally on device).

Sensor modes: MONOCULAR / STEREO / RGBD (reference include/System.h:66-70).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import init2view, lie, matching, orb
from . import frontend as fe
from . import local_mapping as lm
from . import map_state as ms
from . import tracking as tr


@dataclasses.dataclass
class SystemConfig:
    frontend: fe.FrontendConfig
    map: ms.MapConfig
    sensor: str = "mono"            # mono | stereo | rgbd
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    kf_idle_frames: int = 3         # sync-pipeline analogue of the
                                    # bLocalMappingIdle gate in c1b
                                    # (src/Tracking.cc:999,1029): threaded
                                    # mapping occupies the mapping core for
                                    # ~this many frame periods per keyframe,
                                    # so back-to-back insertion (and the
                                    # insert-then-cull churn it causes) is
                                    # impossible in the reference; c1a/c1c
                                    # still force insertion regardless
    kf_ref_ratio: float = 0.9       # (src/Tracking.cc:1027-1044 thRefRatio)
    kf_stereo_ref_ratio: float = 0.75  # thRefRatio for stereo/RGB-D
                                    # (src/Tracking.cc:1021; raise toward
                                    # 1.0 for denser keyframes on scenes
                                    # where inliers decay slowly)
    kf_close_tracked_th: int = 100  # bNeedToInsertClose: tracked close pts
    kf_close_untracked_th: int = 70 # below/above these -> insert
                                    # (src/Tracking.cc:1016; the constants
                                    # assume ~2000-feature frames — scale
                                    # down for smaller feature budgets)
    kf_redundancy_th: float = 0.9   # skip c1b insertion when >= this
                                    # fraction of the frame's tracked
                                    # points already meet the
                                    # KeyFrameCulling criterion (>=3 obs
                                    # at same-or-finer octave,
                                    # src/LocalMapping.cc:661-668) — the
                                    # cull's 90% rule applied BEFORE
                                    # paying for insertion. Deliberate
                                    # deviation from the reference, which
                                    # inserts and then culls (r04: 361
                                    # created / 10 live on revisit-heavy
                                    # motion); 1.0 disables the gate.
                                    # Never overrides c1a (the forced
                                    # mMaxFrames cadence): loop detection
                                    # is keyframe-triggered, so mature
                                    # stretches must still emit keyframes
    kf_strong_inl: int = 100        # the veto needs tracking to be strong
                                    # in ABSOLUTE terms. When tracking
                                    # degrades, young points fail to
                                    # match first, so the survivors are
                                    # the mature ones and the redundancy
                                    # ratio RISES exactly when insertion
                                    # is most needed (measured: veto at
                                    # n_inl 55/red 0.94 where the ungated
                                    # system inserted and recovered —
                                    # the gated run went LOST for good)
    min_inliers_track: int = 30
    min_inliers_kf: int = 15
    local_ba_window: int = 16
    depth_factor: float = 1.0       # RGB-D depth map scaling
    enable_loop_closing: bool = False
    vocab_k: int = 10               # lazily-trained vocabulary branching
    vocab_levels: int = 4           # 10^4 words (BoW discrimination needs
                                    # head-room over the per-frame word count)
    vocab_train_kfs: int = 4        # train once this many KFs accumulated
    vocab_path: Optional[str] = "auto"  # pretrained vocabulary: .txt = DBoW2
                                    # text format (the reference's ORBvoc.txt,
                                    # System.cc:64-71), else this repo's .npz;
                                    # 'auto' = the shipped assets/vocab_*.npz
                                    # (trained by scripts/train_vocab.py on
                                    # this repo's own BRIEF pattern), falling
                                    # back to lazy per-sequence training when
                                    # no asset exists; None = always lazy
    enable_quadrics: bool = False
    async_gba: bool = False         # run post-loop global BA in a background
                                    # thread like the reference's transient
                                    # 4th thread (LoopClosing.cc:579), with
                                    # spanning-tree propagation to KFs/points
                                    # created meanwhile; False = inline GBA
                                    # (deterministic, used by most tests)
    quadric_min_points: int = 15    # QuadricLandmark validity gate
                                    # (reference QuadricLandmark.cc:128-147)
    n_local_kf: int = 64            # local-map window (ref cap 80,
                                    # src/Tracking.cc:1285)
    n_local_pt: int = 4096          # local point budget for tracking


def _default_vocab_asset() -> Optional[str]:
    """The shipped pretrained vocabulary (the reference always loads a
    pretrained ORBvoc, src/System.cc:64-71). Largest assets/vocab_*.npz
    wins; None when the package ships without one (lazy training)."""
    import glob

    adir = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
    cands = sorted(
        glob.glob(os.path.join(adir, "vocab_*.npz")),
        key=os.path.getsize,
    )
    return cands[-1] if cands else None


class System:
    """Facade mirroring System::Track{Monocular,Stereo,RGBD}
    (reference src/System.cc:116-268)."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, cfg: SystemConfig):
        # metric sensors need bf = fx*baseline: the close-point gates are
        # depth < ThDepth*bf/fx (reference src/Tracking.cc:134-147), so
        # bf=0 would silently create ZERO depth points at initialization
        # and the system would never track (seen: rgbd driver flatlined at
        # 29.6% ATE because the settings YAML omitted Camera.bf)
        if cfg.sensor in ("stereo", "rgbd") and not cfg.frontend.bf > 0:
            raise ValueError(
                f"sensor={cfg.sensor!r} requires frontend.bf > 0 "
                "(Camera.bf in reference YAML = fx * baseline); got "
                f"bf={cfg.frontend.bf}"
            )
        self.cfg = cfg
        self.map = ms.empty_map(cfg.map)
        self.state = self.NOT_INITIALIZED
        self.frame_id = 0
        self.last_kf_frame = -999
        self.ref_kf_matches = 0
        self.velocity = lie.se3_identity()
        self.T_cw = lie.se3_identity()
        self.prev_obs = jnp.full((cfg.map.n_features,), -1, jnp.int32)
        self.init_feats = None
        self.init_frame_id = -1
        self.trajectory = []  # (frame_id, timestamp, kf_slot, T_rel  np arrays)
        self.ref_kf = 0
        self.n_kfs_created = 0
        self.n_kfs_culled = 0  # fast-path cull counter (churn metric)
        self.n_reloc_corrections = 0  # reloc-triggered loop corrections
        self._debug_kf = os.environ.get("ORB_DEBUG_KF", "") == "1"
        _, _, self._inv_sigma2 = orb.scale_factors(
            cfg.frontend.n_levels, cfg.frontend.scale_factor
        )
        self.metrics = []
        self._obs_A_src = None  # (kf_obs_point, kf_kp_valid, kf_valid) refs
        self._obs_A = None
        # loop closing (lazily-trained vocabulary, reference expects a
        # pretrained ORBvoc.txt which this repo builds on the fly)
        self.loop_closer = None
        self._vocab_pool = []
        self.n_loops_closed = 0
        self._pretrained_voc = None
        vocab_path = cfg.vocab_path
        if vocab_path == "auto":
            vocab_path = _default_vocab_asset()
        if vocab_path:
            from ..ops import vocab as vocab_mod
            from .loop_closing import LoopCloser

            if vocab_path.endswith(".txt"):
                self._pretrained_voc = vocab_mod.load_dbow2_text(vocab_path)
            else:
                self._pretrained_voc = vocab_mod.load(vocab_path)
            self.loop_closer = LoopCloser(self._pretrained_voc, cfg.map)
        # quadric object landmarks
        self.quadrics = None
        if cfg.enable_quadrics:
            from .quadric_mapping import QuadricManager

            self.quadrics = QuadricManager(
                cfg.frontend.K, min_points=cfg.quadric_min_points
            )
        self._pending_detections = None
        self.frames_since_reloc = 999
        # localization-only mode (System::ActivateLocalizationMode,
        # src/System.cc:127-145 -> Tracking::InformOnlyTracking)
        self.only_tracking = False
        # async global BA (reference's transient GBA thread,
        # LoopClosing.cc:579,645-749)
        import threading

        self._gba_thread = None
        self._gba_result = None
        self._gba_gen = 0
        # guards the (gen check -> result store) pair in the worker and
        # the (gen bump -> result clear) pair on the main thread: without
        # it a compaction between the worker's check and its store lets a
        # result with stale (remapped) keyframe ids slip through
        self._gba_lock = threading.Lock()
        # bumped by point-pool compaction (point ids are remapped);
        # an async-GBA snapshot from an older epoch can still apply its
        # keyframe poses (kf ids are never remapped) but not its point ids
        self._map_epoch = 0
        # big-change counter for MapChanged() (reference Map::mnBigChangeIdx,
        # src/Map.cc:70-80, read by System::MapChanged src/System.cc:282-293)
        self._big_change_idx = 0
        self._last_big_change_idx = 0
        self.last_feats = None
        self._init_fe_cfg = None  # lazily-built 2x-feature init extractor
        self._n_ref_cache = None  # TrackedMapPoints cache (keyframe rate)
        # capacity-event observability (read by scripts/eval_full.py)
        self.n_point_compactions = 0
        self.n_point_growths = 0
        self.n_kf_compactions = 0
        self.n_kf_growths = 0
        # ---- fast-path (single-dispatch pipelined) tracking state ----
        # the steady-state OK path dispatches one fused _frame_step per
        # frame and consumes its prefetched stats ONE FRAME LATER, so
        # the host never blocks on the device (the reference's camera
        # thread similarly never waits for mapping). See _track_fast.
        # ORB_SYNC_TRACK=1 forces the synchronous _track path even in the
        # OK state — the fast/sync bisect switch (the two paths must agree;
        # eval regressions are bisected by diffing their trajectories)
        self._force_sync = os.environ.get("ORB_SYNC_TRACK", "") == "1"
        # bumped by reset(): lets _insert_keyframe_fast detect that a
        # flush inside _ensure_capacity_fast reset/lost the system and the
        # pending keyframe insertion must be abandoned
        self._reset_gen = 0
        self._pend = None          # previous frame awaiting processing
        self._map_aux = None       # in-flight _insert_and_map aux vector;
                                   # None = mapping idle (the reference's
                                   # AcceptKeyFrames flag)
        self._pending_loop = None  # (slot, prefetched detect arrays)
        self._n_kf_host = 0        # host mirror of map.n_kf
        self._kf_live = 0          # live keyframes (aux-updated)
        self._n_pt_est = 0         # point-pool high-water estimate
        self._n_ref_vals = {2: 1, 3: 1}  # ref-KF TrackedMapPoints
        self._extra_obs_holders = []     # frames whose obs need id remaps
        self._ref_anchor = None    # ref KF pose as the track chain saw it
                                   # (the _frame_step re-anchor input)
        self._red_cum = None       # [P, L] per-point obs-level histogram
                                   # (None = recompute lazily from the map;
                                   # invalidated whenever the observation
                                   # table mutates outside _insert_and_map)

    def _init_frontend(self):
        """2x-feature extractor config used only while NOT_INITIALIZED
        (reference mpIniORBextractor with 2*nFeatures,
        src/Tracking.cc:124-125); _mono_init compacts the surviving rows
        back to the map's per-keyframe feature budget."""
        if self._init_fe_cfg is None:
            self._init_fe_cfg = dataclasses.replace(
                self.cfg.frontend,
                n_features=2 * self.cfg.frontend.n_features,
            )
        return self._init_fe_cfg

    # ------------------------------------------------------------------
    # public per-frame entries
    # ------------------------------------------------------------------

    def track_monocular(self, img, timestamp=0.0, detections=None):
        """detections: optional [D,6] (x,y,w,h,prob,class) object boxes for
        the quadric pipeline (reference offline-detection format,
        matrix_utils.h:49-54)."""
        assert self.cfg.sensor == "mono", (
            "called track_monocular but sensor is not mono "
            "(reference System::TrackMonocular sensor check, src/System.cc:220-224)"
        )
        self._pending_detections = detections
        # keep the caller's dtype: a uint8 camera frame uploads 4x less
        # than float32; extraction casts on device
        img = jnp.asarray(img)
        if self.state == self.OK and not self._force_sync:
            return self._track_fast(img, None, timestamp)
        # before initialization the reference extracts 2x the features
        # (mpIniORBextractor, src/Tracking.cc:124-125, selected at :258)
        fcfg = (
            self._init_frontend()
            if self.state == self.NOT_INITIALIZED
            else self.cfg.frontend
        )
        feats = fe.extract_mono(fcfg, img)
        return self._track(feats, timestamp)

    def track_rgbd(self, img, depth, timestamp=0.0, detections=None):
        assert self.cfg.sensor == "rgbd", (
            "called track_rgbd but sensor is not rgbd (src/System.cc:169-173)"
        )
        self._pending_detections = detections
        img = jnp.asarray(img)
        depth = jnp.asarray(depth)
        if self.state == self.OK and not self._force_sync:
            return self._track_fast(img, depth, timestamp)
        feats = fe.extract_rgbd(
            self.cfg.frontend, img,
            depth.astype(jnp.float32) * self.cfg.depth_factor,
        )
        return self._track(feats, timestamp)

    def track_stereo(self, img_l, img_r, timestamp=0.0, detections=None):
        assert self.cfg.sensor == "stereo", (
            "called track_stereo but sensor is not stereo (src/System.cc:118-122)"
        )
        self._pending_detections = detections
        img_l = jnp.asarray(img_l)
        img_r = jnp.asarray(img_r)
        if self.state == self.OK and not self._force_sync:
            return self._track_fast(img_l, img_r, timestamp)
        feats = fe.extract_stereo(self.cfg.frontend, img_l, img_r)
        return self._track(feats, timestamp)

    # ------------------------------------------------------------------
    # mode switches / status getters (reference include/System.h:80-123)
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Stop map building; camera tracking only
        (System::ActivateLocalizationMode, src/System.cc:270-274 ->
        Tracking::InformOnlyTracking(true), src/Tracking.cc:1585-1588).
        With no mapping thread to stop, this is just a flag: keyframe
        insertion and all local-mapping work are skipped while set."""
        self.only_tracking = True

    def deactivate_localization_mode(self):
        """Resume SLAM (System::DeactivateLocalizationMode,
        src/System.cc:276-280)."""
        self.only_tracking = False

    def map_changed(self):
        """True if a big map change (loop closure / global BA / reset)
        happened since the last call (System::MapChanged,
        src/System.cc:282-293; counter Map::mnBigChangeIdx, src/Map.cc:70-80)."""
        changed = self._big_change_idx != self._last_big_change_idx
        self._last_big_change_idx = self._big_change_idx
        return changed

    def warmup(self, verbose: bool = False):
        """Precompile every jitted program the steady-state pipeline can
        dispatch, against the CURRENT pool shapes. XLA compiles lazily at
        first call, and a first-touch compile would stall the frame loop,
        so a camera-rate deployment compiles everything up front — the
        analogue of the reference spending ~10 s loading ORBvoc.txt before
        tracking starts (src/System.cc:64-71). Pure warm-up: all calls run
        on dummy inputs and are discarded."""
        import time as _time

        cfg = self.cfg
        fcfg = cfg.frontend
        m = self.map
        K, N = m.kf_obs_point.shape
        t0 = _time.time()

        def log(name):
            if verbose:
                import sys as _s

                print(f"[warmup] {name} ({_time.time() - t0:.0f}s)",
                      file=_s.stderr, flush=True)

        zimg = jnp.zeros((fcfg.height, fcfg.width), jnp.uint8)
        zaux = (
            jnp.zeros((fcfg.height, fcfg.width), jnp.uint16)
            if cfg.sensor == "rgbd" else zimg
        )
        obs_A = self._get_obs_A()
        feats, *_rest = _frame_step(
            m, obs_A, zimg, zaux, self.T_cw, self.velocity, self.prev_obs,
            np.int32(0), self.map.kf_pose[0],
            jnp.zeros((m.pt_pos.shape[0], fcfg.n_levels), jnp.float32),
            fcfg, cfg.sensor,
            cfg.min_inliers_track, min(cfg.n_local_kf, cfg.map.max_keyframes),
            min(cfg.n_local_pt, cfg.map.max_points), cfg.depth_factor,
        )
        log("frame_step")
        if cfg.sensor == "mono":
            # the init path extracts at 2x features (sync path)
            fe.extract_mono(self._init_frontend(), jnp.zeros(
                (fcfg.height, fcfg.width), jnp.uint8))
        m2, aux, _red = _insert_and_map(
            m, feats, self.T_cw, np.int32(0), np.int32(0),
            jnp.full((cfg.map.n_features,), -1, jnp.int32),
            np.zeros((K,), bool), self._inv_sigma2, fcfg, cfg.sensor,
            cfg.local_ba_window,
        )
        del m2, aux, _red
        log("insert_and_map")
        lm.run_global_ba(
            m, fcfg.K, jnp.asarray(fcfg.bf), self._inv_sigma2, n_iters=10
        )
        if cfg.sensor == "mono":
            lm.run_global_ba(
                m, fcfg.K, jnp.asarray(fcfg.bf), self._inv_sigma2, n_iters=20
            )
        log("global_ba")
        lcs = self.loop_closer
        if lcs is not None:
            from . import loop_closing as lc

            lcs.add_keyframe_from_map(m, 0)
            if lcs.sparse:
                lc._detect_prep_sparse(
                    m, lcs.kf_wid, lcs.kf_wval, lcs.words, lcs.voc.idf,
                    np.int32(0),
                )
            else:
                lc._detect_prep_dense(
                    m, lcs.bow, lcs.words, lcs.voc.idf, np.int32(0),
                    lcs.voc.n_words,
                )
            log("detect_prep")
            gates, S_corr, loop_ids = lc._sim3_geometry(
                m, lcs.words, np.int32(0), np.int32(1), fcfg.K,
                n_levels=fcfg.n_levels, scale=fcfg.scale_factor,
                height=fcfg.height, width=fcfg.width,
                fix_scale=cfg.sensor != "mono",
            )
            log("sim3_geometry")
            for E in (64, 128, 256):
                ei = jnp.zeros((E,), jnp.int32)
                w = jnp.zeros((E,), jnp.float32)
                S_old, S_init, meas = lc._graph_arrays(
                    m, np.int32(0), np.int32(1), S_corr,
                    jnp.zeros((K,), bool), ei, ei,
                    jnp.zeros((E,), bool),
                )
                from ..ops import pose_graph as pg

                pg.optimize_pose_graph(
                    S_init, ei, ei, meas, w,
                    jnp.zeros((K,), jnp.float32),
                )
            lc._apply_graph(m, S_old, S_init)
            lc.gather_loop_points(m, np.int32(0))
            lc.fuse_loop_points(
                m, jnp.asarray(0, jnp.int32), loop_ids, fcfg.K,
                n_levels=fcfg.n_levels, scale=fcfg.scale_factor,
                height=fcfg.height, width=fcfg.width,
            )
            log("graph+fuse")
            # relocalization path
            from ..ops import pnp, vocab as vocab_mod

            word, _ = vocab_mod.transform_any(lcs.voc, feats.desc, feats.valid)
            matching.mutual_match(
                feats.desc, feats.valid, m.kf_desc[0], m.kf_kp_valid[0],
                th=matching.TH_LOW, ratio=0.75,
            )
            pnp.ransac_pnp(
                m.pt_pos[:cfg.map.n_features], feats.uv_und,
                jnp.zeros((cfg.map.n_features,), bool), fcfg.K,
                self._inv_sigma2[
                    jnp.clip(feats.level, 0, self._inv_sigma2.shape[0] - 1)
                ],
            )
            log("reloc")
        jax.block_until_ready(self.map.kf_pose)
        log("done")

    def shutdown(self):
        """Flush all in-flight work (System::Shutdown joins the worker
        threads and spin-waits on isRunningGBA, src/System.cc:301-320; here
        that is the pending pipelined frame, the in-flight mapping
        dispatch, the async-GBA thread and JAX's dispatch queue). Call
        before saving trajectories, as the reference requires."""
        self._flush()
        self._consume_map_aux(block=True)
        self._apply_gba_if_ready(wait=True)
        jax.block_until_ready(self.map.kf_pose)
        jax.block_until_ready(self.T_cw)

    def get_tracking_state(self):
        """NOT_INITIALIZED / OK / LOST (System::GetTrackingState,
        src/System.cc:474-478)."""
        return self.state

    def get_tracked_map_points(self):
        """Map-point ids observed by the most recent frame, with their world
        positions (System::GetTrackedMapPoints, src/System.cc:480-484
        returns MapPoint pointers; ids+positions are the pytree analogue)."""
        obs = np.asarray(self.prev_obs)
        ids = obs[obs >= 0]
        return ids, np.asarray(self.map.pt_pos)[ids]

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints of the most recent frame
        (System::GetTrackedKeyPointsUn, src/System.cc:486-490)."""
        if self.last_feats is None:
            return np.zeros((0, 2), np.float32)
        valid = np.asarray(self.last_feats.valid)
        return np.asarray(self.last_feats.uv_und)[valid]

    # ------------------------------------------------------------------

    def reset(self):
        """Full system reset (reference System::Reset -> Tracking::Reset,
        src/Tracking.cc:1504-1550): clears the map, database and state."""
        cfg = self.cfg
        self.map = ms.empty_map(cfg.map)
        self.state = self.NOT_INITIALIZED
        self.velocity = lie.se3_identity()
        self.T_cw = lie.se3_identity()
        self.prev_obs = jnp.full((cfg.map.n_features,), -1, jnp.int32)
        self.init_feats = None
        self._red_cum = None
        self.ref_kf = 0
        self.ref_kf_matches = 0
        self.last_kf_frame = -999
        self.loop_closer = None
        if self._pretrained_voc is not None:
            from .loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self._pretrained_voc, cfg.map)
        self._vocab_pool = []
        if self.quadrics is not None:
            self.quadrics.landmarks = []
        # abandon any in-flight global BA (its snapshot is now meaningless)
        with self._gba_lock:
            self._gba_gen += 1
            self._gba_result = None
        self._gba_thread = None
        self._big_change_idx += 1
        # fast-path pipeline state
        self._pend = None
        self._map_aux = None
        self._pending_loop = None
        self._n_kf_host = 0
        self._kf_live = 0
        self._n_pt_est = 0
        self._n_ref_vals = {2: 1, 3: 1}
        self._n_ref_cache = None
        self._ref_anchor = None
        self._reset_gen += 1

    def _get_obs_A(self):
        """[K,P] binary observation matrix, cached across frames.

        The matrix only depends on (kf_obs_point, kf_kp_valid, kf_valid);
        those arrays change at keyframe rate, not frame rate, so the cache
        turns tracking's local-window selection into two matvecs
        (tracking.select_local_points). Keyed on array object identity —
        holding the source arrays keeps ids from being recycled.
        """
        src = (self.map.kf_obs_point, self.map.kf_kp_valid, self.map.kf_valid)
        if self._obs_A is None or any(
            a is not b for a, b in zip(src, self._obs_A_src)
        ):
            self._obs_A = _observation_matrix_jit(self.map)
            self._obs_A_src = src
        return self._obs_A

    def _track(self, feats, timestamp):
        cfg = self.cfg
        self.last_feats = feats
        self._apply_gba_if_ready()
        if self.state == self.NOT_INITIALIZED:
            if cfg.sensor == "mono":
                self._mono_init(feats, timestamp)
            else:
                self._depth_init(feats, timestamp)
            self.frame_id += 1
            return self._record(timestamp)

        # motion-model prediction (src/Tracking.cc:858-864)
        T_pred = lie.se3_compose(self.velocity, self.T_cw)
        res = tr.track_frame(
            self.map,
            feats,
            T_pred,
            self.prev_obs,
            cfg.frontend.K,
            jnp.asarray(cfg.frontend.bf),
            height=cfg.frontend.height,
            width=cfg.frontend.width,
            n_levels=cfg.frontend.n_levels,
            scale=cfg.frontend.scale_factor,
            n_local_kf=min(cfg.n_local_kf, cfg.map.max_keyframes),
            n_local_pt=min(cfg.n_local_pt, cfg.map.max_points),
            obs_A=self._get_obs_A(),
        )
        n_inl = int(res.n_inliers)
        if n_inl < cfg.min_inliers_track:
            # lost right after a weak mono init -> start over
            # (reference src/Tracking.cc:472-480)
            if cfg.sensor == "mono" and int(self.map.n_kf) <= 5:
                self.reset()
                self.frame_id += 1
                return self._record(timestamp)
            self.state = self.LOST
            self.velocity = lie.se3_identity()
            if self._relocalize(feats):
                self.state = self.OK
                self.frames_since_reloc = 0
                self.frame_id += 1
                self.metrics.append(
                    {"frame": self.frame_id, "inliers": n_inl, "reloc": True}
                )
                return self._record(timestamp)
            self.frame_id += 1
            self.metrics.append({"frame": self.frame_id, "inliers": n_inl, "lost": True})
            return self._record(timestamp)

        self.state = self.OK
        new_T = res.T_cw
        self.velocity = lie.se3_compose(new_T, lie.se3_inverse(self.T_cw))
        self.T_cw = new_T
        self.prev_obs = res.obs_point

        # tracking statistics for point culling
        self.map = _bump_stats(self.map, res.visible_pt, res.found_pt)

        # localization-only mode never inserts keyframes
        # (src/Tracking.cc:809 mbOnlyTracking gate in NeedNewKeyFrame)
        if not self.only_tracking and self._need_new_keyframe(n_inl, feats, res):
            self._insert_keyframe(feats, res)

        self.frame_id += 1
        self.metrics.append({"frame": self.frame_id, "inliers": n_inl, "lost": False})
        return self._record(timestamp)

    # ------------------------------------------------------------------
    # fast path: pipelined single-dispatch tracking
    # ------------------------------------------------------------------

    def _track_fast(self, img, aux_img, timestamp):
        """Steady-state OK tracking: dispatch ONE fused device program for
        the whole frame, prefetch its 18-float stats vector, and process
        the PREVIOUS frame's (already-transferred) stats — so the host
        never waits for the device and the device queue stays full. The
        depth-1 pipeline mirrors the reference's tracking-thread /
        mapping-thread overlap (SURVEY §2.3 P1/P2): keyframe-rate mapping
        work dispatched here runs on-device underneath later frames'
        tracking dispatches."""
        cfg = self.cfg
        self._apply_gba_if_ready()
        if self._ref_anchor is None:
            self._ref_anchor = self.map.kf_pose[self.ref_kf]
        if self._red_cum is None:
            self._red_cum = _obs_level_cum_jit(
                self.map, cfg.frontend.n_levels
            )
        (feats, T_new, vel_new, obs_new, pt_vis, pt_fnd, stats,
         anchor_new) = _frame_step(
            self.map,
            self._get_obs_A(),
            img,
            img if aux_img is None else aux_img,
            self.T_cw,
            self.velocity,
            self.prev_obs,
            np.int32(self.ref_kf),
            self._ref_anchor,
            self._red_cum,
            cfg.frontend,
            cfg.sensor,
            cfg.min_inliers_track,
            min(cfg.n_local_kf, cfg.map.max_keyframes),
            min(cfg.n_local_pt, cfg.map.max_points),
            cfg.depth_factor,
        )
        self._ref_anchor = anchor_new
        try:
            stats.copy_to_host_async()
        except Exception:
            pass  # backend without async transfers: np.asarray still works
        self.last_feats = feats
        self.map = self.map._replace(pt_visible=pt_vis, pt_found=pt_fnd)
        self.T_cw, self.velocity, self.prev_obs = T_new, vel_new, obs_new
        prev = self._pend
        self._pend = {
            "frame_id": self.frame_id,
            "ts": timestamp,
            "stats": stats,
            "feats": feats,
            "obs": obs_new,
            "T": T_new,
            "ref_kf": self.ref_kf,
            "detections": self._pending_detections,
        }
        self.frame_id += 1
        if prev is not None:
            self._process_pend(prev)
        return T_new

    def _flush(self, allow_kf: bool = True):
        """Drain the depth-1 pipeline (process the pending frame). Called
        before anything that must see a fully-consistent host state:
        savers, shutdown, capacity events, sync-path transitions."""
        p = self._pend
        self._pend = None
        if p is not None:
            self._process_pend(p, allow_kf=allow_kf)

    def _process_pend(self, p, allow_kf: bool = True):
        s = np.asarray(p["stats"])
        n_inl = int(s[0])
        if n_inl < self.cfg.min_inliers_track:
            self._handle_lost(p, s)
            return
        self.state = self.OK
        self.metrics.append(
            {"frame": p["frame_id"] + 1, "inliers": n_inl,
             "matches": int(s[1]), "lost": False}
        )
        self.trajectory.append(
            (p["frame_id"], p["ts"], p["ref_kf"], s[11:18].astype(np.float32))
        )
        if (
            allow_kf
            and not self.only_tracking
            and self._need_kf_fast(p, n_inl, s)
        ):
            self._insert_keyframe_fast(p, n_inl)

    def _handle_lost(self, p, s):
        """Deferred-lost handling: by the time frame i-1's stats reveal a
        tracking failure, frame i is already in flight — its device-side
        ok-gate kept the pose unchanged, so both frames are recorded lost
        and relocalization runs on the NEWEST features (the reference
        relocalizes every frame while LOST, src/Tracking.cc:320)."""
        cfg = self.cfg
        n_inl = int(s[0])
        young = self._pend
        self._pend = None

        def record(fid, ts, ref, t_rel, inl):
            self.metrics.append({"frame": fid + 1, "inliers": inl, "lost": True})
            self.trajectory.append((fid, ts, ref, np.asarray(t_rel, np.float32)))

        # lost right after a weak mono init -> start over
        # (reference src/Tracking.cc:472-480)
        if cfg.sensor == "mono" and self._n_kf_host <= 5:
            record(p["frame_id"], p["ts"], p["ref_kf"], s[11:18], n_inl)
            if young is not None:
                ys = np.asarray(young["stats"])
                record(young["frame_id"], young["ts"], young["ref_kf"],
                       ys[11:18], int(ys[0]))
            self.reset()
            return
        record(p["frame_id"], p["ts"], p["ref_kf"], s[11:18], n_inl)
        feats = p["feats"]
        if young is not None:
            ys = np.asarray(young["stats"])
            if int(ys[0]) >= cfg.min_inliers_track:
                # the in-flight younger frame re-tracked on its own (its
                # device ok-gate tracked from the unchanged pose): keep it
                # as the pipeline head instead of discarding a good frame;
                # the reference likewise recovers without
                # relocalizing if the next frame's motion-model track
                # succeeds
                self.state = self.OK
                self._pend = young
                return
            record(young["frame_id"], young["ts"], young["ref_kf"],
                   ys[11:18], int(ys[0]))
            self.T_cw = young["T"]
            feats = young["feats"]
        self.state = self.LOST
        self.velocity = lie.se3_identity()
        self._ref_anchor = None
        if self._relocalize(feats):
            self.state = self.OK
            self.frames_since_reloc = 0
            # reloc-tagged metric for parity with the sync path's
            # {'reloc': True} entry
            self.metrics.append(
                {"frame": self.frame_id, "inliers": -1, "reloc": True}
            )

    def _consume_map_aux(self, block: bool) -> bool:
        """Consume the in-flight mapping pipeline's aux vector when ready
        (or forcibly). Returns True when mapping is idle afterwards —
        this readiness check is the equivalent of the reference's
        LocalMapping::AcceptKeyFrames flag (src/LocalMapping.cc:603-613,
        read by Tracking::NeedNewKeyFrame at src/Tracking.cc:999)."""
        a = self._map_aux
        if a is None:
            return True
        if not block:
            try:
                if not a.is_ready():
                    return False
            except Exception:
                pass
        v = np.asarray(a)
        self._n_ref_vals = {2: max(int(v[2]), 1), 3: max(int(v[3]), 1)}
        self._n_pt_est = int(v[1])
        self._kf_live = int(v[4])
        if len(v) > 6 and int(v[6]) >= 0:
            self.n_kfs_culled += 1
            if self._debug_kf:
                print(
                    f"[kf] cull slot={int(v[6])} live={int(v[4])} "
                    f"n_ref3={int(v[3])}",
                    file=__import__('sys').stderr, flush=True,
                )
        self._map_aux = None
        return True

    def _n_ref_current(self) -> int:
        min_obs = 3 if self._n_kf_host > 2 else 2
        return max(self._n_ref_vals.get(min_obs, 1), 1)

    def _need_kf_fast(self, p, n_inl, s) -> bool:
        """NeedNewKeyFrame (src/Tracking.cc:977-1061) with the REAL
        mapping-idle gate: c1b requires the in-flight mapping dispatch to
        have completed (plus the kf_idle_frames floor for determinism);
        forced insertions (c1a/c1c) first drain mapping — the analogue of
        the reference's InterruptBA + queue (src/Tracking.cc:1046-1059)."""
        cfg = self.cfg
        since = p["frame_id"] - self.last_kf_frame
        idle = self._consume_map_aux(block=False)

        c1a = since >= cfg.max_frames_between_kf
        if c1a and not idle:
            idle = self._consume_map_aux(block=True)
        n_ref = self._n_ref_current()
        need_close = False
        if cfg.sensor in ("stereo", "rgbd"):
            need_close = (s[2] < cfg.kf_close_tracked_th) and (
                s[3] > cfg.kf_close_untracked_th
            )
        c1c = cfg.sensor != "mono" and (n_inl < 0.25 * n_ref or need_close)
        if c1c and not idle:
            idle = self._consume_map_aux(block=True)
            n_ref = self._n_ref_current()
        c1b = idle and since >= max(
            cfg.min_frames_between_kf, cfg.kf_idle_frames, 1
        )
        ratio = cfg.kf_stereo_ref_ratio
        if self._n_kf_host < 2:
            ratio = 0.4
        if cfg.sensor == "mono":
            ratio = cfg.kf_ref_ratio
        c2 = (
            n_inl < ratio * n_ref or need_close
        ) and n_inl > cfg.min_inliers_kf
        # anti-starvation: when the forced cadence (c1a = mMaxFrames
        # elapsed) fires and tracking is healthy enough to seed a
        # keyframe, insert even if the inlier-ratio part of c2 is
        # borderline false — with n_inl hovering at ~ratio*n_ref (seen
        # post-loop-closure: 40 vs 0.9*44) the strict reference gate
        # never inserts again and the map starves. Deliberate small
        # deviation from src/Tracking.cc:1045.
        if c1a and n_inl > cfg.min_inliers_kf:
            c2 = True
        # redundancy veto: on feature-rich scenes n_inl settles at
        # ~0.5*n_ref (matcher recall vs a mature reference keyframe), so
        # the reference's 0.9 ratio test is permanently true and
        # keyframes insert at the max cadence only to be culled one
        # mapping pass later (r04: 361 created / 10 live; each churned
        # KF costs a full mapping dispatch + DB/loop-prep work). Gate on
        # what the cull will actually measure: the fraction of this
        # frame's tracked points already covered >=3x at same-or-finer
        # scale (device census, stats[18]). Fires ONLY while tracking is
        # strong in absolute terms (>= kf_strong_inl inliers): during
        # degradation the mature survivors dominate the tracked set and
        # the ratio rises exactly when insertion is most needed. c1a and
        # need_close always pass through.
        n_red = int(s[18]) if len(s) > 18 else 0
        redundancy = n_red / max(n_inl, 1)
        if (
            redundancy >= cfg.kf_redundancy_th
            and not need_close
            and not c1a
            and n_inl >= cfg.kf_strong_inl
        ):
            c2 = False
        want = bool((c1a or c1b or c1c) and c2)
        if self._debug_kf and want:
            import sys as _sys

            print(
                f"[kf] insert frame={p['frame_id']} since={since} "
                f"n_inl={n_inl} n_ref={n_ref} red={redundancy:.2f} "
                f"c1a={c1a} c1b={c1b} c1c={c1c} need_close={need_close}",
                file=_sys.stderr, flush=True,
            )
        return want

    def _protect_mask(self):
        K = int(self.map.kf_valid.shape[0])
        pm = np.zeros((K,), bool)
        if self.loop_closer is not None:
            for i, j in self.loop_closer.loop_edges:
                pm[i] = True
                pm[j] = True
        return pm  # numpy: transferred with the jit args, no eager op

    def _ensure_capacity_fast(self, p):
        """Host-estimate capacity check: zero device fetches in the
        steady state. When the estimate says a pool might fill within one
        keyframe's worth of insertions, drain the pipeline once and run
        the exact (fetching) _ensure_capacity."""
        cfg = self.cfg
        P = int(self.map.pt_pos.shape[0])
        K = int(self.map.kf_valid.shape[0])
        N = cfg.map.n_features
        if self._n_pt_est + 3 * N < P and self._n_kf_host + 2 < K:
            return
        self._flush(allow_kf=False)
        self._consume_map_aux(block=True)
        self._extra_obs_holders = [p]
        try:
            self._ensure_capacity()
        finally:
            self._extra_obs_holders = []
        self._n_pt_est = int(self.map.n_pt)
        self._n_kf_host = int(self.map.n_kf)
        self._kf_live = int(np.asarray(self.map.kf_valid).sum())

    def _insert_keyframe_fast(self, p, n_inl):
        """Keyframe insertion on the fast path: ONE async dispatch for
        insert + the whole mapping pipeline (_insert_and_map); the aux
        vector is prefetched and consumed by later keyframe decisions.
        The tracker keeps its own current pose — BA refinements flow
        through the map, as in the reference (the mapping thread never
        rewrites the camera thread's pose)."""
        cfg = self.cfg
        gen = self._reset_gen
        self._ensure_capacity_fast(p)
        # the capacity path may have flushed the younger in-flight frame;
        # if that frame was LOST the flush can reset the whole system
        # (mono weak-init) or enter relocalization — inserting the stale
        # keyframe into that state would corrupt the map
        if self.state != self.OK or gen != self._reset_gen:
            return
        slot = self._n_kf_host
        m2, aux, red_cum = _insert_and_map(
            self.map,
            p["feats"],
            p["T"],
            np.int32(p["frame_id"]),
            np.int32(self.ref_kf),
            p["obs"],
            self._protect_mask(),
            self._inv_sigma2,
            cfg.frontend,
            cfg.sensor,
            cfg.local_ba_window,
        )
        self._red_cum = red_cum
        try:
            aux.copy_to_host_async()
        except Exception:
            pass
        self.map = m2
        self._map_aux = aux
        self._n_kf_host += 1
        self._kf_live += 1
        # until aux lands, bound the pool usage by the per-KF maximum
        self._n_pt_est += 2 * cfg.map.n_features
        self.ref_kf = slot
        self.ref_kf_matches = n_inl
        self.last_kf_frame = p["frame_id"]
        self.n_kfs_created += 1
        self._n_ref_cache = None
        # the chain last saw the new ref KF at its INSERT pose; the
        # pipeline's local BA refinement lands via the next frame's
        # re-anchor correction
        self._ref_anchor = p["T"]

        self._maybe_train_vocab(p["feats"])
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe_from_map(m2, slot)
        if cfg.enable_loop_closing and self.loop_closer is not None:
            self._run_loop_closing(slot)
        if self.quadrics is not None and p["detections"] is not None:
            self.quadrics.add_keyframe_detections(
                self.map, slot, p["detections"]
            )
            self.quadrics.try_initialize(self.map)
            if any(l.initialized for l in self.quadrics.landmarks):
                self.map = self.quadrics.joint_ba(self.map, self._inv_sigma2)

    def _run_loop_closing(self, slot: int):
        """Loop detection with one-keyframe latency: the database scores
        + covisibility needed by DetectLoop are dispatched and PREFETCHED
        at insertion, consumed at the next keyframe — the reference's
        loop thread likewise consumes keyframes from a queue after the
        fact (src/LoopClosing.cc:57-95)."""
        cfg = self.cfg
        pend = self._pending_loop
        self._pending_loop = None
        if pend is not None:
            pslot, prep = pend
            for cand in self.loop_closer.finish_detect(prep):
                self.map, ok = self.loop_closer.attempt_close(
                    self.map, pslot, cand, cfg.frontend.K,
                    n_levels=cfg.frontend.n_levels,
                    scale=cfg.frontend.scale_factor,
                    height=cfg.frontend.height,
                    width=cfg.frontend.width,
                    fix_scale=cfg.sensor != "mono",
                )
                if ok:
                    self.n_loops_closed += 1
                    self._big_change_idx += 1
                    # SearchAndFuse merged duplicate points: the
                    # redundancy histogram must see the fused table
                    self._red_cum = None
                    if cfg.async_gba:
                        self._launch_global_ba(pslot)
                    else:
                        self.map, _ = lm.run_global_ba(
                            self.map, cfg.frontend.K,
                            jnp.asarray(cfg.frontend.bf), self._inv_sigma2,
                            n_iters=10,
                        )
                    break
        prep = self.loop_closer.prepare_detect(
            self.map, slot, self._kf_live
        )
        if prep is not None:
            self._pending_loop = (slot, prep)

    def _refresh_host_counters(self):
        """Sync-path hook: keep the fast path's host mirrors exact after
        any synchronous map mutation (init, sync keyframe insert)."""
        self._red_cum = None  # observation table changed: recompute lazily
        self._n_kf_host = int(self.map.n_kf)
        self._kf_live = int(np.asarray(self.map.kf_valid).sum())
        self._n_pt_est = int(self.map.n_pt)
        self._n_ref_cache = None
        self._ref_anchor = None  # re-derived on the next fast frame
        self._n_ref_vals = {
            2: max(self._ref_kf_tracked(2), 1),
            3: max(self._ref_kf_tracked(3), 1),
        }

    # ------------------------------------------------------------------

    def _need_new_keyframe(self, n_inl, feats, res) -> bool:
        """NeedNewKeyFrame (src/Tracking.cc:977-1061), synchronous-pipeline
        subset: mapping never blocks us, so the 'idle' condition c1b is
        always true when the min-frame gap has passed."""
        cfg = self.cfg
        since = self.frame_id - self.last_kf_frame

        # close-point census for stereo/RGB-D (src/Tracking.cc:1002-1019):
        # tracked close points vs close keypoints not yet in the map
        need_close = False
        if cfg.sensor in ("stereo", "rgbd"):
            close_th = cfg.frontend.depth_th * cfg.frontend.bf / max(
                cfg.frontend.fx, 1e-6
            )
            close = feats.valid & (feats.depth > 0) & (feats.depth < close_th)
            n_tracked_close = int(jnp.sum(close & (res.obs_point >= 0)))
            n_nontracked_close = int(jnp.sum(close & (res.obs_point < 0)))
            need_close = (n_tracked_close < cfg.kf_close_tracked_th) and (
                n_nontracked_close > cfg.kf_close_untracked_th
            )

        # nRefMatches = reference KF's map points with >= minObs
        # observations, recomputed each frame
        # (KeyFrame::TrackedMapPoints, src/KeyFrame.cc:258-287, called at
        # src/Tracking.cc:988-991), NOT the inlier count frozen at
        # insertion time
        n_kfs = int(self.map.n_kf)
        min_obs = 3 if n_kfs > 2 else 2
        n_ref = max(self._ref_kf_tracked(min_obs), 1)

        # thRefRatio (src/Tracking.cc:1021-1027): 0.75 stereo/RGB-D, 0.4
        # while the map has <2 keyframes, 0.9 for mono (overrides both)
        ratio = cfg.kf_stereo_ref_ratio
        if n_kfs < 2:
            ratio = 0.4
        if cfg.sensor == "mono":
            ratio = cfg.kf_ref_ratio

        c1a = since >= cfg.max_frames_between_kf
        # c1b: min-gap AND mapping idle — modeled as kf_idle_frames of
        # mapping occupancy after each insertion (see SystemConfig)
        c1b = since >= max(cfg.min_frames_between_kf, cfg.kf_idle_frames)
        c1c = cfg.sensor != "mono" and (n_inl < 0.25 * n_ref or need_close)
        c2 = (
            n_inl < ratio * n_ref or need_close
        ) and n_inl > cfg.min_inliers_kf
        # redundancy veto — same census as the fast path (see
        # _need_kf_fast): skip views whose tracked points the map already
        # covers >=3x at same-or-finer scale, only while tracking is
        # strong and the forced c1a cadence has not elapsed
        if c2 and not need_close and not c1a and n_inl >= cfg.kf_strong_inl:
            if self._red_cum is None:
                self._red_cum = _obs_level_cum_jit(
                    self.map, cfg.frontend.n_levels
                )
            n_red, n_trk = _frame_redundancy(
                self._red_cum, res.obs_point, feats.level
            )
            if int(n_red) / max(int(n_trk), 1) >= cfg.kf_redundancy_th:
                c2 = False
        return bool((c1a or c1b or c1c) and c2)

    def _ref_kf_tracked(self, min_obs: int) -> int:
        """KeyFrame::TrackedMapPoints(minObs) for the reference keyframe
        (src/KeyFrame.cc:258-287), cached across frames: the observation
        table only changes at keyframe rate (keyed on array identity,
        like the observation-matrix cache)."""
        src = self.map.kf_obs_point
        key = (self.ref_kf, min_obs)
        if (
            self._n_ref_cache is None
            or self._n_ref_cache[0] is not src
            or self._n_ref_cache[1] != key
        ):
            obs_cnt = ms.point_obs_count(self.map)
            row = src[self.ref_kf]
            P = self.map.pt_pos.shape[0]
            n = int(
                jnp.sum((row >= 0) & (obs_cnt[jnp.clip(row, 0, P - 1)] >= min_obs))
            )
            self._n_ref_cache = (src, key, n)
        return self._n_ref_cache[2]

    def _ensure_capacity(self):
        """Never silently stop mapping at pool capacity (the reference has
        no capacity limits at all — MapPoints/KeyFrames are heap objects,
        src/Map.cc). Point pool: compact culled slots first
        (map_state.compact_points); when genuinely full, double the pool.
        Keyframe pool: double when within 2 of capacity. Each doubling
        recompiles the shape-specialized jits once — O(log) growths per
        run — and is announced loudly on stderr."""
        import sys

        cfg = self.cfg
        m = self.map
        P = int(m.pt_pos.shape[0])
        N = cfg.map.n_features
        # each keyframe can allocate up to ~2N rows (depth spawn + triang.)
        if P - int(m.n_pt) < 3 * N:
            old_valid = np.asarray(m.pt_valid)
            n_valid = int(old_valid.sum())
            if P - n_valid >= max(3 * N, P // 8):
                self.map, new_idx = ms.compact_points(m)
                self._map_epoch += 1
                self.n_point_compactions += 1
                self._remap_point_ids(np.asarray(new_idx), old_valid)
            else:
                print(
                    f"[orbslam2] point pool full ({n_valid}/{P} live): "
                    f"growing to {2 * P} (one-time recompile)",
                    file=sys.stderr, flush=True,
                )
                self.map = ms.grow_map(self.map, new_P=2 * P)
                self.n_point_growths += 1
        K = int(self.map.kf_valid.shape[0])
        if K - int(self.map.n_kf) < 2:
            n_live = int(np.asarray(self.map.kf_valid).sum())
            if int(self.map.n_kf) - n_live >= max(8, K // 4):
                # culling freed plenty of slots: compact instead of growing
                self._compact_keyframes()
                self.n_kf_compactions += 1
            else:
                print(
                    f"[orbslam2] keyframe pool full ({n_live}/{K} live): "
                    f"growing to {2 * K} (one-time recompile)",
                    file=sys.stderr, flush=True,
                )
                self.map = ms.grow_map(self.map, new_K=2 * K)
                self.n_kf_growths += 1
                if self.loop_closer is not None:
                    self.loop_closer.grow(2 * K)
        # pool shape / point ids may have changed: the redundancy
        # histogram is recomputed lazily from the (exact) new map
        self._red_cum = None

    def _compact_keyframes(self):
        """Pack valid keyframes to the low end of the pool. Every
        keyframe id held OUTSIDE the MapState is re-anchored first:
        trajectory entries and point reference-keyframes walk the
        spanning tree past culled slots (the System::SaveTrajectoryTUM
        walk, src/System.cc:361-368) to a live ancestor, then all ids are
        remapped; an in-flight async GBA is abandoned (its keyframe ids
        are stale)."""
        m = self.map
        K = int(m.kf_valid.shape[0])
        kf_valid = np.asarray(m.kf_valid)
        parent = np.asarray(m.kf_parent)
        tcp = np.asarray(m.kf_tcp)

        # live ancestor + folded T_slot_ancestor for every slot
        anc = np.arange(K)
        fold = [None] * K  # None = identity
        for s in range(K):
            r, F, hops = s, None, 0
            while 0 <= r < K and not kf_valid[r] and parent[r] >= 0 and hops < K:
                F = tcp[r] if F is None else _np_se3_compose(F, tcp[r])
                r = int(parent[r])
                hops += 1
            anc[s] = r if (0 <= r < K and kf_valid[r]) else -1
            fold[s] = F

        order = np.argsort(np.where(kf_valid, 0, 1), kind="stable")
        new_idx = np.cumsum(kf_valid.astype(np.int32)) - 1
        new_idx = np.where(kf_valid, new_idx, -1).astype(np.int32)

        def live(slot):
            a = anc[slot] if 0 <= slot < K else -1
            return int(new_idx[a]) if a >= 0 else -1

        # 1. trajectory entries: fold culled anchors into T_rel
        kf_pose = np.asarray(m.kf_pose)
        fixed = []
        for fid, ts, ref, T_rel in self.trajectory:
            r = int(ref)
            if 0 <= r < K and not kf_valid[r] and fold[r] is not None:
                T_rel = _np_se3_compose(np.asarray(T_rel), fold[r])
            lr = live(r)
            if lr < 0:
                # whole ancestor chain culled (rare: slot 0 is protected).
                # Re-anchor on slot 0 PRESERVING the absolute pose: the
                # dead-end slot's stored pose is its last-known value, so
                # T_rel' = T_rel . pose[dead_end] . inv(pose[0]) keeps
                # T_rel' . pose[0] == T_rel . pose[dead_end].
                dead_end = r
                hops = 0
                while (0 <= dead_end < K and not kf_valid[dead_end]
                       and parent[dead_end] >= 0 and hops < K):
                    dead_end = int(parent[dead_end])
                    hops += 1
                if 0 <= dead_end < K:
                    T_rel = _np_se3_compose(
                        _np_se3_compose(np.asarray(T_rel), kf_pose[dead_end]),
                        _np_se3_inverse(kf_pose[0]),
                    )
                lr = 0
            fixed.append((fid, ts, lr, np.asarray(T_rel)))
        self.trajectory = fixed

        # 2. point reference keyframes -> live ancestors (pre-resolve so
        #    compact_keyframes' id remap is valid)
        first = np.asarray(m.pt_first_kf)
        ok_f = (first >= 0) & (first < K)
        first_live = np.where(ok_f, anc[np.clip(first, 0, K - 1)], -1)
        m = m._replace(pt_first_kf=jnp.asarray(first_live.astype(np.int32)))

        # 3. compact the MapState arrays
        self.map = ms.compact_keyframes(
            m, jnp.asarray(order.astype(np.int32)), jnp.asarray(new_idx)
        )

        # 4. host-held ids
        self.ref_kf = max(live(self.ref_kf), 0)
        if self.loop_closer is not None:
            lcs = self.loop_closer
            perm = jnp.asarray(order.astype(np.int32))
            lcs.words = lcs.words[perm]
            if lcs.sparse:
                lcs.kf_wid = lcs.kf_wid[perm]
                lcs.kf_wval = lcs.kf_wval[perm]
            else:
                lcs.bow = lcs.bow[perm]
            lcs.loop_edges = [
                (int(new_idx[i]), int(new_idx[j]))
                for i, j in lcs.loop_edges
                if kf_valid[i] and kf_valid[j]
            ]
            lcs.consistency = []
            lcs.last_loop_kf = (
                int(new_idx[lcs.last_loop_kf])
                if 0 <= lcs.last_loop_kf < K and kf_valid[lcs.last_loop_kf]
                else -999
            )
        if self.quadrics is not None:
            for lmk in self.quadrics.landmarks:
                kept = [
                    (int(new_idx[s]), b)
                    for s, b in zip(lmk.kf_slots, lmk.bboxes)
                    if 0 <= s < K and kf_valid[s]
                ]
                lmk.kf_slots = [s for s, _ in kept]
                lmk.bboxes = [b for _, b in kept]
        # in-flight async GBA holds stale keyframe ids
        with self._gba_lock:
            self._gba_gen += 1
            self._gba_result = None
        self._n_ref_cache = None

    def _remap_point_ids(self, new_idx, old_valid):
        """Point-id fixup after compact_points for ids held outside the
        MapState (frame observations, quadric landmark member sets, the
        pipelined frame awaiting insertion)."""
        P = len(old_valid)

        def remap(obs):
            po = np.asarray(obs)
            ok = (po >= 0) & old_valid[np.clip(po, 0, P - 1)]
            return jnp.asarray(
                np.where(ok, new_idx[np.clip(po, 0, P - 1)], -1), jnp.int32
            )

        self.prev_obs = remap(self.prev_obs)
        if self._pend is not None:
            self._pend["obs"] = remap(self._pend["obs"])
        for holder in self._extra_obs_holders:
            holder["obs"] = remap(holder["obs"])
        if self.quadrics is not None:
            for lmk in self.quadrics.landmarks:
                lmk.point_ids = {
                    int(new_idx[p]) for p in lmk.point_ids
                    if p < P and old_valid[p]
                }

    def _insert_keyframe(self, feats, res: tr.TrackResult):
        cfg = self.cfg
        self._ensure_capacity()
        parent = jnp.asarray(self.ref_kf, jnp.int32)
        # NOT res.obs_point: _ensure_capacity may have compacted the point
        # pool and remapped every point id; self.prev_obs was set to
        # res.obs_point by _track and remapped by _remap_point_ids, so it
        # is the post-compaction view of this frame's observations.
        self.map, slot = ms.insert_keyframe(
            self.map,
            self.T_cw,
            jnp.asarray(self.frame_id, jnp.int32),
            feats.uv_und,
            feats.ur,
            feats.level,
            feats.angle,
            feats.desc,
            feats.valid,
            self.prev_obs,
            parent,
        )
        slot = int(slot)
        self.ref_kf = slot
        self.ref_kf_matches = int(res.n_inliers)
        self.last_kf_frame = self.frame_id
        self.n_kfs_created += 1

        if cfg.sensor in ("stereo", "rgbd"):
            self.map = _create_depth_points(
                self.map, slot, feats, cfg.frontend.K, cfg.frontend.bf,
                cfg.frontend.depth_th,
            )

        # --- local mapping pipeline (reference LocalMapping::Run order) ---
        self.map = lm.cull_points(self.map)
        self.map, n_new = lm.create_new_points(
            self.map, jnp.asarray(slot), cfg.frontend.K,
            jnp.asarray(cfg.frontend.bf),
            n_levels=cfg.frontend.n_levels, scale=cfg.frontend.scale_factor,
        )
        # stats BEFORE fuse: the reference refreshes normals/scale bands
        # at MapPoint construction (UpdateNormalAndDepth in the ctor path,
        # src/MapPoint.cc:330-371) — fuse's distance-based level
        # prediction needs real pt_max_dist, not the fresh-point sentinel
        self.map = ms.update_point_stats(
            self.map, orb.scale_factors(cfg.frontend.n_levels, cfg.frontend.scale_factor)[0]
        )
        self.map = lm.fuse_neighbors(
            self.map, jnp.asarray(slot), cfg.frontend.K,
            height=cfg.frontend.height, width=cfg.frontend.width,
            n_levels=cfg.frontend.n_levels, scale=cfg.frontend.scale_factor,
        )
        self.map = ms.update_point_stats(
            self.map, orb.scale_factors(cfg.frontend.n_levels, cfg.frontend.scale_factor)[0]
        )
        self.map, _ = lm.run_local_ba(
            self.map, jnp.asarray(slot), cfg.frontend.K,
            jnp.asarray(cfg.frontend.bf), self._inv_sigma2,
            window=cfg.local_ba_window,
        )
        # loop-closure keyframes are never culled (AddLoopEdge pins them
        # with mbNotErase, src/KeyFrame.cc:424-435): culling one would
        # silently drop its loop edge from every later essential graph
        protect = None
        if self.loop_closer is not None and self.loop_closer.loop_edges:
            pm = np.zeros((int(self.map.kf_valid.shape[0]),), bool)
            for i, j in self.loop_closer.loop_edges:
                pm[i] = True
                pm[j] = True
            protect = jnp.asarray(pm)
        self.map = lm.cull_keyframes(
            self.map, jnp.asarray(slot), protect,
            n_levels=cfg.frontend.n_levels,
        )

        # --- place recognition database (always maintained: the reference
        # always loads the vocabulary and populates the KeyFrameDatabase —
        # relocalization needs it even with loop closing disabled,
        # src/System.cc:64-88, src/Tracking.cc:1341-1502) ---
        self._maybe_train_vocab(feats)
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe_from_map(self.map, slot)
        # --- loop closing ---
        if cfg.enable_loop_closing:
            if self.loop_closer is not None:
                for cand in self.loop_closer.detect(self.map, slot):
                    self.map, ok = self.loop_closer.attempt_close(
                        self.map, slot, cand, cfg.frontend.K,
                        n_levels=cfg.frontend.n_levels,
                        scale=cfg.frontend.scale_factor,
                        height=cfg.frontend.height,
                        width=cfg.frontend.width,
                        # metric sensors fix the Sim3 scale (reference
                        # mbFixScale, src/LoopClosing.cc:56)
                        fix_scale=cfg.sensor != "mono",
                    )
                    if ok:
                        self.n_loops_closed += 1
                        self._big_change_idx += 1
                        # global refinement after the essential graph
                        # (RunGlobalBundleAdjustment, LoopClosing.cc:645-749)
                        if cfg.async_gba:
                            self._launch_global_ba(slot)
                        else:
                            self.map, _ = lm.run_global_ba(
                                self.map, cfg.frontend.K,
                                jnp.asarray(cfg.frontend.bf), self._inv_sigma2,
                                n_iters=10,
                            )
                        break

        # --- quadric object landmarks ---
        if self.quadrics is not None and self._pending_detections is not None:
            self.quadrics.add_keyframe_detections(
                self.map, slot, self._pending_detections
            )
            self.quadrics.try_initialize(self.map)
            if any(l.initialized for l in self.quadrics.landmarks):
                self.map = self.quadrics.joint_ba(self.map, self._inv_sigma2)

        # adopt the BA-refined pose + surviving observations
        self.T_cw = self.map.kf_pose[slot]
        self.prev_obs = self.map.kf_obs_point[slot]
        self._refresh_host_counters()

    # ------------------------------------------------------------------
    # async global BA (the reference's transient 4th thread:
    # LoopClosing.cc:579 spawns RunGlobalBundleAdjustment; :645-749 applies
    # the result and spanning-tree-propagates to KFs/points created while
    # it ran). Immutable MapState snapshots replace mTcwGBA staging + the
    # map-update mutex: the thread optimizes a snapshot while tracking
    # keeps replacing self.map; the merge is pure array surgery.
    # ------------------------------------------------------------------

    def _launch_global_ba(self, slot: int):
        import threading

        cfg = self.cfg
        snap = self.map
        with self._gba_lock:
            self._gba_gen += 1
            gen = self._gba_gen
            self._gba_result = None

        epoch = self._map_epoch

        def run():
            m2, _ = lm.run_global_ba(
                snap, cfg.frontend.K,
                jnp.asarray(cfg.frontend.bf), self._inv_sigma2,
                n_iters=10,
            )
            jax.block_until_ready(m2.kf_pose)
            with self._gba_lock:
                if gen == self._gba_gen:  # superseded by a newer loop? drop
                    self._gba_result = (snap, m2, epoch)

        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()

    def _apply_gba_if_ready(self, wait: bool = False):
        if self._gba_thread is not None and wait:
            self._gba_thread.join()
        with self._gba_lock:
            if self._gba_result is None:
                return
            snap, gba, epoch = self._gba_result
            self._gba_result = None
        self._gba_thread = None
        m = self.map
        K = m.kf_valid.shape[0]

        # the map may have GROWN since the snapshot (keyframe/point ids
        # are preserved by grow_map, so pad the snapshot masks with False)
        Ks = snap.kf_valid.shape[0]
        snap_kf_valid = np.zeros((K,), bool)
        snap_kf_valid[:Ks] = np.asarray(snap.kf_valid)
        in_gba_kf = snap_kf_valid & np.asarray(m.kf_valid)
        old_pose = np.asarray(m.kf_pose)
        new_pose = old_pose.copy()
        new_pose[in_gba_kf] = np.asarray(gba.kf_pose)[in_gba_kf[:Ks]]
        # spanning-tree propagation to keyframes created during GBA
        # (LoopClosing.cc:677-708): Tcw_new = Tcw_old Twc_parent_old
        # Tcw_parent_new, walking until every new KF has a corrected parent
        parents = np.asarray(m.kf_parent)
        kf_valid = np.asarray(m.kf_valid)
        done = in_gba_kf.copy()
        pending = [k for k in range(K) if kf_valid[k] and not done[k]]
        for _ in range(K):
            if not pending:
                break
            rest = []
            for k in pending:
                p = parents[k]
                if p >= 0 and done[p]:
                    T_rel = lie.se3_compose(
                        jnp.asarray(old_pose[k]),
                        lie.se3_inverse(jnp.asarray(old_pose[p])),
                    )
                    new_pose[k] = np.asarray(
                        lie.se3_compose(T_rel, jnp.asarray(new_pose[p]))
                    )
                    done[k] = True
                else:
                    rest.append(k)
            if len(rest) == len(pending):
                break  # orphans (no corrected ancestor): keep old pose
            pending = rest

        # points: GBA result for snapshot points, reference-KF correction
        # for points created meanwhile (LoopClosing.cc:710-737). If a
        # point-pool compaction remapped ids since the snapshot (epoch
        # bump), snapshot point ids are stale: fall back to the
        # reference-KF correction for EVERY point (kf ids stay valid).
        P = m.pt_pos.shape[0]
        Ps = snap.pt_valid.shape[0]
        snap_pt_valid = np.zeros((P,), bool)
        if epoch == self._map_epoch:
            snap_pt_valid[:Ps] = np.asarray(snap.pt_valid)
        in_gba_pt = snap_pt_valid & np.asarray(m.pt_valid)
        pos = np.asarray(m.pt_pos).copy()
        if in_gba_pt.any():
            pos[in_gba_pt] = np.asarray(gba.pt_pos)[in_gba_pt[:Ps]]
        new_pt = np.asarray(m.pt_valid) & ~in_gba_pt
        if new_pt.any():
            ref = np.clip(np.asarray(m.pt_first_kf), 0, K - 1)
            idx = np.where(new_pt)[0]
            r = ref[idx]
            corr = jax.vmap(
                lambda To, Tn, p: lie.se3_apply(
                    lie.se3_inverse(Tn), lie.se3_apply(To, p)
                )
            )(
                jnp.asarray(old_pose[r]), jnp.asarray(new_pose[r]),
                jnp.asarray(pos[idx]),
            )
            pos[idx] = np.asarray(corr)

        self.map = m._replace(
            kf_pose=jnp.asarray(new_pose), pt_pos=jnp.asarray(pos)
        )
        # re-anchor the live camera on its (possibly corrected) reference KF
        T_rel = lie.se3_compose(
            self.T_cw, lie.se3_inverse(jnp.asarray(old_pose[self.ref_kf]))
        )
        self.T_cw = lie.se3_compose(
            T_rel, jnp.asarray(new_pose[self.ref_kf])
        )
        self._ref_anchor = jnp.asarray(new_pose[self.ref_kf])
        self._big_change_idx += 1

    def _maybe_train_vocab(self, feats):
        """Train a small vocabulary from early keyframe descriptors
        (the reference loads a pretrained ORBvoc.txt, System.cc:64-71;
        this repo bootstraps one from the sequence itself)."""
        if self.loop_closer is not None:
            return
        from ..ops import vocab as vocab_mod
        from .loop_closing import LoopCloser

        self._vocab_pool.append(np.asarray(feats.desc[np.asarray(feats.valid)]))
        if len(self._vocab_pool) < self.cfg.vocab_train_kfs:
            return
        desc = np.concatenate(self._vocab_pool, axis=0)
        if len(desc) < 256:
            return
        voc = vocab_mod.train(
            jnp.asarray(desc), k=self.cfg.vocab_k, levels=self.cfg.vocab_levels
        )
        self.loop_closer = LoopCloser(voc, self.cfg.map)
        # the keyframe pool may have grown past cfg.map.max_keyframes
        # before vocab training finished — size the database rows from
        # the LIVE pool, or score_query shape-errors / add_keyframe
        # clamps its scatter index onto the last row
        self.loop_closer.grow(int(self.map.kf_valid.shape[0]))
        # index all existing keyframes
        for s in range(int(self.map.n_kf)):
            if bool(self.map.kf_valid[s]):
                self.loop_closer.add_keyframe_from_map(self.map, s)
        self._vocab_pool = []

    def _relocalize(self, feats) -> bool:
        """Relocalization (reference src/Tracking.cc:1341-1502):
        covisibility-group-scored BoW candidates
        (KeyFrameDatabase::DetectRelocalizationCandidates,
        src/KeyFrameDatabase.cc:199-309) -> word-bucketed matching (>=15)
        -> PnP RANSAC -> pose LM (>=10 to continue) -> guided projection
        rescue against the candidate keyframe's points -> accept at >=50
        final inliers (the reference's staged 10/50 gates at
        src/Tracking.cc:1414-1494)."""
        from ..ops import pnp, vocab as vocab_mod

        if self.loop_closer is None:
            return False
        lcs = self.loop_closer
        word, _ = vocab_mod.transform_any(lcs.voc, feats.desc, feats.valid)
        P = self.map.pt_pos.shape[0]
        for cand in lcs.detect_reloc_candidates(self.map, word):
            # dense mutual-best pairing instead of exact leaf-word
            # bucketing: the reference's SearchByBoW buckets at
            # FeatureVector nodes 4 levels up (~10^2 buckets — barely a
            # constraint); exact-leaf equality starved the >=15 gate on
            # genuine revisits (see loop_closing._sim3_geometry)
            mi, _ = matching.mutual_match(
                feats.desc, feats.valid,
                self.map.kf_desc[cand], self.map.kf_kp_valid[cand],
                th=matching.TH_LOW, ratio=0.75,
            )
            pt = self.map.kf_obs_point[cand, jnp.clip(mi, 0, mi.shape[0] - 1)]
            ok = (mi >= 0) & (pt >= 0)
            if int(jnp.sum(ok)) < 15:
                continue
            pw = self.map.pt_pos[jnp.clip(pt, 0, P - 1)]
            T, inl, n_inl = pnp.ransac_pnp(
                pw, feats.uv_und, ok, self.cfg.frontend.K,
                self._inv_sigma2[
                    jnp.clip(feats.level, 0, self._inv_sigma2.shape[0] - 1)
                ],
            )
            if int(n_inl) < 10:
                # reference keeps candidates with >=10 PnP+opt inliers
                # alive for the projection rescue (src/Tracking.cc:1437)
                continue
            # guided rescue: seed from the PnP inliers, re-match by
            # projection (motion window then the tight local window) and
            # re-optimize — the superset of the reference's narrowing
            # 10px/3px SearchByProjection iterations
            obs = jnp.where(inl & ok, pt, -1)
            res = tr.track_frame(
                self.map, feats, T, obs, self.cfg.frontend.K,
                jnp.asarray(self.cfg.frontend.bf),
                height=self.cfg.frontend.height, width=self.cfg.frontend.width,
                n_levels=self.cfg.frontend.n_levels,
                scale=self.cfg.frontend.scale_factor,
                obs_A=self._get_obs_A(),
            )
            if int(res.n_inliers) >= 50:
                T_drift = self.T_cw  # stale prediction in the DRIFTED frame
                self.T_cw = res.T_cw
                self.prev_obs = res.obs_point
                self.velocity = lie.se3_identity()
                self._reloc_loop_correction(cand, T_drift, res.T_cw)
                return True
        return False

    def _reloc_loop_correction(self, cand: int, T_drift, T_new):
        """Treat a relocalization after tracking loss as the loop-closure
        event it topologically is: the jump between the drifted
        prediction ``T_drift`` and the relocalized pose ``T_new`` IS the
        Sim3 correction CorrectLoop would have applied had DetectLoop
        fired before tracking broke down. Bends the drifted keyframe
        chain (anchored at the pre-loss reference keyframe) onto the
        revisited map with the existing essential-graph machinery.

        Deviation from the reference (documented): ORB-SLAM2 relocalizes
        and simply continues (src/Tracking.cc:1341-1502), leaving the
        pre-loss drifted segment permanently inconsistent — on
        out-and-back motion this leaves O(10%) of-span ATE in the
        interior that no later loop closure can repair (measured:
        EVAL r05 diagnostic, 13.7 % ATE with tracking loss at the
        drift peak). The correction below reuses CorrectLoop's exact
        pipeline (src/LoopClosing.cc:402-585) with the reloc pair as
        the loop pair."""
        lcs = self.loop_closer
        if lcs is None:
            return
        slot = self.ref_kf  # drifted frontier keyframe
        if slot == cand:
            return
        # significance gate: centers differ by > 2 cm or rotation > 1 deg
        c_d = -np.asarray(
            lie.quat_rotate(lie.quat_conj(T_drift[:4]), T_drift[4:7])
        )
        c_n = -np.asarray(
            lie.quat_rotate(lie.quat_conj(T_new[:4]), T_new[4:7])
        )
        dq = float(np.abs(np.sum(np.asarray(T_drift[:4]) * np.asarray(T_new[:4]))))
        jump = float(np.linalg.norm(c_d - c_n))
        if jump < 0.02 and dq > np.cos(np.deg2rad(1.0) / 2):
            return
        cfg = self.cfg
        T_slot = self.map.kf_pose[slot]
        # corrected pose of the drifted frontier:
        # T_slot_corr = (T_slot o T_drift^-1) o T_new
        S_corr = lie.sim3_from_se3(
            lie.se3_compose(
                lie.se3_compose(T_slot, lie.se3_inverse(T_drift)), T_new
            )
        )
        if self._debug_kf or os.environ.get("ORB_DEBUG_LOOPS"):
            import sys as _sys

            print(
                f"[reloc-loop] slot={slot} cand={cand} jump={jump:.3f}",
                file=_sys.stderr, flush=True,
            )
        from . import loop_closing as lc

        self.map = lcs._correct_graph(self.map, slot, cand, S_corr)
        loop_ids = lc.gather_loop_points(self.map, np.int32(cand))
        self.map, _ = lc.fuse_loop_points(
            self.map, jnp.asarray(slot, jnp.int32), loop_ids,
            cfg.frontend.K, n_levels=cfg.frontend.n_levels,
            scale=cfg.frontend.scale_factor,
            height=cfg.frontend.height, width=cfg.frontend.width,
        )
        lcs.loop_edges.append((int(slot), int(cand)))
        lcs.last_loop_kf = max(int(slot), int(cand))
        self.n_loops_closed += 1
        self.n_reloc_corrections += 1
        self._big_change_idx += 1
        # a keyframe insertion pending across this surgery would land a
        # drifted-frame pose in the corrected map — abort it (the same
        # generation guard that protects against reset)
        self._reset_gen += 1
        self._ref_anchor = None
        self._n_ref_cache = None
        self._red_cum = None  # fuse merged duplicates: histogram stale
        # the relocalized pose itself is already in the (fixed) old-map
        # frame: cand is the essential graph's gauge, so T_new stays valid
        if cfg.async_gba:
            self._launch_global_ba(slot)
        else:
            self.map, _ = lm.run_global_ba(
                self.map, cfg.frontend.K, jnp.asarray(cfg.frontend.bf),
                self._inv_sigma2, n_iters=10,
            )

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _mono_init(self, feats, timestamp):
        """MonocularInitialization (src/Tracking.cc:563-737)."""
        cfg = self.cfg
        n_valid = int(jnp.sum(feats.valid))
        if self.init_feats is None or n_valid < 100:
            if n_valid >= 100:
                self.init_feats = feats
                self.init_frame_id = self.frame_id
            return

        idx, _ = matching.match_windowed(
            self.init_feats.uv_und,
            self.init_feats.desc,
            self.init_feats.angle,
            self.init_feats.valid,
            feats.uv_und,
            feats.desc,
            feats.angle,
            feats.valid,
            window=100.0,
            th=matching.TH_LOW,
            check_rotation=True,
            level_a=self.init_feats.level,
            level_b=feats.level,
        )
        n_matches = int(jnp.sum(idx >= 0))
        if n_matches < 100:
            # stale initializer (reference resets after a gap,
            # src/Tracking.cc:582-588)
            self.init_feats = feats if n_valid >= 100 else None
            self.init_frame_id = self.frame_id
            return

        M = idx.shape[0]  # 2x the map's feature budget (init extractor)
        tgt = jnp.clip(idx, 0, M - 1)
        uv1 = self.init_feats.uv_und
        uv2 = feats.uv_und[tgt]
        res = init2view.initialize_two_view(
            cfg.frontend.K, uv1, uv2, idx >= 0
        )
        if not bool(res.ok):
            return

        # median-depth normalization (src/Tracking.cc:689-713)
        good = np.asarray(res.good)
        depths = np.asarray(res.points)[:, 2]
        med = float(np.median(depths[good])) if good.any() else 1.0
        inv_med = 1.0 / max(med, 1e-6)
        pts = np.asarray(res.points) * inv_med
        T21 = np.asarray(res.T_21)
        T21 = jnp.asarray(T21).at[4:7].multiply(inv_med)

        # compact the 2x init rows to the map's per-keyframe budget:
        # triangulated matches first, then other valid keypoints (kept for
        # future triangulation). Rows stay ALIGNED between the two
        # keyframes — row i of KF0 and of KF1 observe the same new point.
        Nm = cfg.map.n_features
        valid0 = np.asarray(self.init_feats.valid)
        tgt_np = np.asarray(tgt)
        sel0 = np.argsort(
            np.where(good, 0, np.where(valid0, 1, 2)), kind="stable"
        )[:Nm]
        good0 = good[sel0]
        valid1 = np.asarray(feats.valid)
        sel1 = np.full((Nm,), 0, np.int64)
        gi = np.where(good0)[0]
        sel1[gi] = tgt_np[sel0[gi]]
        used = np.zeros(len(valid1), bool)
        used[sel1[gi]] = True
        fill = np.where(valid1 & ~used)[0]
        rest = np.where(~good0)[0]
        k_fill = min(len(rest), len(fill))
        sel1[rest[:k_fill]] = fill[:k_fill]
        row1_ok = np.zeros((Nm,), bool)
        row1_ok[gi] = True
        row1_ok[rest[:k_fill]] = True

        def take(a, sel):
            return jnp.asarray(np.asarray(a)[sel])

        # KF0 (identity) + KF1 (T21)
        self.map, s0 = ms.insert_keyframe(
            self.map, lie.se3_identity(),
            jnp.asarray(self.init_frame_id, jnp.int32),
            take(self.init_feats.uv_und, sel0), take(self.init_feats.ur, sel0),
            take(self.init_feats.level, sel0), take(self.init_feats.angle, sel0),
            take(self.init_feats.desc, sel0), jnp.asarray(valid0[sel0]),
            jnp.full((Nm,), -1, jnp.int32),
            jnp.asarray(-1, jnp.int32),
        )
        self.map, s1 = ms.insert_keyframe(
            self.map, T21, jnp.asarray(self.frame_id, jnp.int32),
            take(feats.uv_und, sel1), take(feats.ur, sel1),
            take(feats.level, sel1), take(feats.angle, sel1),
            take(feats.desc, sel1), jnp.asarray(valid1[sel1] & row1_ok),
            jnp.full((Nm,), -1, jnp.int32), s0,
        )
        self.map, pids = ms.insert_points(
            self.map, jnp.asarray(pts[sel0]),
            take(self.init_feats.desc, sel0),
            jnp.full((Nm,), int(s0), jnp.int32), jnp.asarray(good0),
        )
        # wire observations in both KFs (rows aligned by construction)
        obs_row = jnp.where(pids >= 0, pids, -1)
        self.map = self.map._replace(
            kf_obs_point=self.map.kf_obs_point.at[int(s0)].set(obs_row)
            .at[int(s1)].set(obs_row)
        )
        self.map = ms.update_point_stats(
            self.map, orb.scale_factors(cfg.frontend.n_levels, cfg.frontend.scale_factor)[0]
        )
        # full BA on the initial map (GlobalBundleAdjustemnt(20),
        # src/Tracking.cc:686)
        self.map, _ = lm.run_global_ba(
            self.map, cfg.frontend.K, jnp.asarray(cfg.frontend.bf),
            self._inv_sigma2, n_iters=20,
        )
        self.T_cw = self.map.kf_pose[int(s1)]
        self.prev_obs = self.map.kf_obs_point[int(s1)]
        self.ref_kf = int(s1)
        self.ref_kf_matches = int(jnp.sum(self.prev_obs >= 0))
        self.last_kf_frame = self.frame_id
        self.velocity = lie.se3_identity()
        self.state = self.OK
        self._refresh_host_counters()

    def _depth_init(self, feats, timestamp):
        """StereoInitialization (src/Tracking.cc:509-561): first frame with
        >=500 features becomes KF0; every close keypoint spawns a point."""
        if int(jnp.sum(feats.valid)) < 500:
            return
        N = feats.uv.shape[0]
        self.map, s0 = ms.insert_keyframe(
            self.map, lie.se3_identity(),
            jnp.asarray(self.frame_id, jnp.int32),
            feats.uv_und, feats.ur, feats.level, feats.angle, feats.desc,
            feats.valid, jnp.full((N,), -1, jnp.int32),
            jnp.asarray(-1, jnp.int32),
        )
        self.map = _create_depth_points(
            self.map, int(s0), feats, self.cfg.frontend.K,
            self.cfg.frontend.bf, 1e9,
        )
        self.map = ms.update_point_stats(
            self.map,
            orb.scale_factors(
                self.cfg.frontend.n_levels, self.cfg.frontend.scale_factor
            )[0],
        )
        self.T_cw = lie.se3_identity()
        self.prev_obs = self.map.kf_obs_point[int(s0)]
        self.ref_kf = int(s0)
        self.ref_kf_matches = int(jnp.sum(self.prev_obs >= 0))
        self.last_kf_frame = self.frame_id
        self.state = self.OK
        self._refresh_host_counters()

    # ------------------------------------------------------------------

    def _record(self, timestamp):
        T_rel = lie.se3_compose(
            self.T_cw, lie.se3_inverse(self.map.kf_pose[self.ref_kf])
        )
        self.trajectory.append(
            (self.frame_id - 1, timestamp, self.ref_kf, np.asarray(T_rel))
        )
        return np.asarray(self.T_cw)

    def keyframe_trajectory(self):
        """(frame_id, T_cw 7-vec) per valid keyframe
        (SaveKeyFrameTrajectoryTUM, src/System.cc:383-417)."""
        self._flush()
        out = []
        kf_valid = np.asarray(self.map.kf_valid)
        kf_pose = np.asarray(self.map.kf_pose)
        kf_fid = np.asarray(self.map.kf_frame_id)
        for s in range(int(self.map.n_kf)):
            if kf_valid[s]:
                out.append((int(kf_fid[s]), kf_pose[s]))
        return out

    def full_trajectory(self):
        """Per-frame poses re-anchored on final optimized keyframe poses,
        walking the spanning tree past culled reference keyframes with
        their frozen T_child_parent (SaveTrajectoryTUM logic,
        src/System.cc:322-380; the while(pKF->isBad()) walk at :361-368)."""
        self._flush()
        out = []
        kf_pose = np.asarray(self.map.kf_pose)
        kf_valid = np.asarray(self.map.kf_valid)
        kf_parent = np.asarray(self.map.kf_parent)
        kf_tcp = np.asarray(self.map.kf_tcp)
        K = len(kf_valid)
        for fid, ts, ref, T_rel in self.trajectory:
            r = int(ref)
            T_rel_j = jnp.asarray(T_rel)
            hops = 0
            while not kf_valid[r] and kf_parent[r] >= 0 and hops < K:
                T_rel_j = lie.se3_compose(T_rel_j, jnp.asarray(kf_tcp[r]))
                r = int(kf_parent[r])
                hops += 1
            T = np.asarray(
                lie.se3_compose(T_rel_j, jnp.asarray(kf_pose[r]))
            )
            out.append((fid, ts, T))
        return out

    # file savers matching the reference's System::Save* (src/System.cc:322-472)

    def save_trajectory_tum(self, path: str):
        from ..utils import metrics, trajectory

        trajectory.save_tum(
            path,
            ((ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in self.full_trajectory()),
        )

    def save_keyframe_trajectory_tum(self, path: str):
        from ..utils import metrics, trajectory

        ts_by_fid = {fid: ts for fid, ts, _, _ in self.trajectory}
        trajectory.save_tum(
            path,
            (
                (ts_by_fid.get(fid, float(fid)), metrics.se3_vec_to_mat(T7))
                for fid, T7 in self.keyframe_trajectory()
            ),
        )

    def save_trajectory_kitti(self, path: str):
        from ..utils import metrics, trajectory

        trajectory.save_kitti(
            path,
            ((ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in self.full_trajectory()),
        )


def _np_se3_compose(a7, b7):
    """Host-side se3_compose (mat(A) @ mat(B)) for the compaction walks —
    avoids thousands of tiny device dispatches."""
    from ..utils import metrics
    from ..utils.trajectory import _R_to_quat

    M = metrics.se3_vec_to_mat(np.asarray(a7)) @ metrics.se3_vec_to_mat(
        np.asarray(b7)
    )
    qx, qy, qz, qw = _R_to_quat(M[:3, :3])
    return np.concatenate([[qw, qx, qy, qz], M[:3, 3]]).astype(np.float32)


def _np_se3_inverse(a7):
    """Host-side se3_inverse counterpart of _np_se3_compose."""
    from ..utils import metrics
    from ..utils.trajectory import _R_to_quat

    M = np.linalg.inv(metrics.se3_vec_to_mat(np.asarray(a7)))
    qx, qy, qz, qw = _R_to_quat(M[:3, :3])
    return np.concatenate([[qw, qx, qy, qz], M[:3, 3]]).astype(np.float32)


@jax.jit
def _bump_stats_arrays(pt_visible, pt_found, visible, found):
    return (
        pt_visible + visible.astype(jnp.int32),
        pt_found + found.astype(jnp.int32),
    )


def _bump_stats(m: ms.MapState, visible, found):
    # jit only the touched arrays: the other MapState leaves keep their
    # object identity across frames, which the System's observation-matrix
    # cache relies on (jit over the whole pytree would return fresh Array
    # objects for every leaf every frame)
    pv, pf = _bump_stats_arrays(m.pt_visible, m.pt_found, visible, found)
    return m._replace(pt_visible=pv, pt_found=pf)


from functools import partial

# eager calls of observation_matrix pay one dispatch per op; the System
# rebuilds it at keyframe rate through this jit
_observation_matrix_jit = jax.jit(ms.observation_matrix)
_obs_level_cum_jit = jax.jit(ms.obs_level_cum, static_argnums=(1,))


@jax.jit
def _frame_redundancy(red_cum, obs, level):
    """(n_redundant, n_tracked) of a frame's observation row against the
    per-point obs-level histogram — the sync-path twin of _frame_step's
    in-program census."""
    P, L = red_cum.shape
    lvl_gate = jnp.minimum(jnp.clip(level, 0, L - 1) + 1, L - 1)
    n_oth = red_cum[jnp.clip(obs, 0, P - 1), lvl_gate]
    tracked = obs >= 0
    return (
        jnp.sum(tracked & (n_oth >= 3.0)),
        jnp.sum(tracked),
    )


@partial(
    jax.jit,
    static_argnames=("fcfg", "sensor", "min_inl", "n_local_kf", "n_local_pt",
                     "depth_factor"),
)
def _frame_step(
    m: ms.MapState,
    obs_A,
    img,
    aux_img,
    T_cw,
    velocity,
    prev_obs,
    ref_kf,
    ref_anchor,
    red_cum,
    fcfg,
    sensor: str,
    min_inl: int,
    n_local_kf: int,
    n_local_pt: int,
    depth_factor: float = 1.0,
):
    """The whole per-frame hot path as ONE device program: extraction,
    guided matching, both pose optimizations, tracking-stat bumps, the
    keyframe-decision census, and the trajectory anchor — the
    single-dispatch equivalent of the reference's one-function-call
    frame (Tracking::Track, src/Tracking.cc:267-506).

    Returns (feats, T_new, vel_new, obs_new, pt_visible, pt_found,
    stats[19]) where stats packs every scalar the host needs:
    [n_inliers, n_matches, n_close_tracked, n_close_nontracked,
    T_new(7), T_rel(7), n_redundant]. n_redundant counts tracked points
    already observed >=3 times at the same-or-finer octave (gathered
    from ``red_cum``, the keyframe-rate histogram produced by
    _insert_and_map) — the KeyFrameCulling redundancy criterion
    (src/LocalMapping.cc:661-668) measured per FRAME, so the keyframe
    gate can skip views the map already covers. The host prefetches
    stats with ``copy_to_host_async`` and reads them one frame later, so
    the steady-state loop never blocks on the device."""
    if sensor == "mono":
        feats = fe.extract_mono(fcfg, img)
    elif sensor == "rgbd":
        feats = fe.extract_rgbd(
            fcfg, img, aux_img.astype(jnp.float32) * depth_factor
        )
    else:
        feats = fe.extract_stereo(fcfg, img, aux_img)

    # re-anchor the live pose on the reference keyframe: ``ref_anchor``
    # is the ref KF's pose as the tracking chain last saw it; any change
    # since (local BA per keyframe, loop-closure essential graph, GBA)
    # is applied as T_cw <- (T_cw o anchor^-1) o pose_now. The reference
    # gets the same effect implicitly by optimizing against the mutated
    # map under mMutexMapUpdate each frame (src/Tracking.cc:277); with
    # an immutable snapshot pipeline the correction must be explicit —
    # without it, BA refinements never reach the tracker and drift
    # accumulates (observed: EVAL ATE 1.6% -> 9.3% when this was
    # dropped in the first fast-path version).
    T_ref_now = m.kf_pose[ref_kf]
    T_cw = lie.se3_compose(
        lie.se3_compose(T_cw, lie.se3_inverse(ref_anchor)), T_ref_now
    )

    T_pred = lie.se3_compose(velocity, T_cw)
    res = tr.track_frame(
        m, feats, T_pred, prev_obs, fcfg.K, jnp.asarray(fcfg.bf),
        height=fcfg.height, width=fcfg.width, n_levels=fcfg.n_levels,
        scale=fcfg.scale_factor, n_local_kf=n_local_kf,
        n_local_pt=n_local_pt, obs_A=obs_A,
    )
    ok = res.n_inliers >= min_inl
    T_new = jnp.where(ok, res.T_cw, T_cw)
    vel_new = jnp.where(
        ok, lie.se3_compose(res.T_cw, lie.se3_inverse(T_cw)),
        lie.se3_identity(),
    )
    obs_new = jnp.where(ok, res.obs_point, -1)
    pt_visible = m.pt_visible + (res.visible_pt & ok).astype(jnp.int32)
    pt_found = m.pt_found + (res.found_pt & ok).astype(jnp.int32)

    # close-point census for the stereo/RGB-D keyframe decision
    # (src/Tracking.cc:1002-1019)
    if sensor in ("stereo", "rgbd"):
        close_th = fcfg.depth_th * fcfg.bf / max(fcfg.fx, 1e-6)
        close = feats.valid & (feats.depth > 0) & (feats.depth < close_th)
        n_tc = jnp.sum(close & (obs_new >= 0)).astype(jnp.float32)
        n_nc = jnp.sum(close & (obs_new < 0)).astype(jnp.float32)
    else:
        n_tc = jnp.float32(0.0)
        n_nc = jnp.float32(0.0)

    # frame redundancy census: tracked points whose map coverage already
    # meets the cull criterion (>=3 observations at octave <= own+1).
    # One [N] gather from the keyframe-rate histogram — free next to the
    # matmuls above, unlike recomputing the [K*N]->[P,L] histogram here.
    P = m.pt_pos.shape[0]
    L = red_cum.shape[1]
    lvl_gate = jnp.minimum(jnp.clip(feats.level, 0, L - 1) + 1, L - 1)
    n_oth = red_cum[jnp.clip(obs_new, 0, P - 1), lvl_gate]
    n_red = jnp.sum((obs_new >= 0) & (n_oth >= 3.0)).astype(jnp.float32)

    T_rel = lie.se3_compose(T_new, lie.se3_inverse(T_ref_now))
    stats = jnp.concatenate([
        jnp.stack([
            res.n_inliers.astype(jnp.float32),
            res.n_matches.astype(jnp.float32),
            n_tc,
            n_nc,
        ]),
        T_new,
        T_rel,
        n_red[None],
    ])
    return feats, T_new, vel_new, obs_new, pt_visible, pt_found, stats, T_ref_now


@partial(
    jax.jit,
    static_argnames=("fcfg", "sensor", "window", "quality"),
)
def _insert_and_map(
    m: ms.MapState,
    feats,
    T_cw,
    frame_id,
    parent,
    obs_row,
    protect,
    inv_sigma2,
    fcfg,
    sensor: str,
    window: int,
    quality: int = 0,
):
    """Keyframe insertion + the WHOLE LocalMapping pipeline as one device
    program (reference LocalMapping::Run order, src/LocalMapping.cc:47-112:
    ProcessNewKeyFrame -> MapPointCulling -> CreateNewMapPoints ->
    SearchInNeighbors -> LocalBA -> KeyFrameCulling). Dispatched
    asynchronously at keyframe rate, it overlaps with the tracking steps
    queued behind it exactly as the reference's mapping thread overlaps
    the camera thread — JAX's dataflow queue replaces the KF queue +
    mutexes (SURVEY.md §7 'versioned immutable map snapshots').

    Returns (m2, aux[6]) with aux = [n_new_points, n_pt, n_ref_minobs2,
    n_ref_minobs3, n_kf_live, n_pt_live]; the host prefetches aux — its
    readiness IS the reference's AcceptKeyFrames backpressure flag
    (src/LocalMapping.cc:603-613), and its values feed the next keyframe
    decision (TrackedMapPoints, capacity bookkeeping) without any
    blocking device fetch."""
    Kc, bf = fcfg.K, jnp.asarray(fcfg.bf)
    sf = orb.scale_factors(fcfg.n_levels, fcfg.scale_factor)[0]
    m, slot = ms.insert_keyframe(
        m, T_cw, frame_id,
        feats.uv_und, feats.ur, feats.level, feats.angle, feats.desc,
        feats.valid, obs_row, parent,
    )
    if sensor in ("stereo", "rgbd"):
        m = _create_depth_points(m, slot, feats, Kc, bf, fcfg.depth_th)
    m = lm.cull_points(m)
    # covisibility built TWICE per pass, exactly like the reference
    # (UpdateConnections at ProcessNewKeyFrame and after SearchInNeighbors,
    # src/LocalMapping.cc:164,521) — each build is a [K*P] scatter +
    # matmul, so the pre-fuse stages share one and the post-fuse stages
    # share the other
    W1 = ms.covisibility(m)
    m, n_new = lm.create_new_points(
        m, slot, Kc, bf, n_levels=fcfg.n_levels, scale=fcfg.scale_factor,
        W=W1,
    )
    # stats BEFORE fuse (fresh points need real scale bands for the
    # distance-predicted octave gates, src/MapPoint.cc:330-371)
    m = ms.update_point_stats(m, sf)
    m = lm.fuse_neighbors(
        m, slot, Kc, height=fcfg.height, width=fcfg.width,
        n_levels=fcfg.n_levels, scale=fcfg.scale_factor, W=W1,
    )
    W2 = ms.covisibility(m)
    m = ms.update_point_stats(m, sf)
    m, _ = lm.run_local_ba(
        m, slot, Kc, bf, inv_sigma2, window=window, W=W2,
    )
    valid_before = m.kf_valid
    m = lm.cull_keyframes(m, slot, protect, W=W2, n_levels=fcfg.n_levels)

    obs_cnt = ms.point_obs_count(m)
    P = m.pt_pos.shape[0]
    row = m.kf_obs_point[slot]
    cnt = obs_cnt[jnp.clip(row, 0, P - 1)]
    n_ref2 = jnp.sum((row >= 0) & (cnt >= 2))
    n_ref3 = jnp.sum((row >= 0) & (cnt >= 3))
    # churn observability: which slot (if any) this pass culled
    gone = valid_before & ~m.kf_valid
    culled_slot = jnp.where(jnp.any(gone), jnp.argmax(gone), -1)
    aux = jnp.stack([
        n_new.astype(jnp.float32),
        m.n_pt.astype(jnp.float32),
        n_ref2.astype(jnp.float32),
        n_ref3.astype(jnp.float32),
        jnp.sum(m.kf_valid).astype(jnp.float32),
        jnp.sum(m.pt_valid).astype(jnp.float32),
        culled_slot.astype(jnp.float32),
    ])
    # post-mapping per-(point, octave) observation histogram: consumed by
    # _frame_step's redundancy census, which gates keyframe insertion on
    # "does this view still add information" (the KeyFrameCulling 90%
    # criterion applied BEFORE paying for insertion — r04's 361-created/
    # 10-live churn was keyframes inserted at max cadence into mature map
    # regions and culled one pipeline-pass later)
    red_cum = ms.obs_level_cum(m, fcfg.n_levels)
    return m, aux, red_cum


@jax.jit
def _create_depth_points(m: ms.MapState, kf_id, feats, Kc, bf, depth_th):
    """Spawn map points from stereo/RGB-D depth for unmatched close
    keypoints (StereoInitialization src/Tracking.cc:509-561 and
    CreateNewKeyFrame src/Tracking.cc:1073-1133)."""
    from ..ops import camera

    N = feats.uv.shape[0]
    T = m.kf_pose[kf_id]
    want = (
        feats.valid
        & (feats.depth > 0)
        & (feats.depth < depth_th * bf / jnp.maximum(Kc[0], 1e-6))
        & (m.kf_obs_point[kf_id] < 0)
    )
    pc = camera.backproject(Kc, feats.uv_und, feats.depth)
    pw = lie.se3_apply(lie.se3_inverse(T), pc)
    m2, pids = ms.insert_points(
        m, pw, feats.desc, jnp.full((N,), kf_id, jnp.int32), want
    )
    row = jnp.where(pids >= 0, pids, m2.kf_obs_point[kf_id])
    return m2._replace(kf_obs_point=m2.kf_obs_point.at[kf_id].set(row))
