"""Map checkpoint / resume.

The reference left SaveMap/LoadMap as a TODO (include/System.h:115-117);
here the map is one pytree of arrays, so checkpointing is a single
compressed-npz round trip — implemented as a real feature per SURVEY.md §5.
"""

from __future__ import annotations

import numpy as np

from ..models import map_state as ms


def save_map(path: str, m: ms.MapState) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in m._asdict().items()})


def load_map(path: str) -> ms.MapState:
    import jax.numpy as jnp

    data = np.load(path)
    return ms.MapState(**{k: jnp.asarray(data[k]) for k in ms.MapState._fields})


def save_system(path: str, slam) -> None:
    """Checkpoint the full System: map + tracking state + trajectory +
    vocabulary + quadric landmarks (the reference's unimplemented
    SaveMap TODO, include/System.h:115-117, extended to a full resume)."""
    import pickle

    # drain the pipelined frame + in-flight mapping dispatch so the
    # checkpoint captures a consistent post-processing state
    slam._flush()
    slam._consume_map_aux(block=True)
    state = {
        "map": {k: np.asarray(v) for k, v in slam.map._asdict().items()},
        "state": slam.state,
        "frame_id": slam.frame_id,
        "T_cw": np.asarray(slam.T_cw),
        "velocity": np.asarray(slam.velocity),
        "prev_obs": np.asarray(slam.prev_obs),
        "ref_kf": slam.ref_kf,
        "ref_kf_matches": slam.ref_kf_matches,
        "last_kf_frame": slam.last_kf_frame,
        "trajectory": slam.trajectory,
        "metrics": slam.metrics,
        "quadrics": [
            {
                "class_id": lm.class_id,
                "kf_slots": lm.kf_slots,
                "bboxes": [np.asarray(b) for b in lm.bboxes],
                "point_ids": sorted(lm.point_ids),
                "initialized": lm.initialized,
                "pose": lm.pose,
                "scale": lm.scale,
            }
            for lm in (slam.quadrics.landmarks if slam.quadrics else [])
        ],
    }
    if slam.loop_closer is not None:
        from ..ops.vocab import Vocabulary

        lcs = slam.loop_closer
        state["words"] = np.asarray(lcs.words)
        state["loop_edges"] = list(lcs.loop_edges)
        state["last_loop_kf"] = lcs.last_loop_kf
        if lcs.sparse:
            # large (>=64k-word) vocabularies keep sparse per-KF BoW lists
            state["kf_wid"] = np.asarray(lcs.kf_wid)
            state["kf_wval"] = np.asarray(lcs.kf_wval)
        else:
            state["bow"] = np.asarray(lcs.bow)
        # embed the vocabulary only when it was trained on-the-fly for
        # this run; a pretrained vocabulary (the shipped .npz asset or an
        # ORBvoc .txt) is reloaded from its path by the receiving
        # System's config — provenance, not type, decides (the pretrained
        # .npz also loads as a Vocabulary NamedTuple)
        if isinstance(lcs.voc, Vocabulary) and (
            lcs.voc is not getattr(slam, "_pretrained_voc", None)
        ):
            state["vocab"] = {
                "k": lcs.voc.k,
                "levels": lcs.voc.levels,
                "idf": np.asarray(lcs.voc.idf),
                "centers": [np.asarray(c) for c in lcs.voc.centers],
            }
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_system(path: str, slam) -> None:
    """Restore a checkpoint into an already-constructed System (same
    configs). Mutates ``slam`` in place."""
    import pickle

    import jax.numpy as jnp

    with open(path, "rb") as f:
        state = pickle.load(f)
    slam.map = ms.MapState(
        **{k: jnp.asarray(v) for k, v in state["map"].items()}
    )
    slam.state = state["state"]
    slam.frame_id = state["frame_id"]
    slam.T_cw = jnp.asarray(state["T_cw"])
    slam.velocity = jnp.asarray(state["velocity"])
    slam.prev_obs = jnp.asarray(state["prev_obs"])
    slam.ref_kf = state["ref_kf"]
    slam.ref_kf_matches = state["ref_kf_matches"]
    slam.last_kf_frame = state["last_kf_frame"]
    slam.trajectory = state["trajectory"]
    slam.metrics = state["metrics"]
    if slam.quadrics is not None and state.get("quadrics"):
        from ..models.quadric_mapping import QuadricLandmark

        slam.quadrics.landmarks = [
            QuadricLandmark(
                class_id=q["class_id"], kf_slots=q["kf_slots"],
                bboxes=list(q["bboxes"]), point_ids=set(q["point_ids"]),
                initialized=q["initialized"], pose=q["pose"], scale=q["scale"],
            )
            for q in state["quadrics"]
        ]
    if "words" in state:
        from ..models.loop_closing import LoopCloser
        from ..ops.vocab import Vocabulary

        if "vocab" in state:
            voc = Vocabulary(
                centers=tuple(
                    jnp.asarray(c) for c in state["vocab"]["centers"]
                ),
                idf=jnp.asarray(state["vocab"]["idf"]),
                k=state["vocab"]["k"],
                levels=state["vocab"]["levels"],
            )
        elif slam.loop_closer is not None:
            voc = slam.loop_closer.voc  # pretrained, loaded via config
        else:
            voc = None
        if voc is not None:
            lcs = LoopCloser(voc, slam.cfg.map)
            lcs.grow(int(np.asarray(state["words"]).shape[0]))
            lcs.words = jnp.asarray(state["words"])
            if lcs.sparse and "kf_wid" in state:
                lcs.kf_wid = jnp.asarray(state["kf_wid"])
                lcs.kf_wval = jnp.asarray(state["kf_wval"])
            elif not lcs.sparse and "bow" in state:
                lcs.bow = jnp.asarray(state["bow"])
            lcs.loop_edges = [tuple(e) for e in state.get("loop_edges", [])]
            lcs.last_loop_kf = state.get("last_loop_kf", -999)
            slam.loop_closer = lcs
    # fast-path host mirrors must reflect the restored map
    slam._pend = None
    slam._map_aux = None
    slam._pending_loop = None
    if slam.state == slam.OK:
        slam._refresh_host_counters()
