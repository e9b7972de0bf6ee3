"""Offline vocabulary training: a >=10^5-word BoW tree for THIS repo's
BRIEF pattern (ops/orb.py builds its own seeded pattern — the standard
ORBvoc.txt was trained on the reference's bit_pattern_31_ and scores
poorly on foreign descriptors).

The reference ships/loads a ~1M-leaf pretrained ORBvoc (System.cc:64-71)
trained on a large image corpus. This is the equivalent asset: descriptors
extracted from a diverse synthetic corpus (many textures x many poses),
hierarchical Hamming k-medians (ops/vocab.train), saved to
orbslam2_with_quadrics_tpu/assets/vocab_100k.npz, which System loads by
default (SystemConfig.vocab_path='auto').

Also validates retrieval: on a held-out revisit sequence, the true
revisited keyframe must rank in the database top-k.

Usage:
    python scripts/train_vocab.py [--frames 240] [--features 2000]
                                  [--k 10] [--levels 5]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import numpy as np


def collect_descriptors(n_frames, n_features, h, w):
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.utils import synthetic

    fx = 520.0 * w / 640.0
    cfg = fe.FrontendConfig(
        height=h, width=w, n_features=n_features, n_levels=8,
        fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
    )
    out = []
    t0 = time.time()
    # diversity: many textures (seed), several motions per texture
    n_tex = max(n_frames // 12, 1)
    done = 0
    for tex_seed in range(n_tex):
        for img, _ in synthetic.planar_stream(
            n_frames=12, h=h, w=w, fx=fx, fy=fx, seed=100 + tex_seed,
            motion=("strafe", "orbit_loop", "survey")[tex_seed % 3],
            plane_half=3.0 + (tex_seed % 5), relief=(tex_seed % 2 == 0),
        ):
            feats = fe.extract_mono(cfg, jnp.asarray(img))
            v = np.asarray(feats.valid)
            out.append(np.asarray(feats.desc)[v])
            done += 1
            if done % 24 == 0:
                print(
                    f"extracted {done} frames, "
                    f"{sum(len(o) for o in out)} descriptors, "
                    f"t={time.time()-t0:.0f}s", flush=True,
                )
    desc = np.concatenate(out, axis=0)
    # dedupe exact duplicates (textures repeat under BORDER_WRAP)
    desc = np.unique(desc, axis=0)
    return desc


def validate_retrieval(voc, h=240, w=320, n_features=512):
    """Hold-out check: drive a revisit loop; for each late frame that
    re-observes an early place, the early keyframe must outrank the
    unrelated ones in BoW score."""
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.models import frontend as fe
    from orbslam2_with_quadrics_tpu.ops import vocab as vocab_mod
    from orbslam2_with_quadrics_tpu.utils import synthetic

    fx = 260.0 * w / 320.0
    cfg = fe.FrontendConfig(
        height=h, width=w, n_features=n_features, n_levels=4,
        fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
    )
    n = 40
    words_all, valid_all = [], []
    for img, _ in synthetic.planar_stream(
        n_frames=n, h=h, w=w, fx=fx, fy=fx, seed=999, motion="orbit_loop",
        plane_half=4.0, relief=True,
    ):
        feats = fe.extract_mono(cfg, jnp.asarray(img))
        wid, _ = vocab_mod.transform_any(voc, feats.desc, feats.valid)
        words_all.append(np.asarray(wid))
        valid_all.append(np.asarray(feats.valid))

    # orbit_loop returns to start: frame n-1 revisits frame 0's place.
    # score frame n-1's words against all earlier frames
    def l1_score(wa, wb):
        # sparse L1 similarity via tf-idf bags
        import collections

        idf = np.asarray(voc.idf)

        def bag(ws):
            c = collections.Counter(int(x) for x in ws if x >= 0)
            tot = sum(c.values())
            return {k: v / tot * idf[k] for k, v in c.items()} if tot else {}

        A, B = bag(wa), bag(wb)
        na = sum(abs(v) for v in A.values()) or 1.0
        nb = sum(abs(v) for v in B.values()) or 1.0
        s = 0.0
        for k2, va in A.items():
            if k2 in B:
                va_, vb_ = va / na, B[k2] / nb
                s += abs(va_) + abs(vb_) - abs(va_ - vb_)
        return 0.5 * s

    q = words_all[-1]
    scores = [l1_score(q, words_all[i]) for i in range(n - 8)]
    truth = int(np.argmax(scores))
    top5 = np.argsort(scores)[::-1][:5]
    # the revisited place is frames 0-3 (orbit returns to start)
    hit1 = truth <= 3
    hit5 = any(t <= 3 for t in top5)
    return {
        "revisit_top1_hit": bool(hit1),
        "revisit_top5_hit": bool(hit5),
        "best_match_frame": truth,
        "score_best": float(max(scores)),
        "score_median": float(np.median(scores)),
        "separation": float(max(scores) / max(np.median(scores), 1e-9)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import vocab as vocab_mod

    out = args.out or os.path.join(
        REPO, "orbslam2_with_quadrics_tpu", "assets",
        f"vocab_{args.k**args.levels // 1000}k.npz",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)

    print(f"collecting descriptors ({args.frames} frames x "
          f"{args.features} features)...", flush=True)
    desc = collect_descriptors(
        args.frames, args.features, args.height, args.width
    )
    print(f"training on {len(desc)} unique descriptors -> "
          f"{args.k}^{args.levels} = {args.k**args.levels} words", flush=True)
    t0 = time.time()
    voc = vocab_mod.train(
        jnp.asarray(desc), k=args.k, levels=args.levels, seed=0
    )
    import jax

    jax.block_until_ready(voc.idf)
    t_train = time.time() - t0
    vocab_mod.save(out, voc)
    sz = os.path.getsize(out) / 1e6
    print(f"trained in {t_train:.0f}s, saved {out} ({sz:.1f} MB)", flush=True)

    print("validating retrieval on held-out revisit sequence...", flush=True)
    val = validate_retrieval(voc)
    report = {
        "asset": os.path.relpath(out, REPO),
        "words": args.k ** args.levels,
        "k": args.k, "levels": args.levels,
        "train_descriptors": int(len(desc)),
        "train_seconds": round(t_train, 1),
        "asset_mb": round(sz, 2),
        "retrieval": val,
    }
    print(json.dumps(report))
    with open(os.path.join(REPO, "VOCAB_TRAIN.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
