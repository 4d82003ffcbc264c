#!/usr/bin/env python
"""Write tests/data/torch_a16_fixture.npz, the reference of chip_smoke.py's
phases 8a and 8c (sub-pixel keypoints and models, batched detection).

Runs with the JAX package on the CPU, after the smoke, SIFT, global and
train fixtures (it reads their frames, models, views and configs):

    JAX_PLATFORMS=cpu python tools/make_torch_a16_fixture.py

The file holds

- ``sub_xy`` (2, 5000, 2) and ``sub_valid``: the reference's ORB keypoints
  of both smoke frames with ``subpixel=True`` at the serving point (5000
  features, 3 levels, scale 1.2, FAST threshold 20), compiled;
- object 0's sub-pixel model from its 60 views of torch_train_fixture.npz
  (the Trainer's batched program with ``subpixel=True``, ORB 600
  features): ``sub8_desc`` / ``sub8_points`` after the Trainer's dedup at
  8 bits / 5 mm, and ``sub_keep16`` (packed bits, bit order little, over
  those rows) the rows the bench's recompression at 16 bits / 5 mm keeps;
- ``subserve_*``: the reference's detections (every accept, with its
  quality; the gate is applied on the host) of the 100-object ORB smoke
  catalog with object 0 swapped for its sub-pixel model, served with
  ``subpixel=True`` at the smoke fixture's config (seed 0), on both frames;
- ``batch_{orb,sift,global}_*``: the reference's per-frame detections of
  both frames with the batch keys of ``detect_batch_raw`` at B = 2,
  ``split(split(PRNGKey(BATCH_SEED))[1], 2)[b]``, through its compiled
  per-frame stages under its batched config (``fixed_refine_loop=True``;
  the full exact sweep): the 100-object ORB smoke catalog at the smoke
  fixture's config, the 100-object SIFT smoke catalog at the SIFT
  fixture's, the ORB catalog on the global-kNN path at the global
  fixture's.

``*_config_json`` hold the configs, gated as the fixtures they come from.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DATA = os.path.join(ROOT, "tests", "data")
N_FEATURES_TRAIN = 600
DEDUP = (8, 0.005)
RECOMPRESS = (16, 0.005)
SEED = 0
BATCH_SEED = 11
B = 2


def packed(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, bool), axis=-1, bitorder="little")


def accepts(det, object_ids, cfg, frame: int):
    """Every accepted instance of one frame's detections (O, I, ...):
    ``(frame, id, R, T, quality, inliers)``, the quality as the reference's
    ``confidence_v2``."""
    from tod_tpu.models.fused import confidence_v2

    acc = np.asarray(det.accepted)
    n_in, rms, cs = (np.asarray(x) for x in (det.n_inliers,
                                             det.rms_residual,
                                             det.clique_size))
    out = []
    for o, inst in zip(*np.nonzero(acc)):
        q = confidence_v2(float(n_in[o, inst]), float(rms[o, inst]),
                          int(cs[o, inst]), cfg.guess.sensor_error)
        out.append((frame, object_ids[o], np.asarray(det.R[o, inst]),
                    np.asarray(det.T[o, inst]), q, float(n_in[o, inst])))
    return out


def pack(prefix: str, ref) -> dict:
    return {
        f"{prefix}_frame": np.asarray([r[0] for r in ref], np.int32),
        f"{prefix}_ids": np.asarray([r[1] for r in ref]),
        f"{prefix}_R": np.asarray([r[2] for r in ref],
                                  np.float32).reshape(-1, 3, 3),
        f"{prefix}_T": np.asarray([r[3] for r in ref],
                                  np.float32).reshape(-1, 3),
        f"{prefix}_quality": np.asarray([r[4] for r in ref], np.float32),
        f"{prefix}_inliers": np.asarray([r[5] for r in ref], np.float32),
    }


def checked_config(cfg, stored_json: str):
    """``cfg`` gated at the stored config's gate, which it must equal."""
    stored = json.loads(stored_json)
    gated = dataclasses.replace(cfg, min_quality=stored["min_quality"])
    mine = json.loads(json.dumps(dataclasses.asdict(gated)))
    if mine != stored:
        raise SystemExit(f"config differs from the fixture's in "
                         f"{sorted(k for k in mine if mine[k] != stored[k])}")
    return gated


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        DATA, "torch_a16_fixture.npz"))
    ap.add_argument("--objects", type=int, default=100,
                    help="catalog size (smaller ones rehearse chip_smoke.py "
                         "on a CPU)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench
    from tod_tpu.cells.trainer import _jitted_train_views
    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector, FusedDetectorConfig
    from tod_tpu.models.fused import geom_db
    from tod_tpu.ops import image as jimage
    from tod_tpu.ops.compress import compress_model
    from tod_tpu.ops.orb import orb_detect_and_compute
    from tod_tpu_torch.types import fixture_observations
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    gx = np.load(os.path.join(DATA, "torch_global_fixture.npz"))
    tx = np.load(os.path.join(DATA, "torch_train_fixture.npz"))
    K = fx["K"]
    frames = [(fx["images"][f], fx["depths"][f]) for f in range(B)]
    model_ids = [str(s) for s in fx["model_ids"]]
    orb_cfg = checked_config(bench.build_config(5000), str(fx["config_json"]))
    out = {"seed": np.asarray(SEED, np.int32),
           "batch_seed": np.asarray(BATCH_SEED, np.int32)}

    # ---- sub-pixel keypoints of both frames --------------------------------
    kw = dict(n_features=orb_cfg.n_features, n_levels=orb_cfg.n_levels,
              scale_factor=orb_cfg.scale_factor,
              fast_threshold=orb_cfg.fast_threshold)
    detect = jax.jit(lambda g: orb_detect_and_compute(g, subpixel=True,
                                                      **kw))
    kps = [detect(jimage.rgb_to_gray(jnp.asarray(image, jnp.float32)))[0]
           for image, _ in frames]
    out["sub_xy"] = np.stack([np.asarray(k.xy) for k in kps])
    out["sub_valid"] = np.stack([np.asarray(k.valid) for k in kps])

    # ---- object 0's sub-pixel model -----------------------------------------
    t0 = time.time()
    obs = fixture_observations(tx, 0)
    images = np.stack([o.image for o in obs])
    run = _jitted_train_views("ORB", N_FEATURES_TRAIN, 3, 1.2, 20.0,
                              images.shape[1:3], images.ndim == 4, True)
    desc, world, valid = (np.asarray(a) for a in run(
        jnp.asarray(images), jnp.asarray(np.stack([o.mask for o in obs])),
        jnp.asarray(np.stack([o.depth for o in obs])),
        *(jnp.asarray(np.stack([np.asarray(getattr(o, n), np.float32)
                                for o in obs])) for n in "KRT")))
    flat = valid.reshape(-1)
    d8, p8 = compress_model(desc.reshape(-1, 32)[flat],
                            world.reshape(-1, 3)[flat].astype(np.float32),
                            *DEDUP)
    d16, p16 = compress_model(d8, p8, *RECOMPRESS)
    keep16 = np.zeros(len(d8), bool)
    j = 0
    for r in range(len(d8)):        # the recompression keeps a subsequence
        if j < len(d16) and np.array_equal(d8[r], d16[j]) \
                and np.array_equal(p8[r], p16[j]):
            keep16[r] = True
            j += 1
    assert j == len(d16)
    out.update(sub8_desc=d8, sub8_points=p8, sub_keep16=packed(keep16))
    print(f"object 0 sub-pixel: {int(flat.sum())} rows stacked, {len(d8)} "
          f"after {DEDUP}, {len(d16)} after {RECOMPRESS}; "
          f"{time.time() - t0:.0f}s", flush=True)

    # ---- the sub-pixel catalog served with subpixel=True -------------------
    real = [(fx[f"desc{i}"], fx[f"points{i}"]) for i in range(len(model_ids))]
    ids, arrays = smoke_catalog(model_ids, real, n_objects=args.objects)
    orb_catalog = [TodModel(i, d, p) for i, (d, p) in zip(ids, arrays)]
    sub_catalog = [TodModel(model_ids[0], d16, p16)] + orb_catalog[1:]
    sub_cfg = dataclasses.replace(orb_cfg, subpixel=True)
    out["sub_config_json"] = np.asarray(json.dumps(dataclasses.asdict(
        sub_cfg)))
    det = FusedDetector(sub_catalog, dataclasses.replace(sub_cfg,
                                                         min_quality=0.0),
                        seed=SEED)
    ref = []
    for f, (image, depth) in enumerate(frames):
        t0 = time.time()
        _, raw = det.detect_raw(image, depth, K)
        ref += accepts(raw, ids, sub_cfg, f)
        print(f"sub-pixel serving, frame {f}: {time.time() - t0:.0f}s: "
              f"{[(r[1], round(r[4])) for r in ref if r[0] == f]}",
              flush=True)
    out.update(pack("subserve", ref))
    del det

    # ---- the batch keys' per-frame detections, B = 2 -----------------------
    _, sub = jax.random.split(jax.random.PRNGKey(BATCH_SEED))
    keys = jax.random.split(sub, B)

    def fixed(cfg):
        return dataclasses.replace(cfg, min_quality=0.0, guess=dataclasses.
                                   replace(cfg.guess, ransac=dataclasses.
                                           replace(cfg.guess.ransac,
                                                   fixed_refine_loop=True)))

    sift_cfg = checked_config(dataclasses.replace(orb_cfg, feature="SIFT",
                                                  radius=0.9),
                              str(sx["config_json"]))
    quant = [(sx[f"desc{i}"], sx[f"points{i}"]) for i in range(3)]
    s_ids, s_arrays = smoke_catalog([str(s) for s in sx["model_ids"]], quant,
                                    n_objects=args.objects)
    sift_catalog = [TodModel(i, d.astype(np.float32) / 256.0, p)
                    for i, (d, p) in zip(s_ids, s_arrays)]
    glob_cfg = checked_config(FusedDetectorConfig(pipeline="global"),
                              str(gx["config_json"]))
    for name, cfg, catalog, cat_ids in (
            ("orb", orb_cfg, orb_catalog, ids),
            ("sift", sift_cfg, sift_catalog, s_ids),
            ("global", glob_cfg, orb_catalog, ids)):
        out[f"batch_{name}_config_json"] = np.asarray(json.dumps(
            dataclasses.asdict(cfg)))
        det = FusedDetector(catalog, fixed(cfg), seed=BATCH_SEED)
        s1, s2, s3 = det._stages
        ref = []
        for b, (image, depth) in enumerate(frames):
            t0 = time.time()
            feats = s1(*det.prepare_frame(image, depth, K))
            if det.segmented:
                xy, qp, dsc, ok = feats
                dist, rows = s2(dsc, det.sdb)
                raw = s3(keys[b], xy, qp, ok, dist, rows, det.sdb.points,
                         det.sdb.obj_start, det.sdb.spans)
            else:
                kp, desc, qp = feats
                dist, rows = s2(desc, det.db)
                raw = s3(keys[b], kp.xy, kp.valid, dist, rows, qp,
                         geom_db(det.db))
            ref += accepts(raw, cat_ids, cfg, b)
            print(f"batch {name}, frame {b}: {time.time() - t0:.0f}s: "
                  f"{[(r[1], round(r[4])) for r in ref if r[0] == b]}",
                  flush=True)
        out.update(pack(f"batch_{name}", ref))
        del det

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
