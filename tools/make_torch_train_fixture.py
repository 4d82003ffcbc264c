#!/usr/bin/env python
"""Write tests/data/torch_train_fixture.npz, the training workload of
chip_smoke.py and tests/test_torch_train.py.

Runs with the JAX package on the CPU (it renders with cv2):

    JAX_PLATFORMS=cpu python tools/make_torch_train_fixture.py

It renders the bench's objects 0..2 (bench.make_obj) with the bench's
capture plan (bench.build_db: 4 rings of 12 views at the first distance,
one ring of 12 at 60 degrees for each further distance; 60 views of
480x640) and trains them as the bench's Trainer does
(cells/trainer.py _jitted_train_views: ORB, 600 features, 3 levels, scale
1.2, FAST threshold 20, all views of an object in one batch), then dedups
at Hamming 8 / 5 mm (the Trainer's dedup_hamming) and again at 16 / 5 mm
(bench._recompress). It stops unless those models equal the smoke
fixture's desc0-2 / points0-2, which bench.build_db trained through the
whole TodTrainer graph.

The file holds, per object i:
- the views: gray{i} (V, H, W) u8 (one channel: the renders' three are
  equal, which the tool asserts), depth{i} (V, H, W) u16, mask{i} packed
  bits (np.packbits, bit order little) with mask_value{i} the value of a
  set pixel, K{i} / R{i} / T{i} float32 as the trainer reads them,
  frame{i} frame numbers;
- the reference's outputs: stacked{i}_desc / stacked{i}_points, the
  stacked model before dedup (mergePoints of the valid rows in view order),
  keep8_{i} (packed bits over the stacked rows: the rows the dedup at 8 /
  5 mm keeps) and keep16_{i} (over those rows: what 16 / 5 mm keeps).

Object 0 also carries its per-view outputs, views0_desc (V, K, 32),
views0_world (V, K, 3) and views0_valid (V, K) packed, and its SIFT model
on every fifth view (sift_views; 12 of 60, to keep the file small):
sift0_desc (N, 128) float32, sift0_points (N, 3), sift0_valid (12, K)
packed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_OBJECTS = 3
N_FEATURES = 600
DEDUP = (8, 0.005)          # the Trainer's dedup_hamming (bench BENCH_DEDUP)
RECOMPRESS = (16, 0.005)    # bench.DEFAULT_RECOMPRESS "16x5"
SIFT_STRIDE = 5


def bench_views(obj):
    """The bench's capture plan for one object (bench.build_db), in the
    order the trainer reads the views (by frame number)."""
    import bench
    from tod_tpu.utils.synthetic import turntable_observations

    dists = [float(v) for v in bench.DEFAULT_TRAIN_DIST.split(",")]
    elevs = tuple(float(v) for v in bench.DEFAULT_TRAIN_ELEV.split(","))
    views = list(turntable_observations(obj, n_views=12,
                                        elevations_deg=elevs,
                                        distance=dists[0]))
    for extra in dists[1:]:
        ring = turntable_observations(obj, n_views=12,
                                      elevations_deg=(60.0,), distance=extra)
        for o in ring:
            o["frame_number"] += len(views)
        views += ring
    return sorted(views, key=lambda o: o["frame_number"])


def train_batch(views, feature: str):
    """The Trainer's one batched program over ``views``: (desc, world,
    valid) per view, as numpy."""
    import jax.numpy as jnp
    from tod_tpu.cells.trainer import _jitted_train_views

    images = np.stack([o["image"] for o in views])
    run = _jitted_train_views(feature, N_FEATURES, 3, 1.2, 20.0,
                              images.shape[1:3], images.ndim == 4, False)
    # the trainer reads K, R, T from the DB, stored as float64
    cams = [np.stack([np.asarray(np.asarray(o[k], np.float64), np.float32)
                      .reshape(shape) for o in views])
            for k, shape in (("K", (3, 3)), ("R", (3, 3)), ("T", (3,)))]
    out = run(jnp.asarray(images),
              jnp.asarray(np.stack([o["mask"] for o in views])),
              jnp.asarray(np.stack([o["depth"] for o in views])),
              *(jnp.asarray(c) for c in cams))
    return tuple(np.asarray(a) for a in out), cams


def packed(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, bool), axis=-1, bitorder="little")


def _subset(d, p, d_kept, p_kept) -> np.ndarray:
    """The rows of (d, p) that an order-preserving filter kept as
    (d_kept, p_kept): greedy, first match in order."""
    keep = np.zeros(len(d), bool)
    j = 0
    for r in range(len(d)):
        if j < len(d_kept) and np.array_equal(d[r], d_kept[j]) \
                and np.array_equal(p[r], p_kept[j], equal_nan=True):
            keep[r] = True
            j += 1
    assert j == len(d_kept), "the kept rows are not a subsequence"
    return keep


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_train_fixture.npz"))
    args = ap.parse_args()

    import bench
    from tod_tpu.ops.compress import compress_model

    smoke = np.load(os.path.join(ROOT, "tests", "data",
                                 "torch_smoke_fixture.npz"))
    out = {"config_json": np.asarray(json.dumps(dict(
        feature="ORB", n_features=N_FEATURES, n_levels=3, scale_factor=1.2,
        fast_threshold=20.0, dedup=DEDUP, recompress=RECOMPRESS,
        train_dist=bench.DEFAULT_TRAIN_DIST,
        train_elev=bench.DEFAULT_TRAIN_ELEV, sift_stride=SIFT_STRIDE)))}
    for i in range(N_OBJECTS):
        t0 = time.time()
        obj = bench.make_obj(i)
        views = bench_views(obj)
        images = np.stack([o["image"] for o in views])
        assert (images == images[..., :1]).all(), "render not gray"
        masks = np.stack([o["mask"] for o in views])
        values = np.unique(masks)
        assert len(values) <= 2 and values[0] == 0, values
        (desc, world, valid), cams = train_batch(views, "ORB")
        flat = valid.reshape(-1)
        stacked_d = desc.reshape(-1, 32)[flat]
        stacked_p = world.reshape(-1, 3)[flat].astype(np.float32)
        d8, p8 = compress_model(stacked_d, stacked_p, *DEDUP)
        d16, p16 = compress_model(d8, p8, *RECOMPRESS)
        if not (np.array_equal(d16, smoke[f"desc{i}"])
                and np.array_equal(p16, smoke[f"points{i}"])):
            raise SystemExit(
                f"object {i}: the 16x5 model ({len(d16)} rows) is not the "
                f"smoke fixture's ({len(smoke[f'desc{i}'])} rows)")
        keep8 = _subset(stacked_d, stacked_p, d8, p8)
        keep16 = _subset(d8, p8, d16, p16)
        out.update({
            f"gray{i}": images[..., 0], f"depth{i}": np.stack(
                [o["depth"] for o in views]),
            f"mask{i}": packed(masks > 0),
            f"mask_value{i}": np.asarray(values[-1], masks.dtype),
            f"K{i}": cams[0], f"R{i}": cams[1], f"T{i}": cams[2],
            f"frame{i}": np.asarray([o["frame_number"] for o in views],
                                    np.int32),
            f"stacked{i}_desc": stacked_d, f"stacked{i}_points": stacked_p,
            f"keep8_{i}": packed(keep8), f"keep16_{i}": packed(keep16)})
        if i == 0:
            out.update({"views0_desc": desc, "views0_world": world,
                        "views0_valid": packed(valid)})
            sv = list(range(0, len(views), SIFT_STRIDE))
            (s_desc, s_world, s_valid), _ = train_batch(
                [views[v] for v in sv], "SIFT")
            s_flat = s_valid.reshape(-1)
            out.update({"sift_views": np.asarray(sv, np.int32),
                        "sift0_desc": s_desc.reshape(-1, 128)[s_flat],
                        "sift0_points": s_world.reshape(-1, 3)[s_flat]
                        .astype(np.float32),
                        "sift0_valid": packed(s_valid)})
        print(f"object {i}: {len(views)} views, {len(stacked_d)} rows -> "
              f"{len(d8)} (dedup 8) -> {len(d16)} (16x5, equal to the smoke "
              f"fixture's) in {time.time() - t0:.0f}s", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")



if __name__ == "__main__":
    main()
