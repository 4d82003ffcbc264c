#!/usr/bin/env python
"""Write tests/data/torch_sizes_fixture.npz, the camera-size references that
chip_smoke.py phase 13 holds the port to.

Runs with the JAX package on the CPU (about 6 minutes: the compiles at every
frame size dominate):

    JAX_PLATFORMS=cpu python tools/make_torch_sizes_fixture.py

The file holds SHA-256 digests (``tod_tpu_torch/utils/camera_sizes.py``
``digest``, which also defines the scenes and cameras below), not arrays:

- ``grid_json``: for each frame size of the grid (240x320, 480x640,
  480x848, 720x1280, 960x1280, 1080x1920), bench objects 0 and 1 rendered
  at that size (``size_scene``: VGA's focal length scaled with the width)
  and the reference's results on its serving gray: the frame's image and
  depth, the 8 levels of ``build_pyramid`` (scale 1.2; the 3-level
  pyramid's levels are its first three), ORB (5000 features) at 3 and 8
  levels (valid, xy, level, descriptors, in slot order) and SIFT (2000) at
  3 and 8 levels (valid, xy, level);
- ``main_json``: the main path at 720x1280 with ``K720``: bench objects
  0-2, 24 views each (``turntable_observations(obj, 12, (65, 40))``), the
  views' images, depths and masks; the reference Trainer's batched
  program over each object's views, dedup 8 bits / 5 mm and then 16 / 5 mm
  (rows and digests of each model); two scenes of the three objects
  (``bench_placements``), their images and depths and the reference detector's
  compacted queries at the bench's operating point (valid rows as a sorted
  multiset, and slot by slot);
- ``config_json``: that operating point (bench.py build_config, 5000
  features, gated at 156), served over the three trained models and the
  seeded fillers of the 100-object smoke catalog with ``seed`` 0;
- ``det_frame`` / ``det_ids`` / ``det_conf`` / ``det_quality`` / ``det_R`` /
  ``det_T``: the reference's gated detections of the two scenes, and
  ``gt_ids`` / ``gt_R`` / ``gt_T``: the scenes' placements.
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

from tod_tpu_torch.utils.camera_sizes import (  # noqa: E402
    GRID, HW720, K720, bench_placements, digest, rows_digest, size_scene,
    views_720p)

LEVELS = 8
SCALE = 1.2
N_OBJECTS = 3
N_SCENES = 2
N_FEATURES = 600            # the trainer's ORB (bench.build_db)
DEDUP = (8, 0.005)
RECOMPRESS = (16, 0.005)
CATALOG = 100
SEED = 0
GATE = 156.0


def features(gray) -> dict:
    import jax
    import jax.numpy as jnp
    from tod_tpu.ops import image as jimage
    from tod_tpu.ops import orb as jorb
    from tod_tpu.ops import sift as jsift

    g = jnp.asarray(gray)
    levels = jax.jit(lambda x: jimage.build_pyramid(x, LEVELS, SCALE))(g)
    out = {"levels": [digest(np.asarray(a)) for a in levels]}
    for n in (3, LEVELS):
        k, d = jax.jit(lambda x, n=n: jorb.orb_detect_and_compute(
            x, n_features=5000, n_levels=n, scale_factor=SCALE))(g)
        out[f"orb{n}"] = {**{name: digest(np.asarray(getattr(k, name)),
                                          name)
                             for name in ("valid", "xy", "level")},
                          "desc": digest(np.asarray(d), "desc"),
                          "n_valid": int(np.asarray(k.valid).sum())}
        k, _ = jax.jit(lambda x, n=n: jsift.sift_detect_and_compute(
            x, n_features=2000, n_levels=n, scale_factor=SCALE))(g)
        out[f"sift{n}"] = {**{name: digest(np.asarray(getattr(k, name)),
                                           name)
                              for name in ("valid", "xy", "level")},
                           "n_valid": int(np.asarray(k.valid).sum())}
    return out


def train(views) -> tuple:
    import jax.numpy as jnp
    from tod_tpu.cells.trainer import _jitted_train_views
    from tod_tpu.ops.compress import compress_model

    images = np.stack([o["image"] for o in views])
    run = _jitted_train_views("ORB", N_FEATURES, 3, SCALE, 20.0, HW720,
                              True, False)
    cams = [np.stack([np.asarray(np.asarray(o[k], np.float64), np.float32)
                      .reshape(shape) for o in views])
            for k, shape in (("K", (3, 3)), ("R", (3, 3)), ("T", (3,)))]
    desc, world, valid = (np.asarray(a) for a in run(
        jnp.asarray(images), jnp.asarray(np.stack([o["mask"] for o in views])),
        jnp.asarray(np.stack([o["depth"] for o in views])),
        *(jnp.asarray(c) for c in cams)))
    flat = valid.reshape(-1)
    d8, p8 = compress_model(desc.reshape(-1, 32)[flat],
                            world.reshape(-1, 3)[flat].astype(np.float32),
                            *DEDUP)
    d16, p16 = compress_model(d8, p8, *RECOMPRESS)
    return d8, np.asarray(p8, np.float32), d16, np.asarray(p16, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_sizes_fixture.npz"))
    args = ap.parse_args()

    import bench
    import jax.numpy as jnp
    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector
    from tod_tpu.ops.image import rgb_to_gray
    from tod_tpu.utils import synthetic as syn
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    grid = {}
    for h, w in GRID:
        t0 = time.time()
        image, depth = size_scene(syn, h, w)
        gray = np.asarray(rgb_to_gray(jnp.asarray(image)))
        grid[f"{h}x{w}"] = {"image": digest(image), "depth": digest(depth),
                            **features(gray)}
        print(f"{h}x{w}: {time.time() - t0:.0f} s", flush=True)

    objects = [bench.make_obj(i) for i in range(N_OBJECTS)]
    views, models, trained = {}, {}, []
    for obj in objects:
        t0 = time.time()
        obs = views_720p(syn, obj)
        views[obj.object_id] = {
            "n": len(obs),
            **{k: digest(np.stack([o[k] for o in obs]))
               for k in ("image", "depth", "mask")}}
        d8, p8, d16, p16 = train(obs)
        models[obj.object_id] = {"rows8": len(d8), "desc8": digest(d8),
                                 "points8": digest(p8), "rows16": len(d16),
                                 "desc16": digest(d16),
                                 "points16": digest(p16)}
        trained.append((d16, p16))
        print(f"{obj.object_id}: {len(obs)} views, {len(d8)} rows after "
              f"dedup 8, {len(d16)} after 16x5 ({time.time() - t0:.0f} s)",
              flush=True)

    cfg = dataclasses.replace(bench.build_config(5000), min_quality=GATE)
    ids, arrays = smoke_catalog([o.object_id for o in objects], trained,
                                n_objects=CATALOG)
    det = FusedDetector([TodModel(i, d, p) for i, (d, p) in
                         zip(ids, arrays)], cfg, seed=SEED)
    scenes, det_rows, gt = [], [], []
    for f, (trio, poses) in enumerate(bench_placements(syn, objects,
                                                       N_SCENES)):
        t0 = time.time()
        image, depth = syn.compose_scene(trio, poses, hw=HW720, K=K720)
        frame = det.prepare_frame(image, depth, K720)
        xy, qp, dsc, ok = (np.asarray(a) for a in det._stages[0](*frame))
        scenes.append({"image": digest(image), "depth": digest(depth),
                       "rows": rows_digest(xy, qp, dsc, ok),
                       "n_valid": int(ok.sum()),
                       **{k: digest(a, k) for k, a in
                          (("xy", xy), ("qp", qp), ("dsc", dsc), ("ok", ok))}})
        found = det.detect(image, depth, K720)
        det_rows += [(f, r) for r in found]
        gt.append([(o.object_id, np.asarray(R), np.asarray(T))
                   for o, (R, T) in zip(trio, poses)])
        print(f"scene {f}: " + ", ".join(
            f"{r.object_id} q={r.quality:.0f} inliers={r.confidence:.0f}"
            for r in found) + f" ({time.time() - t0:.0f} s)", flush=True)

    out = {
        "grid_json": json.dumps(grid),
        "main_json": json.dumps({"K": K720.tolist(), "seed": SEED,
                                 "catalog": CATALOG, "views": views,
                                 "models": models, "scenes": scenes}),
        "config_json": json.dumps(dataclasses.asdict(cfg)),
        "det_frame": np.array([f for f, _ in det_rows], np.int32),
        "det_ids": np.array([r.object_id for _, r in det_rows]),
        "det_conf": np.array([r.confidence for _, r in det_rows], np.float32),
        "det_quality": np.array([r.quality for _, r in det_rows],
                                np.float32),
        "det_R": np.array([np.asarray(r.R) for _, r in det_rows],
                          np.float32).reshape(-1, 3, 3),
        "det_T": np.array([np.asarray(r.T) for _, r in det_rows],
                          np.float32).reshape(-1, 3),
        "gt_ids": np.array([[oid for oid, _, _ in p] for p in gt]),
        "gt_R": np.array([[R for _, R, _ in p] for p in gt], np.float64),
        "gt_T": np.array([[T for _, _, T in p] for p in gt], np.float64),
    }
    np.savez_compressed(args.out, **{k: np.asarray(v) for k, v in
                                     out.items()})
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
