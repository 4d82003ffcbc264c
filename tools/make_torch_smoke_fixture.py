#!/usr/bin/env python
"""Write tests/data/torch_smoke_fixture.npz, the workload of chip_smoke.py.

Runs with the JAX package on the CPU (it renders with cv2):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py

It trains the bench's objects 0..2 (plane, box, cylinder) with the bench's
capture plan and load-time recompression (bench.build_db), renders 2 scenes
of them at the bench's seeded poses (bench.build_scenes), builds the
100-object smoke catalog (tod_tpu_torch/utils/smoke_catalog.py) and runs the
JAX FusedDetector at the bench's operating point with min_quality 156 on
both frames. The file holds the models, the frames (RGB u8, depth u16), K,
the ground-truth placements, the reference's compaction outputs (xy, 3D
query points, descriptors, ok) and gated detections, and the config they
were made with.
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

N_REAL = 3
N_SCENES = 2
MIN_QUALITY = 156.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_smoke_fixture.npz"))
    args = ap.parse_args()
    os.environ["BENCH_DB_CACHE"] = ""     # train live, cache nothing

    import bench
    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector
    from tod_tpu.utils.synthetic import DEFAULT_K
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    t0 = time.time()
    objects, models = bench.build_db(N_REAL)
    print(f"trained {N_REAL} models in {time.time() - t0:.0f}s: rows "
          f"{[m.n_points for m in models]}", flush=True)
    scenes = bench.build_scenes(objects, N_SCENES)
    ids, arrays = smoke_catalog([m.object_id for m in models],
                                [(m.descriptors, m.points) for m in models])
    catalog = [TodModel(i, d, p) for i, (d, p) in zip(ids, arrays)]
    cfg = dataclasses.replace(bench.build_config(5000),
                              min_quality=MIN_QUALITY)
    det = FusedDetector(catalog, cfg)
    ref, compact = [], []
    for s, (image, depth, _) in enumerate(scenes):
        t0 = time.time()
        # the compaction stage's outputs (xy, query points, descriptors,
        # ok), so that the port's features can be held to them on the card
        compact.append([np.asarray(a) for a in det._stages[0](
            *det.prepare_frame(image, depth, DEFAULT_K))])
        found = det.detect(image, depth, DEFAULT_K)
        print(f"scene {s}: {len(found)} gated detections in "
              f"{time.time() - t0:.0f}s: "
              f"{[(r.object_id, r.quality) for r in found]}", flush=True)
        ref += [(s, r) for r in found]

    out = {
        "config_json": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        "model_ids": np.asarray([m.object_id for m in models]),
        "K": np.asarray(DEFAULT_K, np.float32),
        "images": np.stack([img for img, _, _ in scenes]),
        "depths": np.stack([dep for _, dep, _ in scenes]),
        "gt_ids": np.asarray([[oid for oid, _, _ in gt]
                              for _, _, gt in scenes]),
        "gt_R": np.asarray([[R for _, R, _ in gt] for _, _, gt in scenes],
                           np.float32),
        "gt_T": np.asarray([[T for _, _, T in gt] for _, _, gt in scenes],
                           np.float32),
        "ref_frame": np.asarray([s for s, _ in ref], np.int32),
        "ref_ids": np.asarray([r.object_id for _, r in ref]),
        "ref_R": np.asarray([r.R for _, r in ref], np.float32).reshape(-1, 3, 3),
        "ref_T": np.asarray([r.T for _, r in ref], np.float32).reshape(-1, 3),
        "ref_quality": np.asarray([r.quality for _, r in ref], np.float32),
        "ref_xy": np.stack([c[0] for c in compact]),
        "ref_qp": np.stack([c[1] for c in compact]),
        "ref_dsc": np.stack([c[2] for c in compact]),
        "ref_ok": np.stack([c[3] for c in compact]),
    }
    for i, m in enumerate(models):
        out[f"desc{i}"] = m.descriptors
        out[f"points{i}"] = m.points.astype(np.float32)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
