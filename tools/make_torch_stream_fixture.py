#!/usr/bin/env python
"""Write tests/data/torch_stream_fixture.npz, the coarse->fine reference of
chip_smoke.py.

Runs with the JAX package on the CPU, after make_torch_smoke_fixture.py:

    JAX_PLATFORMS=cpu python tools/make_torch_stream_fixture.py

It reuses the smoke fixture's three trained models and two frames, builds
the 100-object smoke catalog (tod_tpu_torch/utils/smoke_catalog.py) and runs
the JAX FusedDetector with the frontier recipe of docs/SERVING.md
(coarse->fine at stride 16 into a 64-slot slab with 16 tracked and 16
exploration slots, coarse queries at stride 2) on the bench's operating
point, gated at min_quality 156, over a stream of six frames (the two
fixture frames alternated). The file holds, per frame, the slab (``sel``,
``force``, ``force_act``) and the gated detections, and the config they
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

N_FRAMES = 6
SEED = 0
# docs/SERVING.md "Sizing rules of thumb", ~400-2000 objects, streaming
FRONTIER = dict(coarse_stride=16, fine_width=64, coarse_q_stride=2,
                track_width=16, explore_width=16, track_ttl=2,
                track_min_confidence=16.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data = os.path.join(ROOT, "tests", "data")
    ap.add_argument("--smoke", default=os.path.join(
        data, "torch_smoke_fixture.npz"))
    ap.add_argument("--out", default=os.path.join(
        data, "torch_stream_fixture.npz"))
    args = ap.parse_args()

    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector, FusedDetectorConfig
    from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
    from tod_tpu.geometry.ransac import RansacConfig
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    fx = np.load(args.smoke)
    real = [(fx[f"desc{i}"], fx[f"points{i}"])
            for i in range(len(fx["model_ids"]))]
    ids, arrays = smoke_catalog([str(s) for s in fx["model_ids"]], real)
    catalog = [TodModel(i, d, p) for i, (d, p) in zip(ids, arrays)]
    base = json.loads(str(fx["config_json"]))
    guess = base.pop("guess")
    cfg = FusedDetectorConfig(**{
        **base, **FRONTIER,
        "bucket_grid": tuple(base["bucket_grid"]),
        "activation": ActivationConfig(**base.pop("activation")),
        "guess": GuessConfig(ransac=RansacConfig(**guess.pop("ransac")),
                             **guess)})
    det = FusedDetector(catalog, cfg, seed=SEED)
    slabs = []
    c1, c2, c3 = det._coarse

    def recording_c1(*a):
        out = c1(*a)
        slabs.append([np.asarray(x) for x in out])
        return out

    det._coarse = (recording_c1, c2, c3)
    ref = []
    for f in range(N_FRAMES):
        t0 = time.time()
        found = det.detect(fx["images"][f % 2], fx["depths"][f % 2], fx["K"])
        print(f"frame {f}: {len(found)} gated detections in "
              f"{time.time() - t0:.0f}s: "
              f"{[(r.object_id, r.quality) for r in found]}", flush=True)
        ref += [(f, r) for r in found]

    out = {
        "config_json": np.asarray(json.dumps(dataclasses.asdict(cfg))),
        "frame_image": np.arange(N_FRAMES, dtype=np.int32) % 2,
        "sel": np.stack([s[0] for s in slabs]).astype(np.int32),
        "force": np.stack([s[1] for s in slabs]),
        "force_act": np.stack([s[2] for s in slabs]),
        "ref_frame": np.asarray([f for f, _ in ref], np.int32),
        "ref_ids": np.asarray([r.object_id for _, r in ref]),
        "ref_R": np.asarray([r.R for _, r in ref], np.float32).reshape(-1, 3, 3),
        "ref_T": np.asarray([r.T for _, r in ref], np.float32).reshape(-1, 3),
        "ref_quality": np.asarray([r.quality for _, r in ref], np.float32),
    }
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e3:.1f} kB)")


if __name__ == "__main__":
    main()
