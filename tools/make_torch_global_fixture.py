#!/usr/bin/env python
"""Write tests/data/torch_global_fixture.npz, the global-kNN reference of
chip_smoke.py.

Runs with the JAX package on the CPU, after make_torch_smoke_fixture.py:

    JAX_PLATFORMS=cpu python tools/make_torch_global_fixture.py

It reads the smoke fixture's three trained ORB models and its two frames (no
retraining), builds the 100-object smoke catalog
(tod_tpu_torch/utils/smoke_catalog.py) and runs the JAX FusedDetector with
``pipeline="global"`` at ``FusedDetectorConfig()``'s own operating point
(conf/detection.ork: ORB, 5000 features, k 5, radius 35, RANSAC 1024
hypotheses, 5 instances, 16 active objects, 512 matches an object), seed 0,
on both frames. Per frame the file holds

- all ``n_features`` keypoints (``xy``, ``valid``), their descriptors and
  3D query points (``kp_*``);
- the matcher's top-k after the radius cut (``dist``, ``rows``: a match
  farther than the radius, or on a padding row, is ``(1e9, -1)``), which is
  what the fused kernel returns;
- the active set of the geometry stage (the ``max_active_objects`` objects
  with the most valid matches, -1 where an object has none);
- every accepted detection with its quality (``ref_*``).

The detector runs at ``min_quality`` 0 so that junk accepts are kept with
their qualities; ``config_json`` holds the config gated at 156, as the
serving ``.ork`` files ship it (the gate is host-side and changes no device
work). On the CPU the reference's matcher sweeps 2.1M rows for 5000 queries
a frame in bf16 products.
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

MIN_QUALITY = 156.0
SEED = 0
BIG_DIST = 1e9


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data = os.path.join(ROOT, "tests", "data")
    ap.add_argument("--smoke", default=os.path.join(
        data, "torch_smoke_fixture.npz"))
    ap.add_argument("--out", default=os.path.join(
        data, "torch_global_fixture.npz"))
    ap.add_argument("--objects", type=int, default=100,
                    help="catalog size (smaller ones rehearse chip_smoke.py "
                         "on a CPU)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector, FusedDetectorConfig
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    fx = np.load(args.smoke)
    model_ids = [str(s) for s in fx["model_ids"]]
    ids, arrays = smoke_catalog(
        model_ids, [(fx[f"desc{i}"], fx[f"points{i}"])
                    for i in range(len(model_ids))], n_objects=args.objects)
    catalog = [TodModel(i, d, p) for i, (d, p) in zip(ids, arrays)]
    print(f"catalog: {len(catalog)} objects, "
          f"{sum(m.n_points for m in catalog)} rows", flush=True)
    gated = FusedDetectorConfig(pipeline="global", min_quality=MIN_QUALITY)
    cfg = dataclasses.replace(gated, min_quality=0.0)
    det = FusedDetector(catalog, cfg, seed=SEED)
    print(f"packed DB: {det.db.descriptors.shape[0]} rows "
          f"({int(det.db.n_valid)} valid)", flush=True)

    # record the feature and matcher stages' outputs as detect runs them
    s1, s2, s3 = det._stages
    seen = {}

    def rec1(*a):
        out = s1(*a)
        seen["features"] = out
        return out

    def rec2(*a):
        out = s2(*a)
        seen["match"] = out
        return out

    det._stages = (rec1, rec2, s3)
    n_active = min(cfg.guess.max_active_objects, len(catalog))
    kp, cut, active, ref = [], [], [], []
    for f in range(len(fx["images"])):
        t0 = time.time()
        found = det.detect(fx["images"][f], fx["depths"][f], fx["K"])
        kps, desc, qp = seen["features"]
        dist, rows = seen["match"]
        within = (rows >= 0) & (dist <= cfg.radius)
        cut.append((np.asarray(jnp.where(within, dist, BIG_DIST)),
                    np.asarray(jnp.where(within, rows, -1))))
        # the geometry stage's active set, as detect_frame_from_matches
        # forms it (tod_tpu/geometry/detection.py:160-172)
        m_valid = within & kps.valid[:, None]
        obj = jnp.where(m_valid, det.db.obj_of_row[jnp.maximum(rows, 0)], -1)
        v = m_valid & jnp.isfinite(qp).all(-1)[:, None]
        counts = jnp.zeros(len(catalog), jnp.int32).at[
            jnp.maximum(obj, 0).reshape(-1)].add(v.reshape(-1).astype(
                jnp.int32))
        top, act = jax.lax.top_k(counts, n_active)
        if n_active < len(catalog):
            act = jnp.where(top > 0, act, -1)
        else:       # every object, in order
            act = jnp.arange(n_active)
        active.append(np.asarray(act, np.int32))
        kp.append([np.asarray(a) for a in (kps.xy, kps.valid, desc, qp)])
        ref += [(f, r) for r in found]
        print(f"frame {f}: {time.time() - t0:.0f}s; "
              f"{int(np.asarray(kps.valid).sum())} valid keypoints, "
              f"{int(np.asarray(m_valid).sum())} matches in radius; active "
              f"{active[-1].tolist()}; counts {np.asarray(top).tolist()}; "
              f"{[(r.object_id, round(r.quality)) for r in found]}",
              flush=True)

    out = {
        "config_json": np.asarray(json.dumps(dataclasses.asdict(gated))),
        "model_ids": np.asarray(model_ids),
        "kp_xy": np.stack([k[0] for k in kp]),
        "kp_valid": np.stack([k[1] for k in kp]),
        "kp_desc": np.stack([k[2] for k in kp]),
        "kp_qp": np.stack([k[3] for k in kp]),
        "dist": np.stack([c[0] for c in cut]).astype(np.float32),
        "rows": np.stack([c[1] for c in cut]).astype(np.int32),
        "active": np.stack(active),
        "ref_frame": np.asarray([f for f, _ in ref], np.int32),
        "ref_ids": np.asarray([r.object_id for _, r in ref]),
        "ref_R": np.asarray([r.R for _, r in ref],
                            np.float32).reshape(-1, 3, 3),
        "ref_T": np.asarray([r.T for _, r in ref], np.float32).reshape(-1, 3),
        "ref_quality": np.asarray([r.quality for _, r in ref], np.float32),
        "ref_inliers": np.asarray([r.confidence for _, r in ref], np.float32),
    }
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
