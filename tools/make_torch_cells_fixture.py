#!/usr/bin/env python
"""Write tests/data/torch_cells_fixture.npz, the cell-graph reference of
chip_smoke.py (phase 7a).

Runs with the JAX package on the CPU, after make_torch_smoke_fixture.py:

    JAX_PLATFORMS=cpu python tools/make_torch_cells_fixture.py

It reads the smoke fixture's three trained ORB models and its two frames,
writes the 100-object smoke catalog (tod_tpu_torch/utils/smoke_catalog.py)
into a FilesystemDb with the reference's ``write_model`` and the frames as
``.npz`` files (image, depth, K) in a temporary directory, and runs
``conf/detection.ork`` unchanged through the reference's
``build_pipeline_from_ork`` and ``Scheduler``, with ``db`` and
``source1.path`` overridden: the reference's global-kNN cell graph
(FeatureDescriptor -> DescriptorMatcher -> GuessGenerator, seed 0), one
scheduler iteration a frame. Per frame the file holds

- the matcher cell's ``MatchSet`` (``match_dist``, ``match_train_idx``,
  ``match_obj_idx``, ``match_local_idx``, ``match_valid``): the unrestricted
  top-5 of every query, then the radius cut;
- every pose the GuessGenerator accepted (``ref_*``: frame, object id, R,
  T and the unique-inlier count).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ORK = os.path.join(ROOT, "conf", "detection.ork")
COLLECTION = "object_recognition"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data = os.path.join(ROOT, "tests", "data")
    ap.add_argument("--smoke", default=os.path.join(
        data, "torch_smoke_fixture.npz"))
    ap.add_argument("--out", default=os.path.join(
        data, "torch_cells_fixture.npz"))
    ap.add_argument("--objects", type=int, default=100,
                    help="catalog size (smaller ones rehearse chip_smoke.py "
                         "on a CPU)")
    args = ap.parse_args()

    from tod_tpu.db import FilesystemDb, write_model
    from tod_tpu.pipeline.ork import build_pipeline_from_ork
    from tod_tpu.pipeline.scheduler import Scheduler
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    fx = np.load(args.smoke)
    model_ids = [str(s) for s in fx["model_ids"]]
    ids, arrays = smoke_catalog(
        model_ids, [(fx[f"desc{i}"], fx[f"points{i}"])
                    for i in range(len(model_ids))], n_objects=args.objects)
    with tempfile.TemporaryDirectory() as tmp:
        db_params = {"type": "filesystem", "root": os.path.join(tmp, "db"),
                     "collection": COLLECTION}
        db = FilesystemDb(db_params["root"], COLLECTION)
        for oid, (desc, pts) in zip(ids, arrays):
            write_model(db, oid, desc, pts)
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        n_frames = len(fx["images"])
        for f in range(n_frames):
            np.savez(os.path.join(frames, f"frame{f}.npz"),
                     image=fx["images"][f], depth=fx["depths"][f], K=fx["K"])
        print(f"catalog: {len(ids)} objects, "
              f"{sum(len(d) for d, _ in arrays)} rows; {n_frames} frames",
              flush=True)

        pipeline = build_pipeline_from_ork(ORK, {
            "source1": {"path": frames, "loop": False},
            "pipeline1": {"db": db_params}})
        sched = Scheduler(pipeline.plasm)
        det = pipeline.cells["pipeline1"]
        match_sets, ref = [], []
        for f in range(n_frames):
            t0 = time.time()
            sched.execute_iteration()
            m = det.descriptor_matcher.outputs["matches"]
            match_sets.append(m)
            found = det.outputs["pose_results"]
            ref += [(f, r) for r in found]
            print(f"frame {f}: {time.time() - t0:.0f}s; "
                  f"{int(m.valid.sum())} matches in radius; "
                  f"{[(r.object_id, int(r.confidence)) for r in found]}",
                  flush=True)
        print(sched.timing_report(), flush=True)

    out = {
        "ork": np.asarray(os.path.relpath(ORK, ROOT)),
        "overrides_json": np.asarray(json.dumps(
            {"source1": {"loop": False}, "pipeline1": {"db": {
                "type": "filesystem", "collection": COLLECTION}}})),
        "n_objects": np.asarray(len(ids), np.int32),
        "match_dist": np.stack([m.dist for m in match_sets]),
        "match_train_idx": np.stack([m.train_idx for m in match_sets]),
        "match_obj_idx": np.stack([m.obj_idx for m in match_sets]),
        "match_local_idx": np.stack([m.local_idx for m in match_sets]),
        "match_valid": np.stack([m.valid for m in match_sets]),
        "ref_frame": np.asarray([f for f, _ in ref], np.int32),
        "ref_ids": np.asarray([r.object_id for _, r in ref]),
        "ref_R": np.asarray([r.R for _, r in ref],
                            np.float32).reshape(-1, 3, 3),
        "ref_T": np.asarray([r.T for _, r in ref], np.float32).reshape(-1, 3),
        "ref_inliers": np.asarray([r.confidence for _, r in ref], np.float32),
    }
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
