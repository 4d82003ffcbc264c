#!/usr/bin/env python
"""Write tests/data/torch_legacy_fixture.npz, the reference-era data and
the reference's outputs that chip_smoke.py phase 11 holds the port to.

Runs with the JAX package and cv2 on the CPU, after the smoke, train and
cells fixtures exist (about 20 s):

    JAX_PLATFORMS=cpu python tools/make_torch_legacy_fixture.py

The file holds

- ``dump_json`` / ``dump_blobs``: a reference-format dump
  (tests/torch_parity.py ``write_legacy_dump``, the layout
  tests/test_migrate.py builds): obj000's smoke model as zlib FileStorage
  YAML (``descriptors``; ``points`` as ``1 x N x 3f``) written by the
  reference's ``encode_legacy_mat``, and ``VIEWS`` of obj000's training
  views (tests/data/torch_train_fixture.npz) as PNG image/depth/mask
  written by cv2 plus YAML K/R/T; ``view_frames`` names the views;
- ``desc_xml`` / ``points_xml``: the same model as FileStorage XML written
  by cv2 (deflated), and ``points_raw``: its points as a raw
  ``rows, cols, type`` header blob;
- ``migrated_json``: tools/migrate_db.py's output for the dump (every
  document's fields and each attachment's dtype, shape and SHA-256),
  ``migrate_stats`` its counts, and ``view_text`` what apps/feature_viewer
  prints for obj000 on that output;
- the reference's overlays over the smoke fixture's two frames, as
  SHA-256 digests of the arrays cv2 drew: ``pose_sha`` (the PoseDrawer's
  drawing: the reference FeatureDescriptor's keypoints at
  conf/detection.ork's settings, ``kp_xy`` / ``kp_valid``, then the poses
  the reference graph accepted, tests/data/torch_cells_fixture.npz) and
  ``cluster_sha`` (the GuessGenerator's cluster overlay from the same
  keypoints and the cells fixture's MatchSets).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

VIEWS = (0, 20, 40)        # obj000's training views in the dump
OBJECT = "obj000"


def digest(array: np.ndarray) -> str:
    a = np.ascontiguousarray(array)
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def _documents(root: str, collection: str) -> dict:
    from tod_tpu.db import FilesystemDb

    db = FilesystemDb(root, collection)
    out = {}
    for doc_id in sorted(db.all_ids()):
        doc = db.load(doc_id)
        out[doc_id] = {"fields": doc.fields, "attachments": {
            name: {"dtype": a.dtype.str, "shape": list(a.shape),
                   "sha256": digest(a)}
            for name, a in sorted(doc.attachments.items())}}
    return out


def _filestorage(array: np.ndarray, ext: str) -> bytes:
    import cv2

    fs = cv2.FileStorage("m" + ext, cv2.FILE_STORAGE_WRITE
                         | cv2.FILE_STORAGE_MEMORY)
    fs.write("data", array)
    return zlib.compress(fs.releaseAndGetString().encode())


def _overlays(fx, cx) -> dict:
    """The reference's PoseDrawer and cluster drawings over both frames."""
    import tod_tpu.cells as rc
    from tod_tpu.cells.types import PoseResult
    from tod_tpu.utils import visualize as rviz

    feat = rc.FeatureDescriptor("f", json_feature_params=json.dumps(
        {"type": "ORB", "n_features": 5000, "n_levels": 3,
         "scale_factor": 1.2}))
    feat.ensure_configured()
    out = {"kp_xy": [], "kp_valid": [], "pose_sha": [], "cluster_sha": []}
    for f in range(len(fx["images"])):
        image = fx["images"][f]
        feat.inputs["image"] = image
        feat.process()
        kps = feat.outputs["keypoints"]
        xy, valid = np.asarray(kps.xy, np.float32), np.asarray(kps.valid)
        poses = [PoseResult(R=cx["ref_R"][i], T=cx["ref_T"][i],
                            object_id=str(cx["ref_ids"][i]),
                            confidence=float(cx["ref_inliers"][i]))
                 for i in np.nonzero(cx["ref_frame"] == f)[0]]
        drawn = rviz.draw_detections(rviz.draw_keypoints(image, xy[valid]),
                                     np.asarray(fx["K"], np.float64), poses)
        mvalid, obj = cx["match_valid"][f], cx["match_obj_idx"][f]
        flat = mvalid.any(axis=1) & valid
        cluster = np.where(mvalid, obj, -1).max(axis=1)
        clusters = rviz.draw_clusters(image, xy[flat], cluster[flat])
        out["kp_xy"].append(xy)
        out["kp_valid"].append(valid)
        out["pose_sha"].append(digest(drawn))
        out["cluster_sha"].append(digest(clusters))
    return {k: np.asarray(v) for k, v in out.items()}


def main() -> None:
    data = os.path.join(ROOT, "tests", "data")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        data, "torch_legacy_fixture.npz"))
    args = ap.parse_args()

    import migrate_db
    from tod_tpu.db.legacy import decode_legacy_mat
    from tod_tpu_torch.types import fixture_observations
    from torch_parity import write_legacy_dump

    fx = np.load(os.path.join(data, "torch_smoke_fixture.npz"))
    tx = np.load(os.path.join(data, "torch_train_fixture.npz"))
    cx = np.load(os.path.join(data, "torch_cells_fixture.npz"))
    assert str(fx["model_ids"][0]) == OBJECT
    desc, pts = fx["desc0"], fx["points0"]
    views = fixture_observations(tx, 0)
    obs = [dict(image=views[v].image, depth=views[v].depth,
                mask=views[v].mask, K=views[v].K, R=views[v].R,
                T=views[v].T, frame_number=views[v].frame_number)
           for v in VIEWS]
    out = {"object_id": np.asarray(OBJECT),
           "view_frames": np.asarray([o["frame_number"] for o in obs])}
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump")
        os.makedirs(dump)
        write_legacy_dump(dump, OBJECT, obs, desc, pts)
        index, blobs, pos = {}, [], 0
        for doc_id in sorted(os.listdir(dump)):
            with open(os.path.join(dump, doc_id, "doc.json")) as f:
                entry = {"fields": json.load(f), "blobs": {}}
            for name in sorted(os.listdir(os.path.join(dump, doc_id))):
                if name == "doc.json":
                    continue
                with open(os.path.join(dump, doc_id, name), "rb") as f:
                    blob = f.read()
                entry["blobs"][name] = [pos, pos + len(blob)]
                blobs.append(blob)
                pos += len(blob)
            index[doc_id] = entry
        out["dump_json"] = np.asarray(json.dumps(index))
        out["dump_blobs"] = np.frombuffer(b"".join(blobs), np.uint8)
        dst = {"type": "filesystem", "root": os.path.join(tmp, "db"),
               "collection": "object_recognition"}
        stats = migrate_db.migrate(migrate_db.iter_dump(dump),
                                   json.dumps(dst))
        out["migrate_stats"] = np.asarray(json.dumps(stats))
        migrated = _documents(dst["root"], dst["collection"])
        out["migrated_json"] = np.asarray(json.dumps(migrated))
        text = subprocess.run(
            [sys.executable, os.path.join(ROOT, "apps", "feature_viewer"),
             OBJECT, "--db", json.dumps(dst)], capture_output=True,
            text=True, check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        out["view_text"] = np.asarray(text.stdout)
    out["desc_xml"] = np.frombuffer(_filestorage(desc, ".xml"), np.uint8)
    out["points_xml"] = np.frombuffer(
        _filestorage(pts.reshape(1, -1, 3), ".xml"), np.uint8)
    out["points_raw"] = np.frombuffer(
        struct.pack("<iii", len(pts), 3, 5) + pts.tobytes(), np.uint8)
    # every blob decodes, in the reference, to its npy counterpart
    for key, want in (("desc_xml", desc), ("points_xml", pts[None]),
                      ("points_raw", pts)):
        got = decode_legacy_mat(out[key].tobytes())
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    model_doc = migrated["model_obj0"]["attachments"]
    assert model_doc["descriptors"]["sha256"] == digest(desc)
    assert model_doc["points"]["sha256"] == digest(pts.reshape(1, -1, 3))
    out.update(_overlays(fx, cx))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes; "
          f"migrate {stats}; dump {pos} bytes")


if __name__ == "__main__":
    main()
