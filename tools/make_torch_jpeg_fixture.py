#!/usr/bin/env python
"""Write tests/data/torch_jpeg_fixture.npz, the JPEG decoding and rendered
workload references that chip_smoke.py phase 12 holds the port to.

Runs with the JAX package and cv2 on the CPU, after the smoke, train,
cells and legacy fixtures exist (about 2 minutes: the reference's cell
graph over the 100-object catalog dominates):

    JAX_PLATFORMS=cpu python tools/make_torch_jpeg_fixture.py

The file holds

- ``case_names`` / ``case_blob`` / ``case_offsets``: JPEG files cv2 wrote
  (every sampling it offers, sequential and progressive, restart
  intervals, gray, optimised tables, an Adobe RGB file, an EXIF-rotated
  one) and, per case ``i``, cv2's pixels under ``IMREAD_UNCHANGED`` and
  ``IMREAD_COLOR``: ``case{i}_unchanged`` / ``case{i}_color`` arrays for the
  small cases, SHA-256 digests ``case{i}_unchanged_sha`` /
  ``case{i}_color_sha`` for the three 480 x 640 ones (the bench's scene 0
  as q95 4:2:0, its progressive and its 4:4:4 encodings);
- ``rec_color{f}`` / ``rec_depth{f}``: a two-frame "pairs" recording, the
  smoke fixture's scenes as q95 4:2:0 JPEG colour and 16-bit PNG depth,
  and ``rec_frames_json``: the digests of every array tools/ingest_frames.py
  writes for it;
- ``rec_match_json`` / ``rec_ref_*``: the reference's ``conf/detection.ork``
  graph (the cells fixture's catalog and settings) over the first ingested
  frame: its MatchSet's digests and the poses it accepted;
- ``train_frames`` / ``train_jpeg`` / ``train_offsets``: obj000's views of
  the legacy fixture (``view_frames``) as q95 JPEG images, and
  ``train_model_json``: the digests of the model the reference trains from
  their cv2-decoded pixels (the Trainer's batched views, dedup 8 bits /
  5 mm);
- ``hard0_json``: the digests of ``degrade_frame`` of scene 0 at the
  bench's ``BENCH_NOISE=hard`` preset (rng 1000);
- ``sift_graph_*``: ``conf/detection.ork`` with SIFT features
  (``SIFT_GRAPH``) through the reference's graph over the SIFT smoke
  models (tests/data/torch_sift_fixture.npz, served as ``q / 256``) and
  both smoke frames, the queue-C probe of the L2 matcher: per frame the
  MatchSet's ``train_idx``, ``dist`` and ``valid`` (``sift_graph_json``:
  digests of ``obj_idx`` and ``local_idx``) and every accept (``frame``,
  ``ids``, ``R``, ``T``, ``inliers``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

QUALITY = 95
HARD = dict(rgb_sigma=10.0, depth_sigma_mm=5.0, depth_dropout=0.10,
            n_occluders=2)             # bench.NOISE_PRESETS["hard"]
TRAIN_FEATURE = "ORB"
DEDUP = (8, 0.005)
# conf/detection.ork's settings with the feature switched to SIFT and the
# SIFT serving graph's radius (tests/test_torch_sift_graph.py SIFT_GRAPH)
SIFT_GRAPH = {
    "feature": {"type": "SIFT", "n_features": 5000, "n_levels": 3,
                "scale_factor": 1.2},
    "descriptor": {"type": "SIFT"},
    "search": {"type": "LSH", "key_size": 16, "multi_probe_level": 1,
               "n_tables": 10, "radius": 0.9, "ratio": 0.8},
}


def digest(array: np.ndarray) -> str:
    a = np.ascontiguousarray(array)
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def _encode(img: np.ndarray, **kw) -> bytes:
    import cv2

    params = []
    for key, value in kw.items():
        params += [getattr(cv2, "IMWRITE_JPEG_" + key.upper()), value]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _small_image(rng, h, w, channels=3):
    import cv2

    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, channels)) \
        .astype(np.float32)
    up = cv2.resize(base, (w, h)).reshape(h, w, channels)
    img = np.clip(up + rng.normal(0, 8, (h, w, channels)), 0, 255) \
        .astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _exif_rotated(jpg: bytes, value: int) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack("<I", 0))
    return (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(tiff) + 8)
            + b"Exif\x00\x00" + tiff + jpg[2:])


def _adobe_rgb(jpg: bytes) -> bytes:
    at = jpg.index(b"\xff\xe0")
    end = at + 2 + struct.unpack(">H", jpg[at + 2:at + 4])[0]
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    return jpg[:at] + b"\xff\xee" + struct.pack(">H", len(body) + 2) \
        + body + jpg[end:]


def cases(scene_bgr: np.ndarray):
    """[(name, bytes, small)]: the decoding cases."""
    import cv2

    rng = np.random.default_rng(0)
    out = []
    for name, factor in (("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                         ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                         ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
                         ("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                         ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)):
        for prog in (0, 1):
            out.append((f"{name} {'progressive' if prog else 'sequential'} "
                        "33x61 q90 restart 2",
                        _encode(_small_image(rng, 33, 61), quality=90,
                                progressive=prog, sampling_factor=factor,
                                rst_interval=2), True))
    gray = _small_image(rng, 17, 23, 1)
    out.append(("gray sequential 17x23", _encode(gray, quality=90), True))
    out.append(("gray progressive 17x23",
                _encode(gray, quality=90, progressive=1), True))
    img = _small_image(rng, 40, 56)
    out.append(("restart every MCU, optimised tables",
                _encode(img, rst_interval=1, optimize=1), True))
    out.append(("Adobe RGB (transform 0) 4:4:4",
                _adobe_rgb(_encode(img, sampling_factor=cv2
                                   .IMWRITE_JPEG_SAMPLING_FACTOR_444)), True))
    out.append(("EXIF orientation 6", _exif_rotated(_encode(img), 6), True))
    f420 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
    out.append(("scene 0 480x640 q95 4:2:0",
                _encode(scene_bgr, quality=QUALITY, sampling_factor=f420),
                False))
    out.append(("scene 0 480x640 q95 4:2:0 progressive",
                _encode(scene_bgr, quality=QUALITY, sampling_factor=f420,
                        progressive=1), False))
    out.append(("scene 0 480x640 q95 4:4:4",
                _encode(scene_bgr, quality=QUALITY,
                        sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                False))
    return out


def packed_blobs(blobs):
    offsets = np.cumsum([0] + [len(b) for b in blobs]).astype(np.int64)
    return np.frombuffer(b"".join(blobs), np.uint8), offsets


def reference_graph(frames_dir: str, smoke, tmp: str) -> dict:
    """conf/detection.ork through the reference's graph over the first
    frame of ``frames_dir``, on the cells fixture's 100-object catalog."""
    from tod_tpu.db import FilesystemDb, write_model
    from tod_tpu.pipeline.ork import build_pipeline_from_ork
    from tod_tpu.pipeline.scheduler import Scheduler
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    model_ids = [str(s) for s in smoke["model_ids"]]
    ids, arrays = smoke_catalog(
        model_ids, [(smoke[f"desc{i}"], smoke[f"points{i}"])
                    for i in range(len(model_ids))])
    params = {"type": "filesystem", "root": os.path.join(tmp, "db"),
              "collection": "object_recognition"}
    db = FilesystemDb(params["root"], params["collection"])
    for oid, (desc, pts) in zip(ids, arrays):
        write_model(db, oid, desc, pts)
    pipeline = build_pipeline_from_ork(
        os.path.join(ROOT, "conf", "detection.ork"),
        {"source1": {"path": frames_dir, "loop": False},
         "pipeline1": {"db": params}})
    Scheduler(pipeline.plasm).execute_iteration()
    det = pipeline.cells["pipeline1"]
    m = det.descriptor_matcher.outputs["matches"]
    found = list(det.outputs["pose_results"])
    print(f"reference graph: {int(m.valid.sum())} matches in radius; "
          f"{[(r.object_id, int(r.confidence)) for r in found]}", flush=True)
    return {
        "rec_match_json": np.asarray(json.dumps({
            name: digest(getattr(m, name))
            for name in ("dist", "train_idx", "obj_idx", "local_idx",
                         "valid")})),
        "rec_ref_frame": np.zeros(len(found), np.int32),
        "rec_ref_ids": np.asarray([r.object_id for r in found]),
        "rec_ref_R": np.asarray([r.R for r in found],
                                np.float32).reshape(-1, 3, 3),
        "rec_ref_T": np.asarray([r.T for r in found],
                                np.float32).reshape(-1, 3),
        "rec_ref_inliers": np.asarray([r.confidence for r in found],
                                      np.float32)}


def reference_sift_graph(smoke, tmp: str) -> dict:
    """conf/detection.ork with SIFT_GRAPH over the three SIFT smoke models
    and the smoke frames, through the reference's graph."""
    from tod_tpu.db import FilesystemDb, write_model
    from tod_tpu.pipeline.ork import build_pipeline_from_ork
    from tod_tpu.pipeline.scheduler import Scheduler

    sx = np.load(os.path.join(ROOT, "tests", "data",
                              "torch_sift_fixture.npz"))
    params = {"type": "filesystem", "root": os.path.join(tmp, "sift_db")}
    db = FilesystemDb(params["root"])
    for i, oid in enumerate(sx["model_ids"]):
        write_model(db, str(oid), sx[f"desc{i}"].astype(np.float32) / 256.0,
                    sx[f"points{i}"])
    frames = os.path.join(tmp, "sift_frames")
    os.makedirs(frames)
    for f in range(len(smoke["images"])):
        np.savez(os.path.join(frames, f"frame{f}.npz"),
                 image=smoke["images"][f], depth=smoke["depths"][f],
                 K=smoke["K"])
    pipeline = build_pipeline_from_ork(
        os.path.join(ROOT, "conf", "detection.ork"),
        {"source1": {"path": frames, "loop": False},
         "pipeline1": {"db": params, **SIFT_GRAPH}})
    sched = Scheduler(pipeline.plasm)
    det = pipeline.cells["pipeline1"]
    out, sets, found = {}, [], []
    for f in range(len(smoke["images"])):
        sched.execute_iteration()
        sets.append(det.descriptor_matcher.outputs["matches"])
        found += [(f, r) for r in det.outputs["pose_results"]]
        print(f"reference SIFT graph, frame {f}: "
              f"{int(sets[-1].valid.sum())} matches in radius; "
              f"{[(r.object_id, int(r.confidence)) for _, r in found]}",
              flush=True)
    out["sift_graph_json"] = np.asarray(json.dumps({
        "settings": SIFT_GRAPH,
        "obj_idx": [digest(m.obj_idx) for m in sets],
        "local_idx": [digest(m.local_idx) for m in sets]}))
    out["sift_graph_train_idx"] = np.stack([m.train_idx for m in sets])
    out["sift_graph_dist"] = np.stack([m.dist for m in sets])
    out["sift_graph_valid"] = np.stack([m.valid for m in sets])
    out["sift_graph_frame"] = np.asarray([f for f, _ in found], np.int32)
    out["sift_graph_ids"] = np.asarray([r.object_id for _, r in found])
    out["sift_graph_R"] = np.asarray([r.R for _, r in found],
                                     np.float32).reshape(-1, 3, 3)
    out["sift_graph_T"] = np.asarray([r.T for _, r in found],
                                     np.float32).reshape(-1, 3)
    out["sift_graph_inliers"] = np.asarray([r.confidence for _, r in found],
                                           np.float32)
    return out


def reference_model(views) -> dict:
    """The reference Trainer's model of ``views`` (batched views, then the
    dedup): digests of its descriptors and points."""
    from make_torch_train_fixture import train_batch
    from tod_tpu.ops.compress import compress_model

    (desc, world, valid), _ = train_batch(views, TRAIN_FEATURE)
    flat = valid.reshape(-1)
    d8, p8 = compress_model(desc.reshape(-1, 32)[flat],
                            world.reshape(-1, 3)[flat].astype(np.float32),
                            *DEDUP)
    p8 = np.asarray(p8, np.float32).reshape(-1, 3)
    print(f"reference model: {int(flat.sum())} rows -> {len(d8)}",
          flush=True)
    return {"rows": int(len(d8)), "descriptors": digest(d8),
            "points": digest(p8)}


def main() -> None:
    data = os.path.join(ROOT, "tests", "data")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        data, "torch_jpeg_fixture.npz"))
    args = ap.parse_args()

    import cv2

    import ingest_frames
    from tod_tpu.db.legacy import decode_legacy_mat
    from tod_tpu.utils.synthetic import degrade_frame
    from tod_tpu_torch.types import fixture_observations

    t_start = time.time()
    fx = np.load(os.path.join(data, "torch_smoke_fixture.npz"))
    tx = np.load(os.path.join(data, "torch_train_fixture.npz"))
    lx = np.load(os.path.join(data, "torch_legacy_fixture.npz"))
    out = {}

    # ---- decoding cases ----------------------------------------------------
    scene_bgr = np.ascontiguousarray(fx["images"][0][..., ::-1])
    all_cases = cases(scene_bgr)
    out["case_names"] = np.asarray([n for n, _, _ in all_cases])
    out["case_blob"], out["case_offsets"] = packed_blobs(
        [b for _, b, _ in all_cases])
    for i, (name, blob, small) in enumerate(all_cases):
        buf = np.frombuffer(blob, np.uint8)
        for flag, key in ((cv2.IMREAD_UNCHANGED, "unchanged"),
                          (cv2.IMREAD_COLOR, "color")):
            px = cv2.imdecode(buf, flag)
            assert px is not None, name
            if small:
                out[f"case{i}_{key}"] = px
            else:
                out[f"case{i}_{key}_sha"] = np.asarray(digest(px))
        print(f"case {i}: {name}: {len(blob)} bytes", flush=True)

    # ---- the recording, the reference tool's frames and graph -------------
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rec")
        os.makedirs(src)
        for f in range(len(fx["images"])):
            color = _encode(np.ascontiguousarray(fx["images"][f][..., ::-1]),
                            quality=QUALITY, sampling_factor=cv2
                            .IMWRITE_JPEG_SAMPLING_FACTOR_420)
            depth = cv2.imencode(".png", fx["depths"][f])[1].tobytes()
            out[f"rec_color{f}"] = np.frombuffer(color, np.uint8)
            out[f"rec_depth{f}"] = np.frombuffer(depth, np.uint8)
            for name, blob in ((f"color_{f:04d}.jpg", color),
                               (f"depth_{f:04d}.png", depth)):
                with open(os.path.join(src, name), "wb") as fh:
                    fh.write(blob)
        frames_dir = os.path.join(tmp, "frames")
        ingest_frames.main([src, frames_dir, "--format", "pairs",
                            "--rgb-glob", "color_*.jpg",
                            "--depth-glob", "depth_*.png"])
        written = {}
        for name in sorted(os.listdir(frames_dir)):
            with np.load(os.path.join(frames_dir, name)) as z:
                written[name] = {k: digest(z[k]) for k in sorted(z.files)}
        out["rec_frames_json"] = np.asarray(json.dumps(written))
        one = os.path.join(tmp, "one")
        os.makedirs(one)
        first = sorted(os.listdir(frames_dir))[0]
        os.link(os.path.join(frames_dir, first), os.path.join(one, first))
        out.update(reference_graph(one, fx, tmp))
        out.update(reference_sift_graph(fx, tmp))

    # ---- training from JPEG views ------------------------------------------
    views = {o.frame_number: o for o in fixture_observations(tx, 0)}
    frames = [int(f) for f in lx["view_frames"]]
    blobs, obs = [], []
    for f in frames:
        v = views[f]
        jpg = _encode(np.ascontiguousarray(v.image[..., ::-1]),
                      quality=QUALITY)
        blobs.append(jpg)
        rgb = decode_legacy_mat(jpg)
        obs.append(dict(image=rgb, mask=v.mask, depth=v.depth,
                        K=np.float64(v.K), R=np.float64(v.R),
                        T=np.float64(v.T), frame_number=f))
    out["train_frames"] = np.asarray(frames, np.int32)
    out["train_jpeg"], out["train_offsets"] = packed_blobs(blobs)
    out["train_model_json"] = np.asarray(json.dumps(reference_model(obs)))

    # ---- the bench's hard degradation of scene 0 ---------------------------
    img, dep = degrade_frame(fx["images"][0], fx["depths"][0],
                             np.random.default_rng(1000), **HARD)
    out["hard0_json"] = np.asarray(json.dumps(
        {"image": digest(img), "depth": digest(dep), "preset": HARD}))

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB) in "
          f"{time.time() - t_start:.0f} s")


if __name__ == "__main__":
    main()
