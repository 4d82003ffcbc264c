#!/usr/bin/env python
"""Write tests/data/torch_jpeg_smoothing_fixture.npz, the references that
chip_smoke.py phase 12a holds the port's decoding of block-smoothed JPEG
to: progressive files whose last scans are missing, which libjpeg-turbo
(cv2) decodes with its block smoothing.

Runs with the JAX package and cv2 on the CPU, after the smoke and cells
fixtures exist (about 2 minutes: the reference's cell graph over the
100-object catalog dominates):

    JAX_PLATFORMS=cpu python tools/make_torch_jpeg_smoothing_fixture.py

The file holds

- ``case_names`` / ``case_blob`` / ``case_offsets``: cv2's progressive
  files cut after k scans and closed by EOI (every k at every sampling cv2
  writes and gray at 33 x 61, every k at 4:2:0 at 17 x 23, the two subsets
  that are not prefixes, and the bench's scene 0 at 480 x 640 q95 4:2:0
  cut after 1 and 9 of its 10 scans) and, per case ``i``, cv2's pixels
  under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``: ``case{i}_unchanged`` /
  ``case{i}_color`` arrays for the small cases, SHA-256 digests
  ``case{i}_unchanged_sha`` / ``case{i}_color_sha`` for the 480 x 640 ones;
- ``rec_color{f}`` / ``rec_depth{f}``: a two-frame "pairs" recording, the
  smoke fixture's scenes as q95 4:2:0 progressive JPEG cut after the
  ninth of their ten scans and 16-bit PNG depth, and ``rec_frames_json``:
  the digests of every array tools/ingest_frames.py writes for it;
- ``rec_match_json`` / ``rec_ref_*``: the reference's ``conf/detection.ork``
  graph (the cells fixture's catalog and settings) over the first
  ingested frame: its MatchSet's digests and the poses it accepted.
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
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

QUALITY = 95
REC_SCANS = 9                   # of the recording's 10 scans


def cases(scene_bgr: np.ndarray):
    """[(name, bytes, small)]: the cut files."""
    from make_torch_jpeg_fixture import _encode
    from test_torch_jpeg_smoothing import SAMPLINGS, cut, progressive_file

    out = []
    for sampling in SAMPLINGS:
        data = progressive_file(sampling, 33, 61)
        n = 6 if sampling == "gray" else 10
        out += [(f"{sampling} 33x61 q90 first {k} of {n} scans",
                 cut(data, range(k)), True) for k in range(1, n)]
    data = progressive_file("420", 17, 23)
    out += [(f"420 17x23 q90 first {k} of 10 scans", cut(data, range(k)),
             True) for k in range(1, 10)]
    data = progressive_file("420", 33, 61, seed=1)
    out.append(("420 33x61 q90 without the DC refinement",
                cut(data, [0, 1, 2, 3, 4, 5, 7, 8, 9]), True))
    out.append(("420 33x61 q90 without the chroma refinements",
                cut(data, [0, 1, 2, 3, 4, 5, 6, 9]), True))
    import cv2

    scene = _encode(scene_bgr, quality=QUALITY, progressive=1,
                    sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    for k in (1, REC_SCANS):
        out.append((f"scene 0 480x640 q95 4:2:0 progressive, first {k} of "
                    "10 scans", cut(scene, range(k)), False))
    return out


def main() -> None:
    data = os.path.join(ROOT, "tests", "data")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        data, "torch_jpeg_smoothing_fixture.npz"))
    args = ap.parse_args()

    import cv2

    import ingest_frames
    from make_torch_jpeg_fixture import (_encode, digest, packed_blobs,
                                         reference_graph)
    from test_torch_jpeg_smoothing import cut

    t_start = time.time()
    fx = np.load(os.path.join(data, "torch_smoke_fixture.npz"))
    out = {}

    # ---- the cut files ------------------------------------------------------
    all_cases = cases(np.ascontiguousarray(fx["images"][0][..., ::-1]))
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
    print(f"{len(all_cases)} cut files", flush=True)

    # ---- the cut recording, the reference tool's frames and graph ----------
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rec")
        os.makedirs(src)
        for f in range(len(fx["images"])):
            full = _encode(np.ascontiguousarray(fx["images"][f][..., ::-1]),
                           quality=QUALITY, progressive=1, sampling_factor=cv2
                           .IMWRITE_JPEG_SAMPLING_FACTOR_420)
            color = cut(full, range(REC_SCANS))
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

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB) in "
          f"{time.time() - t_start:.0f} s")


if __name__ == "__main__":
    main()
