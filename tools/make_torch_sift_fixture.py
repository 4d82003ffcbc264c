#!/usr/bin/env python
"""Write tests/data/torch_sift_fixture.npz, the SIFT/L2 reference of
chip_smoke.py.

Runs with the JAX package on the CPU, after make_torch_smoke_fixture.py:

    JAX_PLATFORMS=cpu python tools/make_torch_sift_fixture.py

It trains the bench's objects 0..2 (plane, box, cylinder) with SIFT features
(bench.build_db under BENCH_FEATURE=SIFT), quantises the three models to int8
(``round(d * 256)`` clipped to [0, 127]) and serves ``q / 256``, which is
exact in float32 and quantises back to ``q``: both packages then pack the
same rows. The frames are the smoke fixture's two scenes (checked to be what
bench.build_scenes renders; not stored again). On the 100-object SIFT smoke
catalog (tod_tpu_torch/utils/smoke_catalog.py, integer-noise fillers) the
JAX FusedDetector runs at the bench's SIFT operating point (radius 0.9)

- as the full exact sweep on both frames: the compaction outputs (xy, 3D
  query points, quantised descriptors, ok) and every accepted detection with
  its quality (``ref_*``; the serving gate is ``min_quality`` 156), and
- with the frontier recipe (coarse->fine at stride 16 into a 64-slot slab
  with 16 tracked and 16 exploration slots, coarse queries at stride 2) over
  a stream of six frames: per frame the slab (``sel``, ``force``,
  ``force_act``) and the accepted detections (``stream_*``).

Both runs use ``min_quality`` 0 so that junk accepts are kept with their
qualities; the gate is applied on the host after the device stages and
changes nothing else. ``config_json`` holds the config gated at 156.

``ref_desc_digest`` holds, per frame, the SHA-256 (``camera_sizes.digest``)
of the reference's float SIFT descriptors before quantisation, all
``n_features`` slots, as ``jax.jit(sift_detect_and_compute)`` gives them at
the served config, so that the port's floats are held bit for bit where the
int8 rows could hide a last-bit difference. ``--float-digests`` adds only
that key to an existing fixture (~1 min), leaving the rest as it is.
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
N_STREAM = 6
MIN_QUALITY = 156.0
SEED = 0
# docs/SERVING.md "Sizing rules of thumb", ~400-2000 objects, streaming
FRONTIER = dict(coarse_stride=16, fine_width=64, coarse_q_stride=2,
                track_width=16, explore_width=16, track_ttl=2,
                track_min_confidence=16.0)


def detections(found, frame):
    return [(frame, r) for r in found]


def pack_detections(prefix, ref):
    return {
        f"{prefix}_frame": np.asarray([f for f, _ in ref], np.int32),
        f"{prefix}_ids": np.asarray([r.object_id for _, r in ref]),
        f"{prefix}_R": np.asarray([r.R for _, r in ref],
                                  np.float32).reshape(-1, 3, 3),
        f"{prefix}_T": np.asarray([r.T for _, r in ref],
                                  np.float32).reshape(-1, 3),
        f"{prefix}_quality": np.asarray([r.quality for _, r in ref],
                                        np.float32),
        f"{prefix}_inliers": np.asarray([r.confidence for _, r in ref],
                                        np.float32),
    }


def float_digests(images, cfg_json: str):
    """Per frame, the digest of the reference's float SIFT descriptors at
    the served config (``cfg_json``), and their int8 rows."""
    import jax
    import jax.numpy as jnp

    from tod_tpu.ops.image import rgb_to_gray
    from tod_tpu.ops.pallas.segmented_l2 import quantize_descriptors
    from tod_tpu.ops.sift import sift_detect_and_compute
    from tod_tpu_torch.utils.camera_sizes import digest

    cfg = json.loads(cfg_json)
    run = jax.jit(lambda gray: sift_detect_and_compute(
        gray, n_features=cfg["n_features"], n_levels=cfg["n_levels"],
        scale_factor=cfg["scale_factor"],
        fast_threshold=cfg["fast_threshold"])[1])
    out = []
    for image in images:
        # the gray as FusedDetector.prepare_frame makes it, eagerly
        desc = run(rgb_to_gray(jnp.asarray(image, jnp.float32)))
        out.append((digest(np.asarray(desc)),
                    np.asarray(quantize_descriptors(desc))))
    return out


def check_float_rows(quantised, ref_dsc, ref_ok) -> None:
    """Every compacted row (``ref_dsc`` where ``ref_ok``) is a row of the
    floats' quantisation: they are the compaction's own descriptors."""
    for f, (q, dsc, ok) in enumerate(zip(quantised, ref_dsc, ref_ok)):
        rows = {r.tobytes() for r in q}
        if not all(r.tobytes() in rows for r in dsc[ok]):
            raise SystemExit(f"frame {f}: the float descriptors are not the "
                             "compaction's")


def add_float_digests(path: str, smoke: str) -> None:
    fx, sx = np.load(smoke), dict(np.load(path))
    got = float_digests(fx["images"], str(sx["config_json"]))
    check_float_rows([q for _, q in got], sx["ref_dsc"], sx["ref_ok"])
    sx["ref_desc_digest"] = np.asarray([d for d, _ in got])
    np.savez_compressed(path, **sx)
    print(f"wrote ref_desc_digest {sx['ref_desc_digest']} to {path}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data = os.path.join(ROOT, "tests", "data")
    ap.add_argument("--smoke", default=os.path.join(
        data, "torch_smoke_fixture.npz"))
    ap.add_argument("--out", default=os.path.join(
        data, "torch_sift_fixture.npz"))
    ap.add_argument("--float-digests", action="store_true",
                    help="add ref_desc_digest to the fixture at --out only")
    args = ap.parse_args()
    if args.float_digests:
        add_float_digests(args.out, args.smoke)
        return
    os.environ["BENCH_DB_CACHE"] = ""     # train live, cache nothing
    os.environ["BENCH_FEATURE"] = "SIFT"

    import bench
    from tod_tpu.db.models import TodModel
    from tod_tpu.models import FusedDetector
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    t0 = time.time()
    objects, models = bench.build_db(N_REAL)
    print(f"trained {N_REAL} SIFT models in {time.time() - t0:.0f}s: rows "
          f"{[m.n_points for m in models]}", flush=True)
    quant = [np.clip(np.round(np.asarray(m.descriptors, np.float32) * 256.0),
                     0, 127).astype(np.int8) for m in models]
    points = [np.asarray(m.points, np.float32).reshape(-1, 3) for m in models]
    fx = np.load(args.smoke)
    scenes = bench.build_scenes(objects, N_SCENES)
    for s, (image, depth, gt) in enumerate(scenes):
        if not (np.array_equal(image, fx["images"][s])
                and np.array_equal(depth, fx["depths"][s])
                and [o for o, _, _ in gt] == [str(o) for o in fx["gt_ids"][s]]):
            raise SystemExit(f"scene {s} is not the smoke fixture's frame")
    K = fx["K"]

    ids, arrays = smoke_catalog([m.object_id for m in models],
                                list(zip(quant, points)))
    # how far a filler row lies from its source row, in L2 units
    gap = np.sqrt(((arrays[N_REAL][0].astype(np.float32)
                    - quant[0].astype(np.float32)) ** 2).sum(1)) / 256.0
    print(f"filler rows lie {gap.mean():.3f} +- {gap.std():.3f} L2 units "
          f"from their source rows (min {gap.min():.3f}, max {gap.max():.3f})",
          flush=True)
    catalog = [TodModel(i, d.astype(np.float32) / 256.0, p)
               for i, (d, p) in zip(ids, arrays)]
    print(f"catalog: {len(catalog)} objects, "
          f"{sum(m.n_points for m in catalog)} rows", flush=True)
    gated = dataclasses.replace(bench.build_config(5000),
                                min_quality=MIN_QUALITY)
    cfg = dataclasses.replace(gated, min_quality=0.0)

    # ---- the full exact sweep ---------------------------------------------
    det = FusedDetector(catalog, cfg, seed=SEED)
    ref, compact = [], []
    for s, (image, depth, _) in enumerate(scenes):
        t0 = time.time()
        compact.append([np.asarray(a) for a in det._stages[0](
            *det.prepare_frame(image, depth, K))])
        found = det.detect(image, depth, K)
        print(f"sweep scene {s}: {time.time() - t0:.0f}s: "
              f"{[(r.object_id, r.quality) for r in found]}", flush=True)
        ref += detections(found, s)
    del det

    # ---- the frontier recipe over a stream ---------------------------------
    det = FusedDetector(catalog, dataclasses.replace(cfg, **FRONTIER),
                        seed=SEED)
    slabs = []
    c1, c2, c3 = det._coarse

    def recording_c1(*a):
        out = c1(*a)
        slabs.append([np.asarray(x) for x in out])
        return out

    det._coarse = (recording_c1, c2, c3)
    stream = []
    for f in range(N_STREAM):
        t0 = time.time()
        image, depth, _ = scenes[f % N_SCENES]
        found = det.detect(image, depth, K)
        print(f"stream frame {f}: {time.time() - t0:.0f}s: "
              f"{[(r.object_id, r.quality) for r in found]}", flush=True)
        stream += detections(found, f)

    out = {
        "config_json": np.asarray(json.dumps(dataclasses.asdict(gated))),
        "stream_config_json": np.asarray(json.dumps(dataclasses.asdict(
            dataclasses.replace(gated, **FRONTIER)))),
        "model_ids": np.asarray([m.object_id for m in models]),
        "filler_gap_mean": np.float32(gap.mean()),
        "ref_xy": np.stack([c[0] for c in compact]),
        "ref_qp": np.stack([c[1] for c in compact]),
        "ref_dsc": np.stack([c[2] for c in compact]),
        "ref_ok": np.stack([c[3] for c in compact]),
        "frame_image": np.arange(N_STREAM, dtype=np.int32) % N_SCENES,
        "sel": np.stack([s[0] for s in slabs]).astype(np.int32),
        "force": np.stack([s[1] for s in slabs]),
        "force_act": np.stack([s[2] for s in slabs]),
        **pack_detections("ref", ref),
        **pack_detections("stream", stream),
    }
    got = float_digests([image for image, _, _ in scenes],
                        str(out["config_json"]))
    check_float_rows([q for _, q in got], out["ref_dsc"], out["ref_ok"])
    out["ref_desc_digest"] = np.asarray([d for d, _ in got])
    for i, (q, p) in enumerate(zip(quant, points)):
        out[f"desc{i}"] = q
        out[f"points{i}"] = p
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
