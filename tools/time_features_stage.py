#!/usr/bin/env python3
"""Time the port's image pyramid and features stage on the GPU, frame size by
frame size, for one checkout of the port.

    python3 tools/time_features_stage.py [--root DIR] [--label NAME]
        [--frames 480x640,720x1280] [--runs 20] [--train RUNS]

Imports ``tod_tpu_torch`` from ``--root`` (default this checkout), so that
two versions are compared on one card by running this once a checkout in
turns: parent, change, change, parent. The frame of each size is
tod_tpu_torch/utils/camera_sizes.py's ``size_scene`` (read from this
checkout, which an older one may lack) rendered by ``--root``'s renderer.
Each size prints one JSON line: the label, the size, the card's name and
power limit, the median and range of host ms over ``--runs`` calls (each
synchronised, after 3 warm-up calls) of ``build_pyramid`` (the operating
point's levels and scale) and of ``stage_features_compact`` (the bench's
operating point, tests/data/torch_sizes_fixture.npz ``config_json``), and
the device operations of one call of each under torch.profiler, and the
same of the keypoint orientation alone (``ops/orb.py keypoint_angles`` at
every level of one features call, with that call's keypoints).
``--train RUNS`` also times ``cells/trainer.py train_views`` on object 0's
60 views of tests/data/torch_train_fixture.npz (ORB, 600 features: the
bench's training) over RUNS runs and prints ms a view. Needs a CUDA
device; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def own_module(name: str, path: str):
    """A numpy-only module of this checkout, loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def synced_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_ops(torch, fn) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--frames", default="480x640,720x1280")
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--train", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_features_stage: no CUDA device", file=sys.stderr)
        return 1
    sizes = own_module("camera_sizes", os.path.join(
        HERE, "tod_tpu_torch", "utils", "camera_sizes.py"))
    sys.path.insert(0, os.path.abspath(args.root))
    from tod_tpu_torch.convert import config_from_dict
    from tod_tpu_torch.models.fused import (prepare_frame,
                                            stage_features_compact)
    from tod_tpu_torch.ops import orb
    from tod_tpu_torch.ops.image import build_pyramid
    from tod_tpu_torch.utils import synthetic as syn

    fixture = np.load(os.path.join(HERE, "tests", "data",
                                   "torch_sizes_fixture.npz"))
    cfg = config_from_dict(json.loads(str(fixture["config_json"])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for frame in args.frames.split(","):
        h, w = (int(v) for v in frame.split("x"))
        image, depth = sizes.size_scene(syn, h, w)
        gray, depth_t, K_t = prepare_frame(image, depth,
                                           sizes.size_camera(h, w), dev)
        levels, original = [], orb.keypoint_angles
        orb.keypoint_angles = lambda img, xy: (levels.append((img, xy)),
                                               original(img, xy))[1]
        try:
            stage_features_compact(gray, depth_t, K_t, cfg)
        finally:
            orb.keypoint_angles = original
        calls = {
            "pyramid": lambda: build_pyramid(gray, cfg.n_levels,
                                             cfg.scale_factor),
            "features": lambda: stage_features_compact(gray, depth_t, K_t,
                                                       cfg),
            "angles": lambda: [orb.keypoint_angles(img, xy)
                               for img, xy in levels]}
        row = {"label": args.label, "frame": frame, "card": card,
               "runs": args.runs}
        for name, fn in calls.items():
            ms = [synced_ms(torch, fn) for _ in range(3 + args.runs)][3:]
            row[f"{name}_ms"] = float(np.median(ms))
            row[f"{name}_ms_range"] = [min(ms), max(ms)]
            row[f"{name}_device_ops"] = device_ops(torch, fn)
        print(json.dumps(row), flush=True)
    if args.train:
        from tod_tpu_torch.cells.trainer import feature_settings, train_views
        from tod_tpu_torch.types import fixture_observations

        tx = np.load(os.path.join(HERE, "tests", "data",
                                  "torch_train_fixture.npz"))
        views = fixture_observations(tx, 0)
        settings = feature_settings({"type": "ORB", "n_features": 600})
        fn = lambda: train_views(views, settings, dev)  # noqa: E731
        ms = [synced_ms(torch, fn) for _ in range(1 + args.train)][1:]
        print(json.dumps({"label": args.label, "card": card,
                          "train_views": len(views), "runs": args.train,
                          "train_ms_a_view": float(np.median(ms))
                          / len(views),
                          "train_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
