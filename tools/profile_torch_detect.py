#!/usr/bin/env python3
"""Where one frame of the port's serving path spends its time, on the GPU.

    python3 tools/profile_torch_detect.py [--frames 4] [--trace PATH]

Builds chip_smoke.py's detector (the 100-object smoke catalog at the
bench's operating point), warms it up on the fixture's frames, then traces
``--frames`` calls of ``detect`` with torch.profiler. Prints the host
latency per frame, the device-busy share of the traced window, per-stage
host times (features+compaction, B1, geometry, read-back) and the top
operators by device time; writes the chrome trace to ``--trace``.
Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="write the chrome trace here (tens of MB a frame)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tod_tpu_torch.geometry.detection import detect_frame_segmented
    from tod_tpu_torch.models.fused import FusedDetector, \
        stage_features_compact
    from tod_tpu_torch.ops.segmented import object_top1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    fx, ids, models = cs.load_fixture()
    cfg = cs.bench_config(fx)
    det = FusedDetector(cs.smoke_models(ids, models), cfg, seed=0,
                        device="cuda")
    frames = [det.prepare_frame(fx["images"][f], fx["depths"][f], fx["K"])
              for f in range(len(fx["images"]))]
    for frame in frames * 2:
        det.detect(*frame)

    # host time per stage, each stage ended by a synchronize
    stages = {"features": [], "b1": [], "geometry": [], "readback": []}
    for i in range(8):
        gray, depth, K = frames[i % len(frames)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xy, qp, dsc, ok = stage_features_compact(gray, depth, K, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dist, rows = object_top1(dsc, det.sdb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, d = detect_frame_segmented(
            det.noise, dist, rows, ok, qp, xy, det.sdb.points,
            det.sdb.obj_start, det.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        d.R.cpu(), d.accepted.cpu()
        t4 = time.perf_counter()
        for k, a, b in (("features", t0, t1), ("b1", t1, t2),
                        ("geometry", t2, t3), ("readback", t3, t4)):
            stages[k].append((b - a) * 1e3)
    print("stage host ms (median of 8, synchronised): " + ", ".join(
        f"{k} {np.median(v):.2f}" for k, v in stages.items()) + f"; {card}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.frames):
            det.detect(*frames[i % len(frames)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side activity only (kernels and copies), not the aten ops
    # that launched them, so nothing is counted twice
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in device)
    print(f"traced {args.frames} frames: {wall / args.frames * 1e3:.2f} ms "
          f"per frame on the host clock; device busy "
          f"{dev_us / 1e3 / args.frames:.2f} ms per frame "
          f"({100 * dev_us / 1e6 / wall:.1f} % of the window); "
          f"{len(device) / args.frames:.0f} device ops per frame; {card}")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
