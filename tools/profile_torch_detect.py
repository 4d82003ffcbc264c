#!/usr/bin/env python3
"""Where one frame of the port's serving path spends its time, on the GPU.

    python3 tools/profile_torch_detect.py [--frames 4] [--trace PATH]
                                          [--objects N] [--frontier] [--sift]
                                          [--global] [--compare-noise]

Builds one of chip_smoke.py's detectors (the smoke catalog, 100 objects by
default, at the bench's operating point; ``--frontier``: the coarse->fine
frontier recipe with its streaming state; ``--sift``: the SIFT/L2 path on
the SIFT smoke catalog, radius 0.9; ``--global``: the global-kNN path at
FusedDetectorConfig()'s own operating point), warms it up on the fixture's
frames, then traces ``--frames`` calls of ``detect`` with torch.profiler.
Prints the host latency per frame, the device-busy share of the traced
window, per-stage host times (each stage of ``detect`` ended by a
synchronize; ``noise``, the RANSAC's threefry draws by kernel N1, is timed
inside the geometry stage and summed a frame), one frame's noise draws
counted and timed alone, through N1 and through its plain twin
(chip_smoke.noise_cost), and the top operators by device time; writes the
chrome trace to ``--trace``. ``--compare-noise`` also times ``detect``
(closed loop, in turns: threefry, generator, generator, threefry) with the
detector's own threefry noise and with Gumbel noise from a
``torch.Generator`` (one ``torch.rand`` a draw, the noise before the port
replayed the reference's), so that the noise's share of a frame shows end
to end. Needs a CUDA device; imports no JAX.
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


N_TIMED = 8     # frames of the stage split
COMPARE_FRAMES = 20   # closed-loop frames a turn of --compare-noise
# the stages of FusedDetector.detect, by the name fused.py calls them
STAGES = ("stage_features_compact", "stage_features", "object_top1",
          "object_top1_l2", "match_against_db", "stage_coarse_select",
          "object_top1_gathered", "object_top1_l2_gathered",
          "detect_frame_segmented", "detect_frame_gathered", "stage_geometry",
          "update_age", "fold_best_pose", "poses")


def stage_timers(det):
    """Wrap each stage of ``det.detect``, and each noise draw, so that it
    synchronises before and after itself and adds its host milliseconds to
    a list; returns ``{stage: [ms, ...]}`` and a function that undoes the
    wrapping."""
    from tod_tpu_torch.geometry.ransac import ThreefryNoise
    from tod_tpu_torch.models import fused

    times = {name: [] for name in STAGES + ("noise",)}
    saved = []

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for name in STAGES:
        owner = det if name == "poses" else fused
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, timed(name, getattr(owner, name)))
    saved.append((ThreefryNoise, "__call__", ThreefryNoise.__call__))
    ThreefryNoise.__call__ = timed("noise", ThreefryNoise.__call__)

    def undo():
        for owner, name, fn in saved:
            if owner is det:
                delattr(det, name)
            else:
                setattr(owner, name, fn)
    return times, undo


def generator_noise(device):
    """Standard Gumbel noise from a seeded ``torch.Generator``: a
    yardstick for the threefry draws' cost, not the reference's noise."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tiny = torch.finfo(torch.float32).tiny

    def draw(stage, shape):
        u = torch.rand(shape, generator=gen, device=device).clamp_min_(tiny)
        return -torch.log(-torch.log(u))
    return draw


def compare_noise(cs, det, frames, path: str, card: str) -> None:
    """Closed-loop ``detect`` medians with the detector's threefry noise
    and with :func:`generator_noise`, in turns."""
    lat = {"threefry": [], "generator": []}
    for turn in ("threefry", "generator", "generator", "threefry"):
        det.noise = None if turn == "threefry" else generator_noise(
            det.device)
        lat[turn] += list(cs.timed_detect(det, frames, COMPARE_FRAMES))
    det.noise = None
    print(f"{path}: detect median / p95 ms over {2 * COMPARE_FRAMES} frames "
          "a noise, in turns: " + "; ".join(
              f"{k} {np.median(v):.2f} / {np.percentile(v, 95):.2f}"
              for k, v in lat.items()) + f"; {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--trace", default="",
                    help="write the chrome trace here (tens of MB a frame)")
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--frontier", action="store_true",
                    help="coarse->fine with tracked/exploration slots")
    ap.add_argument("--sift", action="store_true",
                    help="SIFT/L2 features and kernels B3/B4")
    ap.add_argument("--global", dest="global_path", action="store_true",
                    help="the global-kNN path and kernel B5")
    ap.add_argument("--compare-noise", action="store_true",
                    help="detect with threefry vs torch.Generator noise")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tod_tpu_torch.models.fused import FusedDetector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    fx, ids, models = cs.load_fixture()
    if args.sift:      # the smoke fixture's frames, the SIFT fixture's models
        sx, ids, models = cs.load_fixture(cs.SIFT_FIXTURE)
        cfg = (cs.config(sx, cs.SIFT_CONFIG, "stream_config_json",
                         **cs.FRONTIER) if args.frontier
               else cs.config(sx, cs.SIFT_CONFIG))
    elif args.global_path:
        cfg = cs.config(np.load(cs.GLOBAL_FIXTURE), cs.GLOBAL_CONFIG)
    elif args.frontier:
        cfg = cs.config(np.load(cs.STREAM_FIXTURE), **cs.FRONTIER)
    else:
        cfg = cs.config(fx)
    det = FusedDetector(cs.smoke_models(ids, models, args.objects,
                                        device="cuda"),
                        cfg, seed=0, device="cuda")
    frames = [det.prepare_frame(fx["images"][f], fx["depths"][f], fx["K"])
              for f in range(len(fx["images"]))]
    for frame in frames * 2:
        det.detect(*frame)

    times, undo = stage_timers(det)
    for i in range(N_TIMED):
        det.detect(*frames[i % len(frames)])
    undo()
    path = ("SIFT " if args.sift else "ORB ") \
        + ("global kNN" if args.global_path else
           "coarse->fine" if args.frontier else "full sweep")
    noise_ms = sum(times.pop("noise")) / N_TIMED
    print(f"{args.objects} objects, {path}; stage host ms (median of "
          f"{N_TIMED} frames, each synchronised): "
          + ", ".join(f"{k} {np.median(v):.2f}" for k, v in times.items()
                      if v) + f"; noise (inside the geometry) {noise_ms:.2f} "
          f"a frame; {card}")
    cs.noise_cost(det, frames[0], f"{args.objects} objects, {path}", card)
    if args.compare_noise:
        compare_noise(cs, det, frames, f"{args.objects} objects, {path}",
                      card)

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
