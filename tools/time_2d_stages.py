"""Time, on a card, the 2D-only path, the SIFT graph's matcher, the P3P,
the 2D refinement, the model normal or the reprojection consensus kernel
of the tree at ``--root`` (default: this
checkout), so that a parent commit and its change can be timed in turns
in one call:

- ``--what 2d``: the 2D-only path of conf/detection.ork on a depthless
  smoke frame, split by ``utils/profiling.py StageTimer`` (CUDA events)
  into its stages (clustering, and per round noise, graph, sampling, p3p,
  consensus, refinement, summed over the rounds), ``--frames`` frames,
  each followed by a graph frame under torch.profiler (``device_ops``,
  ``device_busy_ms``: chip_smoke.py ``device_profile``, as phase 9b);
- ``--what matcher``: the SIFT graph's matcher, ``ops/matching.py
  l2_topk`` at phase 7e's shape (frame 0's 5000 SIFT descriptor slots
  against the three SIFT smoke models' rows, k 5, chunk 4,096), CUDA
  events over ``--frames`` calls;
- ``--what p1``: the P3P alone, ``geometry/pnp.py p3p_distances`` (kernel
  P1 on the card) on phase 3i's samples (``chip_smoke.p3p_samples`` at
  seed 19 and ``P1_SAMPLES``, from this checkout's ``chip_smoke.py``
  whatever ``--root`` names), CUDA events over ``--frames`` calls:
  ``p1`` around the call (its host work included) and ``p1_device`` with
  each call queued behind a device sleep;
- ``--what p2``: the refinement alone, ``geometry/pnp.py
  gauss_newton_pose`` (kernel P2 on the card) at ``chip_smoke.P2_SHAPE``
  (a 2D chunk's refinement) and, where the tree's P2 takes it, at
  ``P2_SCRATCH_SHAPE`` (rows past its shared memory), and at
  ``P2_LARGE_SHAPE`` where the tree's chip_smoke.py has one, on seeded
  poses; CUDA events over ``--frames`` calls each;
- ``--what m2``: the model normal alone, ``geometry/detection2d.py
  sym3_smallest_vector`` (kernel M2 on the card) on phase 3j's 32
  covariances (this checkout's ``chip_smoke.mirror_cases``, seed 37),
  ``m2`` around the call and ``m2_device`` queued behind a device sleep;
- ``--what r1``: the reprojection consensus alone, kernel R1's modes
  (``geometry/detection2d.py consensus_counts``, ``consensus_select``,
  ``consensus_masks``, ``consensus_sse``) on phase 3l's inputs (this
  checkout's ``chip_smoke.consensus_cases``, seed 41, at a chunk's
  ``R1_SHAPES[0]``; masks and SSE at the selection's 16 poses), each
  around the call and queued behind a device sleep (``*_device``), and
  ``consensus`` the stage's two launches together; a tree with R1 only.

Prints one JSON line: the medians in ms and each frame's values, with the
card's name and power limit. Run it from a checkout with its fixtures
(tests/data): ``python tools/time_2d_stages.py --what 2d --root DIR``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else "unknown card"


def time_2d(cs, root: str, frames: int) -> dict:
    import torch

    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
    from tod_tpu_torch.utils.profiling import StageTimer

    dev = torch.device("cuda", 0)
    fx, model_ids, models = cs.load_fixture()
    ax = np.load(cs.A13_FIXTURE)
    ork = os.path.join(root, str(ax["ork"]))
    per_frame = []
    with tempfile.TemporaryDirectory() as tmp:
        db_params = cs.write_catalog_db(tmp, model_ids, models)
        dirs = cs.write_frames(os.path.join(tmp, "depthless"), fx, True)
        p = build_pipeline_from_ork(ork, {
            "source1": {"path": dirs, "loop": True},
            "pipeline1": {"db": db_params, "device": str(dev)}})
        s = Scheduler(p.plasm)
        det = p.cells["pipeline1"]
        for _ in range(2):
            s.execute_iteration()                        # warm
        for _ in range(frames):
            s.execute_iteration()                        # this frame's inputs
            gg = det.guess_generator
            timer = StageTimer(dev)
            gg.timer = timer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gg.process()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            gg.timer = None
            timer.report()
            stages: dict = {"guess_host_ms": host}
            for name, sec in timer.times.items():
                kind = name.split(" ", 1)[1] if name.startswith("round") \
                    else name
                stages[kind] = stages.get(kind, 0.0) + sec * 1e3
            # the next frame whole (graph included) under torch.profiler
            ops, busy, wall = cs.device_profile(s.execute_iteration)
            stages.update(device_ops=ops, device_busy_ms=busy,
                          profiled_frame_ms=wall)
            per_frame.append(stages)
    return per_frame


def time_matcher(cs, frames: int) -> list:
    import torch

    from tod_tpu_torch.models.fused import prepare_frame
    from tod_tpu_torch.ops import matching as tm
    from tod_tpu_torch.ops import sift as tsift

    dev = torch.device("cuda", 0)
    fx = np.load(cs.FIXTURE)
    gray = prepare_frame(fx["images"][0], fx["depths"][0], fx["K"], dev)[0]
    _, desc = tsift.sift_detect_and_compute(gray, n_features=5000)
    s_models = cs.load_fixture(cs.SIFT_FIXTURE)[2]
    rows = np.concatenate([d for d, _ in s_models]).astype(np.float32) / 256
    n_valid = len(rows)
    rows = np.concatenate([rows, np.zeros(((-n_valid) % 4096, 128),
                                          np.float32)])
    db = torch.from_numpy(rows).to(dev)
    for _ in range(2):
        tm.l2_topk(desc, db, n_valid, k=5, chunk=4096)
    out = []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tm.l2_topk(desc, db, n_valid, k=5, chunk=4096)
        end.record()
        end.synchronize()
        out.append({"l2_topk": start.elapsed_time(end)})
    return out


def time_p2(cs, frames: int) -> list:
    import torch

    from tod_tpu_torch.geometry import pnp

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(29)
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    cases = {"p2": cs.P2_SHAPE}
    if hasattr(cs, "P2_LARGE_SHAPE"):
        cases["p2_large"] = cs.P2_LARGE_SHAPE
    if hasattr(pnp, "GN_SHARED_BYTES"):
        cases["p2_scratch"] = cs.P2_SCRATCH_SHAPE
    calls = {}
    for name, (n_obj, n_pose, n) in cases.items():
        X = rng.uniform(-0.12, 0.12, (n_obj, 1, n, 3)).astype(np.float32)
        X[..., 2] += 0.8
        ang = rng.uniform(-0.03, 0.03, (n_obj * n_pose, 3))
        R0 = np.stack([cs.cv_rodrigues(a) for a in ang]).reshape(
            n_obj, n_pose, 3, 3).astype(np.float32)
        T0 = rng.uniform(-0.01, 0.01, (n_obj, n_pose, 3)).astype(np.float32)
        uv = X[..., :2] / X[..., 2:3] * 525.0 + np.float32([319.5, 239.5])
        uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
        w = (rng.random((n_obj, n_pose, n)) > 0.2).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (R0, T0)] + [
            K.to(dev)] + [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (X, uv, w)]
        calls[name] = functools.partial(pnp.gauss_newton_pose, *args)
    out = []
    for f in range(frames + 2):
        row = {}
        for name, call in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            row[name] = start.elapsed_time(end)
        if f >= 2:                                       # after 2 warm
            out.append(row)
    return out


def own_chip_smoke():
    """This checkout's ``chip_smoke.py``, whichever tree ``--root`` names:
    the samples of phase 3i come from it, so a parent is timed on them too.
    """
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_own", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_p1(frames: int) -> list:
    import torch

    from tod_tpu_torch.geometry import pnp

    own = own_chip_smoke()
    dev = torch.device("cuda", 0)
    b, p = (torch.from_numpy(a).to(dev) for a in own.p3p_samples(
        np.random.default_rng(19), own.P1_SAMPLES))
    out = []
    for f in range(frames + 2):
        row = {}
        for name, queued in (("p1", False), ("p1_device", True)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(2_000_000)     # ~1 ms: hides the host
            start.record()
            pnp.p3p_distances(b, p)
            end.record()
            end.synchronize()
            row[name] = start.elapsed_time(end)
        if f >= 2:                                       # after 2 warm
            out.append(row)
    return out


def time_m2(frames: int) -> list:
    import torch

    from tod_tpu_torch.geometry import detection2d as td

    own = own_chip_smoke()
    dev = torch.device("cuda", 0)
    cov = own.mirror_cases(np.random.default_rng(37),
                           *own.MIRROR_SHAPES[0])[3].to(dev)
    out = []
    for f in range(frames + 2):
        row = {}
        for name, queued in (("m2", False), ("m2_device", True)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(2_000_000)     # ~1 ms: hides the host
            start.record()
            td.sym3_smallest_vector(cov)
            end.record()
            end.synchronize()
            row[name] = start.elapsed_time(end)
        if f >= 2:                                       # after 2 warm
            out.append(row)
    return out


def time_r1(frames: int) -> list:
    import torch

    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.adjacency import ObjectMatches

    own = own_chip_smoke()
    dev = torch.device("cuda", 0)
    R, T, K, X, xy, valid, ok = (x.to(dev) for x in own.consensus_cases(
        np.random.default_rng(41), *own.R1_SHAPES[0]))
    m = ObjectMatches(query_pts=None, train_pts=X, query_idx=None,
                      query_xy=xy, valid=valid)
    thr2 = 16.0
    counts = td.consensus_counts(R, T, K, m, valid, ok, thr2)
    sel = td.consensus_select(counts, R, T, K, m, valid, ok, thr2)
    calls = {
        "counts": lambda: td.consensus_counts(R, T, K, m, valid, ok, thr2),
        "select": lambda: td.consensus_select(counts, R, T, K, m, valid, ok,
                                              thr2),
        "masks": lambda: td.consensus_masks(sel.R, sel.T, K, m, valid, thr2),
        "sse": lambda: td.consensus_sse(sel.R, sel.T, K, m, valid, thr2),
        "consensus": lambda: td.consensus_select(
            td.consensus_counts(R, T, K, m, valid, ok, thr2), R, T, K, m,
            valid, ok, thr2)}
    out = []
    for f in range(frames + 2):
        row = {}
        for name, call in calls.items():
            for key, queued in ((name, False), (f"{name}_device", True)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if queued:
                    torch.cuda._sleep(2_000_000)  # ~1 ms: hides the host
                start.record()
                call()
                end.record()
                end.synchronize()
                row[key] = start.elapsed_time(end)
        if f >= 2:                                       # after 2 warm
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--what", choices=("2d", "matcher", "p1", "p2", "m2",
                                       "r1"),
                    default="2d")
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("time_2d_stages: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tod_tpu_torch import kernels

    kernels.build_all()
    per_frame = {"2d": lambda: time_2d(cs, root, args.frames),
                 "matcher": lambda: time_matcher(cs, args.frames),
                 "p1": lambda: time_p1(args.frames),
                 "p2": lambda: time_p2(cs, args.frames),
                 "m2": lambda: time_m2(args.frames),
                 "r1": lambda: time_r1(args.frames)}[args.what]()
    keys = sorted({k for f in per_frame for k in f})
    print(json.dumps({
        "what": args.what, "root": root, "card": card_line(),
        "median_ms": {k: float(np.median([f.get(k, 0.0) for f in per_frame]))
                      for k in keys},
        "frames_ms": per_frame}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
