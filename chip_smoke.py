#!/usr/bin/env python3
"""Drive the port's segmented ORB serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Imports only torch, numpy and tod_tpu_torch (no JAX). Phases, in order;
any failure raises, exits non-zero and prints no ``ok`` line:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
            versions; TF32 off for matrix products and convolutions.
2. build    every CUDA kernel of the paths, from csrc/, with nvcc.
3. kernels  kernel B1 (csrc/segmented_top1.cu) against its plain PyTorch
            twin, bit for bit, on the smoke catalog at Q = 2048 and on edge
            cases; both timed with CUDA events.
3b.         kernel B2 (the gathered entry point of the same file) against
            its twin and against B1's columns at ``sel``, bit for bit, on
            the edge cases (holes, an empty object, repeated and
            out-of-order ids) and on the 1000-object catalog (64 slots with
            holes); B1 against its twin there too. Timed: B2 at Q = 2048 x
            64 slots and its twin, the coarse B1 at Q = 1024 on the
            stride-16 DB, the full-sweep B1 at Q = 2048 over 1000 objects.
4. main     FusedDetector at the bench's operating point on the 100-object
            smoke catalog, frames of tests/data/torch_smoke_fixture.npz
            through prepare_frame -> detect; the compaction stage's
            keypoints, 3D points and descriptors against the JAX
            reference's, bit for bit; every ground-truth placement found
            within 2 cm at the quality gate, the accepted objects and poses
            agreeing with the JAX reference's stored detections (1 cm, 2
            degrees), one B1 launch per frame.
4b.         the frontier recipe (coarse->fine, tracked and exploration
            slots) on the same catalog over a stream of 6 frames, against
            the JAX reference's stream (tests/data/torch_stream_fixture.npz):
            frame 0's slab exactly, then on every frame every placement
            within 2 cm at the gate and the reference's accepted objects
            and poses (1 cm, 2 degrees); one B1 and one B2 launch a frame.
4c.         the frontier recipe at 1000 objects over a stream of 64 frames
            (one exploration cycle is 63): every present object discovered
            within 63 frames and found within 2 cm at the gate on every
            frame after; one B1 and one B2 launch a frame.
5. time     per-frame detect latency (median, p95) over 200 frames after
            warm-up at 100 objects, and the resident catalog bytes.
5b.         the same for the frontier recipe at 1000 objects, beside the
            full exact sweep at 1000 objects over fewer frames; resident
            bytes of both DBs and peak device memory.

The line before the last is a JSON object of every kernel of the paths; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "torch_smoke_fixture.npz")
STREAM_FIXTURE = os.path.join(DATA, "torch_stream_fixture.npz")
Q = 2048
KERNEL_RUNS = 24       # CUDA-event timings of a kernel and its twin
TWIN_RUNS = 3          # twin timings at 1000 objects (~0.1-2 s each)
FRAMES = 200           # timed detect calls: p95 has 10 frames above it
SWEEP_FRAMES = 30      # timed full-sweep frames at 1000 objects
N_OBJECTS = 100
N_LARGE = 1000
STREAM = 64            # frames at 1000 objects: > one exploration cycle
DISCOVERY = 63         # ceil(1000 / explore_width) frames
B2_SLOTS = 64
MAX_KEYPOINT_SWAPS = 0  # per frame, of 2048 (see compaction_mismatches)
SOURCE = "tod_tpu_torch/csrc/segmented_top1.cu"
B1_REPLACES = "tod_tpu/ops/pallas/segmented.py:128"
B2_REPLACES = "tod_tpu/ops/pallas/segmented.py:349"

# The bench's serving operating point, bench.py:444-524 (build_config with
# no BENCH_* overrides), gated at min_quality 156 as
# conf/detection.serving.ork ships it.
BENCH_CONFIG = dict(
    n_features=5000, feature="ORB", subpixel=False, pipeline="segmented",
    q_cap=2048, bucket_grid=(6, 8), radius=50.0, k_matches=8,
    coarse_stride=0, fine_width=128, coarse_q_stride=1, track_width=0,
    explore_width=0, track_ttl=2, track_min_confidence=16.0,
    activation=dict(m_cap=192, n_hypotheses=128, object_batch=20,
                    prescreen=32, active_reserve=4),
    guess=dict(ransac=dict(n_hypotheses=512, continuation_hypotheses=128,
                           min_inliers=8, max_instances=3,
                           tight_final_fit=True),
               max_matches_per_object=384, object_batch=8,
               max_active_objects=16),
    min_quality=156.0)
# The frontier recipe for ~400-2000 objects, streaming (docs/SERVING.md
# "Sizing rules of thumb"), on the same operating point.
FRONTIER = dict(coarse_stride=16, fine_width=64, coarse_q_stride=2,
                track_width=16, explore_width=16)
# The full exact sweep at 1000 objects, prescreen sized as bench.py:501-504
SWEEP_PRESCREEN = max(32, N_LARGE // 12)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, runs: int = KERNEL_RUNS, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, each bracketed
    by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def load_fixture():
    fx = np.load(FIXTURE)
    models = [(fx[f"desc{i}"], fx[f"points{i}"])
              for i in range(len(fx["model_ids"]))]
    return fx, [str(s) for s in fx["model_ids"]], models


def smoke_models(model_ids, models, n_objects: int = N_OBJECTS,
                 device=None):
    from tod_tpu_torch.convert import models_from_numpy
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    ids, arrays = smoke_catalog(model_ids, models, n_objects=n_objects,
                                device=device)
    return models_from_numpy(ids, [d for d, _ in arrays],
                             [p for _, p in arrays])


def config(fx, **change):
    """The bench config with ``change``, held to the config ``fx`` was
    made with."""
    from tod_tpu_torch.convert import config_from_dict

    cfg = config_from_dict({**BENCH_CONFIG, **change})
    stored = json.loads(str(fx["config_json"]))
    mine = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if mine != stored:
        diff = {k for k in set(mine) | set(stored)
                if mine.get(k) != stored.get(k)}
        raise AssertionError(f"config differs from the fixture's "
                             f"reference config in {sorted(diff)}")
    return cfg


def edge_case_db(device):
    """Models that hit the kernels' edges: an empty object, objects
    spanning several row tiles and DB chunks, duplicated rows, and rows at
    distance 0 and 256 from the first queries."""
    from tod_tpu_torch.ops.segmented import pack_segmented
    from tod_tpu_torch.types import TodModel

    rng = np.random.default_rng(7)
    sizes = [300, 0, 9000, 64, 700, 1, 4096, 513]
    descs = [rng.integers(0, 256, (n, 32), dtype=np.uint8) for n in sizes]
    descs[3][10:20] = descs[3][5]
    models = [TodModel(f"e{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    q = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    q[0] = descs[4][123]
    q[1] = ~descs[5][0]
    q[2] = descs[3][5]
    return pack_segmented(models, device=device), \
        torch.from_numpy(q).to(device)


def check_b1(q, sdb, what: str) -> float:
    """B1 against its twin on the card: equal bits or raise. Returns the
    largest absolute distance gap (0.0)."""
    from tod_tpu_torch.ops.segmented import object_top1, object_top1_torch

    d_k, r_k = object_top1(q, sdb)
    torch.cuda.synchronize()
    d_t, r_t = object_top1_torch(q, sdb)
    err = float((d_k - d_t).abs().max())
    rows_equal = bool(torch.equal(r_k, r_t))
    log(f"kernels: B1 vs twin on {what}: Q={q.shape[0]} O={sdb.n_objects} "
        f"rows={sum(sdb.rows_host)} max_abs_err={err} "
        f"rows_equal={rows_equal}")
    if err != 0.0 or not rows_equal or not torch.equal(d_k, d_t):
        raise AssertionError(f"B1 disagrees with its twin on {what}")
    return err


def check_b2(q, sdb, sel, what: str) -> float:
    """B2 against its twin and against B1's columns at ``sel``, and its
    holes, on the card: equal bits or raise. Returns the largest absolute
    distance gap to the twin (0.0)."""
    from tod_tpu_torch.ops import segmented as seg

    d_k, r_k = seg.object_top1_gathered(q, sdb, sel)
    torch.cuda.synchronize()
    d_t, r_t = seg.object_top1_gathered_torch(q, sdb, sel)
    err = float((d_k - d_t).abs().max())
    d_b1, r_b1 = seg.object_top1(q, sdb)
    real = (sel >= 0) & (sel < sdb.n_objects)
    cols = sel[real].long()
    as_b1 = bool(torch.equal(d_k[:, real], d_b1[:, cols])
                 and torch.equal(r_k[:, real], r_b1[:, cols]))
    holes = bool((d_k[:, ~real] == seg.HOLE_DIST).all()
                 and (r_k[:, ~real] == seg.HOLE_ROW).all())
    log(f"kernels: B2 vs twin on {what}: Q={q.shape[0]} C={sel.shape[0]} "
        f"({int((~real).sum())} holes) max_abs_err={err} "
        f"equal_to_B1_columns={as_b1} holes_ok={holes}")
    if err != 0.0 or not (torch.equal(d_k, d_t) and torch.equal(r_k, r_t)
                          and as_b1 and holes):
        raise AssertionError(f"B2 disagrees with its twin or B1 on {what}")
    return err


def compaction_mismatches(port, fx, f: int) -> int:
    """Reference keypoints of frame ``f`` (xy, 3D point, descriptor, all
    bit for bit) that the port's compaction outputs lack."""
    xy, qp, dsc, ok = (t.cpu().numpy() for t in port)
    ref = (fx["ref_xy"][f], fx["ref_qp"][f], fx["ref_dsc"][f], fx["ref_ok"][f])

    def keys(xy, qp, dsc, ok):
        return Counter(a.tobytes() + b.tobytes() + c.tobytes()
                       for a, b, c in zip(xy[ok], qp[ok], dsc[ok]))

    return sum((keys(*ref) - keys(xy, qp, dsc, ok)).values())


def pose_error(R_a, T_a, R_b, T_b):
    dt = float(np.linalg.norm(np.asarray(T_a) - np.asarray(T_b)))
    cos = (np.trace(np.asarray(R_a) @ np.asarray(R_b).T) - 1.0) / 2.0
    return dt, float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def placements_missed(found, fx, image: int):
    """Ground-truth placements of fixture frame ``image`` not found within
    2 cm at the gate: ``[(object id, translation errors)]``."""
    missed = []
    for oid, R, T in zip(fx["gt_ids"][image], fx["gt_R"][image],
                         fx["gt_T"][image]):
        errs = [pose_error(r.R, r.T, R, T)[0] for r in found
                if r.object_id == str(oid)]
        if not errs or min(errs) >= 0.02:
            missed.append((str(oid), errs))
    return missed


def check_frame(f: int, found, fx, ref=None, image=None,
                what: str = "main") -> None:
    """Ground truth within 2 cm at the gate; the same accepted objects as
    the reference's stored detections of frame ``f`` (``ref``, default the
    smoke fixture's), poses within 1 cm and 2 degrees."""
    ref = fx if ref is None else ref
    missed = placements_missed(found, fx, f if image is None else image)
    if missed:
        raise AssertionError(f"frame {f}: not found within 2 cm: {missed}")
    mine = [i for i in range(len(ref["ref_ids"])) if ref["ref_frame"][i] == f]
    ref_ids = sorted(str(ref["ref_ids"][i]) for i in mine)
    got_ids = sorted(r.object_id for r in found)
    if got_ids != ref_ids:
        raise AssertionError(f"frame {f}: accepted {got_ids}, the "
                             f"reference accepted {ref_ids}")
    for i in mine:
        dt, ang = min(pose_error(r.R, r.T, ref["ref_R"][i], ref["ref_T"][i])
                      for r in found if r.object_id == str(ref["ref_ids"][i]))
        if dt >= 0.01 or ang >= 2.0:
            raise AssertionError(f"frame {f}: {ref['ref_ids'][i]} is "
                                 f"{dt * 100:.2f} cm / {ang:.2f} deg from "
                                 "the reference's pose")
    log(f"{what}: frame {f}: " + ", ".join(
        f"{r.object_id} q={r.quality:.0f} inliers={r.confidence:.0f}"
        for r in found))


def reset_counts() -> None:
    from tod_tpu_torch.ops import segmented as seg

    seg.object_top1.launches = 0
    seg.object_top1_gathered.launches = 0


def read_counts():
    from tod_tpu_torch.ops import segmented as seg

    return seg.object_top1.launches, seg.object_top1_gathered.launches


def check_launches(what: str, n_frames: int, b1: int, b2: int,
                   want_b2: bool) -> None:
    log(f"{what}: {n_frames} frames, B1 launches {b1}, B2 launches {b2}")
    if b1 != n_frames or b2 != (n_frames if want_b2 else 0):
        raise AssertionError(f"{what}: B1 launched {b1} and B2 {b2} times "
                             f"for {n_frames} frames")


def timed_detect(det, frames, n: int):
    """Milliseconds of ``n`` closed-loop detect calls (each ends in one
    device read), cycling over ``frames``."""
    lat = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect(*frames[i % len(frames)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(lat)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from tod_tpu_torch import kernels
    from tod_tpu_torch.models.fused import (FusedDetector,
                                            stage_features_compact)
    from tod_tpu_torch.ops import segmented as seg

    # ---- 1. device --------------------------------------------------------
    card = card_line()
    log(f"device: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    for name in kernels.SOURCES:
        kernels.load(name)
    log(f"build: {sorted(kernels.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds})")

    # ---- 3. kernels against their twins -----------------------------------
    fx, model_ids, models = load_fixture()
    sfx = np.load(STREAM_FIXTURE)
    catalog = smoke_models(model_ids, models)
    cfg = config(fx)
    det = FusedDetector(catalog, cfg, seed=0, device=dev)
    sdb = det.sdb
    rng = np.random.default_rng(0)
    pick = rng.choice(len(models[0][0]), Q, replace=False)
    q_main = torch.from_numpy(models[0][0][pick]).to(dev)
    q_main[1::2] ^= torch.from_numpy(
        rng.integers(0, 256, (Q // 2, 32), dtype=np.uint8)).to(dev)
    err = check_b1(q_main, sdb, "the smoke catalog")
    edge_db, edge_q = edge_case_db(dev)
    err = max(err, check_b1(edge_q, edge_db, "edge cases"))
    err = max(err, check_b1(q_main[:1000], sdb, "Q=1000 (partial tile)"))
    ms = cuda_ms(lambda: seg.object_top1(q_main, sdb))
    plain_ms = cuda_ms(lambda: seg.object_top1_torch(q_main, sdb))
    pairs = Q * sum(sdb.rows_host)
    log(f"kernels: B1 {ms:.3f} ms median of {KERNEL_RUNS} "
        f"({pairs / ms / 1e6:.1f} G pairs/s); twin {plain_ms:.3f} ms "
        f"({pairs / plain_ms / 1e6:.1f} G pairs/s); Q={Q} x "
        f"{sum(sdb.rows_host)} rows, {sdb.n_objects} objects; {card}")

    # ---- 3b. B2, and both kernels at 1000 objects -------------------------
    t0 = time.perf_counter()
    large = smoke_models(model_ids, models, N_LARGE, device=dev)
    cfg_cf = config(sfx, **FRONTIER)
    cf = FusedDetector(large, cfg_cf, seed=0, device=dev)
    ldb, cdb = cf.sdb, cf.cdb
    log(f"kernels: {N_LARGE}-object catalog ({sum(ldb.rows_host)} rows, "
        f"fillers past 100 drawn on the card) and its stride-16 coarse DB "
        f"({sum(cdb.rows_host)} rows, chunk {cdb.db_chunk}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    i32 = dict(dtype=torch.int32, device=dev)
    b2_err = check_b2(edge_q, edge_db,
                      torch.tensor([4, -1, 1, 2, 4, 0, -1, 6, 3, 9, 5, 7],
                                   **i32), "edge cases (object 1 empty)")
    sel_holes = torch.from_numpy(rng.choice(N_LARGE, B2_SLOTS, replace=False)
                                 .astype(np.int32)).to(dev)
    sel_holes[:3] = torch.tensor([2, 0, 1], **i32)
    sel_holes[[5, 17, 40]] = -1
    sel_holes[30] = sel_holes[31]                    # a repeated id
    b2_err = max(b2_err, check_b2(q_main, ldb, sel_holes,
                                  f"the {N_LARGE}-object catalog"))
    err = max(err, check_b1(q_main, ldb, f"the {N_LARGE}-object catalog"))
    sel_t = torch.from_numpy(rng.choice(N_LARGE, B2_SLOTS, replace=False)
                             .astype(np.int32)).to(dev)
    b2_ms = cuda_ms(lambda: seg.object_top1_gathered(q_main, ldb, sel_t))
    b2_plain_ms = cuda_ms(
        lambda: seg.object_top1_gathered_torch(q_main, ldb, sel_t),
        runs=TWIN_RUNS, warmup=1)
    b2_pairs = Q * sum(ldb.rows_host[o] for o in sel_t.tolist())
    q_c = q_main[::2].contiguous()
    coarse_ms = cuda_ms(lambda: seg.object_top1(q_c, cdb))
    coarse_pairs = q_c.shape[0] * sum(cdb.rows_host)
    sweep_ms = cuda_ms(lambda: seg.object_top1(q_main, ldb), runs=8)
    sweep_pairs = Q * sum(ldb.rows_host)
    log(f"kernels: B2 {b2_ms:.3f} ms median of {KERNEL_RUNS} "
        f"({b2_pairs / b2_ms / 1e6:.1f} G pairs/s); twin {b2_plain_ms:.3f} "
        f"ms ({b2_pairs / b2_plain_ms / 1e6:.1f} G pairs/s) median of "
        f"{TWIN_RUNS}; Q={Q} x {B2_SLOTS} slots ({b2_pairs // Q} rows); "
        f"{card}")
    log(f"kernels: coarse B1 {coarse_ms:.3f} ms "
        f"({coarse_pairs / coarse_ms / 1e6:.1f} G pairs/s) at "
        f"Q={q_c.shape[0]} x {sum(cdb.rows_host)} rows; full-sweep B1 "
        f"{sweep_ms:.3f} ms ({sweep_pairs / sweep_ms / 1e6:.1f} G pairs/s) "
        f"at Q={Q} x {sum(ldb.rows_host)} rows, {N_LARGE} objects; {card}")

    # ---- 4. the main path -------------------------------------------------
    frames = [det.prepare_frame(fx["images"][f], fx["depths"][f], fx["K"])
              for f in range(len(fx["images"]))]
    for f, frame in enumerate(frames):
        missing = compaction_mismatches(
            stage_features_compact(*frame, cfg), fx, f)
        log(f"main: frame {f}: {missing} of {int(fx['ref_ok'][f].sum())} "
            "reference keypoints not reproduced bit for bit")
        if missing > MAX_KEYPOINT_SWAPS:
            raise AssertionError(f"frame {f}: {missing} keypoints differ "
                                 "from the reference's compaction")
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches = {"4": read_counts()}
    check_launches("main", len(frames), *launches["4"], want_b2=False)
    for f, res in enumerate(found):
        check_frame(f, res, fx)
    log("main: every placement within 2 cm; accepted objects and poses "
        "agree with the reference")

    # ---- 4b. coarse->fine against the reference's stream, 100 objects ----
    stream = FusedDetector(catalog, config(sfx, **FRONTIER), seed=0,
                           device=dev)
    n_stream = len(sfx["frame_image"])
    reset_counts()
    for f in range(n_stream):
        res = stream.detect(*frames[int(sfx["frame_image"][f])])
        sel, force, force_act = (t.cpu().numpy() for t in stream.slab)
        differ = int((sel != sfx["sel"][f]).sum())
        log(f"stream: frame {f}: {differ} of {len(sel)} slab slots differ "
            f"from the reference's; forced {int(force.sum())}, tracked "
            f"{int(force_act.sum())}")
        if f == 0 and (differ or not np.array_equal(force, sfx["force"][0])
                       or not np.array_equal(force_act,
                                             sfx["force_act"][0])):
            raise AssertionError("frame 0's slab differs from the "
                                 "reference's")
        check_frame(f, res, fx, sfx, int(sfx["frame_image"][f]), "stream")
    launches["4b"] = read_counts()
    check_launches("stream", n_stream, *launches["4b"], want_b2=True)
    log("stream: frame 0's slab exact; every placement within 2 cm; "
        "accepted objects and poses agree with the reference")

    # ---- 4c. coarse->fine at catalog scale, 1000 objects -----------------
    first = {}
    reset_counts()
    for f in range(STREAM):
        image = f % len(frames)
        missed = placements_missed(cf.detect(*frames[image]), fx, image)
        for oid in fx["gt_ids"][image]:
            oid = str(oid)
            if oid not in first and all(m[0] != oid for m in missed):
                first[oid] = f
        late = [m for m in missed if m[0] in first]
        if late:
            raise AssertionError(f"scale: frame {f}: discovered objects "
                                 f"lost: {late}")
    launches["4c"] = read_counts()
    present = sorted({str(o) for ids in fx["gt_ids"] for o in ids})
    log(f"scale: {N_LARGE} objects, discovery frame per present object: "
        + ", ".join(f"{o} {first.get(o, 'never')}" for o in present))
    check_launches("scale", STREAM, *launches["4c"], want_b2=True)
    slow = [o for o in present if first.get(o, STREAM) >= DISCOVERY]
    if slow:
        raise AssertionError(f"scale: {slow} not discovered within "
                             f"{DISCOVERY} frames")
    log("scale: every present object discovered within "
        f"{DISCOVERY} frames and found within 2 cm on every frame after")

    # ---- 5. time ----------------------------------------------------------
    for frame in frames:
        det.detect(*frame)
    lat = timed_detect(det, frames, FRAMES)
    log(f"time: detect per frame median {np.median(lat):.2f} ms, p95 "
        f"{np.percentile(lat, 95):.2f} ms over {FRAMES} frames; "
        f"resident catalog {sdb.nbytes()} bytes ({sum(sdb.rows_host)} rows, "
        f"{sdb.n_objects} objects); peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {card}")

    # ---- 5b. time at 1000 objects: coarse->fine and the full sweep --------
    del det, stream
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lat = timed_detect(cf, frames, FRAMES)
    log(f"time: coarse->fine at {N_LARGE} objects: detect per frame median "
        f"{np.median(lat):.2f} ms, p95 {np.percentile(lat, 95):.2f} ms over "
        f"{FRAMES} frames; resident full DB {ldb.nbytes()} bytes + coarse "
        f"DB {cdb.nbytes()} bytes; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {card}")
    cfg_sweep = dataclasses.replace(cfg, activation=dataclasses.replace(
        cfg.activation, prescreen=SWEEP_PRESCREEN))
    sweep = FusedDetector(large, cfg_sweep, seed=0, device=dev)
    del cf, ldb, cdb
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for frame in frames:
        sweep.detect(*frame)
    lat = timed_detect(sweep, frames, SWEEP_FRAMES)
    missed = sum(len(placements_missed(sweep.detect(*frame), fx, f))
                 for f, frame in enumerate(frames))
    log(f"time: full sweep (prescreen {SWEEP_PRESCREEN}) at {N_LARGE} "
        f"objects: detect per frame median {np.median(lat):.2f} ms, p95 "
        f"{np.percentile(lat, 95):.2f} ms over {SWEEP_FRAMES} frames; "
        f"resident DB {sweep.sdb.nbytes()} bytes; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; placements missed on "
        f"the {len(frames)} frames: {missed}; {card}")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(json.dumps({"kernels": [
        {"name": "B1 segmented per-object Hamming top-1", "route": "cuda",
         "source": SOURCE, "replaces": B1_REPLACES,
         "launches": sum(b1 for b1, _ in launches.values()),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms},
        {"name": "B2 gathered per-object Hamming top-1", "route": "cuda",
         "source": SOURCE, "replaces": B2_REPLACES,
         "launches": sum(b2 for _, b2 in launches.values()),
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
