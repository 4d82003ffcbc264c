#!/usr/bin/env python3
"""Drive the port's serving paths (segmented ORB/Hamming and SIFT/L2, and
the global-kNN ORB path), its trainer, its .ork cell graph, the 2D-only
path for depthless frames, its sharding layer, and its reference-era DB
reader, overlays and user tools once on one NVIDIA GPU.

    python3 chip_smoke.py

Imports only torch, numpy and tod_tpu_torch (no JAX). Phases, in order;
any failure raises, exits non-zero and prints no ``ok`` line:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
            versions; TF32 off for matrix products and convolutions.
2. build    every CUDA kernel of the paths, from csrc/, with nvcc; each
            kernel's registers, shared memory and spills (ptxas -v); the
            card's __popc, __dp4a, mma s8, mma b1, wgmma s8 and wgmma b1
            rates (tools/bench_int_rate.py), for the bounds (the Hamming
            bounds at the highest 1-bit rate).
3. kernels  kernel B1 (csrc/segmented_top1.cu: the 1-bit mma.sync
            m16n8k256 .and.popc tile, one key a pair) against its plain
            PyTorch twin, bit for bit, on the smoke catalog at Q = 2048, on
            edge cases and on the tile edges (objects of 0-300 rows beside
            reserved padding, ties across fragments, lanes and tiles,
            all-zero and all-one descriptors; Q = 1 to 2048); both timed
            with CUDA events.
3b.         kernel B2 (the gathered entry point of the same file: B1's
            tile run over the slab, one device function for both grids, a
            hole's block writing (8191, 262143)) against its twin and
            against B1's columns at ``sel``, bit for bit, on the edge cases
            (holes, an empty object, repeated and out-of-order ids), the
            tile edges and the 1000-object catalog (64 slots with
            holes); B1 against its twin there too. Timed: B2 at Q = 2048 x
            64 slots and its twin, the coarse B1 at Q = 1024 on the
            stride-16 DB (held against its twin there first), the
            full-sweep B1 at Q = 2048 over 1000 objects.
3f.         kernel N1 (csrc/threefry_gumbel.cu: threefry-2x32, uniform and
            Gumbel fused, a thread drawing 4 counts in registers, one
            launch a batch of keys) against its plain twins on the card:
            its bits mode equal to prng.random_bits bit for bit, its
            Gumbel values equal to prng.gumbel_torch bit for bit (or, where
            some differ, counted and held to 2^-22 + 2 ulp), at no keys,
            odd n * M, more keys than the grid's y extent and the tier-1
            and global round shapes. Timed at the global path's round shape
            (16 x 3 x 1024 x 512), each run queued behind a device sleep so
            that the keys' upload on the host is not timed, beside its twin
            and torch.rand (a yardstick: Philox, not the function); its
            bound from the instructions of its compiled code by pipe
            (cuobjdump -sass).
4. main     FusedDetector at the bench's operating point on the 100-object
            smoke catalog, frames of tests/data/torch_smoke_fixture.npz
            through prepare_frame -> detect; the compaction stage's
            keypoints, 3D points and descriptors against the JAX
            reference's, bit for bit; every ground-truth placement found
            within 2 cm at the quality gate, the accepted objects and poses
            agreeing with the JAX reference's stored detections (1 cm, 2
            degrees), one B1 launch per frame. The RANSAC noise is the
            reference's threefry draws, drawn by N1 (at least one launch a
            frame on every path below); one frame's draws are replayed
            alone, with no synchronising call, held against the twin's,
            counted (device operations, launches) and timed beside the
            twin's.
4b.         the frontier recipe (coarse->fine, tracked and exploration
            slots) on the same catalog over a stream of 6 frames, against
            the JAX reference's stream (tests/data/torch_stream_fixture.npz):
            B1 on both coarse DBs at each frame's coarse queries against
            its twin; every frame's slab and masks equal to the
            reference's, every slot; every placement within 2 cm at the
            gate and the reference's accepted objects and poses (1 cm, 2
            degrees); one B1 and one B2 launch a frame.
4c.         the frontier recipe at 1000 objects over a stream of 64 frames
            (one exploration cycle is 63): every present object discovered
            within 63 frames and found within 2 cm at the gate on every
            frame after; one B1 and one B2 launch a frame.
5. time     per-frame detect latency (median, p95) over FRAMES frames after
            warm-up at 100 objects, and the resident catalog bytes.
5b.         the same for the frontier recipe at 1000 objects, beside the
            full exact sweep at 1000 objects over fewer frames; resident
            bytes of both DBs and peak device memory.

Then the global-kNN path (FusedDetector(pipeline="global") at
FusedDetectorConfig()'s own operating point: k 5, radius 35), whose
reference outputs are in tests/data/torch_global_fixture.npz:

3e. kernels B5 (csrc/hamming_topk.cu, the tensor-core sweep) against its
            twin, bit for bit, at Q = 5000 queries (model rows, half with
            ~5 % of their bits flipped) over the 100-object catalog at
            (k, radius) 5/35, 8/50 and 5/None; on edge cases (n_valid
            full, cut, just past a split, ragged 128-row tiles, 9, 3 and
            0; ties across the sweep's fragments, lanes, tiles and split
            boundaries; Q = 1, 17, 65, 300 and 1000); at 1000 objects on
            the first 512 queries. Timed: each shape, the twin, and B5 at
            1000 objects on all 5000 queries. T1 (the same file's probe
            modes: distance sum, row minimum, block minimum, each on the
            routes popc, s8 mma and b1 mma) against their plain versions,
            exactly, and timed at T1's shape (Q = 5120 x 262,144 rows) and
            at B5's; the route B5 is compiled with, beside both
            tensor-core routes' sweeps.
4f. main    both frames: all 5000 keypoints, descriptors and 3D points, B5's
            (dist, rows) and the active set equal to the reference's; every
            detection the reference accepts at the gate found within 1 cm
            and 2 degrees, anything else accepted at the gate a
            ground-truth placement within 2 cm; one B5 launch a frame and
            no other.
5d. time    global detect latency (median, p95) over GLOBAL_FRAMES frames,
            resident bytes and peak device memory.

Then the SIFT/L2 path (FusedDetector(feature="SIFT"), radius 0.9), whose
reference outputs are in tests/data/torch_sift_fixture.npz (the frames are
the smoke fixture's):

3c. kernels B3 (csrc/segmented_l2_top1.cu: the int8 mma.sync m16n8k32
            tile that B4 shares) against its twin, the int32
            squared distances, the rows and the float distances bit for
            bit: on the 100-object SIFT smoke catalog at Q = 2048, on a
            partial tile (Q = 1000), on edge cases (an empty object, an
            object of one row, duplicate rows, reserved rows, a query equal
            to a row) and on the full int8 range (-128..127; objects of
            0-300 rows beside reserved padding, ties across the
            tensor-core tile's fragments and tiles; Q = 1 to 2048); both
            timed, and torch._int_mm on the same int8 product as a
            yardstick.
3d.         B4 (the gathered entry point) against its twin and against
            B3's columns at ``sel``, bit for bit: edge cases (holes, an
            empty object, repeated, out-of-order and out-of-catalog ids),
            the full int8 range at Q = 1 to 2048 and the 1000-object
            catalog (64 slots with holes); B3 against its twin there too. Timed: B4 at Q = 2048 x 64 slots, the
            coarse B3 at Q = 1024 on the stride-16 DB (held against its
            twin there first), the full-sweep B3 at 1000 objects.
4d. main    the full sweep at 100 objects on both frames: the compaction
            stage against the reference's (keypoints, 3D points and ok
            exact; quantised descriptors equal or off by one in at most
            QUANT_SHARE of the entries); every detection the reference
            accepts at the gate found within 1 cm and 2 degrees; anything
            else accepted at the gate must be a ground-truth placement
            within 2 cm; one B3 launch a frame.
4e.         the frontier recipe at 100 objects over the reference's stream
            of 6 frames (B3 on both coarse DBs at each frame's coarse
            queries against its twin; every frame's slab and masks equal
            to the reference's; the gated detections as in 4d), then at
            1000 objects over a stream of SIFT_STREAM frames: every object the reference's stream
            accepts is discovered and then found within 2 cm at the gate
            on every frame after; one B3 and one B4 launch a frame.
5c. time    detect latency (median, p95) at 100 objects (full sweep) and
            at 1000 objects (coarse->fine); resident bytes and peak
            device memory.

Then training (cells/trainer.py train_object), on the views of
tests/data/torch_train_fixture.npz (the bench's objects 0-2, 60 views of
480x640 each, and the reference's trained outputs):

6. train    object 0's per-view descriptors, world points and valid masks
            equal to the reference's; objects 0-2 trained as the bench
            trains them (ORB, 600 features, the Trainer's dedup at 8 bits /
            5 mm) and recompressed at 16 bits / 5 mm (bench._recompress):
            every model's rows equal to the reference's at both, the last
            equal to the smoke fixture's models; two B5 launches an object
            (the dedups' self k-NN) and no other kernel. B5 at the dedup's
            shapes (a model's rows against themselves) against its twin,
            bit for bit, and timed beside its twin and bound; the training
            time an object and a view (median of the three, after one
            warm object).
6b.         the port-trained models in the 100-object smoke catalog, served
            at phase 4's operating point on both frames: phase 4's checks
            (every placement within 2 cm; the reference's accepted objects
            and poses within 1 cm and 2 degrees), one B1 launch a frame.
6c.         object 0 trained with SIFT on every fifth view (12 of 60): the
            valid masks and world points equal to the reference's, the
            descriptors within 2e-5 and the quantised entries off by one
            in at most QUANT_SHARE of them.

Then the cell graph (ROADMAP A12b): the 100-object smoke catalog written
into a FilesystemDb in a temporary directory (the port's write_model) and
the two frames as .npz files, each conf/ file run through the port's
build_pipeline_from_ork and Scheduler with db and source1.path
overridden:

7a. cells   conf/detection.ork (FeatureDescriptor -> DescriptorMatcher on B5
            -> GuessGenerator with N1): each frame's MatchSet equal to the
            reference graph's (tests/data/torch_cells_fixture.npz) field by
            field, bit for bit; every pose the reference accepted, junk
            instances included, at its object within 1 cm and 2 degrees,
            the same accepted objects and instance counts; one B5 launch a
            frame; B5 against its twin on the graph's catalog; the graph's
            frame timed in turns with FusedDetector(pipeline="global") at
            the graph's own operating point, and the per-cell split.
7b.         conf/detection.serving.ork (SegmentedDetector -> B1 + N1): the
            reference graph's accepted objects (the cells fixture) at its
            poses within 1 cm and 2 degrees, every placement within 2 cm;
            the pose gap to phase 4's direct detector logged; one B1
            launch a frame; timed in turns with phase 4's direct
            FusedDetector.
7d.         conf/detection.sift.serving.ork (SegmentedDetector on SIFT ->
            B3 + N1) over the 100-object SIFT smoke catalog in a second
            FilesystemDb: every pose the reference's graph reports found
            within 1 cm and 2 degrees, any other accept a ground-truth
            placement; one B3 launch a frame.
7e.         conf/detection.ork with SIFT features (the global-kNN graph on
            the L2 matcher, ROADMAP queue C) over the three SIFT smoke
            models and both frames, against the reference graph's rows
            and accepts (tests/data/torch_jpeg_fixture.npz sift_graph_*):
            the query rows whose matched rows differ counted, the rest of
            the MatchSet exact, squared distances within
            SIFT_GRAPH_SQ_ATOL; the reference's accepts at its poses; N1
            only (the L2 matcher is no kernel).
7c.         conf/training.ork's TodTrainer on object 0's 60 views of
            tests/data/torch_train_fixture.npz, inserted into the DB as
            observations, at the fixture's feature settings and the
            Trainer's dedup (8 bits / 5 mm): the model read back through
            db/models.py equal to the reference's bit for bit; one B5
            launch; timed, with the per-cell split.

Then ROADMAP A16, held to tests/data/torch_a16_fixture.npz
(tools/make_torch_a16_fixture.py):

8a. subpix  both frames' ORB keypoints with subpixel=True equal to the
            reference's; object 0 trained with subpixel from its 60 views
            (two B5 launches) equal to the reference's sub-pixel model after
            the 8-bit dedup and the 16x5 recompression, bit for bit; the
            smoke catalog with object 0 swapped for it served with
            subpixel=True: the reference's gated detections within 1 cm
            and 2 degrees, one B1 launch a frame.
8b. hot     the frontier recipe at 100 slots with reserve_rows the largest
            model's: two objects added into spare slots, then one dropped
            (update_models): every DB tensor keeps its shape, dtype and
            data_ptr, the swap's ms logged, and 3 frames equal a freshly
            built detector's with the same key, bit for bit, slabs too.
8c. batch   detect_batch_raw at B = 1, 2, 4 on the ORB full sweep, the
            global kNN and the SIFT full sweep: one B1, B5 or B3 launch a
            batch and one frame's N1 launches; every row against the
            port's per-frame path with its batch key (accepts, inliers and
            cliques equal, poses at the gate within 1e-5), the B = 2 rows
            against the reference's per-frame detections with the same
            keys (1 cm, 2 degrees); ms a frame (median, p95) in turns with
            detect_raw, device ops a frame, the device-busy share and peak
            memory at each B.

Then ROADMAP A13 and A15, held to tests/data/torch_a13_fixture.npz
(tools/make_torch_a13_fixture.py: the reference's graph on the same frames
without depth):

9a. 2D      conf/detection.ork through the port's graph over the two frames
            with an empty depth (the GuessGenerator's 2D-only path: P3P
            graph-RANSAC over all 100 catalog objects): each MatchSet equal
            to the cells fixture's; the reference graph's accepted
            (object, instance) pairs and unique-inlier counts, poses within
            1 cm and 2 degrees (each pose's error against the ground-truth
            placement logged for both packages); every object's round 0
            (found, n_unique) against the reference's (equal for the
            accepted objects) and the accepted objects' round-0 triples
            (logged); one B5 launch a frame and one N1 launch a round; B5
            timed at the graph's shape (radius None) beside its bound; the
            depthless frame timed in turns with the depth frame (median,
            p95), the per-cell split and peak device memory.
9b. split   one depthless frame split into stages by StageTimer's CUDA
            events (features, matcher, clustering, each round's noise,
            graph, sampling, P3P, consensus, refinement, read-back), the
            device-busy share of a graph frame, the host waits inside one
            round (torch's sync debug mode); then ``python -m
            tod_tpu_torch.cli detection -c conf/detection.ork --frames DIR
            --niter 1 --profile DIR2`` once (the .ork's db root pointed at
            the catalog in a temporary copy): the trace must hold B5's and
            N1's kernels by their CUDA names.

Then ROADMAP A14, the sharding layer (tod_tpu_torch/parallel), on meshes
of this card named four times, (1 x 4) and (2 x 2) (and on the distinct
cards, where the host has several), each result held bit for bit against
the port's single-device path, its launches counted into the kernels
line (the sharded runs only):

10a. match  sharded_hamming_topk and ring_hamming_topk (B5 on each row
            shard) on the 100-object global catalog at Q = 5000, k 5,
            radius 35, equal to one B5's dist and rows; sharded_object_top1
            on the 1000-object ORB (B1) and SIFT (B3) catalogs equal to
            the single-device columns in shard-major order; each timed
            beside the single-device kernel.
10b. serve  ShardedServingDetector at (2 x 2), two streams (stream b sees
            frame (f + b) % 2), every field of every stream's detections
            equal to a FusedDetector(seed=b) fed the same compacted
            queries: the ORB frontier recipe at 1000 objects over 64
            frames (B1, B2, N1), the ORB full sweep at 100 objects, the
            SIFT frontier at 1000 objects (B3, B4); a step timed in turns
            with the two single-device frames.
10c. batch  detect_batch_sharded at (2 x 2) on both frames: each frame's
            detections the single-device global path's with the same key.
10d. train  train_views_sharded at (4 x 1) on object 0's 60 views equal to
            train_views_step's.
10e. pipe   PipelinedDetector on the card named three times equal to
            FusedDetector(pipeline="global").detect_raw frame by frame,
            timed in turns, and over a stream (detect_stream).
10f. dry    dryrun_multichip(4, [cuda:0] * 4).

Then the reference-era data, the visualize overlays and the user tools
(ROADMAP A12c, A12d, A12f), held to tests/data/torch_legacy_fixture.npz
(tools/make_torch_legacy_fixture.py: a reference-format dump of obj000, its
model as zlib FileStorage YAML and three training views as PNG and YAML,
written by the reference and cv2, and the reference's outputs):

11a. legacy the dump's blobs, the model as XML and its points as a raw
            header decoded on the host (db/legacy.py, utils/png.py), each
            equal to its npy counterpart bit for bit, the model's decode
            timed; ``cli migrate`` of the dump: every document's fields and
            npy attachments equal to tools/migrate_db.py's; conf/detection.ork
            over an in-process CouchDB server on 127.0.0.1 holding the
            100-object catalog with obj000 as FileStorage YAML, one frame:
            its MatchSet and accepts equal to the same graph's over the npy
            FilesystemDb bit for bit, one B5 launch and N1's; conf/training.ork
            over the three legacy observations and over their npy copies:
            the same model bit for bit, one B5 launch each.
11b. viz    the drawing functions over both frames (the reference's
            keypoints, poses and MatchSets) equal to cv2's overlays (their
            digests), each PNG write timed; conf/detection.ork (B5),
            conf/detection.serving.ork (B1), conf/detection.sift.serving.ork
            (B3, over the 100-object SIFT smoke catalog) and
            conf/training.ork with a visualize prefix: the detections and the model equal to the
            graphs' without it bit for bit, each PNG (poses, clusters,
            training views) read back by utils/png.py equal to the drawing
            functions over that frame's outputs; a serving frame with and
            without visualize timed in turns.
11c. view   ``cli view obj000`` on the migrated DB prints
            apps/feature_viewer's text; ``--png`` draws, or stops naming
            matplotlib where it is not installed.

Then the last cv2 users (ROADMAP A12g and the synthetic renderer), held to
tests/data/torch_jpeg_fixture.npz (tools/make_torch_jpeg_fixture.py):

12a. jpeg   every JPEG case (every sampling cv2 writes, sequential and
            progressive, restart intervals, gray, Adobe RGB, EXIF-rotated;
            the bench's scene 0 at 480 x 640 as q95 4:2:0, progressive and
            4:4:4) decoded by utils/jpeg.py equal to cv2's pixels under
            IMREAD_UNCHANGED and IMREAD_COLOR, a VGA frame's host decode
            timed; a two-frame "pairs" recording (JPEG colour, PNG depth)
            through ``cli ingest`` into tools/ingest_frames.py's frames;
            the first through conf/detection.ork (B5, N1): its MatchSet
            equal to the reference graph's, the reference's accepts at its
            poses; a legacy CouchDB with obj000's three views as JPEG
            attachments trained through conf/training.ork (B5) to the
            model the reference trains from cv2's pixels.
12b. render the bench's objects 0-2 rendered on the host by
            utils/synthetic.py with the bench's capture plan: all 180
            views' gray, depth and mask equal to the train fixture's;
            trained on the card through phase 6's path to the smoke
            fixture's models (B5); the bench's two scenes equal to the
            smoke fixture's frames and scene 0's BENCH_NOISE=hard
            degradation to the fixture's digests; the port-trained models
            served at phase 4's operating point on the rendered scenes
            giving phase 4's detections bit for bit (B1, N1). Render ms a
            view and train s an object timed.

The line before the card's is a JSON object of every kernel of the paths
(launches on the main paths, error against the twin, time, the twin's time,
the card's bound for the same work and the PR of the kernel's design; B5
also at the dedup's shape and at the .ork graph's radius-None shape; N1,
which replaces no Pallas kernel, also with its torch.rand yardstick); the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "torch_smoke_fixture.npz")
STREAM_FIXTURE = os.path.join(DATA, "torch_stream_fixture.npz")
SIFT_FIXTURE = os.path.join(DATA, "torch_sift_fixture.npz")
GLOBAL_FIXTURE = os.path.join(DATA, "torch_global_fixture.npz")
TRAIN_FIXTURE = os.path.join(DATA, "torch_train_fixture.npz")
CELLS_FIXTURE = os.path.join(DATA, "torch_cells_fixture.npz")
A13_FIXTURE = os.path.join(DATA, "torch_a13_fixture.npz")
A16_FIXTURE = os.path.join(DATA, "torch_a16_fixture.npz")
LEGACY_FIXTURE = os.path.join(DATA, "torch_legacy_fixture.npz")
JPEG_FIXTURE = os.path.join(DATA, "torch_jpeg_fixture.npz")
Q = 2048
KERNEL_RUNS = 24       # CUDA-event timings of a kernel and its twin
TWIN_RUNS = 3          # twin timings at 1000 objects (~0.1-2 s each)
# Timed depths, cut so that phase 10 fits the run's time (PERF.md §5):
FRAMES = 40            # timed detect calls: p95 has 2 frames above it
SIFT_FRAMES = 24       # timed SIFT detect calls
SIFT_STREAM = 12       # SIFT frames at 1000 objects
SWEEP_FRAMES = 12      # timed full-sweep frames at 1000 objects
N_OBJECTS = 100
N_LARGE = 1000
STREAM = 64            # frames at 1000 objects: > one exploration cycle
DISCOVERY = 63         # ceil(1000 / explore_width) frames
B2_SLOTS = 64
MAX_KEYPOINT_SWAPS = 0  # per frame, of 2048 (see compaction_mismatches)
# int8 entries of the 2048 x 128 compacted SIFT queries that may differ, by
# one, from the reference's: the descriptor sums 1,369 pixels in float32 in
# another order, and round(d * 256) flips where d * 256 is that close to a
# half (7 and 10 entries of 262,144 differ on a CPU)
QUANT_SHARE = 2e-4
SOURCE = "tod_tpu_torch/csrc/segmented_top1.cu"
SOURCE_L2 = "tod_tpu_torch/csrc/segmented_l2_top1.cu"
SOURCE_B5 = "tod_tpu_torch/csrc/hamming_topk.cu"
SOURCE_N1 = "tod_tpu_torch/csrc/threefry_gumbel.cu"
B1_REPLACES = "tod_tpu/ops/pallas/segmented.py:128"
B2_REPLACES = "tod_tpu/ops/pallas/segmented.py:349"
B3_REPLACES = "tod_tpu/ops/pallas/segmented_l2.py:119"
B4_REPLACES = "tod_tpu/ops/pallas/segmented_l2.py:300"
B5_REPLACES = "tod_tpu/ops/pallas/hamming.py:69"
T1_REPLACES = "tools/bench_dot_iso.py:29"
# jax.random.gumbel in _masked_gumbel_argmax and _masked_weighted_argmax:
# XLA's fused threefry, not a Pallas kernel
N1_REPLACES = "tod_tpu/geometry/ransac.py:127,136"
N1_SHAPE = (16, 3, 1024, 512)    # a round of the global path
N1_PER_THREAD = 4                # draws a thread of N1 (kPerThread)
# N1's bound counts the instructions of its compiled Gumbel mode
# (n1_sass_counts): those that only the integer ALU pipe runs, at its 64
# lanes a clock and SM, and all of them at the SM's issue rate, 4 warp
# instructions (128 lanes) a clock; the adds the compiler gives the FMA
# pipe (IMAD, VIADD) and the conversions count at the issue rate only
N1_ALU_OPS = frozenset({"SHF", "LOP3", "IADD3", "ISETP", "FSETP", "FMNMX",
                        "IMNMX", "SEL", "FSEL", "LEA", "PRMT"})
ALU_LANES = 64
DISPATCH_LANES = 128
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and the dense int8 tensor-core rate
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
# Operation rates measured on this card in phase 2 (tools/bench_int_rate.py):
# __popc and __dp4a (the CUDA-core designs' bounds, logged beside the
# bound), and the 1-bit products (mma.sync and wgmma), whose peak no data
# sheet gives
RATES: dict = {}
# kernel N1 against its twin on each replayed frame (noise_cost): the
# largest absolute gap of a Gumbel value
NOISE_ERR: list = []

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
# The bench's SIFT operating point (bench.py build_config under
# BENCH_FEATURE=SIFT): the same, with L2 features and radius 0.9
SIFT_CONFIG = {**BENCH_CONFIG, "feature": "SIFT", "radius": 0.9}
# The global-kNN path at FusedDetectorConfig()'s own operating point
# (conf/detection.ork:26-42: ORB, 5000 features, k 5, radius 35, 1024
# hypotheses, 5 instances, 16 active objects), gated as the serving .ork
# files ship it
GLOBAL_CONFIG = dict(pipeline="global", min_quality=156.0)
Q_GLOBAL = 5000        # every keypoint of a frame is a query
B5_SHAPES = ((5, 35.0), (8, 50.0), (5, None))   # (k, radius) held and timed
# The bench's training (bench.py build_db): ORB with 600 features (3
# levels, scale 1.2, FAST threshold 20: the trainer's defaults), the
# Trainer's dedup at 8 bits / 5 mm, then the bench's load-time
# recompression at 16 bits / 5 mm (bench._recompress, "16x5")
TRAIN_FEATURES = {"type": "ORB", "n_features": 600}
TRAIN_DEDUP = (8, 0.005)
RECOMPRESS = (16, 0.005)
DEDUP_K = 8            # compress_model's k-NN
# SIFT descriptors against the reference's: the pixel contraction's order
# (tests/test_torch_sift.py DESC_ATOL)
SIFT_ATOL = 2e-5
EDGE_ROWS = 20000      # B5's edge-case DB: five splits of 4096 rows
B5_EDGE_Q = (1, 17, 65, 300, 1000)   # ragged against 16-query m-tiles
T1_Q, T1_N = 5120, 262144   # tools/bench_dot_iso.py's shape
INT_MM_ROWS = 1 << 17  # rows a torch._int_mm chunk: a 1 GiB int32 product
GLOBAL_FRAMES = 24     # timed global detect calls
NOISE_RUNS = 10        # timed replays of one frame's noise draws
GRAPH_GATE = 156.0     # the serving .ork files' min_quality
GRAPH_FRAMES = 8       # timed frames of each .ork graph, in turns with the
                       # direct detector
# ragged against the tensor-core tiles' 16-query m-tiles and 256-query
# blocks, and a selection with holes, a repeated id, out-of-order ids and
# an id past the 9-object tile-edge catalogs
TILE_Q = (1, 15, 16, 17, 63, 65, 255, 257, 2048)
# detect_batch_raw's query counts: B x q_cap (B1, B3) and B x 5000 (B5) at
# B = 2 and 4, and one short of a tile
BATCH_Q = (2 * Q, 4 * Q, 4 * Q - 77)
BATCH_Q_GLOBAL = (2 * 5000, 4 * 5000 - 77)
BATCHES = (1, 2, 4)    # detect_batch_raw's batch sizes (phase 8c)
BATCH_ROUNDS = 3       # timed rounds of each batch size, in turns
# a batched row against the port's per-frame path: poses at the gate (the
# reference's own tolerance for its batched rows, tests/test_e2e.py)
BATCH_ATOL = 1e-5
HOT_ADDED = ("obj001", "obj002")   # phase 8b: added into spare slots
HOT_DROPPED = "obj002"             # then dropped
HOT_FRAMES = 3
A13_TURNS = 4          # timed frames of the depthless and the depth graph
# Phase 9a's accepts that the card's f32 rounding moves off the reference's
# (ROADMAP queue C): (frame, object, instance) -> (the card's unique
# inliers, the reference's). Frame 0's obj002 takes the other branch of the
# planar two-fold ambiguity in round 0: the f32 P3P candidates round
# otherwise on the card, a candidate counts 370 inliers where the CPU's
# counts 369 and the top 8 change; run in chunks of 16 objects instead of
# 32 (another cuBLAS batch), the same round gives the reference's count.
# Its keypoint invalidation then changes what round 4 sees.
A13_GAPS = {(0, "obj002", 0): (233, 234), (0, "obj002", 4): (8, 8)}
EDGE_SEL = (8, -1, 2, 1, 8, 0, -1, 7, 3, 12, 5, 6, 4)
# Phase 10 (ROADMAP A14): the meshes of one card's device named four
# times, (n_data, n_db)
A14_MESHES = ((1, 4), (2, 2))
A14_SWEEP_FRAMES = 8    # sharded full-sweep steps at 100 objects
A14_SIFT_FRAMES = 16    # sharded SIFT frontier steps at 1000 objects
A14_TURNS = 4           # timed steps, in turns with the single devices
A14_PIPE_FRAMES = 8     # pipelined global frames, in turns with one device
VIZ_TURNS = 4           # phase 11b: serving frames with and without
                        # visualize, in turns
# Phase 12: the bench's BENCH_NOISE=hard preset (bench.py NOISE_PRESETS)
HARD = dict(rgb_sigma=10.0, depth_sigma_mm=5.0, depth_dropout=0.10,
            n_occluders=2)
# Phase 7e: the SIFT global-kNN graph's MatchSet against the reference's.
# Squared L2 distances come from |q|^2 + |r|^2 - 2 q.r (about 2) in f32
# sums of another order: a few of its ulps (2^-22 each) apart
SIFT_GRAPH_SQ_ATOL = 2.0 ** -18
SIFT_GRAPH_ROW_SWAPS = 0    # query rows whose matched rows may differ


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


KERNEL_NAMES = re.compile(
    r"(tc_sweep_kernel|popc_probe_kernel|merge_kernel|"
    r"object_top1_l2_gathered_tc_kernel|object_top1_l2_tc_kernel|"
    r"object_top1_gathered_tc_kernel|object_top1_tc_kernel|threefry_kernel)"
    r"(I((?:L[ib]\d+E)+)E)?")


def log_ptxas(name: str, report: str) -> None:
    """One line per kernel of ``nvcc -Xptxas -v``'s report: its registers,
    shared memory and spills, the kernel named with its template
    arguments (B5/T1: route, mode, k)."""
    entry = None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            kernel = KERNEL_NAMES.search(found.group(1))
            entry = found.group(1)[:40] if kernel is None else (
                kernel.group(1) + "<" + ",".join(
                    re.findall(r"L[ib](\d+)E", kernel.group(3) or "")) + ">")
        elif entry and ("registers" in line or "spill" in line):
            log(f"ptxas: {name}: {entry}: {line.split(':', 1)[-1].strip()}")


def cuda_ms(fn, runs: int = KERNEL_RUNS, warmup: int = 2,
            queued: bool = False) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, each bracketed
    by CUDA events. ``queued`` puts each run behind a ~1 ms device sleep,
    so that the host's work in ``fn`` (N1's key upload) overlaps it and
    the events time the device's work alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)     # clocks: ~1 ms at 1.98 GHz
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def load_fixture(path: str = FIXTURE):
    fx = np.load(path)
    models = [(fx[f"desc{i}"], fx[f"points{i}"])
              for i in range(len(fx["model_ids"]))]
    return fx, [str(s) for s in fx["model_ids"]], models


def bound(pairs: int, ops_per_pair: int, n_bytes: int):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``pairs`` (query, row) pairs of ``ops_per_pair`` int8 tensor-core
    operations each over ``n_bytes`` of inputs and outputs moved once."""
    ops_ms = pairs * ops_per_pair / INT8_OPS_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def hamming_bound(pairs: int, n_bytes: int):
    """``(bound_ms, bound_by)`` of ``pairs`` Hamming pairs: the lesser of
    the int8 tensor-core product on unpacked bits (512 operations a pair at
    the published int8 rate) and the 1-bit product on the packed words
    (512 bit operations a pair at the highest 1-bit rate measured in phase
    2, ``b1_rate``), each against the bytes moved once."""
    from tools.bench_int_rate import b1_rate
    int8 = bound(pairs, 512, n_bytes)
    b1_ms = pairs * 512 / b1_rate(RATES) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    b1 = (max(b1_ms, bytes_ms), "operations" if b1_ms >= bytes_ms
          else "bytes")
    return min(int8, b1)


def matcher_bytes(n_q: int, row_bytes: int, q_bytes: int, n_rows: int,
                  n_cols: int, n_obj: int) -> int:
    """Bytes a matcher call must move: the queries, the visited real rows
    (with their norms, if any), the per-object tables, the selection and
    the two 4-byte outputs per cell."""
    return n_q * q_bytes + n_rows * row_bytes + 8 * n_obj + 4 * n_cols \
        + 8 * n_q * n_cols


def smoke_models(model_ids, models, n_objects: int = N_OBJECTS,
                 device=None):
    from tod_tpu_torch.convert import models_from_numpy
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    ids, arrays = smoke_catalog(model_ids, models, n_objects=n_objects,
                                device=device)
    return models_from_numpy(ids, [d for d, _ in arrays],
                             [p for _, p in arrays])


def config(fx, base=None, key: str = "config_json", **change):
    """The bench config ``base`` (default the ORB one) with ``change``, held
    to the config ``fx`` was made with."""
    from tod_tpu_torch.convert import config_from_dict

    cfg = config_from_dict({**(base or BENCH_CONFIG), **change})
    stored = json.loads(str(fx[key]))
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


def tile_case_hamming(n_q: int, device):
    """``smoke_catalog.edge_case_arrays_hamming_tiles`` (objects of 0-300
    rows, ties across B1's fragments, lanes and tiles, all-zero and
    all-one rows and queries) packed with 200 reserved rows a segment:
    ``(db, queries)``."""
    from tod_tpu_torch.ops.segmented import pack_segmented
    from tod_tpu_torch.types import TodModel
    from tod_tpu_torch.utils.smoke_catalog import \
        edge_case_arrays_hamming_tiles

    descs, q = edge_case_arrays_hamming_tiles(n_q, n_q)
    models = [TodModel(f"e{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return pack_segmented(models, db_chunk=256, reserve_rows=200,
                          device=device), torch.from_numpy(q).to(device)


def batched_queries(q: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` copies of the queries ``q`` one after another, as a batch of
    ``n`` frames reaches the matcher; every copy after the first with a
    tenth of its bytes replaced by seeded random ones."""
    rng = np.random.default_rng(4)
    out = q.repeat(n, 1)
    tail = out[q.shape[0]:]
    noise = torch.from_numpy(rng.integers(0, 128, tuple(tail.shape))
                             .astype(np.int8).view(np.uint8)).to(q.device)
    pick = torch.from_numpy(rng.random(tuple(tail.shape)) < 0.1).to(q.device)
    tail[pick] = noise.view(q.dtype)[pick]
    return out


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


def edge_case_db_l2(device):
    """The L2 edge cases of ``smoke_catalog.edge_case_arrays_l2``, packed
    with reserved rows, and their queries."""
    from tod_tpu_torch.ops.segmented_l2 import pack_segmented_l2
    from tod_tpu_torch.types import TodModel
    from tod_tpu_torch.utils.smoke_catalog import edge_case_arrays_l2

    descs, q = edge_case_arrays_l2(8)
    models = [TodModel(f"e{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return pack_segmented_l2(models, reserve_rows=200, device=device), \
        torch.from_numpy(q).to(device)


def full_range_case_l2(n_q: int, device):
    """``smoke_catalog.edge_case_arrays_l2_int8`` (int8 values -128..127)
    packed with 200 reserved rows a segment: ``(db, queries)``."""
    from tod_tpu_torch.ops.segmented_l2 import pack_segmented_l2
    from tod_tpu_torch.types import TodModel
    from tod_tpu_torch.utils.smoke_catalog import edge_case_arrays_l2_int8

    descs, q = edge_case_arrays_l2_int8(n_q, n_q)
    models = [TodModel(f"e{i}", d, np.zeros((len(d), 3), np.float32))
              for i, d in enumerate(descs)]
    return pack_segmented_l2(models, db_chunk=256, reserve_rows=200,
                             device=device), torch.from_numpy(q).to(device)


def int_mm_ms(q, sdb) -> float:
    """Milliseconds of ``torch._int_mm`` over the (Q, 128) x (128, rows)
    int8 product of ``q`` against ``sdb``'s real rows, in row chunks of
    INT_MM_ROWS (the int32 product of all rows would not fit): a yardstick
    for B3's product alone, not a library call of the same function."""
    real = torch.cat([sdb.rows[s:s + n] for s, n in
                      zip(sdb.starts_host, sdb.rows_host) if n])
    real = torch.cat([real, real.new_zeros(((-real.shape[0]) % 8, 128))])
    chunks = [real[s:s + INT_MM_ROWS] for s in range(0, real.shape[0],
                                                      INT_MM_ROWS)]
    q = q.contiguous()

    def product() -> None:
        for c in chunks:       # each chunk's product is dropped at once
            torch._int_mm(q, c.t())

    return cuda_ms(product, runs=8)


def check_b3(q, sdb, what: str) -> float:
    """B3 against its twin on the card, the int32 squared distances, the
    rows and the float distances: equal bits or raise. Returns the largest
    absolute gap of the float distances (0.0)."""
    from tod_tpu_torch.ops import segmented_l2 as l2

    d_k, r_k = l2.object_top1_l2_sq(q, sdb)
    torch.cuda.synchronize()
    d_t, r_t = l2.object_top1_l2_sq_torch(q, sdb)
    f_k, f_t = l2.to_l2(d_k), l2.object_top1_l2_torch(q, sdb)[0]
    err = float((f_k - f_t).abs().max())
    equal = bool(torch.equal(d_k, d_t) and torch.equal(r_k, r_t)
                 and torch.equal(f_k, f_t))
    log(f"kernels: B3 vs twin on {what}: Q={q.shape[0]} O={sdb.n_objects} "
        f"rows={sum(sdb.rows_host)} max_abs_err={err} "
        f"int32_distances_rows_and_floats_equal={equal}")
    if err != 0.0 or not equal:
        raise AssertionError(f"B3 disagrees with its twin on {what}")
    return err


def check_b4(q, sdb, sel, what: str) -> float:
    """B4 against its twin and against B3's columns at ``sel``, and its
    holes, on the card: equal bits or raise. Returns the largest absolute
    gap of the float distances to the twin (0.0)."""
    from tod_tpu_torch.ops import segmented_l2 as l2

    d_k, r_k = l2.object_top1_l2_gathered_sq(q, sdb, sel)
    torch.cuda.synchronize()
    d_t, r_t = l2.object_top1_l2_gathered_sq_torch(q, sdb, sel)
    f_k = l2.to_l2(d_k)
    f_t = l2.object_top1_l2_gathered_torch(q, sdb, sel)[0]
    err = float((f_k - f_t).abs().max())
    d_b3, r_b3 = l2.object_top1_l2_sq(q, sdb)
    real = (sel >= 0) & (sel < sdb.n_objects)
    cols = sel[real].long()
    as_b3 = bool(torch.equal(d_k[:, real], d_b3[:, cols])
                 and torch.equal(r_k[:, real], r_b3[:, cols]))
    holes = bool((d_k[:, ~real] == l2.DIST_INVALID).all()
                 and (r_k[:, ~real] == l2.HOLE_ROW_L2).all()
                 and (f_k[:, ~real] == l2.HOLE_DIST_L2).all())
    log(f"kernels: B4 vs twin on {what}: Q={q.shape[0]} C={sel.shape[0]} "
        f"({int((~real).sum())} holes) max_abs_err={err} "
        f"equal_to_B3_columns={as_b3} holes_ok={holes}")
    if err != 0.0 or not (torch.equal(d_k, d_t) and torch.equal(r_k, r_t)
                          and torch.equal(f_k, f_t) and as_b3 and holes):
        raise AssertionError(f"B4 disagrees with its twin or B3 on {what}")
    return err


def check_sift_compaction(port, sx, f: int) -> None:
    """The port's SIFT compaction of frame ``f`` against the reference's:
    keypoints, 3D points and ok equal; quantised descriptors equal or off
    by one in at most QUANT_SHARE of the entries."""
    xy, qp, dsc, ok = (t.cpu().numpy() for t in port)
    exact = (np.array_equal(xy, sx["ref_xy"][f])
             and np.array_equal(qp, sx["ref_qp"][f], equal_nan=True)
             and np.array_equal(ok, sx["ref_ok"][f]))
    diff = dsc.astype(np.int32) - sx["ref_dsc"][f].astype(np.int32)
    log(f"sift: frame {f}: keypoints, 3D points and ok equal to the "
        f"reference's: {exact}; {int((diff != 0).sum())} of {diff.size} "
        f"quantised entries differ (max {int(np.abs(diff).max())}) in "
        f"{int((diff != 0).any(1).sum())} of {int(ok.sum())} descriptors")
    if not exact or np.abs(diff).max() > 1 \
            or (diff != 0).mean() > QUANT_SHARE:
        raise AssertionError(f"sift: frame {f}: compaction differs from "
                             "the reference's")


def check_gated_frame(f: int, found, fx, sx, prefix: str, image: int,
                     what: str) -> None:
    """Every detection of frame ``f`` that the reference accepted at the
    gate (``sx[prefix + "_*"]``, quality >= the gate) found within 1 cm and
    2 degrees; any other object accepted at the gate must be a ground-truth
    placement within 2 cm (one the reference missed), or raise. The
    reference's junk accepts, all below the gate, are listed."""
    gate = json.loads(str(sx["config_json"]))["min_quality"]
    mine = [i for i in range(len(sx[f"{prefix}_ids"]))
            if sx[f"{prefix}_frame"][i] == f]
    ref_gated = [i for i in mine if sx[f"{prefix}_quality"][i] >= gate]
    for i in ref_gated:
        oid = str(sx[f"{prefix}_ids"][i])
        errs = [pose_error(r.R, r.T, sx[f"{prefix}_R"][i],
                           sx[f"{prefix}_T"][i])
                for r in found if r.object_id == oid]
        if not errs or min(errs)[0] >= 0.01 or min(errs)[1] >= 2.0:
            raise AssertionError(f"{what}: frame {f}: {oid} (reference "
                                 f"quality {sx[f'{prefix}_quality'][i]:.0f}) "
                                 f"not found at the reference's pose: {errs}")
    ref_ids = {str(sx[f"{prefix}_ids"][i]) for i in ref_gated}
    missed = {m[0] for m in placements_missed(found, fx, image)}
    extra = [r for r in found if r.object_id not in ref_ids]
    bad = [(r.object_id, r.quality) for r in extra
           if r.object_id not in {str(o) for o in fx["gt_ids"][image]}
           or r.object_id in missed]
    if bad:
        raise AssertionError(f"{what}: frame {f}: accepted at the gate, not "
                             f"by the reference and at no placement: {bad}")
    junk = sorted((float(sx[f"{prefix}_quality"][i]) for i in mine
                   if i not in ref_gated), reverse=True)
    log(f"{what}: frame {f}: " + ", ".join(
        f"{r.object_id} q={r.quality:.0f} inliers={r.confidence:.0f}"
        for r in found)
        + "; reference " + ", ".join(
            f"{sx[f'{prefix}_ids'][i]} q={sx[f'{prefix}_quality'][i]:.0f}"
            for i in ref_gated)
        + f"; reference junk accepts below the gate: {len(junk)}, best "
        f"q={junk[0] if junk else 0:.0f}"
        + (f"; true placements the reference missed: "
           f"{[r.object_id for r in extra]}" if extra else ""))


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


def wrappers():
    """The kernel wrappers, B1..B5, T1 and N1."""
    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.ops import segmented as seg
    from tod_tpu_torch.ops import segmented_l2 as l2
    from tod_tpu_torch.utils import prng

    return (seg.object_top1, seg.object_top1_gathered, l2.object_top1_l2,
            l2.object_top1_l2_gathered, ham.hamming_topk_fused,
            ham.hamming_probe, prng.gumbel)


def reset_counts() -> None:
    for fn in wrappers():
        fn.launches = 0


def read_counts():
    """Launches of (B1, B2, B3, B4, B5, T1, N1) since :func:`reset_counts`."""
    return tuple(fn.launches for fn in wrappers())


def check_launches(what: str, n_frames: int, counts, full: int,
                   gathered=None) -> None:
    """One launch a frame of the kernels B<full + 1> and, on a coarse->fine
    path, B<gathered + 1>, and none of the others (T1 on no path); N1 the
    same number of times on every frame, at least once."""
    names = [f"B{i + 1}" for i in range(5)] + ["T1", "N1"]
    log(f"{what}: {n_frames} frames, launches "
        + ", ".join(f"{name} {n}" for name, n in zip(names, counts)))
    *matchers, noise = counts
    want = [n_frames if i in (full, gathered) else 0
            for i in range(len(matchers))]
    if matchers != want or noise < n_frames or noise % n_frames:
        raise AssertionError(f"{what}: launches {list(counts)}, expected "
                             f"{want} and N1 a positive multiple of "
                             f"{n_frames} for {n_frames} frames")


def check_stream_slab(f: int, slab, sfx, what: str) -> None:
    """Frame ``f``'s slab (sel, force, force_act) equal to the reference's
    stream ``sfx``, every slot and both masks, or raise. The port draws the
    reference's threefry noise, so the tracked slots, which follow each
    side's accepts, junk ones included, agree too."""
    sel, force, force_act = (t.cpu().numpy() for t in slab)
    r_sel, r_force, r_act = sfx["sel"][f], sfx["force"][f], sfx["force_act"][f]
    differ = np.nonzero((sel != r_sel) | (force != r_force)
                        | (force_act != r_act))[0]
    log(f"{what}: frame {f}: {len(differ)} of {len(sel)} slab slots differ "
        f"from the reference's (sel or masks); forced {int(force.sum())}, "
        f"tracked {int(force_act.sum())}")
    if len(differ):
        raise AssertionError(
            f"{what}: frame {f}: slab slots {differ.tolist()} hold "
            f"{sel[differ].tolist()} (forced {force[differ].tolist()}, "
            f"tracked {force_act[differ].tolist()}), the reference's "
            f"{r_sel[differ].tolist()} ({r_force[differ].tolist()}, "
            f"{r_act[differ].tolist()})")


def scale_stream(cf, frames, fx, n_frames: int, what: str) -> dict:
    """Run ``n_frames`` of the stream through the coarse->fine detector
    ``cf``; raise if a placement once found within 2 cm at the gate is
    missed on a later frame. Returns each present object's discovery
    frame."""
    first = {}
    for f in range(n_frames):
        image = f % len(frames)
        missed = placements_missed(cf.detect(*frames[image]), fx, image)
        for oid in fx["gt_ids"][image]:
            oid = str(oid)
            if oid not in first and all(m[0] != oid for m in missed):
                first[oid] = f
        late = [m for m in missed if m[0] in first]
        if late:
            raise AssertionError(f"{what}: frame {f}: discovered objects "
                                 f"lost: {late}")
    return first


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


def noise_cost(det, frame, what: str, card: str) -> dict:
    """One frame's threefry noise on the card: the (stage, shape) draws
    ``det.detect(*frame)`` makes, replayed from that frame's key through
    kernel N1, once with no synchronising call allowed, then held against
    the twin's draws on the card (equal, or within 2^-22 + 2 ulp with the
    differing values counted), counted (device operations, kernels and
    copies, by torch.profiler; runtime launch calls) and timed (host clock
    around the synchronised draws; CUDA events), each the median of
    NOISE_RUNS; the twin's draws counted and timed the same way. Logs one
    line; returns its numbers."""
    from tod_tpu_torch.geometry.ransac import ThreefryNoise
    from tod_tpu_torch.utils import prng

    noise = ThreefryNoise(prng.split(det._key)[1],
                          det.config.guess.ransac.max_instances,
                          det.segmented, det.device)
    calls = []

    def record(stage, shape):
        calls.append((stage, shape))
        return noise(stage, shape)

    det.noise = record
    try:
        det.detect(*frame)
    finally:
        det.noise = None
    keys = [noise.keys(stage, shape[0]) for stage, shape in calls]

    def draw() -> None:
        for stage, shape in calls:
            noise(stage, shape)

    def draw_twin() -> None:
        for k, (_, shape) in zip(keys, calls):
            prng.gumbel_torch(k, shape[2:], det.device)

    # the draws must not wait for the device: PyTorch raises on any
    # synchronising call in this mode
    before = prng.gumbel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        draw()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = prng.gumbel.launches - before
    if launches != len(calls):
        raise AssertionError(f"{what}: {len(calls)} draws launched N1 "
                             f"{launches} times")
    differ, total, err = 0, 0, 0.0
    for k, (stage, shape) in zip(keys, calls):
        got = noise(stage, shape)
        ref = prng.gumbel_torch(k, shape[2:], det.device)
        differ += int((got != ref).sum())
        total += got.numel()
        err = max(err, gumbel_gap(got, ref, f"{what}: {stage}"))
    NOISE_ERR.append(err)
    kernel, twin = draw_cost(draw), draw_cost(draw_twin)
    log(f"noise: {what}: a frame draws {len(calls)} Gumbel batches "
        f"({', '.join(f'{s} {tuple(sh)}' for s, sh in calls)}; {total} "
        f"values) through N1 ({launches} launches) with no synchronising "
        f"call; {differ} values differ from the twin's on the card "
        f"(max_abs_err {err}); N1 {kernel['device_ops']} device operations "
        f"({kernel['copies']} copies), {kernel['launch_calls']} kernel "
        f"launch calls, {kernel['host_ms']:.3f} ms on the host clock, "
        f"{kernel['device_ms']:.3f} ms between CUDA events; twin "
        f"{twin['device_ops']} device operations, {twin['host_ms']:.3f} / "
        f"{twin['device_ms']:.3f} ms (medians of {NOISE_RUNS}); {card}")
    return dict(draws=len(calls), launches=launches, values=total,
                differ=differ, max_abs_err=err, kernel=kernel, twin=twin)


def draw_cost(draw) -> dict:
    """Device operations (kernels and copies, torch.profiler), runtime
    launch calls, and the median host-clock and CUDA-event milliseconds of
    ``draw()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        draw()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    host = []
    for _ in range(NOISE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draw()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return dict(device_ops=len(device),
                copies=sum(e.name.startswith("Memcpy") for e in device),
                launch_calls=sum(e.name == "cudaLaunchKernel"
                                 for e in prof.events()),
                host_ms=float(np.median(host)),
                device_ms=cuda_ms(draw, runs=NOISE_RUNS))


def gumbel_gap(got, ref, what: str) -> float:
    """The largest |got - ref| of two Gumbel arrays on the card; raise if
    any exceeds 2^-22 + 2 ulp of ``ref`` (tests/test_torch_prng.py)."""
    gap = (got.double() - ref.double()).abs()
    ulp = torch.from_numpy(np.spacing(np.abs(ref.cpu().numpy())).astype(
        np.float64)).to(gap.device)
    if bool((gap > 2.0 ** -22 + 2.0 * ulp).any()):
        raise AssertionError(f"{what}: N1's Gumbel values beyond 2^-22 + "
                             f"2 ulp of the twin's: {float(gap.max())}")
    return float(gap.max()) if gap.numel() else 0.0


def n1_sass_counts() -> tuple:
    """``(instructions, ALU-pipe instructions)`` that a thread of kernel
    N1's Gumbel mode issues where a row is whole 16-byte vectors (the timed
    shape, one key a block), from ``cuobjdump -sass`` of the built library.
    Left out: the padding NOPs, the closing self-branch, and the
    element-wise store path, which the branch to the vector store skips."""
    from tod_tpu_torch import kernels

    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           kernels.load("threefry_gumbel")._name],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if "threefry_kernelILb0E" in f.split("\n", 1)[0])
    code = [(int(a, 16), t.strip()) for a, t in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    vector = next(a for a, t in code if "STG.E.128" in t)
    skip = [a for a, t in code if re.search(rf"\bBRA {vector:#x}$", t)]
    if len(skip) != 1:
        raise AssertionError(f"N1's SASS: {len(skip)} branches to the "
                             "vector store, expected 1")
    ops = [re.match(r"(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", t).group(1)
           for a, t in code
           if not skip[0] < a < vector and t != f"BRA {a:#x}"]
    ops = [op for op in ops if op != "NOP"]
    counts = Counter(ops)
    log(f"kernels: N1's compiled Gumbel mode issues {len(ops)} instructions "
        f"a thread of {N1_PER_THREAD} draws: {dict(counts.most_common())}")
    return len(ops), sum(counts[op] for op in N1_ALU_OPS)


def check_n1(dev, card: str) -> dict:
    """Phase 3f: kernel N1 against its twins on the card, then timed at
    the global path's round shape beside its twin and torch.rand. Returns
    its ``kernels`` entry's measured fields."""
    from tod_tpu_torch.utils import prng

    err = 0.0
    for i, shape in enumerate([(0, 3, 128, 192), (3, 3, 7, 9),
                               (5, 3, 13, 1), (20, 3, 128, 192),
                               (20, 3, 512, 384), (21846, 3, 1, 5),
                               N1_SHAPE]):
        n_obj, _, n, m = shape
        keys = prng.split(prng.split(prng.prng_key(2**31 - 1 - i), n_obj), 3)
        bits = prng.threefry_bits(keys, (n, m), dev)
        torch.cuda.synchronize()
        bits_ok = bool(torch.equal(bits.to(torch.int64) & prng.MASK,
                                   prng.random_bits(keys, (n, m), dev)))
        g = prng.gumbel(keys, (n, m), dev)
        ref = prng.gumbel_torch(keys, (n, m), dev)
        differ = int((g != ref).sum())
        gap = gumbel_gap(g, ref, f"N1 at {shape}")
        err = max(err, gap)
        log(f"kernels: N1 vs twins at {shape}: bits equal to random_bits "
            f"{bits_ok}; {differ} of {g.numel()} Gumbel values differ from "
            f"gumbel_torch on the card, max_abs_err {gap}")
        if not bits_ok or g.shape != shape or g.dtype != torch.float32:
            raise AssertionError(f"N1 disagrees with its twins at {shape}")
    keys = prng.split(prng.split(prng.prng_key(5), N1_SHAPE[0]), 3)
    draw_shape = N1_SHAPE[2:]
    ms = cuda_ms(lambda: prng.gumbel(keys, draw_shape, dev), queued=True)
    plain_ms = cuda_ms(lambda: prng.gumbel_torch(keys, draw_shape, dev),
                       runs=TWIN_RUNS, warmup=1, queued=True)
    yard_ms = cuda_ms(lambda: torch.rand(N1_SHAPE, device=dev), queued=True)
    draws = int(np.prod(N1_SHAPE))
    issued, alu = n1_sass_counts()
    clocks = RATES["dp4a"]["n_sm"] * RATES["dp4a"]["max_mhz"] * 1e6
    threads = draws / N1_PER_THREAD
    issue_ms = threads * issued / (DISPATCH_LANES * clocks) * 1e3
    alu_ms = threads * alu / (ALU_LANES * clocks) * 1e3
    ops_ms = max(issue_ms, alu_ms)
    bytes_ms = (4 * draws + 8 * keys.size // 2) / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"kernels: N1 {ms:.3f} ms median of {KERNEL_RUNS} "
        f"({draws / ms / 1e6:.1f} G draws/s); twin {plain_ms:.3f} ms; "
        f"torch.rand (yardstick) {yard_ms:.3f} ms; bound {bound_ms:.4f} ms "
        f"({issued} instructions a thread at {DISPATCH_LANES} lanes a clock "
        f"and SM {issue_ms:.4f} ms, {alu} of them on the ALU pipe at "
        f"{ALU_LANES} {alu_ms:.4f} ms, {RATES['dp4a']['n_sm']} SMs at "
        f"{RATES['dp4a']['max_mhz']:.0f} MHz; 4 bytes a draw "
        f"{bytes_ms:.4f} ms) at {N1_SHAPE}; {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                yardstick_ms=yard_ms)


def sift_phases(dev, card: str, fx, frames, launches: dict):
    """Phases 3c, 3d, 4d, 4e and 5c: the SIFT/L2 path. ``frames`` are the
    prepared fixture frames; the launch counts of each driven path go into
    ``launches``. Returns the ``kernels`` entries' measured fields of B3 and
    B4."""
    from tod_tpu_torch.models.fused import (FusedDetector,
                                            stage_features_compact)
    from tod_tpu_torch.ops import segmented_l2 as l2

    sx, model_ids, models = load_fixture(SIFT_FIXTURE)
    cfg = config(sx, SIFT_CONFIG)
    cfg_cf = config(sx, SIFT_CONFIG, "stream_config_json", **FRONTIER)

    # ---- 3c. B3 against its twin ------------------------------------------
    t0 = time.perf_counter()
    catalog = smoke_models(model_ids, models)
    det = FusedDetector(catalog, cfg, seed=0, device=dev)
    sdb = det.sdb
    log(f"sift: {N_OBJECTS}-object catalog ({sum(sdb.rows_host)} rows, "
        f"{sdb.nbytes()} bytes resident) built in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    # queries: rows of the first model, every other one with integer noise
    pick = rng.choice(len(models[0][0]), Q, replace=False)
    q_np = models[0][0][pick].astype(np.int16)
    q_np[1::2] += rng.integers(-24, 25, (Q // 2, 128), dtype=np.int16)
    q_main = torch.from_numpy(np.clip(q_np, 0, 127).astype(np.int8)).to(dev)
    err = check_b3(q_main, sdb, "the SIFT smoke catalog")
    edge_db, edge_q = edge_case_db_l2(dev)
    err = max(err, check_b3(edge_q, edge_db, "edge cases"))
    err = max(err, check_b3(q_main[:1000], sdb, "Q=1000 (partial tile)"))
    for n_q in (1, 17, 65, 257, 2048):
        err = max(err, check_b3(*full_range_case_l2(n_q, dev)[::-1],
                                "the full int8 range (objects of 0-300 rows "
                                "beside reserved padding, ties across "
                                "fragments and tiles)"))
    q_batch = batched_queries(q_main, 4)
    for n_q in BATCH_Q:
        err = max(err, check_b3(q_batch[:n_q], sdb, f"Q={n_q} "
                                "(detect_batch_raw's B x q_cap)"))
    ms = cuda_ms(lambda: l2.object_top1_l2_sq(q_main, sdb))
    plain_ms = cuda_ms(lambda: l2.object_top1_l2_sq_torch(q_main, sdb),
                       runs=TWIN_RUNS, warmup=1)
    pairs = Q * sum(sdb.rows_host)
    b3_bound = bound(pairs, 256, matcher_bytes(
        Q, 132, 128, pairs // Q, sdb.n_objects, sdb.n_objects))
    mm_ms = int_mm_ms(q_main, sdb)
    log(f"kernels: B3 {ms:.3f} ms median of {KERNEL_RUNS} "
        f"({pairs / ms / 1e6:.1f} G pairs/s); twin {plain_ms:.3f} ms median "
        f"of {TWIN_RUNS}; bound {b3_bound[0]:.3f} ms by {b3_bound[1]}; Q={Q} "
        f"x {sum(sdb.rows_host)} rows, {sdb.n_objects} objects; yardstick "
        f"torch._int_mm on the same int8 product alone (row chunks of "
        f"{INT_MM_ROWS}; the port never calls it): {mm_ms:.3f} ms; __dp4a "
        f"bound of the CUDA-core design "
        f"{pairs * 32 / RATES['dp4a']['rate'] * 1e3:.3f} ms; {card}")

    # ---- 3d. B4, and both kernels at 1000 objects -------------------------
    t0 = time.perf_counter()
    large = smoke_models(model_ids, models, N_LARGE, device=dev)
    cf = FusedDetector(large, cfg_cf, seed=0, device=dev)
    del large
    ldb, cdb = cf.sdb, cf.cdb
    log(f"sift: {N_LARGE}-object catalog ({sum(ldb.rows_host)} rows, "
        f"fillers past 100 drawn on the card) and its stride-16 coarse DB "
        f"({sum(cdb.rows_host)} rows, chunk {cdb.db_chunk}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    i32 = dict(dtype=torch.int32, device=dev)
    b4_err = check_b4(edge_q, edge_db,
                      torch.tensor([4, -1, 1, 2, 4, 0, -1, 6, 3, 9, 5, 7],
                                   **i32), "edge cases (object 1 empty)")
    sel_holes = torch.from_numpy(rng.choice(N_LARGE, B2_SLOTS, replace=False)
                                 .astype(np.int32)).to(dev)
    sel_holes[:3] = torch.tensor([2, 0, 1], **i32)
    sel_holes[[5, 17, 40]] = -1
    sel_holes[30] = sel_holes[31]                    # a repeated id
    b4_err = max(b4_err, check_b4(q_main, ldb, sel_holes,
                                  f"the {N_LARGE}-object SIFT catalog"))
    for n_q in TILE_Q:
        b4_err = max(b4_err, check_b4(
            *full_range_case_l2(n_q, dev)[::-1], torch.tensor(EDGE_SEL, **i32),
            "the full int8 range (objects of 0-300 rows beside reserved "
            "padding, ties across fragments and tiles)"))
    err = max(err, check_b3(q_main, ldb,
                            f"the {N_LARGE}-object SIFT catalog"))
    sel_t = torch.from_numpy(rng.choice(N_LARGE, B2_SLOTS, replace=False)
                             .astype(np.int32)).to(dev)
    b4_ms = cuda_ms(lambda: l2.object_top1_l2_gathered_sq(q_main, ldb, sel_t))
    b4_plain_ms = cuda_ms(
        lambda: l2.object_top1_l2_gathered_sq_torch(q_main, ldb, sel_t),
        runs=TWIN_RUNS, warmup=1)
    b4_pairs = Q * sum(ldb.rows_host[o] for o in sel_t.tolist())
    b4_bound = bound(b4_pairs, 256, matcher_bytes(
        Q, 132, 128, b4_pairs // Q, B2_SLOTS, N_LARGE))
    q_c = q_main[::2].contiguous()
    err = max(err, check_b3(q_c, cdb, f"the {N_LARGE}-object coarse DB"))
    coarse_ms = cuda_ms(lambda: l2.object_top1_l2_sq(q_c, cdb))
    coarse_pairs = q_c.shape[0] * sum(cdb.rows_host)
    sweep_ms = cuda_ms(lambda: l2.object_top1_l2_sq(q_main, ldb), runs=8)
    sweep_pairs = Q * sum(ldb.rows_host)
    log(f"kernels: B4 {b4_ms:.3f} ms median of {KERNEL_RUNS} "
        f"({b4_pairs / b4_ms / 1e6:.1f} G pairs/s); twin {b4_plain_ms:.3f} "
        f"ms median of {TWIN_RUNS}; bound {b4_bound[0]:.3f} ms by "
        f"{b4_bound[1]}; Q={Q} x {B2_SLOTS} slots ({b4_pairs // Q} rows); "
        f"{card}")
    log(f"kernels: coarse B3 {coarse_ms:.3f} ms "
        f"({coarse_pairs / coarse_ms / 1e6:.1f} G pairs/s) at "
        f"Q={q_c.shape[0]} x {sum(cdb.rows_host)} rows; full-sweep B3 "
        f"{sweep_ms:.3f} ms ({sweep_pairs / sweep_ms / 1e6:.1f} G pairs/s) "
        f"at Q={Q} x {sum(ldb.rows_host)} rows, {N_LARGE} objects; {card}")

    # ---- 4d. the SIFT main path: full sweep, 100 objects ------------------
    compacted = [stage_features_compact(*frame, cfg) for frame in frames]
    for f, port in enumerate(compacted):
        check_sift_compaction(port, sx, f)
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches["4d"] = read_counts()
    check_launches("sift main", len(frames), launches["4d"], full=2)
    for f, res in enumerate(found):
        check_gated_frame(f, res, fx, sx, "ref", f, "sift main")
    log("sift main: every detection the reference accepts at the gate found "
        "within 1 cm and 2 degrees")
    noise_cost(det, frames[0], f"SIFT full sweep, {N_OBJECTS} objects", card)

    # ---- 4e. SIFT coarse->fine: the reference's stream, then 1000 objects -
    stream = FusedDetector(catalog, cfg_cf, seed=0, device=dev)
    # B3 at the coarse pass's own shape: every other query of a frame
    for f, port in enumerate(compacted):
        q_f = port[2][::cfg_cf.coarse_q_stride].contiguous()
        for db, n in ((stream.cdb, N_OBJECTS), (cdb, N_LARGE)):
            err = max(err, check_b3(
                q_f, db, f"frame {f}'s coarse queries, {n}-object coarse DB"))
    n_stream = len(sx["frame_image"])
    reset_counts()
    for f in range(n_stream):
        image = int(sx["frame_image"][f])
        res = stream.detect(*frames[image])
        check_stream_slab(f, stream.slab, sx, "sift stream")
        check_gated_frame(f, res, fx, sx, "stream", image, "sift stream")
    launches["4e"] = read_counts()
    check_launches("sift stream", n_stream, launches["4e"], full=2,
                   gathered=3)
    reset_counts()
    first = scale_stream(cf, frames, fx, SIFT_STREAM, "sift scale")
    launches["4e-1000"] = read_counts()
    check_launches("sift scale", SIFT_STREAM, launches["4e-1000"], full=2,
                   gathered=3)
    gate = cfg.min_quality
    held = sorted({str(sx["stream_ids"][i])
                   for i in range(len(sx["stream_ids"]))
                   if sx["stream_quality"][i] >= gate})
    log(f"sift scale: {N_LARGE} objects, discovery frame per object the "
        "reference's stream accepts: "
        + ", ".join(f"{o} {first.get(o, 'never')}" for o in held))
    if any(o not in first for o in held):
        raise AssertionError(f"sift scale: not all of {held} discovered "
                             f"within {SIFT_STREAM} frames")
    log("sift scale: each discovered and found within 2 cm on every frame "
        "after")

    # ---- 5c. time ---------------------------------------------------------
    del stream
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lat = timed_detect(det, frames, SIFT_FRAMES)
    log(f"time: SIFT full sweep at {N_OBJECTS} objects: detect per frame "
        f"median {np.median(lat):.2f} ms, p95 {np.percentile(lat, 95):.2f} "
        f"ms over {SIFT_FRAMES} frames; resident catalog {sdb.nbytes()} "
        f"bytes ({sum(sdb.rows_host)} rows); resident {N_LARGE}-object DB "
        f"{ldb.nbytes()} bytes + coarse DB {cdb.nbytes()} bytes; peak device "
        f"memory {torch.cuda.max_memory_allocated()} bytes; {card}")
    torch.cuda.reset_peak_memory_stats()
    lat = timed_detect(cf, frames, SIFT_FRAMES)
    log(f"time: SIFT coarse->fine at {N_LARGE} objects: detect per frame "
        f"median {np.median(lat):.2f} ms, p95 {np.percentile(lat, 95):.2f} "
        f"ms over {SIFT_FRAMES} frames; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {card}")
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b3_bound[0], bound_by=b3_bound[1],
                 int_mm_ms=mm_ms),
            dict(max_abs_err=b4_err, ms=b4_ms, plain_ms=b4_plain_ms,
                 bound_ms=b4_bound[0], bound_by=b4_bound[1]))


def check_b5(q, words, n_valid: int, k: int, radius, what: str,
             quiet: bool = False) -> float:
    """B5 against its twin on the card: equal bits or raise; the holes come
    after every real match. Returns the largest absolute distance gap
    (0.0). ``quiet`` logs nothing when they agree."""
    from tod_tpu_torch.ops import hamming as ham

    d_k, i_k = ham.hamming_topk_fused(q, words, n_valid, k=k, radius=radius)
    torch.cuda.synchronize()
    d_t, i_t = ham.hamming_topk_fused_torch(q, words, n_valid, k, radius)
    err = float((d_k - d_t).abs().max()) if d_k.numel() else 0.0
    equal = bool(torch.equal(d_k, d_t) and torch.equal(i_k, i_t))
    real = i_k >= 0
    ordered = bool((real[:, :-1] | ~real[:, 1:]).all())
    ok = err == 0.0 and equal and ordered
    if not quiet or not ok:
        log(f"kernels: B5 vs twin on {what}: Q={q.shape[0]} "
            f"n_valid={n_valid} k={k} radius={radius} "
            f"matches={int(real.sum())} max_abs_err={err} equal={equal} "
            f"holes_last={ordered}")
    if not ok:
        raise AssertionError(f"B5 disagrees with its twin on {what}")
    return err


def check_t1(q, words, n_valid: int, what: str) -> None:
    """Every T1 mode on every route against its plain version on the card,
    exactly."""
    from tod_tpu_torch.ops import hamming as ham

    for mode in ham.PROBE_MODES:
        want = ham.hamming_probe_torch(q, words, n_valid, mode)
        for route in ham.PROBE_ROUTES:
            got = ham.hamming_probe(q, words, n_valid, mode, route)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"T1 {mode} on route {route} differs "
                                     f"from its plain version on {what}")
    log(f"kernels: T1 modes {sorted(ham.PROBE_MODES)} on routes "
        f"{sorted(ham.PROBE_ROUTES)} equal to their plain versions on "
        f"{what} (Q={q.shape[0]}, n_valid={n_valid})")


def global_phases(dev, card: str, fx, frames, large, launches: dict):
    """Phases 3e, 4f and 5d: the global-kNN path
    (FusedDetector(pipeline="global"), kernel B5) and T1. ``large`` are the
    1000-object catalog's models. Returns the ``kernels`` entries' measured
    fields of B5 and T1."""
    from tod_tpu_torch.geometry.detection import active_objects
    from tod_tpu_torch.models.fused import (FusedDetector, flat_matches,
                                            geom_db, match_against_db,
                                            pack_models, stage_features)
    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.utils.smoke_catalog import edge_case_arrays_hamming

    gx = np.load(GLOBAL_FIXTURE)
    _, model_ids, models = load_fixture()
    cfg = config(gx, GLOBAL_CONFIG)

    # ---- 3e. B5 against its twin, T1 against its plain versions ----------
    t0 = time.perf_counter()
    gdet = FusedDetector(smoke_models(model_ids, models, N_OBJECTS), cfg,
                         seed=0, device=dev)
    db = gdet.db
    log(f"global: {N_OBJECTS}-object catalog ({db.n_valid} rows, "
        f"{db.words.shape[0]} padded to {cfg.db_chunk}, {db.nbytes()} bytes "
        f"resident) built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    # queries: rows of the first model, every other one with ~5 % of its
    # bits flipped, so that the radius has hits beside the exact ones
    pick = rng.choice(len(models[0][0]), Q_GLOBAL, replace=False)
    q_np = models[0][0][pick].copy()
    q_np[1::2] ^= np.packbits(rng.random((Q_GLOBAL // 2, 256)) < 0.05,
                              axis=1, bitorder="little")
    q_main = torch.from_numpy(q_np).to(dev)
    n_main = db.n_valid
    err = 0.0
    for k, radius in B5_SHAPES:
        err = max(err, check_b5(q_main, db.words, n_main, k, radius,
                                "the smoke catalog"))
    q_batch = batched_queries(q_main, 4)
    for n_q in BATCH_Q_GLOBAL:
        err = max(err, check_b5(q_batch[:n_q], db.words, n_main,
                                cfg.k_matches, cfg.radius, f"Q={n_q} "
                                "(detect_batch_raw's B x 5000)"))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_edge = 0
    for n_q in B5_EDGE_Q:
        n_split, per = ham.split_plan(n_q, EDGE_ROWS, n_sm)
        e_db, e_q = edge_case_arrays_hamming(
            n_q, EDGE_ROWS, max(n_q, 70),
            [per * s for s in range(1, n_split)])
        e_words = ham.pack_db_bits(torch.from_numpy(e_db).to(dev))
        e_q = torch.from_numpy(e_q[:n_q]).to(dev)
        for n_valid in (EDGE_ROWS, EDGE_ROWS - 77, per + 1, 257, 129, 9,
                        3, 0):
            for k, radius in B5_SHAPES:
                err = max(err, check_b5(
                    e_q, e_words, n_valid, k, radius,
                    f"edge cases ({n_split} splits of {per} rows)",
                    quiet=True))
                n_edge += 1
    log(f"kernels: B5 equal to its twin on {n_edge} edge cases: Q "
        f"{list(B5_EDGE_Q)}, n_valid {EDGE_ROWS} down to 0 (ragged tiles "
        "and splits), ties across the sweep's fragments, lanes, 128-row "
        "tiles and split boundaries, (k, radius) "
        f"{[(k, r) for k, r in B5_SHAPES]}")
    t0 = time.perf_counter()
    ldb = pack_models(large, cfg.db_chunk, device=dev)[0]
    log(f"global: {N_LARGE}-object DB ({ldb.n_valid} rows, {ldb.nbytes()} "
        f"bytes) built in {time.perf_counter() - t0:.1f} s")
    err = max(err, check_b5(q_main[:512].contiguous(), ldb.words,
                            ldb.n_valid, 5, 35.0,
                            f"the {N_LARGE}-object catalog"))
    times = {}
    for k, radius in B5_SHAPES:
        times[(k, radius)] = cuda_ms(lambda: ham.hamming_topk_fused(
            q_main, db.words, n_main, k=k, radius=radius))
    ms = times[(5, 35.0)]
    plain_ms = cuda_ms(lambda: ham.hamming_topk_fused_torch(
        q_main, db.words, n_main, 5, 35.0), runs=TWIN_RUNS, warmup=1)
    large_ms = cuda_ms(lambda: ham.hamming_topk_fused(
        q_main, ldb.words, ldb.n_valid, k=5, radius=35.0), runs=8)
    pairs = Q_GLOBAL * n_main
    b5_bound = hamming_bound(pairs, Q_GLOBAL * 32 + n_main * 32
                             + Q_GLOBAL * 5 * 8)
    popc_ms = pairs * 8 / RATES["popc"]["rate"] * 1e3
    log(f"kernels: B5 {ms:.3f} ms median of {KERNEL_RUNS} "
        f"({pairs / ms / 1e6:.1f} G pairs/s) at Q={Q_GLOBAL} x {n_main} "
        f"rows, k 5, radius 35; twin {plain_ms:.3f} ms median of "
        f"{TWIN_RUNS}; bound {b5_bound[0]:.3f} ms by {b5_bound[1]} "
        f"(popcount bound {popc_ms:.3f} ms); k 8 / radius 50 "
        f"{times[(8, 50.0)]:.3f} ms; radius None {times[(5, None)]:.3f} ms; "
        f"{N_LARGE} objects ({ldb.n_valid} rows) {large_ms:.3f} ms "
        f"({Q_GLOBAL * ldb.n_valid / large_ms / 1e6:.1f} G pairs/s); {card}")
    del ldb
    torch.cuda.empty_cache()

    # T1 at its own shape (tools/bench_dot_iso.py: Q = 5120, N = 262144)
    # and at B5's main shape: the distance sweep alone, per mode
    q_t1 = torch.from_numpy(rng.integers(0, 256, (T1_Q, 32), dtype=np.uint8)
                            ).to(dev)
    w_t1 = ham.pack_db_bits(torch.from_numpy(
        rng.integers(0, 256, (T1_N, 32), dtype=np.uint8)).to(dev))
    check_t1(q_t1, w_t1, T1_N, "T1's shape")
    check_t1(q_main, db.words, n_main, "B5's main shape")
    t1 = {route: {mode: {
        "t1_shape": cuda_ms(lambda: ham.hamming_probe(q_t1, w_t1, T1_N, mode,
                                                      route)),
        "b5_shape": cuda_ms(lambda: ham.hamming_probe(
            q_main, db.words, n_main, mode, route))}
        for mode in ham.PROBE_MODES} for route in ham.PROBE_ROUTES}
    t1_plain_ms = cuda_ms(lambda: ham.hamming_probe_torch(
        q_t1, w_t1, T1_N, "dist_sum"), runs=TWIN_RUNS, warmup=1)
    t1_pairs = T1_Q * T1_N
    t1_bound = hamming_bound(t1_pairs, T1_Q * 32 + T1_N * 32 + T1_Q * 8)
    for route, modes in t1.items():
        log(f"kernels: T1 route {route} at Q={T1_Q} x {T1_N} rows / at B5's "
            "shape, ms: " + "; ".join(
                f"{m} {v['t1_shape']:.3f} / {v['b5_shape']:.3f}"
                for m, v in modes.items()) + f"; {card}")
    sweep = {r: t1[r]["row_min"]["b5_shape"] for r in ham.PROBE_ROUTES}
    faster = min(("s8", "b1"), key=sweep.get)
    b5_route = ham.b5_route()
    log(f"kernels: B5 is compiled with route {b5_route} "
        f"(csrc/hamming_topk.cu kB5Route); T1's row-min sweep at B5's shape "
        f"takes s8 {sweep['s8']:.3f} ms, b1 {sweep['b1']:.3f} ms, popc "
        f"{sweep['popc']:.3f} ms, so the faster tensor-core route in this "
        f"run is {faster}; B5 (k 5, radius 35) {ms:.3f} ms: extraction "
        f"{ms - sweep[b5_route]:.3f} ms over its route's row-min sweep; "
        f"dist_sum plain version {t1_plain_ms:.3f} ms; bound at T1's shape "
        f"{t1_bound[0]:.3f} ms by {t1_bound[1]} (popcount bound "
        f"{t1_pairs * 8 / RATES['popc']['rate'] * 1e3:.3f} ms); {card}")
    del q_t1, w_t1

    # ---- 4f. the global path on both frames --------------------------------
    n_obj = len(gdet.object_ids)
    n_active = min(cfg.guess.max_active_objects, n_obj)
    for f, frame in enumerate(frames):
        kps, desc, qp = stage_features(*frame, cfg)
        got = [t.cpu().numpy() for t in (kps.xy, kps.valid, desc)]
        keypoints = all(np.array_equal(a, gx[name][f]) for a, name in
                        zip(got, ("kp_xy", "kp_valid", "kp_desc")))
        points = np.array_equal(qp.cpu().numpy(), gx["kp_qp"][f],
                                equal_nan=True)
        dist, rows = match_against_db(desc, db, cfg)     # B5, not counted
        matches = bool(np.array_equal(dist.cpu().numpy(), gx["dist"][f])
                       and np.array_equal(rows.cpu().numpy(), gx["rows"][f]))
        obj, valid, _ = flat_matches(kps.valid, dist, rows, geom_db(db),
                                     cfg.radius)
        act = active_objects(obj, valid, qp, n_obj, n_active).cpu().numpy()
        same_act = bool(np.array_equal(act, gx["active"][f]))
        log(f"global: frame {f}: {int(got[1].sum())} valid of {len(got[1])} "
            f"keypoints; keypoints and descriptors equal to the reference's: "
            f"{keypoints}, 3D points: {points}; B5's (dist, rows) equal: "
            f"{matches} ({int(valid.sum())} matches in radius); active set "
            f"equal: {same_act} {act.tolist()}")
        if not (keypoints and points and matches and same_act):
            raise AssertionError(f"global: frame {f} differs from the "
                                 "reference's")
    reset_counts()
    found = [gdet.detect(*frame) for frame in frames]
    launches["4f"] = read_counts()
    check_launches("global", len(frames), launches["4f"], full=4)
    for f, res in enumerate(found):
        check_gated_frame(f, res, fx, gx, "ref", f, "global")
    log("global: every detection the reference accepts at the gate found "
        "within 1 cm and 2 degrees")
    noise_cost(gdet, frames[0], f"ORB global kNN, {N_OBJECTS} objects", card)

    # ---- 5d. time ---------------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for frame in frames:
        gdet.detect(*frame)
    lat = timed_detect(gdet, frames, GLOBAL_FRAMES)
    log(f"time: global at {N_OBJECTS} objects: detect per frame median "
        f"{np.median(lat):.2f} ms, p95 {np.percentile(lat, 95):.2f} ms over "
        f"{GLOBAL_FRAMES} frames; resident DB {db.nbytes()} bytes "
        f"({db.n_valid} rows); peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; {card}")
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=b5_bound[0], bound_by=b5_bound[1]),
            dict(max_abs_err=0.0, ms=t1["popc"]["dist_sum"]["t1_shape"],
                 plain_ms=t1_plain_ms, bound_ms=t1_bound[0],
                 bound_by=t1_bound[1], timed_route="popc",
                 modes_ms=t1["popc"], b5_route=b5_route, routes_ms=t1))


def unpacked(bits: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(bits, axis=-1, count=n,
                         bitorder="little").astype(bool)


def train_phases(dev, card: str, fx, frames, launches: dict) -> dict:
    """Phases 6, 6b and 6c: training on the card, held to the reference's
    trained models (tests/data/torch_train_fixture.npz), and the trained
    models served. ``frames`` are the prepared smoke fixture frames.
    Returns B5's fields at the dedup's shape for the ``kernels`` line."""
    from tod_tpu_torch.cells.trainer import (feature_settings, fill_model,
                                             train_object, train_views)
    from tod_tpu_torch.models.fused import FusedDetector
    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.ops.compress import compress_model
    from tod_tpu_torch.ops.segmented_l2 import quantize_numpy
    from tod_tpu_torch.types import fixture_observations

    tx = np.load(TRAIN_FIXTURE)
    model_ids = [str(s) for s in fx["model_ids"]]
    views = [fixture_observations(tx, i) for i in range(len(model_ids))]
    n_feat = TRAIN_FEATURES["n_features"]

    # ---- 6. object 0's views, then each object's model -------------------
    desc, world, valid = train_views(views[0], feature_settings(
        TRAIN_FEATURES), dev)
    same = (np.array_equal(valid, unpacked(tx["views0_valid"], n_feat))
            and np.array_equal(desc, tx["views0_desc"])
            and np.array_equal(world, tx["views0_world"], equal_nan=True))
    log(f"train: object 0: {len(views[0])} views of "
        f"{views[0][0].image.shape[:2]}: {int(valid.sum())} valid of "
        f"{valid.size} keypoints; descriptors, world points and valid masks "
        f"equal to the reference's: {same}")
    if not same:
        raise AssertionError("train: object 0's per-view outputs differ "
                             "from the reference's")

    def train(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, p = train_object(views[i], TRAIN_FEATURES, *TRAIN_DEDUP,
                            device=dev)
        t1 = time.perf_counter()
        d16, p16 = compress_model(d, p.reshape(-1, 3), *RECOMPRESS,
                                  device=dev)
        return (d, p.reshape(-1, 3)), (d16, p16), t1 - t0, \
            time.perf_counter() - t1

    train(0)                                            # warm
    reset_counts()
    secs, rc_secs, trained = [], [], []
    for i, oid in enumerate(model_ids):
        (d8, p8), (d16, p16), s, rc = train(i)
        secs.append(s)
        rc_secs.append(rc)
        stacked = tx[f"stacked{i}_desc"], tx[f"stacked{i}_points"]
        keep8 = unpacked(tx[f"keep8_{i}"], len(stacked[0]))
        same = (np.array_equal(d8, stacked[0][keep8])
                and np.array_equal(p8, stacked[1][keep8])
                and np.array_equal(d16, fx[f"desc{i}"])
                and np.array_equal(p16, fx[f"points{i}"]))
        log(f"train: {oid}: {len(stacked[0])} rows before dedup, "
            f"{len(d8)} after {TRAIN_DEDUP[0]} bits / "
            f"{TRAIN_DEDUP[1] * 1e3:g} mm, {len(d16)} after "
            f"{RECOMPRESS[0]} / {RECOMPRESS[1] * 1e3:g} mm; descriptors and "
            f"points equal to the reference's at both: {same}; trained in "
            f"{s:.3f} s, recompressed in {rc:.3f} s")
        if not same:
            raise AssertionError(f"train: {oid}'s model differs from the "
                                 "reference's")
        trained.append(fill_model(oid, d16, p16))
    launches["6"] = read_counts()
    log(f"train: {len(model_ids)} objects, launches "
        + ", ".join(f"{name} {n}" for name, n in zip(
            [f"B{i + 1}" for i in range(5)] + ["T1", "N1"], launches["6"])))
    want = [0, 0, 0, 0, 2 * len(model_ids), 0, 0]
    if list(launches["6"]) != want:
        raise AssertionError(f"train: launches {list(launches['6'])}, "
                             f"expected {want} (two B5 dedups an object)")
    n_views = len(views[0])
    log(f"time: training per object median {np.median(secs):.3f} s "
        f"({np.median(secs) / n_views * 1e3:.2f} ms a view of {n_views}; "
        f"objects {', '.join(f'{s:.3f}' for s in secs)} s, after one warm "
        f"object), {RECOMPRESS[0]}x{RECOMPRESS[1] * 1e3:g} recompression "
        f"median {np.median(rc_secs) * 1e3:.2f} ms; {card}")

    # B5 at the dedup's own shapes: a model's rows against themselves
    err = 0.0
    shapes = []
    rows0 = tx["stacked0_desc"]
    for radius, d, what in (
            (TRAIN_DEDUP[0], rows0, "obj000 before dedup"),
            (RECOMPRESS[0], rows0[unpacked(tx["keep8_0"], len(rows0))],
             "obj000 after dedup 8")):
        rows = torch.from_numpy(d).to(dev)
        words = ham.pack_db_bits(rows)
        err = max(err, check_b5(rows, words, len(d), DEDUP_K, radius,
                                f"the dedup of {what} (Q = N)"))
        shapes.append((rows, words, radius))
    rows, words, radius = shapes[0]
    n = rows.shape[0]
    ms = cuda_ms(lambda: ham.hamming_topk_fused(rows, words, n, k=DEDUP_K,
                                                radius=radius))
    ms16 = cuda_ms(lambda: ham.hamming_topk_fused(
        shapes[1][0], shapes[1][1], shapes[1][0].shape[0], k=DEDUP_K,
        radius=shapes[1][2]))
    plain_ms = cuda_ms(lambda: ham.hamming_topk_fused_torch(
        rows, words, n, DEDUP_K, radius), runs=TWIN_RUNS, warmup=1)
    pairs = n * n
    b5_bound = hamming_bound(pairs, 2 * n * 32 + n * DEDUP_K * 8)
    log(f"kernels: B5 at the dedup's shape {ms:.3f} ms median of "
        f"{KERNEL_RUNS} ({pairs / ms / 1e6:.1f} G pairs/s) at Q = N = {n} "
        f"rows, k {DEDUP_K}, radius {radius}; twin {plain_ms:.3f} ms median "
        f"of {TWIN_RUNS}; bound {b5_bound[0]:.4f} ms by {b5_bound[1]}; "
        f"the recompression's shape (N = {shapes[1][0].shape[0]}, radius "
        f"{shapes[1][2]}) {ms16:.3f} ms; {card}")
    del shapes, rows, words

    # ---- 6b. the port-trained models served ------------------------------
    catalog = smoke_models(model_ids, [(m.descriptors, m.points)
                                       for m in trained])
    det = FusedDetector(catalog, config(fx), seed=0, device=dev)
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches["6b"] = read_counts()
    check_launches("train->serve", len(frames), launches["6b"], full=0)
    for f, res in enumerate(found):
        check_frame(f, res, fx, what="train->serve")
    log("train->serve: the port-trained models served: every placement "
        "within 2 cm; accepted objects and poses agree with the reference")
    del det, catalog

    # ---- 6c. SIFT training on the reference's views ----------------------
    sv = [views[0][v] for v in tx["sift_views"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    desc, world, valid = train_views(sv, feature_settings(
        {**TRAIN_FEATURES, "type": "SIFT"}), dev)
    sift_s = time.perf_counter() - t0
    flat = valid.reshape(-1)
    model = fill_model(model_ids[0], desc.reshape(-1, 128)[flat],
                       world.reshape(-1, 3)[flat])
    want_d, want_p = tx["sift0_desc"], tx["sift0_points"]
    exact = (np.array_equal(valid, unpacked(tx["sift0_valid"], n_feat))
             and np.array_equal(model.points, want_p))
    gap = float(np.abs(model.descriptors - want_d).max()) if exact else 1.0
    diff = quantize_numpy(model.descriptors).astype(np.int32) \
        - quantize_numpy(want_d).astype(np.int32)
    log(f"train: SIFT, {model_ids[0]} on {len(sv)} of {len(views[0])} "
        f"views (every {tx['sift_views'][1]}th): {model.n_points} rows; "
        f"valid masks and points equal to the reference's: {exact}; "
        f"descriptors within {gap:.3g} (bound {SIFT_ATOL}); "
        f"{int((diff != 0).sum())} of {diff.size} quantised entries differ "
        f"(max {int(np.abs(diff).max())}); trained in {sift_s:.3f} s "
        f"({sift_s / len(sv) * 1e3:.2f} ms a view); {card}")
    if not exact or gap > SIFT_ATOL or np.abs(diff).max() > 1 \
            or (diff != 0).mean() > QUANT_SHARE:
        raise AssertionError("train: the SIFT model differs from the "
                             "reference's")
    return dict(dedup_ms=ms, dedup_plain_ms=plain_ms,
                dedup_bound_ms=b5_bound[0], dedup_bound_by=b5_bound[1],
                dedup_shape=f"Q = N = {n}, k {DEDUP_K}, radius {radius}",
                dedup_max_abs_err=err)


def write_catalog_db(root: str, model_ids, models, name: str = "db"
                     ) -> dict:
    """The 100-object smoke catalog in a port FilesystemDb ``root/name``
    (the port's ``write_model``; quantised SIFT models as ``q / 256``): its
    ``.ork`` db parameters."""
    from tod_tpu_torch.db import FilesystemDb, write_model
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    params = {"type": "filesystem", "root": os.path.join(root, name),
              "collection": "object_recognition"}
    db = FilesystemDb(params["root"], params["collection"])
    ids, arrays = smoke_catalog(model_ids, models, n_objects=N_OBJECTS)
    for oid, (desc, pts) in zip(ids, arrays):
        if desc.dtype == np.int8:
            desc = desc.astype(np.float32) / 256.0
        write_model(db, oid, desc, pts)
    return params


def graph_view(cx, prefix: str) -> dict:
    """The reference graph's poses ``prefix_*`` of the cells fixture under
    the ``ref_*`` keys :func:`check_frame` and :func:`check_gated_frame`
    read, with the gate of the graph's .ork file."""
    view = {"ref_" + k[len(prefix) + 1:]: cx[k] for k in cx.files
            if k.startswith(prefix + "_")}
    view["config_json"] = np.asarray(json.dumps({"min_quality": GRAPH_GATE}))
    return view


def graph_turns(sched, det, frames, n: int):
    """Milliseconds of ``n`` scheduler iterations of a looping .ork graph
    (each cell ends in its device read), in turns with ``n`` closed-loop
    ``det.detect`` calls on the same frames: (graph, direct)."""
    graph, direct = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.execute_iteration()
        graph.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        det.detect(*frames[i % len(frames)])
        direct.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(graph), np.asarray(direct)


def log_graph_time(what: str, pipeline, sched, graph, direct, card: str
                   ) -> None:
    """A graph's median frame beside the direct detector's, and the
    per-cell split of the timed iterations (the outer graph and the
    TodDetector's inner cells)."""
    log(f"time: {what}: graph frame median {np.median(graph):.2f} ms, p95 "
        f"{np.percentile(graph, 95):.2f} ms; direct FusedDetector "
        f"{np.median(direct):.2f} / {np.percentile(direct, 95):.2f} ms, in "
        f"turns over {len(graph)} frames; {card}")
    inner = pipeline.cells["pipeline1"].scheduler
    for line in (sched.timing_report() + "\n"
                 + inner.timing_report()).splitlines():
        log(f"time: {what}: {line.strip()}")


def cells_phases(dev, card: str, fx, frames, found4, launches: dict) -> None:
    """Phases 7a-7d: the cell graph (ROADMAP A12b) and the serving graphs
    (A12e) through the port's .ork path, held to the reference's graphs
    (tests/data/torch_cells_fixture.npz, tools/make_torch_cells_fixture.py)
    and to the reference's trained model; the gap to phase 4's poses
    logged. ``frames`` are the prepared smoke frames,
    ``found4`` phase 4's detections of them."""
    import tempfile

    from tod_tpu_torch.db import (FilesystemDb, insert_observation,
                                  load_models_for_objects)
    from tod_tpu_torch.models.fused import FusedDetector, FusedDetectorConfig
    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
    from tod_tpu_torch.types import fixture_observations

    cx = np.load(CELLS_FIXTURE)
    model_ids, models = load_fixture()[1:]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        db_params = write_catalog_db(tmp, model_ids, models)
        frame_dir = os.path.join(tmp, "frames")
        os.makedirs(frame_dir)
        for f in range(len(fx["images"])):
            np.savez(os.path.join(frame_dir, f"frame{f}.npz"),
                     image=fx["images"][f], depth=fx["depths"][f], K=fx["K"])
        log(f"cells: {N_OBJECTS}-object catalog written to a FilesystemDb "
            f"and {len(fx['images'])} frames as .npz in "
            f"{time.perf_counter() - t0:.1f} s")
        over = {"source1": {"path": frame_dir, "loop": False},
                "pipeline1": {"db": db_params, "device": str(dev)}}

        # ---- 7a. conf/detection.ork: the global-kNN cell graph ------------
        ork = str(cx["ork"])
        t0 = time.perf_counter()
        pipeline = build_pipeline_from_ork(os.path.join(ROOT, ork), over)
        sched = Scheduler(pipeline.plasm)
        sched.prepare()
        det = pipeline.cells["pipeline1"]
        det.scheduler.prepare()            # configures the inner cells
        index = det.descriptor_matcher.index
        log(f"cells: {ork} built and configured in "
            f"{time.perf_counter() - t0:.1f} s: {len(index.object_ids)} "
            f"objects, {index.n_descriptors} rows on {index.descriptors.device}")
        reset_counts()
        results = []
        for f in range(len(fx["images"])):
            sched.execute_iteration()
            m = det.descriptor_matcher.outputs["matches"]
            same = {name: bool(np.array_equal(getattr(m, name),
                                              cx[f"match_{name}"][f]))
                    for name in ("dist", "train_idx", "obj_idx",
                                 "local_idx", "valid")}
            log(f"cells: frame {f}: MatchSet ({m.dist.shape[0]} queries x k "
                f"{m.k}, {int(m.valid.sum())} in radius) equal to the "
                f"reference's, field by field: {same}")
            if not all(same.values()):
                raise AssertionError(f"cells: frame {f}'s MatchSet differs "
                                     "from the reference's")
            results.append(list(det.outputs["pose_results"]))
            query = det.descriptor_matcher.inputs["descriptors"]
        launches["7a"] = read_counts()
        check_launches("cells", len(results), launches["7a"], full=4)
        for f, res in enumerate(results):
            check_frame(f, res, fx, cx, what="cells")
        log("cells: every placement within 2 cm; the reference's accepted "
            "objects (every instance) at its poses within 1 cm and 2 degrees")
        q = torch.from_numpy(np.ascontiguousarray(query)).to(dev)
        check_b5(q, index.descriptors, index.n_descriptors, 5, None,
                 "the cell graph's catalog, frame 1's descriptors")
        # the direct detector at the graph's own operating point
        direct = FusedDetector(
            load_models_for_objects(FilesystemDb(db_params["root"],
                                                 db_params["collection"])),
            FusedDetectorConfig(pipeline="global", radius=35.0,
                                guess=det.guess_generator._cfg),
            seed=0, device=dev)
        pipeline.cells["source1"].params["loop"] = True
        timed = Scheduler(pipeline.plasm)
        for _ in range(2):                               # warm
            timed.execute_iteration()
            direct.detect(*frames[0])
        timed = Scheduler(pipeline.plasm)
        det.scheduler.cell_times.clear()
        det.scheduler.n_iterations = 0
        graph_ms, direct_ms = graph_turns(timed, direct, frames, GRAPH_FRAMES)
        log_graph_time(f"{ork} (global-kNN cell graph, {N_OBJECTS} objects)",
                       pipeline, timed, graph_ms, direct_ms, card)
        del pipeline, sched, timed, det, index, direct, q
        torch.cuda.empty_cache()

        # ---- 7b. conf/detection.serving.ork: SegmentedDetector -------------
        ork = "conf/detection.serving.ork"
        pipeline = build_pipeline_from_ork(os.path.join(ROOT, ork), over)
        sched = Scheduler(pipeline.plasm)
        reset_counts()
        results = []
        for f in range(len(fx["images"])):
            sched.execute_iteration()
            results.append(list(pipeline.cells["pipeline1"].outputs[
                "pose_results"]))
        launches["7b"] = read_counts()
        check_launches("cells-serving", len(results), launches["7b"], full=0)
        ref_graph = graph_view(cx, "serving")
        gap = 0.0
        for f, (res, mine) in enumerate(zip(results, found4)):
            check_frame(f, res, fx, ref_graph, what="cells-serving")
            for r in res:
                errs = [pose_error(r.R, r.T, p.R, p.T) for p in mine
                        if p.object_id == r.object_id]
                if errs:
                    dt, ang = min(errs)
                    gap = max(gap, dt, np.radians(ang))
        log(f"cells-serving: {ork} through the graph: the reference graph's "
            f"accepted objects on both frames at its poses (1 cm, 2 deg); "
            f"largest pose gap to phase 4's direct detector {gap:.3g} (m or "
            "rad; the graph's catalog is in the DB's object-id order and its "
            "depth is the eager cell's, so its noise slots and rounding may "
            "differ)")
        seg = pipeline.cells["pipeline1"].serving._detector
        direct = FusedDetector(smoke_models(model_ids, models), seg.config,
                               seed=0, device=dev)
        pipeline.cells["source1"].params["loop"] = True
        timed = Scheduler(pipeline.plasm)
        timed.execute_iteration()
        direct.detect(*frames[0])
        timed = Scheduler(pipeline.plasm)
        pipeline.cells["pipeline1"].scheduler.cell_times.clear()
        pipeline.cells["pipeline1"].scheduler.n_iterations = 0
        graph_ms, direct_ms = graph_turns(timed, direct, frames, GRAPH_FRAMES)
        log_graph_time(f"{ork} (SegmentedDetector, {N_OBJECTS} objects)",
                       pipeline, timed, graph_ms, direct_ms, card)
        del pipeline, sched, timed, seg, direct
        torch.cuda.empty_cache()

        # ---- 7d. conf/detection.sift.serving.ork: SIFT SegmentedDetector ---
        phase_t0 = time.perf_counter()
        ork = "conf/detection.sift.serving.ork"
        s_ids, s_models = load_fixture(SIFT_FIXTURE)[1:]
        sift_params = write_catalog_db(tmp, s_ids, s_models, "db_sift")
        pipeline = build_pipeline_from_ork(os.path.join(ROOT, ork), {
            **over, "pipeline1": {"db": sift_params, "device": str(dev)}})
        sched = Scheduler(pipeline.plasm)
        reset_counts()
        results = []
        for f in range(len(fx["images"])):
            sched.execute_iteration()
            results.append(list(pipeline.cells["pipeline1"].outputs[
                "pose_results"]))
        launches["7d"] = read_counts()
        check_launches("cells-sift", len(results), launches["7d"], full=2)
        ref_graph = graph_view(cx, "sift")
        for f, res in enumerate(results):
            check_gated_frame(f, res, fx, ref_graph, "ref", f, "cells-sift")
            want = sorted(str(i) for i, g in zip(ref_graph["ref_ids"],
                                                 ref_graph["ref_frame"])
                          if g == f)
            log(f"cells-sift: frame {f}: accepted objects equal to the "
                f"reference graph's: {sorted(r.object_id for r in res) == want}")
        log(f"cells-sift: {ork} through the graph: every pose the reference "
            "graph reports found within 1 cm and 2 degrees, no other accept "
            f"off a ground-truth placement; phase 7d took "
            f"{time.perf_counter() - phase_t0:.1f} s")
        del pipeline, sched
        torch.cuda.empty_cache()

        # ---- 7c. TodTrainer through conf/training.ork -----------------------
        tx = np.load(TRAIN_FIXTURE)
        db = FilesystemDb(db_params["root"], db_params["collection"])
        for o in fixture_observations(tx, 0):
            insert_observation(db, model_ids[0], o.frame_number, o.image,
                               o.depth, o.mask, o.K, o.R, o.T)
        pipeline = build_pipeline_from_ork(
            os.path.join(ROOT, "conf", "training.ork"),
            {"pipeline1": {"db": db_params, "feature": TRAIN_FEATURES,
                           "object_id": model_ids[0], "device": str(dev),
                           "dedup_hamming": TRAIN_DEDUP[0],
                           "dedup_point_m": TRAIN_DEDUP[1]}})
        sched = Scheduler(pipeline.plasm)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.execute_iteration()
        secs = time.perf_counter() - t0
        launches["7c"] = read_counts()
        (model,) = load_models_for_objects(db, [model_ids[0]])
        stacked = tx["stacked0_desc"], tx["stacked0_points"]
        keep8 = unpacked(tx["keep8_0"], len(stacked[0]))
        same = (np.array_equal(model.descriptors, stacked[0][keep8])
                and np.array_equal(model.points, stacked[1][keep8]))
        log(f"cells-train: conf/training.ork's TodTrainer on "
            f"{model_ids[0]}'s 60 views from the DB: model document "
            f"{model.document_id}, {model.n_points} rows; descriptors and "
            f"points equal to the reference's (dedup {TRAIN_DEDUP[0]} bits / "
            f"{TRAIN_DEDUP[1] * 1e3:g} mm) bit for bit: {same}; "
            f"{secs:.3f} s; launches " + ", ".join(
                f"{name} {n}" for name, n in zip(
                    [f"B{i + 1}" for i in range(5)] + ["T1", "N1"],
                    launches["7c"])) + f"; {card}")
        if not same:
            raise AssertionError("cells-train: the model differs from the "
                                 "reference's")
        if list(launches["7c"]) != [0, 0, 0, 0, 1, 0, 0]:
            raise AssertionError(f"cells-train: launches "
                                 f"{list(launches['7c'])}, expected one B5")
        for line in (sched.timing_report() + "\n" + pipeline.cells[
                "pipeline1"].scheduler.timing_report()).splitlines():
            log(f"time: cells-train: {line.strip()}")


# ---- ROADMAP A16: sub-pixel, hot catalog updates, batched detection -------


def fixture_view(ax, prefix: str, config_key: str) -> dict:
    """The ``prefix_*`` detections of ``ax`` with the config they were made
    at, under the keys :func:`check_gated_frame` reads."""
    return {"config_json": ax[config_key], "batch_seed": ax["batch_seed"],
            **{k: ax[k] for k in ax.files if k.startswith(prefix + "_")}}


def db_layout(det) -> dict:
    """(shape, dtype, data_ptr) of every tensor of the detector's DBs."""
    return {f"{which}.{f.name}": (tuple(t.shape), t.dtype, t.data_ptr())
            for which, db in (("sdb", det.sdb), ("cdb", det.cdb))
            if db is not None for f in dataclasses.fields(db)
            for t in [getattr(db, f.name)] if isinstance(t, torch.Tensor)}


def same_detections(a, b, gate: float, what: str) -> float:
    """Accepted instances, inlier counts and clique sizes equal; R and T
    within BATCH_ATOL at the accepts of quality >= ``gate``, or raise.
    Returns the largest R/T gap over every accept."""
    for name in ("accepted", "n_inliers", "clique_size"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differ")
    from tod_tpu_torch.models.fused import CLIQUE_WEIGHT

    acc = a.accepted
    gated = acc & (a.n_inliers + CLIQUE_WEIGHT * a.clique_size >= gate)
    gap = gated_gap = 0.0
    for name in ("R", "T"):
        d = (getattr(a, name) - getattr(b, name)).abs()
        d = d.reshape(d.shape[:acc.dim()] + (-1,)).amax(-1)
        gap = max(gap, float(d[acc].max()) if acc.any() else 0.0)
        gated_gap = max(gated_gap, float(d[gated].max())
                        if gated.any() else 0.0)
    if gated_gap >= BATCH_ATOL:
        raise AssertionError(f"{what}: poses at the gate {gated_gap:.3g} "
                             "apart")
    return gap


def stacked(frames, n: int):
    """``n`` prepared frames, cycling over ``frames``, as the (B, ...)
    tensors ``detect_batch_raw`` takes."""
    return [torch.stack(t) for t in zip(*(frames[i % len(frames)]
                                          for i in range(n)))]


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_profile(fn) -> tuple:
    """(device operations, device-busy ms, window ms) of ``fn()`` under
    torch.profiler: kernels and copies, as tools/profile_torch_detect.py
    counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (len(device), sum(e.time_range.elapsed_us() for e in device)
            / 1e3, wall)


def batch_path(name: str, det, fx, frames, view: dict, prefix: str,
               matcher: int, launches: dict, card: str) -> None:
    """Phase 8c on one path: ``det`` through
    ``detect_batch_raw`` at each of BATCHES: every row against the port's
    per-frame path with its batch key, the B = 2 rows against the
    reference's per-frame detections with the same keys (``view``'s
    ``prefix_*``), one
    launch of kernel B<matcher + 1> and one frame's N1 launches a batch;
    then timed in turns with ``detect_raw``, traced and measured for peak
    memory at each B."""
    from tod_tpu_torch.geometry.ransac import ThreefryNoise
    from tod_tpu_torch.utils import prng

    n_inst = det.config.guess.ransac.max_instances
    gate = det.config.min_quality
    seed = int(view["batch_seed"])
    reset_counts()
    det.detect_raw(*frames[0])
    per_frame_n1 = read_counts()[6]
    gap = 0.0
    for n in BATCHES:
        det._key = prng.prng_key(seed)
        keys = prng.split(prng.split(det._key)[1], n)
        reset_counts()
        _, rows = det.detect_batch_raw(*stacked(frames, n))
        counts = launches[f"8c {name} B={n}"] = read_counts()
        want = [int(i == matcher) for i in range(6)] + [per_frame_n1]
        log(f"batch: {name}, B={n}: launches " + ", ".join(
            f"{k} {c}" for k, c in zip([f"B{i + 1}" for i in range(5)]
                                       + ["T1", "N1"], counts)))
        if list(counts) != want:
            raise AssertionError(f"batch: {name}, B={n}: launches "
                                 f"{list(counts)}, expected {want}")
        for b in range(n):
            row = type(rows)(*(x[b] for x in rows))
            det.noise = ThreefryNoise(keys[b], n_inst, det.segmented,
                                      det.device)
            mine = det.detect_raw(*frames[b % len(frames)])[1]
            det.noise = None
            gap = max(gap, same_detections(row, mine, gate,
                                           f"batch: {name}, B={n}, row {b}"))
            if n == 2:
                check_gated_frame(b, det.poses(row), fx, view, prefix, b,
                                  f"batch {name} B=2")
    log(f"batch: {name}: every row at B = {BATCHES} equal to the port's "
        f"per-frame path with its batch key (accepts, inliers, cliques; "
        f"largest R/T gap {gap:.3g}, at the gate below {BATCH_ATOL}); the "
        "B = 2 rows hold the reference's gated detections (1 cm, 2 deg)")

    batches = {n: stacked(frames, n) for n in BATCHES}
    for n in BATCHES:                                   # warm
        det.detect_batch_raw(*batches[n])
    ms = {"frame": []} | {n: [] for n in BATCHES}
    for r in range(BATCH_ROUNDS):
        ms["frame"].append(synced_ms(lambda: det.detect_raw(
            *frames[r % len(frames)])))
        for n in BATCHES:
            ms[n].append(synced_ms(lambda: det.detect_batch_raw(
                *batches[n])) / n)
    ops_1 = device_profile(lambda: det.detect_raw(*frames[0]))
    for n in BATCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops, busy, wall = device_profile(
            lambda: det.detect_batch_raw(*batches[n]))
        log(f"time: batch: {name}, B={n}: {np.median(ms[n]):.2f} ms a frame "
            f"median, p95 {np.percentile(ms[n], 95):.2f} (detect_raw in "
            f"turns {np.median(ms['frame']):.2f} / "
            f"{np.percentile(ms['frame'], 95):.2f}) over {BATCH_ROUNDS} "
            f"batches; {ops / n:.0f} device ops a frame (detect_raw "
            f"{ops_1[0]}); device busy {busy / n:.2f} ms a frame, "
            f"{100 * busy / wall:.1f} % of the traced batch ({wall:.2f} ms); "
            f"peak device memory {torch.cuda.max_memory_allocated()} bytes; "
            f"{card}")


def a16_phases(dev, card: str, fx, frames, launches: dict) -> None:
    """Phases 8a-8c (ROADMAP A16), held to tests/data/torch_a16_fixture.npz
    (tools/make_torch_a16_fixture.py) and to the port's own paths.
    ``frames`` are the prepared smoke frames."""
    from tod_tpu_torch.cells.trainer import train_object
    from tod_tpu_torch.models.fused import FusedDetector
    from tod_tpu_torch.ops.compress import compress_model
    from tod_tpu_torch.ops.orb import orb_detect_and_compute
    from tod_tpu_torch.types import fixture_observations

    ax = np.load(A16_FIXTURE)
    model_ids, models = load_fixture()[1:]
    phase_t0 = time.perf_counter()

    # ---- 8a. sub-pixel keypoints, model and serving ----------------------
    cfg_sub = config(ax, key="sub_config_json", subpixel=True)
    for f, (gray, _, _) in enumerate(frames):
        kps, _ = orb_detect_and_compute(
            gray, n_features=cfg_sub.n_features, n_levels=cfg_sub.n_levels,
            scale_factor=cfg_sub.scale_factor,
            fast_threshold=cfg_sub.fast_threshold, subpixel=True)
        xy, valid = kps.xy.cpu().numpy(), kps.valid.cpu().numpy()
        same = (np.array_equal(xy, ax["sub_xy"][f])
                and np.array_equal(valid, ax["sub_valid"][f]))
        log(f"subpixel: frame {f}: {int(valid.sum())} keypoints, "
            f"{int((xy[valid] != np.round(xy[valid])).any(1).sum())} off "
            f"the integer pixels; equal to the reference's bit for bit: "
            f"{same}")
        if not same:
            raise AssertionError(f"subpixel: frame {f}'s keypoints differ")
    tx = np.load(TRAIN_FIXTURE)
    views = fixture_observations(tx, 0)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d8, p8 = train_object(views, {**TRAIN_FEATURES, "subpixel": True},
                          *TRAIN_DEDUP, device=dev)
    secs = time.perf_counter() - t0
    d16, p16 = compress_model(d8, p8.reshape(-1, 3), *RECOMPRESS, device=dev)
    launches["8a train"] = read_counts()
    keep16 = unpacked(ax["sub_keep16"], len(ax["sub8_desc"]))
    same = (np.array_equal(d8, ax["sub8_desc"])
            and np.array_equal(p8.reshape(-1, 3), ax["sub8_points"])
            and np.array_equal(d16, ax["sub8_desc"][keep16])
            and np.array_equal(p16, ax["sub8_points"][keep16]))
    log(f"subpixel: {model_ids[0]} trained with subpixel from "
        f"{len(views)} views in {secs:.3f} s: {len(d8)} rows after "
        f"{TRAIN_DEDUP[0]} bits / {TRAIN_DEDUP[1] * 1e3:g} mm, {len(d16)} "
        f"after {RECOMPRESS[0]} / {RECOMPRESS[1] * 1e3:g} mm; equal to the "
        f"reference's sub-pixel model at both, bit for bit: {same}; "
        f"launches {list(launches['8a train'])}; {card}")
    if not same or list(launches["8a train"]) != [0, 0, 0, 0, 2, 0, 0]:
        raise AssertionError("subpixel: the sub-pixel model differs from "
                             "the reference's, or not two B5 launches")
    # object 0 swapped for its sub-pixel model; the fillers stay copies of
    # the integer models, as in the fixture
    catalog = smoke_models(model_ids, models)
    catalog[0] = dataclasses.replace(catalog[0], descriptors=d16, points=p16)
    det = FusedDetector(catalog, cfg_sub, seed=int(ax["seed"]), device=dev)
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches["8a serve"] = read_counts()
    check_launches("subpixel", len(frames), launches["8a serve"], full=0)
    view = fixture_view(ax, "subserve", "sub_config_json")
    for f, res in enumerate(found):
        check_gated_frame(f, res, fx, view, "subserve", f, "subpixel")
    log("subpixel: served with subpixel on the catalog with the sub-pixel "
        f"{model_ids[0]}: the reference's gated detections within 1 cm and "
        f"2 degrees; phase 8a took {time.perf_counter() - phase_t0:.1f} s")
    phase_t0 = time.perf_counter()
    del det, catalog

    # ---- 8b. hot catalog updates on the frontier recipe --------------------
    sfx = np.load(STREAM_FIXTURE)
    catalog = smoke_models(model_ids, models)
    cfg_hot = dataclasses.replace(
        config(sfx, **FRONTIER), catalog_capacity=N_OBJECTS,
        reserve_rows=max(m.n_points for m in catalog))
    added = [m for m in catalog if m.object_id in HOT_ADDED]
    start = [m for m in catalog if m.object_id not in HOT_ADDED]
    det = FusedDetector(start, cfg_hot, seed=0, device=dev)
    layout = db_layout(det)
    for frame in frames:                    # streaming state to reset
        det.detect(*frame)
    for step, now in (("add", start + added),
                      ("drop", [m for m in start + added
                                if m.object_id != HOT_DROPPED])):
        swap_ms = synced_ms(lambda: det.update_models(now))
        moved = [k for k, v in db_layout(det).items() if layout[k] != v]
        fresh = FusedDetector(now, cfg_hot, seed=0, device=dev)
        fresh._key = det._key.copy()
        reset_counts()
        seen = set()
        for f in range(HOT_FRAMES):
            a = det.detect_raw(*frames[f % len(frames)])[1]
            b = fresh.detect_raw(*frames[f % len(frames)])[1]
            same = all(torch.equal(x, y) for x, y in zip(a, b)) and all(
                torch.equal(x, y) for x, y in zip(det.slab, fresh.slab))
            if not same:
                raise AssertionError(f"hot-swap: {step}: frame {f} differs "
                                     "from a fresh detector's")
            seen |= {r.object_id for r in det.poses(a)}
        counts = launches[f"8b {step}"] = read_counts()
        check_launches(f"hot-swap {step}", 2 * HOT_FRAMES, counts, full=0,
                       gathered=1)
        log(f"hot-swap: {step} ({len(now)} objects in {N_OBJECTS} slots, "
            f"reserve {cfg_hot.reserve_rows} rows): update_models "
            f"{swap_ms:.2f} ms, one upload of {det.sdb.nbytes()} + "
            f"{det.cdb.nbytes()} bytes into the same tensors (shape, dtype "
            f"and data_ptr unchanged: {not moved}); {HOT_FRAMES} frames "
            f"equal to a fresh detector's with the same key, bit for bit, "
            f"slabs too; accepted at the gate: {sorted(seen)}; {card}")
        if moved:
            raise AssertionError(f"hot-swap: {step}: {moved} moved")
        if step == "drop" and HOT_DROPPED in seen:
            raise AssertionError("hot-swap: the dropped object was found")
    del det, fresh, catalog, start, added
    torch.cuda.empty_cache()
    log(f"hot-swap: phase 8b took {time.perf_counter() - phase_t0:.1f} s")

    # ---- 8c. batched detection on the three paths ------------------------
    sx, s_ids, s_models = load_fixture(SIFT_FIXTURE)
    gx = np.load(GLOBAL_FIXTURE)
    catalog = smoke_models(model_ids, models)
    for name, cfg, cat, matcher, key in (
            ("orb full sweep", config(fx), catalog, 0, "orb"),
            ("global kNN", config(gx, GLOBAL_CONFIG), catalog, 4, "global"),
            ("sift full sweep", config(sx, SIFT_CONFIG),
             smoke_models(s_ids, s_models), 2, "sift")):
        if json.loads(str(ax[f"batch_{key}_config_json"])) != json.loads(
                json.dumps(dataclasses.asdict(cfg))):
            raise AssertionError(f"batch: {name}: config differs from the "
                                 "fixture's")
        det = FusedDetector(cat, cfg, device=dev)
        phase_t0 = time.perf_counter()
        batch_path(name, det, fx, frames, fixture_view(
            ax, f"batch_{key}", f"batch_{key}_config_json"), f"batch_{key}",
            matcher, launches, card)
        log(f"batch: {name}: phase 8c took "
            f"{time.perf_counter() - phase_t0:.1f} s")
        del det
        torch.cuda.empty_cache()


# ---- ROADMAP A13 and A15: the 2D-only path and its stage split ------------


def write_frames(root: str, fx, depthless: bool) -> str:
    """The smoke frames as .npz files in ``root`` (image, K; depth, or an
    empty depth): the directory."""
    os.makedirs(root)
    for f in range(len(fx["images"])):
        np.savez(os.path.join(root, f"frame{f}.npz"), image=fx["images"][f],
                 depth=np.zeros((0, 0)) if depthless else fx["depths"][f],
                 K=fx["K"])
    return root


def a13_reference(ax, f: int):
    """The reference graph's 2D accepts of frame ``f``: [(object id,
    instance, unique inliers, R, T)] in the graph's order."""
    rows = np.nonzero(ax["acc_frame"] == f)[0]
    return [(str(ax["acc_ids"][i]), int(ax["acc_instance"][i]),
             int(ax["acc_inliers"][i]), ax["acc_R"][i], ax["acc_T"][i])
            for i in rows]


def gt_error(fx, image: int, object_id: str, R, T) -> str:
    """The pose's error against the nearest ground-truth placement of the
    object in frame ``image``, or "no placement"."""
    errs = [pose_error(R, T, gR, gT) for oid, gR, gT in zip(
        fx["gt_ids"][image], fx["gt_R"][image], fx["gt_T"][image])
        if str(oid) == object_id]
    if not errs:
        return "no placement"
    dt, ang = min(errs)
    return f"{dt * 100:.2f} cm / {ang:.2f} deg"


def replay_2d(gg, inputs: dict, sub, dev):
    """The GuessGenerator's 2D call of one frame replayed with its key
    ``sub`` (as ``_process_2d`` makes it): (ObjectDetections, the clustered
    stores, the config, the frame's K on the card)."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.detection import cluster_matches
    from tod_tpu_torch.geometry.ransac import ThreefryNoise

    m = inputs["matches"]
    rcfg = gg._cfg.ransac
    cfg = td.Pnp2dConfig(n_hypotheses=min(rcfg.n_hypotheses, 512),
                         min_inliers=rcfg.min_inliers,
                         max_instances=rcfg.max_instances)
    valid = m.valid & np.asarray(inputs["keypoints"].valid)[:, None]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        m.obj_idx.astype(np.int32), m.dist.astype(np.float32), valid,
        np.asarray(inputs["matches_3d"], np.float32),
        np.asarray(inputs["keypoints"].xy, np.float32),
        np.asarray(inputs["K"], np.float32))]
    ids = torch.arange(len(inputs["object_ids"]), device=dev)
    max_m = gg._cfg.max_matches_per_object
    det = td.detect_frame_2d(ThreefryNoise(sub, cfg.max_instances, False,
                                           dev), *t[:5], t[5], ids, max_m,
                             cfg)
    clustered = cluster_matches(t[0], t[1], t[2], t[3],
                                torch.zeros((len(t[0]), 3), device=dev),
                                t[4], ids, max_m)
    return det, clustered, cfg, t[5]


def check_round0(ax, f: int, clustered, cfg, K, sub, dev) -> None:
    """Round 0 of every catalog object on the card against the reference's
    (``found``, ``n_unique``), and the accepted objects' round-0 triples:
    logged (equal given equal noise and graph, which f32 can move; the
    accepts are held in :func:`check_frame_2d`)."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.ransac import (ThreefryNoise,
                                               consistency_log_weights,
                                               sample_triples)

    n_obj, mcap = clustered.valid.shape
    g = ThreefryNoise(sub, cfg.max_instances, False, dev)(
        "round0", (n_obj, 3, cfg.n_hypotheses, mcap))
    found, unique = [], []
    for c in range(0, n_obj, 16):
        part = type(clustered)(*(x[c:c + 16] for x in clustered))
        out = td.ransac_round_2d(g[c:c + 16], part, K, part.valid, cfg)
        found.append(out[4])
        unique.append(out[3])
    found = torch.cat(found).cpu().numpy()
    unique = torch.cat(unique).cpu().numpy()
    r_found, r_unique = ax["round0_found"][f], ax["round0_unique"][f]
    same = (found == r_found) & (unique == r_unique)
    ids = [str(o) for o in ax["object_ids"]]
    log(f"a13: frame {f}: round 0 (found, n_unique) equal to the "
        f"reference's on {int(same.sum())} of {n_obj} objects; found "
        f"{int(found.sum())} vs {int(r_found.sum())}")
    for row in np.nonzero(ax["triples_frame"] == f)[0]:
        o = ids.index(str(ax["triples_object"][row]))
        part = type(clustered)(*(x[o:o + 1] for x in clustered))
        geom = td.pair_geometry(part)
        lo, hi = td.scale_range(K, cfg)
        adj, _ = td.sampling_graph(*geom, part.valid, lo, hi)
        logw = consistency_log_weights(adj, part.valid)
        tri, _ = sample_triples(g[o:o + 1], adj, part.valid, logw)
        got = torch.stack(tri, 1)[0].cpu().numpy()
        want = ax["triples"][row]
        log(f"a13: frame {f}: {ids[o]}: round-0 triples equal to the "
            f"reference's on {int((got == want).all(0).sum())} of "
            f"{cfg.n_hypotheses} hypotheses")


def count_at_round(det, clustered, o: int, inst: int, R, T, K, cfg) -> int:
    """The port's unique-inlier count of pose (R, T) for object ``o`` at
    round ``inst``: over its valid matches after the earlier accepted
    rounds of ``det`` invalidated their inliers' keypoints (a round's
    inliers are its pose's reprojection inliers)."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.adjacency import count_unique_query_indices

    part = type(clustered)(*(x[o:o + 1] for x in clustered))
    thr2 = cfg.pixel_error ** 2
    valid = part.valid
    yes = torch.ones(1, dtype=torch.bool, device=valid.device)

    def inliers(r, t):
        return td.count_inliers(r[None, None], t[None, None], K, part, valid,
                                thr2)[:, 0]

    for i in range(inst):
        if det.accepted[o, i]:
            valid = td.invalidate_keypoints(
                valid, part.query_idx, inliers(det.R[o, i], det.T[o, i]), yes)
    return int(count_unique_query_indices(part.query_idx, inliers(R, T))[0])


def check_frame_2d(ax, fx, f: int, res, gg, inputs: dict, sub, dev) -> list:
    """Frame ``f``'s 2D accepts through the graph (``res``) against the
    reference's: the same (object, instance) pairs (read off the replayed
    call, whose poses must be the graph's), each with the reference's
    unique-inlier count and a pose within 1 cm and 2 degrees of its pose.
    A count that differs passes when the port's own count at the
    reference's pose, over the same round's matches, is the reference's
    (the f32 rounding of the refined pose moved a match across the 4 px
    threshold). Returns the accepts that differ otherwise: (frame, object,
    instance, inliers, the reference's, cm and degrees from its pose).
    Then every object's round 0 (logged)."""
    ref = a13_reference(ax, f)
    rep, clustered, cfg, K = replay_2d(gg, inputs, sub, dev)
    acc = rep.accepted.cpu().numpy()
    pairs = [(o, i) for o in range(acc.shape[0])
             for i in range(acc.shape[1]) if acc[o, i]]
    names = [str(o) for o in inputs["object_ids"]]
    if [(names[o], i) for o, i in pairs] != [(o, i) for o, i, *_ in ref]:
        raise AssertionError(f"a13: frame {f}: (object, instance) "
                             f"{[(names[o], i) for o, i in pairs]}, the "
                             f"reference's {[(o, i) for o, i, *_ in ref]}")
    if [r.object_id for r in res] != [names[o] for o, _ in pairs] or not all(
            np.array_equal(r.R, rep.R[o, i].cpu().numpy())
            for r, (o, i) in zip(res, pairs)):
        raise AssertionError(f"a13: frame {f}: the replayed call differs "
                             "from the graph's")
    differ = []
    for r, (o, i), (oid, _, n, R, T) in zip(res, pairs, ref):
        dt, ang = pose_error(r.R, r.T, R, T)
        got = int(r.confidence)
        log(f"a13: frame {f}: {oid} instance {i}: inliers {got} (reference "
            f"{n}); {dt * 100:.4f} cm / {ang:.4f} deg from the reference's "
            f"pose; ground truth: port {gt_error(fx, f, oid, r.R, r.T)}, "
            f"reference {gt_error(fx, f, oid, R, T)}")
        same = got == n
        if not same:
            at_ref = count_at_round(
                rep, clustered, o, i, torch.from_numpy(R).to(dev),
                torch.from_numpy(T).to(dev), K, cfg)
            own = count_at_round(rep, clustered, o, i, rep.R[o, i],
                                 rep.T[o, i], K, cfg)
            log(f"a13: frame {f}: {oid} instance {i}: the port counts {own} "
                f"at its own pose and {at_ref} at the reference's")
            same = at_ref == n and own == got
        if not same or dt >= 0.01 or ang >= 2.0:
            differ.append((f, oid, i, got, n, round(dt * 100, 2),
                           round(ang, 2)))
    check_round0(ax, f, clustered, cfg, K, sub, dev)
    return differ


def host_waits(fn) -> int:
    """Synchronising calls ``fn()`` makes (torch's sync debug mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing" in str(w.message) for w in caught)


def a13_phases(dev, card: str, fx, launches: dict) -> dict:
    """Phases 9a-9b: conf/detection.ork over depthless frames through the
    port's graph (ROADMAP A13) held to tests/data/torch_a13_fixture.npz
    (tools/make_torch_a13_fixture.py), timed in turns with the depth frame;
    then one depthless frame split into stages with StageTimer and the CLI
    run once with --profile (A15). Returns B5 at the graph's radius-None
    shape: its time, bound and the bound's kind."""
    import tempfile

    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
    from tod_tpu_torch.utils import prng
    from tod_tpu_torch.utils.profiling import StageTimer

    phase_t0 = time.perf_counter()
    ax, cx = np.load(A13_FIXTURE), np.load(CELLS_FIXTURE)
    model_ids, models = load_fixture()[1:]
    n_frames = len(fx["images"])
    ork = os.path.join(ROOT, str(ax["ork"]))
    with tempfile.TemporaryDirectory() as tmp:
        db_params = write_catalog_db(tmp, model_ids, models)
        dirs = {kind: write_frames(os.path.join(tmp, kind), fx,
                                   kind == "depthless")
                for kind in ("depthless", "depth")}

        def graph(kind: str, loop: bool):
            p = build_pipeline_from_ork(ork, {
                "source1": {"path": dirs[kind], "loop": loop},
                "pipeline1": {"db": db_params, "device": str(dev)}})
            return p, Scheduler(p.plasm)

        # ---- 9a. depthless frames through conf/detection.ork -------------
        pipeline, sched = graph("depthless", False)
        det = pipeline.cells["pipeline1"]
        reset_counts()
        results, inputs = [], []
        for f in range(n_frames):
            sched.execute_iteration()
            gg = det.guess_generator
            m = gg.inputs["matches"]
            if not all(np.array_equal(getattr(m, name), cx[f"match_{name}"][f])
                       for name in ("dist", "train_idx", "obj_idx",
                                    "local_idx", "valid")):
                raise AssertionError(f"a13: frame {f}'s MatchSet differs "
                                     "from the reference's")
            if np.asarray(gg.inputs["points3d"]).size:
                raise AssertionError("a13: the depthless frame has a cloud")
            results.append(list(det.outputs["pose_results"]))
            inputs.append({k: gg.inputs[k] for k in (
                "keypoints", "matches", "matches_3d", "object_ids", "K")})
        launches["9a"] = read_counts()
        rounds = gg._cfg.ransac.max_instances
        log(f"a13: {n_frames} depthless frames, launches " + ", ".join(
            f"{name} {n}" for name, n in zip(
                [f"B{i + 1}" for i in range(5)] + ["T1", "N1"],
                launches["9a"])))
        if list(launches["9a"]) != [0, 0, 0, 0, n_frames, 0,
                                    n_frames * rounds]:
            raise AssertionError(f"a13: launches {list(launches['9a'])}, "
                                 f"expected one B5 a frame and {rounds} N1 "
                                 "(one a round)")
        key = prng.prng_key(int(gg.params["seed"]))
        differ = []
        for f, res in enumerate(results):
            key, sub = prng.split(key)
            differ += check_frame_2d(ax, fx, f, res, gg, inputs[f], sub, dev)
        known = {d[:3]: d[3:5] for d in differ if A13_GAPS.get(d[:3])
                 == d[3:5]}
        other = [d for d in differ if d[:3] not in known]
        log(f"a13: accepts off the reference's (frame, object, instance, "
            f"inliers, the reference's, cm, degrees): {differ}; the gaps of "
            f"ROADMAP queue C {sorted(A13_GAPS)}, "
            f"{len(A13_GAPS) - len(known)} of them not seen this run")
        if other:
            raise AssertionError(f"a13: accepts off the reference's beyond "
                                 f"queue C's: {other}")
        log("a13: both frames: the reference's accepted (object, instance) "
            "pairs; unique-inlier counts and poses (1 cm, 2 degrees) the "
            "reference's but for queue C's gaps; one B5 launch a frame and "
            "one N1 launch a round")

        # B5 at the graph's own shape (radius None) and its bound
        index = det.descriptor_matcher.index
        q = torch.from_numpy(np.ascontiguousarray(
            det.descriptor_matcher.inputs["descriptors"])).to(dev)
        none_ms = cuda_ms(lambda: ham.hamming_topk_fused(
            q, index.descriptors, index.n_descriptors, k=5, radius=None))
        pairs_b5 = q.shape[0] * index.n_descriptors
        none_bound = hamming_bound(pairs_b5, q.shape[0] * 32
                                   + index.n_descriptors * 32
                                   + q.shape[0] * 5 * 8)
        log(f"kernels: B5 at the graph's shape (Q={q.shape[0]} x "
            f"{index.n_descriptors} rows, k 5, radius None) {none_ms:.3f} ms "
            f"median of {KERNEL_RUNS}; bound {none_bound[0]:.3f} ms by "
            f"{none_bound[1]}; {card}")

        # time: the depthless frame in turns with the depth frame (7a)
        del pipeline, sched
        torch.cuda.empty_cache()
        loops = {kind: graph(kind, True) for kind in ("depthless", "depth")}
        for p, s in loops.values():
            s.execute_iteration()                        # warm
            p.cells["pipeline1"].scheduler.cell_times.clear()
            p.cells["pipeline1"].scheduler.n_iterations = 0
        loops = {kind: (p, Scheduler(p.plasm))
                 for kind, (p, _) in loops.items()}
        torch.cuda.reset_peak_memory_stats()
        ms = {"depthless": [], "depth": []}
        for _ in range(A13_TURNS):
            for kind, (_, s) in loops.items():
                ms[kind].append(synced_ms(s.execute_iteration))
        log(f"time: a13: conf/detection.ork depthless frame median "
            f"{np.median(ms['depthless']):.2f} ms, p95 "
            f"{np.percentile(ms['depthless'], 95):.2f} ms; the depth frame "
            f"(7a's graph) {np.median(ms['depth']):.2f} / "
            f"{np.percentile(ms['depth'], 95):.2f} ms, in turns over "
            f"{A13_TURNS} frames each; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes; {card}")
        p, s = loops["depthless"]
        for line in (s.timing_report() + "\n" + p.cells[
                "pipeline1"].scheduler.timing_report()).splitlines():
            log(f"time: a13: {line.strip()}")

        # ---- 9b. the stage split (StageTimer) and the trace (--profile) ---
        det = p.cells["pipeline1"]
        s.execute_iteration()
        gg = det.guess_generator
        n_ops, busy, wall = device_profile(s.execute_iteration)
        log(f"a13-split: one depthless graph frame: {n_ops} device "
            f"operations, device busy {busy:.2f} of {wall:.2f} ms "
            f"({100 * busy / wall:.1f} %); {card}")
        timer = StageTimer(dev)
        with timer.stage("features"):
            det.feature_descriptor.process()
        with timer.stage("matcher"):
            det.descriptor_matcher.process()
        gg.timer = timer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gg.process()
        torch.cuda.synchronize()
        guess_ms = (time.perf_counter() - t0) * 1e3
        gg.timer = None
        report = timer.report()
        log(f"a13-split: CUDA-event stages of one depthless frame (the "
            f"GuessGenerator {guess_ms:.2f} ms on the host clock, stages "
            f"sum {sum(timer.times.values()) * 1e3:.2f} ms); {card}")
        for line in report.splitlines():
            log(f"a13-split: {line.strip()}")
        _, clustered, cfg, K = replay_2d(gg, inputs[0], prng.prng_key(1),
                                         dev)
        from tod_tpu_torch.geometry import detection2d as td
        from tod_tpu_torch.geometry.ransac import ThreefryNoise
        run = slice(0, 16)
        part = type(clustered)(*(x[run] for x in clustered))
        g = ThreefryNoise(prng.prng_key(1), 1, False, dev)(
            "round0", (16, 3, cfg.n_hypotheses, part.valid.shape[1]))
        torch.cuda.synchronize()
        waits = host_waits(lambda: td.ransac_round_2d(g, part, K, part.valid,
                                                      cfg))
        log(f"a13-split: host waits inside one 2D round (16 objects): "
            f"{waits}")
        del loops, p, s, det, gg
        torch.cuda.empty_cache()

        conf = os.path.join(tmp, "detection.ork")
        with open(ork) as src, open(conf, "w") as dst:
            dst.write(src.read().replace("root: /tmp/tod_tpu_db",
                                         f"root: {db_params['root']}"))
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "tod_tpu_torch.cli", "detection", "-c",
             conf, "--frames", dirs["depthless"], "--niter", "1",
             "--profile", trace_dir], capture_output=True, text=True,
            timeout=600, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": ROOT})
        if r.returncode:
            raise AssertionError(f"a13-trace: the CLI failed: {r.stderr}")
        traces = list(Path(trace_dir).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"a13-trace: {len(traces)} trace files")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = Counter(e["name"] for e in events
                          if e.get("cat") == "kernel")
        found = {what: sum(n for name, n in kernels.items() if pat in name)
                 for what, pat in (("B5 sweep", "tc_sweep_kernel"),
                                   ("B5 merge", "merge_kernel"),
                                   ("N1", "threefry_kernel"))}
        log(f"a13-trace: python -m tod_tpu_torch.cli detection -c "
            f"conf/detection.ork (db root in a temporary copy) --frames "
            f"DIR --niter 1 --profile DIR2 in {time.perf_counter() - t0:.1f}"
            f" s: {r.stdout.strip().splitlines()[0]}; "
            f"{traces[0].stat().st_size} bytes of trace, "
            f"{sum(kernels.values())} kernel events; {found}")
        if not all(found.values()):
            raise AssertionError(f"a13-trace: the trace lacks B5 or N1: "
                                 f"{found}")
    log(f"a13: phases 9a-9b took {time.perf_counter() - phase_t0:.1f} s")
    return dict(radius_none_ms=none_ms, radius_none_bound_ms=none_bound[0],
                radius_none_bound_by=none_bound[1])


class Counted:
    """Launch counts of the sharded paths only: each ``with`` window adds
    the kernels' launches inside it (comparisons and timings run
    outside)."""

    def __init__(self):
        self.total = [0] * 7

    def __enter__(self):
        reset_counts()

    def __exit__(self, *exc):
        self.total = [a + b for a, b in zip(self.total, read_counts())]


def same_bits(a, b, what: str) -> None:
    """Every field of two ObjectDetections (or tensors) equal, NaN where
    the other has NaN, or raise."""
    pairs = (zip(a._fields, a, b) if hasattr(a, "_fields")
             else [("tensor", a, b)])
    for name, x, y in pairs:
        y = y.to(x.device)
        if x.shape != y.shape or x.dtype != y.dtype or not bool(
                ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()
                if x.is_floating_point() else torch.equal(x, y)):
            raise AssertionError(f"{what}: {name} differs")


def ordered_models(ids, models, empty):
    """The single-device catalog in a sharded DB's shard-major order."""
    from tod_tpu_torch.types import TodModel

    by_id = {m.object_id: m for m in models}
    return [TodModel("", empty, np.zeros((0, 3), np.float32))
            if i is None else by_id[i] for i in ids]


def a14_serving(dev, card: str, mesh, models, cfg, queries, n_frames: int,
                counted: Counted, what: str) -> None:
    """Phase 10b on one catalog: a ShardedServingDetector over ``mesh``
    and one FusedDetector(seed=b) a stream on the shard-major order, fed
    the same compacted queries (stream b sees ``queries[(f + b) % 2]`` at
    frame f); every field equal on every frame; then steps timed in turns
    with the single-device frames."""
    from tod_tpu_torch.models.fused import FusedDetector
    from tod_tpu_torch.parallel import ShardedServingDetector

    t0 = time.perf_counter()
    drv = ShardedServingDetector(mesh, models, cfg, seed=0)
    empty = (np.zeros((0, 128), np.float32) if cfg.feature == "SIFT"
             else np.zeros((0, 32), np.uint8))
    ordered = ordered_models(drv.object_ids, models, empty)
    refs = [FusedDetector(ordered, cfg, seed=b, device=dev)
            for b in range(drv.n_data)]
    log(f"a14 {what}: {len(models)} objects over {mesh.shape}, "
        f"{drv.sdb.nbytes()} bytes of shards; built in "
        f"{time.perf_counter() - t0:.1f} s")

    def batch(f):
        per = [queries[(f + b) % len(queries)] for b in range(drv.n_data)]
        xy, qp, dsc, ok = (torch.stack(t) for t in zip(*per))
        return xy, qp, ok, dsc

    n_acc = 0
    for f in range(n_frames):
        xy, qp, ok, dsc = batch(f)
        with counted:
            det = drv.step(xy, qp, ok, dsc)
        for b, ref in enumerate(refs):
            one = type(det)(*(x[b] for x in det))
            same_bits(one, ref.detect_compacted(xy[b], qp[b], dsc[b], ok[b]),
                      f"a14 {what}: frame {f} stream {b}")
            n_acc += len(drv.results(det, b))
    log(f"a14 {what}: {n_frames} steps x {drv.n_data} streams: every field "
        f"of every stream's detections equal to FusedDetector(seed=b)'s on "
        f"the same queries; {n_acc} gated accepts")
    step_ms, one_ms = [], []
    for f in range(A14_TURNS):
        xy, qp, ok, dsc = batch(n_frames + f)
        step_ms.append(synced_ms(lambda: drv.step(xy, qp, ok, dsc)))
        one_ms.append(synced_ms(lambda: [
            ref.detect_compacted(xy[b], qp[b], dsc[b], ok[b])
            for b, ref in enumerate(refs)]))
    log(f"time: a14 {what}: sharded step (both streams) median "
        f"{np.median(step_ms):.2f} ms, the two single-device frames "
        f"{np.median(one_ms):.2f} ms, in turns over {A14_TURNS} steps; peak "
        f"device memory {torch.cuda.max_memory_allocated()} bytes; {card}")


def a14_phases(dev, card: str, fx, frames, launches: dict) -> None:
    """Phases 10a-10f (ROADMAP A14): the sharded paths on meshes of this
    card named four times, each held bit for bit against the port's
    single-device path: 10a the matchers (B5 row-sharded, plain and ring;
    B1 and B3 object-sharded at 1000 objects), 10b ShardedServingDetector
    (B1-B4, N1), 10c detect_batch_sharded, 10d train_views_sharded, 10e
    PipelinedDetector, 10f the dry run. ``frames`` are the prepared smoke
    frames. With more than one card the matchers also run on the distinct
    cards."""
    from tod_tpu_torch.cells.trainer import (feature_settings, view_batch)
    from tod_tpu_torch.geometry.ransac import ThreefryNoise
    from tod_tpu_torch.models.fused import (FusedDetector, geom_db,
                                            match_against_db, match_full,
                                            pack_models, stage_features,
                                            stage_features_compact,
                                            stage_geometry)
    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.ops.segmented import pack_segmented
    from tod_tpu_torch.ops.segmented_l2 import pack_segmented_l2
    from tod_tpu_torch.parallel import (PipelinedDetector,
                                        detect_batch_sharded,
                                        dryrun_multichip, make_mesh,
                                        pack_segmented_l2_sharded,
                                        pack_segmented_sharded,
                                        ring_hamming_topk,
                                        sharded_hamming_topk,
                                        sharded_object_top1,
                                        train_views_sharded)
    from tod_tpu_torch.parallel.train import train_views_step
    from tod_tpu_torch.types import fixture_observations
    from tod_tpu_torch.utils import prng

    phase_t0 = time.perf_counter()
    counted = Counted()
    meshes = {shape: make_mesh(*shape, devices=[dev] * 4)
              for shape in A14_MESHES}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:     # never on a one-card machine
        meshes[("cards", n_cards)] = make_mesh(n_data=1, n_db=n_cards)
    mesh22 = meshes[(2, 2)]
    gx = np.load(GLOBAL_FIXTURE)
    _, model_ids, models = load_fixture()
    gcfg = config(gx, GLOBAL_CONFIG)
    gmodels = smoke_models(model_ids, models, N_OBJECTS)

    # ---- 10a. the matchers ------------------------------------------------
    q_g = stage_features(*frames[0], gcfg)[1]
    gdb, _ = pack_models(gmodels, gcfg.db_chunk * math.lcm(
        *(m.shape["db"] for m in meshes.values())), device=dev)
    one = lambda: ham.hamming_topk_fused(q_g, gdb.words, gdb.n_valid,  # noqa
                                         k=gcfg.k_matches, radius=gcfg.radius)
    want = one()
    one_ms = cuda_ms(one)
    for shape, mesh in meshes.items():
        for name, fn in (("sharded", sharded_hamming_topk),
                         ("ring", ring_hamming_topk)):
            run = lambda: fn(mesh, q_g, gdb.words, gdb.n_valid,  # noqa
                             k=gcfg.k_matches, chunk=gcfg.db_chunk,
                             radius=gcfg.radius)
            with counted:
                got = run()
            for a, b, field in zip(got, want, ("dist", "rows")):
                same_bits(a, b, f"a14 {name}_hamming_topk {shape} {field}")
            log(f"time: a14 {name}_hamming_topk {shape}: {cuda_ms(run):.3f}"
                f" ms median of {KERNEL_RUNS}, single-device B5 {one_ms:.3f}"
                f" ms (Q={q_g.shape[0]} x {gdb.n_valid} rows, k "
                f"{gcfg.k_matches}, radius {gcfg.radius}); dist and rows "
                f"equal; {card}")
    del gdb
    t0 = time.perf_counter()
    large = smoke_models(model_ids, models, N_LARGE, device=dev)
    sx, sift_ids, sift_arrays = load_fixture(SIFT_FIXTURE)
    sift_cfg = config(sx, SIFT_CONFIG)
    large_sift = smoke_models(sift_ids, sift_arrays, N_LARGE, device=dev)
    log(f"a14: the {N_LARGE}-object ORB and SIFT catalogs built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = config(fx)
    compacted = [stage_features_compact(*frame, cfg) for frame in frames]
    compacted_sift = [stage_features_compact(*frame, sift_cfg)
                      for frame in frames]
    for what, cat, q, pack_sh, pack_one, runs in (
            ("B1", large, compacted[0][2], pack_segmented_sharded,
             pack_segmented, KERNEL_RUNS),
            ("B3", large_sift, compacted_sift[0][2],
             pack_segmented_l2_sharded, pack_segmented_l2, 8)):
        db1 = pack_one(cat, device=dev)
        want = match_full(q, db1)
        ms1 = cuda_ms(lambda: match_full(q, db1), runs=runs)
        column = {m.object_id: i for i, m in enumerate(cat)}
        for shape, mesh in meshes.items():
            sdb, ids = pack_sh(cat, mesh)
            if None in ids:
                raise AssertionError(f"a14: {N_LARGE} objects do not fill "
                                     f"{shape}'s shards")
            with counted:
                got = sharded_object_top1(mesh, q, sdb)
            cols = torch.tensor([column[i] for i in ids], device=dev)
            for a, b, field in zip(got, want, ("dist", "rows")):
                same_bits(a, b[:, cols], f"a14 sharded_object_top1 {what} "
                          f"{shape} {field}")
            ms = cuda_ms(lambda: sharded_object_top1(mesh, q, sdb),
                         runs=runs)
            log(f"time: a14 sharded_object_top1 {what} {shape}: {ms:.3f} ms "
                f"median of {runs}, single-device {ms1:.3f} ms (Q="
                f"{q.shape[0]} x {sum(db1.rows_host)} rows, {N_LARGE} "
                f"objects, columns in shard-major order equal); {card}")
            del sdb
        del db1
        torch.cuda.empty_cache()

    # ---- 10b. ShardedServingDetector at (2 x 2) ---------------------------
    torch.cuda.reset_peak_memory_stats()
    a14_serving(dev, card, mesh22, large,
                config(np.load(STREAM_FIXTURE), **FRONTIER), compacted,
                STREAM, counted, f"ORB frontier, {STREAM} frames")
    del large
    torch.cuda.empty_cache()
    a14_serving(dev, card, mesh22, smoke_models(model_ids, models), cfg,
                compacted, A14_SWEEP_FRAMES, counted,
                "ORB full sweep (prescreen 32)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a14_serving(dev, card, mesh22, large_sift,
                config(sx, SIFT_CONFIG, "stream_config_json", **FRONTIER),
                compacted_sift,
                A14_SIFT_FRAMES, counted, "SIFT frontier")
    del large_sift, compacted_sift
    torch.cuda.empty_cache()

    # ---- 10c. detect_batch_sharded at (2 x 2) -----------------------------
    gdb, _ = pack_models(gmodels, gcfg.db_chunk * 2, device=dev)
    keys = prng.split(prng.prng_key(7), len(frames))
    grays, depths, Ks = stacked(frames, len(frames))
    with counted:
        det = detect_batch_sharded(mesh22, keys, grays, depths, Ks, gdb,
                                   gcfg)
    n_acc = 0
    for b, frame in enumerate(frames):
        kps, desc, qp = stage_features(*frame, gcfg)
        dist, rows = match_against_db(desc, gdb, gcfg)
        want = stage_geometry(
            ThreefryNoise(keys[b], gcfg.guess.ransac.max_instances, False,
                          dev), kps.xy, kps.valid, dist, rows, qp,
            geom_db(gdb), gcfg)
        same_bits(type(det)(*(x[b] for x in det)), want,
                  f"a14 detect_batch_sharded frame {b}")
        n_acc += int(want.accepted.sum())
    log(f"a14 detect_batch_sharded (2, 2): both frames' detections equal to "
        f"the single-device global path's with the same key ({n_acc} "
        "accepts)")
    del gdb

    # ---- 10d. train_views_sharded at (4 x 1) ------------------------------
    tx = np.load(TRAIN_FIXTURE)
    views = view_batch(fixture_observations(tx, 0), dev)
    settings = feature_settings(TRAIN_FEATURES)
    with counted:
        got = train_views_sharded(make_mesh(4, 1, [dev] * 4),
                                  **settings)(*views)
    for a, b, field in zip(got, train_views_step(*views, **settings),
                           ("descriptors", "world points", "valid")):
        same_bits(a, b, f"a14 train_views_sharded {field}")
    log(f"a14 train_views_sharded (4, 1): object 0's {views[0].shape[0]} "
        "views equal to train_views_step's, every output")

    # ---- 10e. PipelinedDetector on the card named three times -------------
    pipe = PipelinedDetector(gmodels, gcfg, devices=[dev] * 3, seed=0)
    single = FusedDetector(gmodels, gcfg, seed=0, device=dev)
    pipe_ms, one_ms, got = [], [], {}
    for f in range(A14_PIPE_FRAMES):
        frame = frames[f % len(frames)]
        with counted:
            pipe_ms.append(synced_ms(
                lambda: got.update(pipe=pipe.detect_raw(*frame)[1])))
        one_ms.append(synced_ms(
            lambda: got.update(one=single.detect_raw(*frame)[1])))
        same_bits(got["pipe"], got["one"], f"a14 PipelinedDetector frame {f}")
    stream = frames * (A14_PIPE_FRAMES // len(frames))
    pipe_stream_ms = synced_ms(lambda: pipe.detect_stream(stream))
    one_stream_ms = synced_ms(lambda: [single.detect_raw(*fr)
                                       for fr in stream])
    log(f"a14 PipelinedDetector([cuda:0] * 3): {A14_PIPE_FRAMES} frames, "
        f"every field equal to FusedDetector(pipeline='global')'s "
        f"detect_raw; frame median {np.median(pipe_ms):.2f} ms against "
        f"{np.median(one_ms):.2f} ms, in turns; detect_stream of "
        f"{len(stream)} frames {pipe_stream_ms:.2f} ms against "
        f"{one_stream_ms:.2f} ms for the single device's loop, in turns; "
        f"{card}")

    # ---- 10f. the dry run --------------------------------------------------
    with counted:
        shapes = dryrun_multichip(4, [dev] * 4)
    log(f"a14 dryrun_multichip(4, [cuda:0] * 4): {shapes}")

    launches["10"] = tuple(counted.total)
    names = [f"B{i + 1}" for i in range(5)] + ["T1", "N1"]
    log("a14: launches of the sharded paths " + ", ".join(
        f"{name} {n}" for name, n in zip(names, counted.total)))
    missing = [name for name, n in zip(names, counted.total)
               if n == 0 and name != "T1"]
    if missing:
        raise AssertionError(f"a14: the sharded paths never launched "
                             f"{missing}")
    log(f"a14: phases 10a-10f took {time.perf_counter() - phase_t0:.1f} s")


# ---- phase 11: reference-era data, visualize, the user tools ----------------


def couch_server(store: dict):
    """An in-process server of the CouchDB dialect the port's CouchDb and
    migrate speak (PUT /db, GET|PUT|DELETE /db/doc, GET|PUT
    /db/doc/attachment, GET /db/_all_docs) over ``store``: {db: {doc id:
    {"fields", "rev", "atts": {name: bytes}}}}, on 127.0.0.1. Returns the
    server (``shutdown`` it) and its URL."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, body=b"{}", ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _parts(self):
            return [p for p in self.path.partition("?")[0].split("/") if p]

        def do_PUT(self):
            parts = self._parts()
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            if len(parts) == 1:
                if parts[0] in store:
                    return self._send(412, b'{"error":"file_exists"}')
                store[parts[0]] = {}
                return self._send(201, b'{"ok":true}')
            doc = store[parts[0]].setdefault(parts[1], {"rev": 0,
                                                        "atts": {}})
            if len(parts) == 2:
                fields = json.loads(body)
                fields.pop("_rev", None)
                doc["fields"] = fields
            else:
                doc["atts"][parts[2]] = body
            doc["rev"] += 1
            self._send(201, json.dumps({"ok": True, "id": parts[1],
                                        "rev": f"{doc['rev']}-x"}).encode())

        def do_GET(self):
            parts = self._parts()
            if parts[1:] == ["_all_docs"]:
                rows = [{"id": d} for d in sorted(store.get(parts[0], {}))]
                return self._send(200, json.dumps({"rows": rows}).encode())
            doc = store.get(parts[0], {}).get(parts[1])
            if doc is None:
                return self._send(404, b'{"error":"not_found"}')
            if len(parts) == 3:
                return self._send(200, doc["atts"][parts[2]],
                                  "application/octet-stream")
            out = dict(doc["fields"], _id=parts[1], _rev=f"{doc['rev']}-x")
            if doc["atts"]:
                out["_attachments"] = {n: {"stub": True} for n in doc["atts"]}
            self._send(200, json.dumps(out).encode())

        def do_DELETE(self):
            parts = self._parts()
            store.get(parts[0], {}).pop(parts[1], None)
            self._send(200, b'{"ok":true}')

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def digest(array: np.ndarray) -> str:
    """tools/make_torch_legacy_fixture.py's digest of an array."""
    import hashlib

    a = np.ascontiguousarray(array)
    return hashlib.sha256(str((a.dtype.str, a.shape)).encode()
                          + a.tobytes()).hexdigest()


def same_array(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape \
            or not np.array_equal(got, want):
        raise AssertionError(f"{what}: {got.dtype}{got.shape} differs from "
                             f"{want.dtype}{want.shape}")


def same_poses(got, want, what: str) -> None:
    """Every field of two lists of PoseResults, bit for bit."""
    if [(r.object_id, r.confidence) for r in got] != \
            [(r.object_id, r.confidence) for r in want]:
        raise AssertionError(f"{what}: accepted {[r.object_id for r in got]}"
                             f" against {[r.object_id for r in want]}")
    for a, b in zip(got, want):
        same_array(a.R, b.R, f"{what}: {a.object_id}'s R")
        same_array(a.T, b.T, f"{what}: {a.object_id}'s T")


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured (the script's own
    output keeps its last lines for the kernels and ok lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def legacy_blobs(lx) -> dict:
    """The fixture's dump: {doc id: (fields, {name: blob})}."""
    index, data = json.loads(str(lx["dump_json"])), lx["dump_blobs"]
    return {doc_id: (entry["fields"], {
        name: data[a:b].tobytes() for name, (a, b) in entry["blobs"].items()})
        for doc_id, entry in index.items()}


def run_graph(ork: str, over: dict, n: int = 1):
    """A .ork graph run for ``n`` iterations: each detection's pose
    results (None for a trainer), the pipeline and its scheduler."""
    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork

    pipeline = build_pipeline_from_ork(os.path.join(ROOT, ork), over)
    sched = Scheduler(pipeline.plasm)
    outs = pipeline.cells["pipeline1"].outputs
    out = []
    for _ in range(n):
        sched.execute_iteration()
        out.append(list(outs["pose_results"])
                   if "pose_results" in outs.keys() else None)
    return out, pipeline, sched


def legacy_phases(dev, card: str, fx, launches: dict) -> None:
    """Phases 11a-11c: reference-era data (db/legacy.py, db/migrate.py)
    held to tests/data/torch_legacy_fixture.npz
    (tools/make_torch_legacy_fixture.py), the visualize overlays and PNGs,
    and the view command."""
    import tempfile

    from tod_tpu_torch import cli
    from tod_tpu_torch.cells.trainer import (feature_settings, train_views,
                                             write_view_pngs)
    from tod_tpu_torch.cells.types import PoseResult
    from tod_tpu_torch.db import (Document, FilesystemDb, ObjectDbParameters,
                                  insert_observation,
                                  load_models_for_objects,
                                  observations_for_object)
    from tod_tpu_torch.db.legacy import decode_legacy_mat
    from tod_tpu_torch.types import fixture_observations
    from tod_tpu_torch.utils import png
    from tod_tpu_torch.utils import visualize as viz

    phase_t0 = time.perf_counter()
    lx, cx, tx = (np.load(p) for p in (LEGACY_FIXTURE, CELLS_FIXTURE,
                                       TRAIN_FIXTURE))
    model_ids, models = load_fixture()[1:]
    oid = str(lx["object_id"])
    blobs = legacy_blobs(lx)
    views = {o.frame_number: o for o in fixture_observations(tx, 0)}
    views = [views[int(f)] for f in lx["view_frames"]]

    # ---- 11a. decoding: every blob against its npy counterpart -----------
    desc, pts = models[0]
    model_blobs = blobs["model_obj0"][1]
    t0 = time.perf_counter()
    got_desc = decode_legacy_mat(model_blobs["descriptors"])
    got_pts = decode_legacy_mat(model_blobs["points"])
    decode_ms = (time.perf_counter() - t0) * 1e3
    same_array(got_desc, desc, "legacy: YAML descriptors")
    same_array(got_pts, pts.reshape(1, -1, 3), "legacy: YAML points")
    same_array(decode_legacy_mat(lx["desc_xml"].tobytes()), desc,
               "legacy: XML descriptors")
    same_array(decode_legacy_mat(lx["points_xml"].tobytes()),
               pts.reshape(1, -1, 3), "legacy: XML points")
    same_array(decode_legacy_mat(lx["points_raw"].tobytes()), pts,
               "legacy: raw-header points")
    for v, view in enumerate(views):
        _, atts = blobs[f"obs_{v:03d}"]
        for name, want in (("image", view.image), ("depth", view.depth),
                           ("mask", view.mask),
                           ("K", np.float64(view.K)), ("R", np.float64(
                               view.R)), ("T", np.float64(view.T)[None])):
            same_array(decode_legacy_mat(atts[name]), want,
                       f"legacy: view {v}'s {name}")
    log(f"legacy: {oid}'s model ({len(desc)} rows) from zlib FileStorage "
        f"YAML decoded in {decode_ms:.1f} ms on the host; the YAML, XML and "
        f"raw-header blobs and {len(views)} views' PNG image/depth/mask and "
        f"YAML K/R/T equal to their npy counterparts bit for bit; {card}")

    server = None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # ---- 11a. migrate: the reference tool's documents ------------
            dump = os.path.join(tmp, "dump")
            for doc_id, (fields, atts) in blobs.items():
                os.makedirs(os.path.join(dump, doc_id))
                with open(os.path.join(dump, doc_id, "doc.json"), "w") as f:
                    json.dump(fields, f)
                for name, blob in atts.items():
                    with open(os.path.join(dump, doc_id, name), "wb") as f:
                        f.write(blob)
            migrated = {"type": "filesystem", "root": os.path.join(tmp, "mig"),
                        "collection": "object_recognition"}
            _, out = quiet(cli.main, ["migrate", "--src", dump, "--dst",
                                      json.dumps(migrated)])
            if json.loads(out) != json.loads(str(lx["migrate_stats"])):
                raise AssertionError(f"migrate: stats {out.strip()}")
            mdb = FilesystemDb(migrated["root"], migrated["collection"])
            got = {doc_id: {"fields": mdb.load(doc_id).fields,
                            "attachments": {
                                name: {"dtype": a.dtype.str,
                                       "shape": list(a.shape),
                                       "sha256": digest(a)}
                                for name, a in sorted(
                                    mdb.load(doc_id).attachments.items())}}
                   for doc_id in sorted(mdb.all_ids())}
            if got != json.loads(str(lx["migrated_json"])):
                raise AssertionError("migrate: the documents differ from "
                                     "tools/migrate_db.py's")
            log(f"migrate: {out.strip()}: every document's fields and npy "
                "attachments equal to tools/migrate_db.py's output")

            # ---- 11a. detection over a CouchDB with obj000 in legacy form --
            npy = write_catalog_db(tmp, model_ids, models)
            fdb = FilesystemDb(npy["root"], npy["collection"])
            store = {npy["collection"]: {}}
            for doc_id in fdb.all_ids():
                doc = fdb.load(doc_id)
                atts = {name: Document.encode_array(a)
                        for name, a in doc.attachments.items()}
                if doc.fields["object_id"] == oid:
                    atts = dict(model_blobs)
                store[npy["collection"]][doc_id] = {
                    "fields": doc.fields, "rev": 1, "atts": atts}
            store["train"] = {
                doc_id: {"fields": fields, "rev": 1, "atts": dict(atts)}
                for doc_id, (fields, atts) in blobs.items()
                if fields["Type"] == "Observation"}
            server, url = couch_server(store)
            couch = {"type": "CouchDB", "root": url,
                     "collection": npy["collection"]}
            frame_dir = write_frames(os.path.join(tmp, "frames"), fx, False)
            ork = "conf/detection.ork"
            over = {"source1": {"path": frame_dir, "loop": False}}
            results = {}
            for kind, params in (("npy", npy), ("legacy", couch)):
                reset_counts()
                res, pipeline, _ = run_graph(ork, {**over, "pipeline1": {
                    "db": params, "device": str(dev)}})
                launches[f"11a-{kind}"] = read_counts()
                check_launches(f"{kind}-detect", 1, launches[f"11a-{kind}"],
                               full=4)
                det = pipeline.cells["pipeline1"]
                results[kind] = (res[0], det.descriptor_matcher.outputs[
                    "matches"])
                del pipeline, det
            (res_l, m_l), (res_n, m_n) = results["legacy"], results["npy"]
            for name in ("dist", "train_idx", "obj_idx", "local_idx",
                         "valid"):
                same_array(getattr(m_l, name), getattr(m_n, name),
                           f"legacy-detect: MatchSet {name}")
            same_poses(res_l, res_n, "legacy-detect")
            log(f"legacy-detect: {ork} over a CouchDB with {oid} as FileStorage "
                f"YAML: frame 0's MatchSet and {len(res_l)} accepts equal to "
                "the npy DB's graph bit for bit")

            # ---- 11a. training from the legacy observations ---------------
            train_npy = {"type": "filesystem",
                         "root": os.path.join(tmp, "train"),
                         "collection": "train"}
            tdb = FilesystemDb(train_npy["root"], train_npy["collection"])
            for view in views:
                insert_observation(tdb, oid, view.frame_number, view.image,
                                   view.depth, view.mask, view.K, view.R,
                                   view.T)
            trained = {}
            reset_counts()
            for kind, params in (("npy", train_npy), ("legacy", dict(
                    couch, collection="train"))):
                run_graph("conf/training.ork", {"pipeline1": {
                    "db": params, "feature": TRAIN_FEATURES, "object_id": oid,
                    "device": str(dev), "dedup_hamming": TRAIN_DEDUP[0],
                    "dedup_point_m": TRAIN_DEDUP[1]}})
                trained[kind] = load_models_for_objects(
                    ObjectDbParameters(params).generate_db(), [oid])[0]
            launches["11a-train"] = read_counts()
            same_array(trained["legacy"].descriptors,
                       trained["npy"].descriptors, "legacy-train: descriptors")
            same_array(trained["legacy"].points, trained["npy"].points,
                       "legacy-train: points")
            if list(launches["11a-train"]) != [0, 0, 0, 0, 2, 0, 0]:
                raise AssertionError(f"legacy-train: launches "
                                     f"{list(launches['11a-train'])}, "
                                     "expected two B5")
            log(f"legacy-train: conf/training.ork's TodTrainer over {oid}'s "
                f"{len(views)} legacy observations (PNG, YAML) from the "
                f"CouchDB: {trained['legacy'].n_points} rows, equal to the "
                "model trained over the npy observations bit for bit; one "
                "B5 launch each")
            server.shutdown()
            server = None

            # ---- 11b. the drawing functions against the reference's ------
            K = np.asarray(fx["K"], np.float64)
            write_ms = []
            for f in range(len(fx["images"])):
                image = fx["images"][f]
                xy, valid = lx["kp_xy"][f], lx["kp_valid"][f]
                poses = [PoseResult(R=cx["ref_R"][i], T=cx["ref_T"][i],
                                    object_id=str(cx["ref_ids"][i]),
                                    confidence=float(cx["ref_inliers"][i]))
                         for i in np.nonzero(cx["ref_frame"] == f)[0]]
                drawn = viz.draw_detections(
                    viz.draw_keypoints(image, xy[valid]), K, poses)
                mvalid, obj = cx["match_valid"][f], cx["match_obj_idx"][f]
                flat = mvalid.any(axis=1) & valid
                clusters = viz.draw_clusters(
                    image, xy[flat], np.where(mvalid, obj, -1).max(axis=1)[
                        flat])
                for what, img, want in (("poses", drawn, lx["pose_sha"][f]),
                                        ("clusters", clusters,
                                         lx["cluster_sha"][f])):
                    if digest(img) != str(want):
                        raise AssertionError(f"viz: frame {f}'s {what} "
                                             "overlay differs from cv2's")
                    t0 = time.perf_counter()
                    png.write_png(os.path.join(tmp, f"{what}{f}.png"), img)
                    write_ms.append((time.perf_counter() - t0) * 1e3)
                    same_array(png.read_png(os.path.join(
                        tmp, f"{what}{f}.png")), img, f"viz: {what} PNG")
            log(f"viz: both frames' PoseDrawer and cluster overlays equal to "
                f"the reference's (cv2) bit for bit; PNG write of each "
                f"640x480 overlay " + ", ".join(f"{ms:.1f}" for ms in write_ms)
                + f" ms on the host; {card}")

            # ---- 11b. the graphs with visualize ---------------------------
            prefix = os.path.join(tmp, "viz_cells")
            reset_counts()
            res, pipeline, _ = run_graph(ork, {**over, "pipeline1": {
                "db": npy, "device": str(dev), "visualize": prefix}})
            launches["11b-cells"] = read_counts()
            check_launches("viz-cells", 1, launches["11b-cells"], full=4)
            same_poses(res[0], res_n, "viz-cells: against no visualize")
            det = pipeline.cells["pipeline1"]
            check_drawer(det.pose_drawer, res[0], prefix, "viz-cells")
            gg = det.guess_generator.inputs
            kxy = np.asarray(gg["keypoints"].xy, np.float32)
            flat = gg["matches"].valid.any(axis=1) & np.asarray(
                gg["keypoints"].valid)
            want = viz.draw_clusters(gg["image"], kxy[flat], np.where(
                gg["matches"].valid, gg["matches"].obj_idx, -1).max(axis=1)[
                    flat])
            same_array(png.read_png(prefix + "_clusters_0001.png"), want,
                       "viz-cells: cluster PNG")
            del pipeline, det, gg

            serving = "conf/detection.serving.ork"
            plain, p_plain, s_plain = run_graph(serving, {
                "source1": {"path": frame_dir, "loop": True},
                "pipeline1": {"db": npy, "device": str(dev)}})
            prefix = os.path.join(tmp, "viz_serving")
            reset_counts()
            seen, p_viz, s_viz = run_graph(serving, {
                "source1": {"path": frame_dir, "loop": True},
                "pipeline1": {"db": npy, "device": str(dev),
                              "visualize": prefix}})
            launches["11b-serving"] = read_counts()
            check_launches("viz-serving", 1, launches["11b-serving"], full=0)
            same_poses(seen[0], plain[0], "viz-serving: against no visualize")
            check_drawer(p_viz.cells["pipeline1"].pose_drawer, seen[0],
                         prefix, "viz-serving")
            times = {"with": [], "without": []}
            for _ in range(VIZ_TURNS):
                for kind, sched in (("without", s_plain), ("with", s_viz)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sched.execute_iteration()
                    times[kind].append((time.perf_counter() - t0) * 1e3)
            log(f"time: {serving}: a frame with visualize median "
                f"{np.median(times['with']):.2f} ms, without "
                f"{np.median(times['without']):.2f} ms, in turns over "
                f"{VIZ_TURNS} frames each; {card}")
            del p_plain, p_viz, s_plain, s_viz

            sift = "conf/detection.sift.serving.ork"
            s_ids, s_models = load_fixture(SIFT_FIXTURE)[1:]
            sift_db = write_catalog_db(tmp, s_ids, s_models, "db_sift")
            sift_over = {"source1": {"path": frame_dir, "loop": False},
                         "pipeline1": {"db": sift_db, "device": str(dev)}}
            plain = run_graph(sift, sift_over)[0]
            prefix = os.path.join(tmp, "viz_sift")
            reset_counts()
            seen, p_viz, _ = run_graph(sift, {**sift_over, "pipeline1": {
                **sift_over["pipeline1"], "visualize": prefix}})
            launches["11b-sift"] = read_counts()
            check_launches("viz-sift", 1, launches["11b-sift"], full=2)
            same_poses(seen[0], plain[0], "viz-sift: against no visualize")
            check_drawer(p_viz.cells["pipeline1"].pose_drawer, seen[0],
                         prefix, "viz-sift")
            del p_viz

            prefix = os.path.join(tmp, "viz_train")
            reset_counts()
            run_graph("conf/training.ork", {"pipeline1": {
                "db": train_npy, "feature": TRAIN_FEATURES, "object_id": oid,
                "device": str(dev), "dedup_hamming": TRAIN_DEDUP[0],
                "dedup_point_m": TRAIN_DEDUP[1], "visualize": prefix}})
            launches["11b-train"] = read_counts()
            (model,) = load_models_for_objects(tdb, [oid])
            same_array(model.descriptors, trained["npy"].descriptors,
                       "viz-train: against no visualize")
            same_array(model.points, trained["npy"].points,
                       "viz-train: against no visualize")
            group = observations_for_object(tdb, oid)
            _, world, valid = train_views(group, feature_settings(
                TRAIN_FEATURES), dev)
            write_view_pngs(os.path.join(tmp, "again"), oid, group, world,
                            valid)
            for v in range(len(group)):
                name = f"_{oid}_v{v:02d}.png"
                same_array(png.read_png(prefix + name),
                           png.read_png(os.path.join(tmp, "again") + name),
                           f"viz-train: view {v}'s PNG")
            log(f"viz: conf/detection.ork, {serving}, {sift} and "
                "conf/training.ork with visualize: the PNGs of every frame "
                "and view written "
                "and equal to the port's drawing of that frame's outputs; "
                "detections and the model equal to the graphs' without "
                "visualize, bit for bit")

            # ---- 11c. the view command -------------------------------------
            db_json = json.dumps(migrated)
            code, out = quiet(cli.main, ["view", oid, "--db", db_json])
            if code != 0 or out != str(lx["view_text"]):
                raise AssertionError(f"view: printed {out!r}")
            try:
                code, out = quiet(cli.main, ["view", oid, "--db", db_json,
                                             "--png", os.path.join(
                                                 tmp, "view.png")])
                png_note = "--png wrote a figure (matplotlib installed)"
                if not os.path.exists(os.path.join(tmp, "view.png")):
                    raise AssertionError("view --png wrote no figure")
            except SystemExit as err:
                if "matplotlib" not in str(err):
                    raise
                png_note = f"--png stops naming matplotlib: {err}"
            log(f"view: {oid} on the migrated DB prints the reference's "
                f"text; {png_note}")
        finally:
            if server is not None:
                server.shutdown()
    log(f"legacy: phase 11 took {time.perf_counter() - phase_t0:.1f} s")


def check_drawer(drawer, results, prefix: str, what: str) -> None:
    """The PoseDrawer's PNG of the graph's first frame: its image_out,
    equal to the drawing functions over the drawer's inputs."""
    from tod_tpu_torch.utils import png
    from tod_tpu_torch.utils import visualize as viz

    ins = drawer.inputs
    want = ins["image"]
    if ins["keypoints"] is not None:
        kps = ins["keypoints"]
        want = viz.draw_keypoints(want, np.asarray(kps.xy)[np.asarray(
            kps.valid)])
    want = viz.draw_detections(want, np.asarray(ins["K_image"], np.float64),
                               results)
    same_array(drawer.outputs["image_out"], want, f"{what}: image_out")
    same_array(png.read_png(prefix + "_poses_0001.png")[..., ::-1], want,
               f"{what}: pose PNG")


def sift_graph_phase(dev, card: str, fx, launches: dict) -> None:
    """Phase 7e: conf/detection.ork with SIFT features on the card (the
    L2 matcher ``ops/matching.py l2_topk``, queue C's probe), against the
    reference graph's MatchSets and accepts."""
    import tempfile

    from tod_tpu_torch.db import FilesystemDb, write_model
    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork

    jx = np.load(JPEG_FIXTURE)
    meta = json.loads(str(jx["sift_graph_json"]))
    s_ids, s_models = load_fixture(SIFT_FIXTURE)[1:]
    ref = {"ref_" + k[len("sift_graph_"):]: jx[k] for k in jx.files
           if k.startswith("sift_graph_")}
    with tempfile.TemporaryDirectory() as tmp:
        params = {"type": "filesystem", "root": os.path.join(tmp, "db")}
        db = FilesystemDb(params["root"])
        for oid, (desc, pts) in zip(s_ids, s_models):
            write_model(db, oid, desc.astype(np.float32) / 256.0, pts)
        frame_dir = write_frames(os.path.join(tmp, "frames"), fx, False)
        pipeline = build_pipeline_from_ork(
            os.path.join(ROOT, "conf", "detection.ork"),
            {"source1": {"path": frame_dir, "loop": False},
             "pipeline1": {"db": params, "device": str(dev),
                           **meta["settings"]}})
        sched = Scheduler(pipeline.plasm)
        det = pipeline.cells["pipeline1"]
        reset_counts()
        results = []
        for f in range(len(fx["images"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.execute_iteration()
            secs = time.perf_counter() - t0
            m = det.descriptor_matcher.outputs["matches"]
            swapped = int((m.train_idx != ref["ref_train_idx"][f])
                          .any(axis=1).sum())
            same = swapped == 0 and all((
                np.array_equal(m.valid, ref["ref_valid"][f]),
                digest(m.obj_idx) == meta["obj_idx"][f],
                digest(m.local_idx) == meta["local_idx"][f]))
            gap = float(np.abs(np.float64(m.dist) ** 2 - np.float64(
                ref["ref_dist"][f]) ** 2).max())
            rel = np.abs(m.dist - ref["ref_dist"][f]) / np.maximum(
                ref["ref_dist"][f], 1e-30)
            log(f"sift-graph: frame {f}: {m.dist.shape[0]} queries x k "
                f"{m.k}, {int(m.valid.sum())} in radius; query rows whose "
                f"matched rows differ from the reference's: {swapped}; the "
                f"rest of the MatchSet equal: {same}; squared distances "
                f"within {gap:.3g} (bound {SIFT_GRAPH_SQ_ATOL:.3g}), "
                f"{int((rel > 1e-5).sum())} distances past 1e-5 relative "
                f"(max {float(rel.max()):.3g}); {secs:.2f} s; {card}")
            if swapped > SIFT_GRAPH_ROW_SWAPS or not same \
                    or gap > SIFT_GRAPH_SQ_ATOL:
                raise AssertionError(f"sift-graph: frame {f}'s MatchSet "
                                     "differs from the reference's")
            results.append(list(det.outputs["pose_results"]))
        launches["7e"] = read_counts()
        check_launches("sift-graph", len(results), launches["7e"], full=None)
        for f, res in enumerate(results):
            check_frame(f, res, fx, ref, what="sift-graph")
        log("sift-graph: conf/detection.ork with SIFT on the card: every "
            "placement within 2 cm; the reference's accepts (every "
            "instance) at its poses within 1 cm and 2 degrees")
        del pipeline, sched, det


# ---- the last cv2 users: JPEG (A12g) and the synthetic renderer -----------

def bench_object(syn, i: int):
    """bench.py make_obj (BENCH_SHAPES=mixed, bench.py:120-138): a plane,
    a box and a cylinder in turn."""
    oid = f"obj{i:03d}"
    if i % 3 == 0:
        return syn.SyntheticObject.make(oid, seed=100 + i)
    if i % 3 == 1:
        return syn.SyntheticBox.make(oid, seed=100 + i,
                                     size_m=(0.2, 0.15, 0.1))
    return syn.SyntheticCylinder.make(oid, seed=100 + i, radius_m=0.08,
                                      height_m=0.2)


def bench_views(syn, obj, plan: dict):
    """The bench's capture plan (bench.build_db; the train fixture's
    ``train_dist`` / ``train_elev``): rings of 12 at the first distance,
    one ring at 60 degrees for each further one, by frame number."""
    dists = [float(v) for v in plan["train_dist"].split(",")]
    elevs = tuple(float(v) for v in plan["train_elev"].split(","))
    views = list(syn.turntable_observations(obj, n_views=12,
                                            elevations_deg=elevs,
                                            distance=dists[0]))
    for extra in dists[1:]:
        ring = syn.turntable_observations(obj, n_views=12,
                                          elevations_deg=(60.0,),
                                          distance=extra)
        for o in ring:
            o["frame_number"] += len(views)
        views += ring
    return sorted(views, key=lambda o: o["frame_number"])


def bench_scenes(syn, objects, n_scenes: int):
    """bench.py build_scenes (clean): three objects a scene at z 0.75,
    0.9 and 1.05, x -0.22, 0.02 and 0.24, poses from rng 7."""
    rng = np.random.default_rng(7)
    scenes = []
    for s in range(n_scenes):
        trio = [objects[(3 * s + j) % len(objects)] for j in range(3)]
        poses = [syn.facing_pose(rng, z=z)
                 if isinstance(o, syn.SyntheticObject)
                 else syn.presenting_pose(rng, z=z)
                 for o, z in zip(trio, (0.75, 0.9, 1.05))]
        poses[0][1][0] = -0.22
        poses[1][1][0] = 0.02
        poses[2][1][0] = 0.24
        scenes.append(syn.compose_scene(trio, poses))
    return scenes


def blobs_of(data: np.ndarray, offsets: np.ndarray):
    return [data[a:b].tobytes() for a, b in zip(offsets[:-1], offsets[1:])]


def jpeg_phases(dev, card: str, fx, jx, launches: dict) -> None:
    """Phase 12a: the JPEG decoder against cv2's pixels, ``cli ingest`` of
    a JPEG recording, its frame through conf/detection.ork, and training
    from JPEG attachments of a legacy CouchDB."""
    import shutil
    import tempfile

    from tod_tpu_torch import cli
    from tod_tpu_torch.db import ObjectDbParameters, load_models_for_objects
    from tod_tpu_torch.utils.jpeg import decode_jpeg

    model_ids, models = load_fixture()[1:]
    names = [str(n) for n in jx["case_names"]]
    vga = []
    for i, (name, data) in enumerate(zip(names, blobs_of(
            jx["case_blob"], jx["case_offsets"]))):
        for key, color in (("unchanged", False), ("color", True)):
            t0 = time.perf_counter()
            px = decode_jpeg(data, color=color)
            ms = (time.perf_counter() - t0) * 1e3
            if f"case{i}_{key}" in jx.files:
                same_array(px, jx[f"case{i}_{key}"], f"jpeg: {name} ({key})")
            elif digest(px) != str(jx[f"case{i}_{key}_sha"]):
                raise AssertionError(f"jpeg: {name} ({key}) differs from "
                                     "cv2's pixels")
            else:
                vga.append(f"{name} ({key}) {ms:.0f} ms")
    log(f"jpeg: {len(names)} files decoded equal to cv2's pixels under "
        f"IMREAD_UNCHANGED and IMREAD_COLOR; host decode of a 480x640 "
        f"frame: {'; '.join(vga)}; {card}")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rec")
        os.makedirs(src)
        n_rec = sum(1 for k in jx.files if k.startswith("rec_color"))
        for f in range(n_rec):
            for name, key in ((f"color_{f:04d}.jpg", f"rec_color{f}"),
                              (f"depth_{f:04d}.png", f"rec_depth{f}")):
                with open(os.path.join(src, name), "wb") as fh:
                    fh.write(jx[key].tobytes())
        frames_dir = os.path.join(tmp, "frames")
        t0 = time.perf_counter()
        _, text = quiet(cli.main, ["ingest", "--format", "pairs",
                                   "--rgb-glob", "color_*.jpg",
                                   "--depth-glob", "depth_*.png", src,
                                   frames_dir])
        ingest_s = time.perf_counter() - t0
        got = {}
        for name in sorted(os.listdir(frames_dir)):
            with np.load(os.path.join(frames_dir, name)) as z:
                got[name] = {k: digest(z[k]) for k in sorted(z.files)}
        if got != json.loads(str(jx["rec_frames_json"])):
            raise AssertionError("ingest: the frames differ from "
                                 "tools/ingest_frames.py's")
        log(f"ingest: {text.strip()}: a {n_rec}-frame pairs recording (JPEG "
            f"colour, PNG depth) in {ingest_s:.2f} s on the host; every "
            "array equal to tools/ingest_frames.py's (cv2)")

        one = os.path.join(tmp, "one")
        os.makedirs(one)
        first = sorted(os.listdir(frames_dir))[0]
        shutil.copy(os.path.join(frames_dir, first), one)
        npy = write_catalog_db(tmp, model_ids, models)
        reset_counts()
        res, pipeline, _ = run_graph("conf/detection.ork", {
            "source1": {"path": one, "loop": False},
            "pipeline1": {"db": npy, "device": str(dev)}})
        launches["12a-detect"] = read_counts()
        check_launches("jpeg-detect", 1, launches["12a-detect"], full=4)
        m = pipeline.cells["pipeline1"].descriptor_matcher.outputs["matches"]
        want = json.loads(str(jx["rec_match_json"]))
        for name, sha in want.items():
            if digest(getattr(m, name)) != sha:
                raise AssertionError(f"jpeg-detect: MatchSet {name} differs "
                                     "from the reference graph's")
        ref = {k[len("rec_"):]: jx[k] for k in jx.files
               if k.startswith("rec_ref_")}
        check_frame(0, res[0], fx, ref, image=0, what="jpeg-detect")
        log(f"jpeg-detect: conf/detection.ork over the ingested JPEG frame: "
            f"MatchSet ({int(m.valid.sum())} in radius) equal to the "
            "reference graph's; its accepts at the reference's poses")
        del pipeline, m

        lx = np.load(LEGACY_FIXTURE)
        oid = str(lx["object_id"])
        jpegs = dict(zip((int(f) for f in jx["train_frames"]),
                         blobs_of(jx["train_jpeg"], jx["train_offsets"])))
        store = {"train": {}}
        for doc_id, (fields, atts) in legacy_blobs(lx).items():
            if fields["Type"] == "Observation":
                store["train"][doc_id] = {"fields": fields, "rev": 1,
                                          "atts": {**atts, "image": jpegs[
                                              int(fields["frame_number"])]}}
        server, url = couch_server(store)
        try:
            params = {"type": "CouchDB", "root": url, "collection": "train"}
            reset_counts()
            t0 = time.perf_counter()
            run_graph("conf/training.ork", {"pipeline1": {
                "db": params, "feature": TRAIN_FEATURES, "object_id": oid,
                "device": str(dev), "dedup_hamming": TRAIN_DEDUP[0],
                "dedup_point_m": TRAIN_DEDUP[1]}})
            train_s = time.perf_counter() - t0
            (model,) = load_models_for_objects(
                ObjectDbParameters(params).generate_db(), [oid])
        finally:
            server.shutdown()
        launches["12a-train"] = read_counts()
        got = {"rows": int(len(model.descriptors)),
               "descriptors": digest(model.descriptors),
               "points": digest(np.asarray(model.points, np.float32)
                                .reshape(-1, 3))}
        if got != json.loads(str(jx["train_model_json"])):
            raise AssertionError(f"jpeg-train: the model {got} differs from "
                                 "the reference's")
        if list(launches["12a-train"]) != [0, 0, 0, 0, 1, 0, 0]:
            raise AssertionError(f"jpeg-train: launches "
                                 f"{list(launches['12a-train'])}, expected "
                                 "one B5")
        log(f"jpeg-train: conf/training.ork over {oid}'s {len(jpegs)} views "
            f"as JPEG attachments of a CouchDB: {got['rows']} rows, equal to "
            f"the model the reference trains from cv2's pixels; one B5 "
            f"launch; {train_s:.2f} s; {card}")


def rendered_phases(dev, card: str, fx, jx, found4, launches: dict) -> None:
    """Phase 12b: the bench's workload rendered on the host by the port's
    renderer, trained and served on the card, each step held to the
    reference's."""
    from tod_tpu_torch.cells.trainer import fill_model, train_object
    from tod_tpu_torch.models.fused import FusedDetector
    from tod_tpu_torch.ops.compress import compress_model
    from tod_tpu_torch.types import Observation
    from tod_tpu_torch.utils import synthetic as syn

    tx = np.load(TRAIN_FIXTURE)
    plan = json.loads(str(tx["config_json"]))
    model_ids = [str(s) for s in fx["model_ids"]]
    t0 = time.perf_counter()
    objects = [bench_object(syn, i) for i in range(len(model_ids))]
    texture_s = time.perf_counter() - t0
    render_ms, train_s, trained = [], [], []
    for i, obj in enumerate(objects):
        t0 = time.perf_counter()
        views = bench_views(syn, obj, plan)
        render_ms.append((time.perf_counter() - t0) * 1e3 / len(views))
        masks = np.unpackbits(tx[f"mask{i}"], axis=-1, count=640,
                              bitorder="little").astype(bool)
        for v, o in enumerate(views):
            img = o["image"]
            if not (img == img[..., :1]).all():
                raise AssertionError(f"render: {obj.object_id} view {v} is "
                                     "not gray")
            same_array(img[..., 0], tx[f"gray{i}"][v],
                       f"render: {obj.object_id} view {v}'s gray")
            same_array(o["depth"], tx[f"depth{i}"][v],
                       f"render: {obj.object_id} view {v}'s depth")
            same_array(o["mask"] > 0, masks[v],
                       f"render: {obj.object_id} view {v}'s mask")
        # as the trainer reads them from the DB: K, R, T as float32
        obs = [Observation(image=o["image"], depth=o["depth"], mask=o["mask"],
                           K=np.float32(o["K"]), R=np.float32(o["R"]),
                           T=np.float32(o["T"]),
                           frame_number=o["frame_number"]) for o in views]
        if i == 0:
            train_object(obs, TRAIN_FEATURES, *TRAIN_DEDUP, device=dev)
            reset_counts()                                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d8, p8 = train_object(obs, TRAIN_FEATURES, *TRAIN_DEDUP, device=dev)
        train_s.append(time.perf_counter() - t0)
        d16, p16 = compress_model(d8, p8.reshape(-1, 3), *RECOMPRESS,
                                  device=dev)
        stacked = tx[f"stacked{i}_desc"], tx[f"stacked{i}_points"]
        keep8 = unpacked(tx[f"keep8_{i}"], len(stacked[0]))
        same_array(d8, stacked[0][keep8], f"render-train: {obj.object_id} "
                   "descriptors after dedup 8")
        same_array(p8.reshape(-1, 3), stacked[1][keep8],
                   f"render-train: {obj.object_id} points after dedup 8")
        same_array(d16, fx[f"desc{i}"], f"render-train: {obj.object_id} "
                   "descriptors (16x5)")
        same_array(p16, fx[f"points{i}"], f"render-train: {obj.object_id} "
                   "points (16x5)")
        trained.append(fill_model(obj.object_id, d16, p16))
    launches["12b-train"] = read_counts()
    if list(launches["12b-train"]) != [0, 0, 0, 0, 2 * len(objects), 0, 0]:
        raise AssertionError(f"render-train: launches "
                             f"{list(launches['12b-train'])}, expected two "
                             "B5 an object")
    log(f"render: {len(objects)} objects x {len(views)} views rendered on the "
        f"host, every view's gray, depth and mask equal to the reference's; "
        f"textures {texture_s:.2f} s, render ms a view "
        + ", ".join(f"{ms:.1f}" for ms in render_ms)
        + f"; trained on the card to the reference's models (dedup 8 and "
        f"16x5) in " + ", ".join(f"{s:.2f}" for s in train_s)
        + f" s an object; {card}")

    t0 = time.perf_counter()
    scenes = bench_scenes(syn, objects, len(fx["images"]))
    scene_ms = (time.perf_counter() - t0) * 1e3 / len(scenes)
    for f, (image, depth) in enumerate(scenes):
        same_array(image, fx["images"][f], f"render: scene {f}'s image")
        same_array(depth, fx["depths"][f], f"render: scene {f}'s depth")
    hard = json.loads(str(jx["hard0_json"]))
    t0 = time.perf_counter()
    img, dep = syn.degrade_frame(*scenes[0], np.random.default_rng(1000),
                                 **HARD)
    degrade_ms = (time.perf_counter() - t0) * 1e3
    if (digest(img), digest(dep)) != (hard["image"], hard["depth"]) \
            or hard["preset"] != HARD:
        raise AssertionError("render: scene 0's hard degradation differs "
                             "from the reference's")
    log(f"render: the bench's {len(scenes)} scenes equal to the smoke "
        f"fixture's frames ({scene_ms:.1f} ms a scene); scene 0's "
        f"BENCH_NOISE=hard degradation equal to the reference's "
        f"({degrade_ms:.1f} ms); {card}")

    catalog = smoke_models(model_ids, [(m.descriptors, m.points)
                                       for m in trained])
    det = FusedDetector(catalog, config(fx), seed=0, device=dev)
    frames = [det.prepare_frame(image, depth, fx["K"])
              for image, depth in scenes]
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches["12b"] = read_counts()
    check_launches("render-serve", len(frames), launches["12b"], full=0)
    for f, (got, want) in enumerate(zip(found, found4)):
        same_poses(got, want, f"render-serve: frame {f}")
        log(f"render-serve: frame {f}: " + ", ".join(
            f"{r.object_id} q={r.quality:.0f} inliers={r.confidence:.0f}"
            for r in got) + ": phase 4's detections bit for bit")
    del det, catalog


def cv2_free_phases(dev, card: str, fx, found4, launches: dict) -> None:
    """Phase 12: the JPEG decoder and the synthetic renderer."""
    phase_t0 = time.perf_counter()
    jx = np.load(JPEG_FIXTURE)
    jpeg_phases(dev, card, fx, jx, launches)
    rendered_phases(dev, card, fx, jx, found4, launches)
    log(f"cv2-free: phase 12 took {time.perf_counter() - phase_t0:.1f} s")


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
    kernels.build_all()
    log(f"build: {sorted(kernels.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds})")
    for name in kernels.SOURCES:
        log_ptxas(name, kernels.build_log.get(name, ""))
    from tools.bench_int_rate import UNITS, b1_rate, measure_rates
    RATES.update(measure_rates())
    for name, r in RATES.items():
        log(f"rates: {UNITS[name]}: {r['rate']:.4g} /s, "
            f"{r['per_clock_sm']:.2f} per clock and SM at the maximum "
            f"{r['max_mhz']:.0f} MHz x {r['n_sm']} SMs "
            f"(tools/bench_int_rate.py); {card}")
    log(f"rates: the Hamming bounds take {b1_rate(RATES):.4g} bit "
        f"operations /s; wgmma s8 at "
        f"{RATES['wgmma_s8']['rate'] / INT8_OPS_S * 100:.1f} % of the "
        f"published int8 peak; {card}")

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
    tile_cases = [tile_case_hamming(n_q, dev) for n_q in TILE_Q]
    for t_db, t_q in tile_cases:
        err = max(err, check_b1(t_q, t_db, "the tile edges (objects of "
                                "0-300 rows beside reserved padding, ties "
                                "across fragments, lanes and tiles, all-zero "
                                "and all-one descriptors)"))
    q_batch = batched_queries(q_main, 4)
    for n_q in BATCH_Q:
        err = max(err, check_b1(q_batch[:n_q], sdb, f"Q={n_q} "
                                "(detect_batch_raw's B x q_cap)"))
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
    for t_db, t_q in tile_cases:
        b2_err = max(b2_err, check_b2(
            t_q, t_db, torch.tensor(EDGE_SEL, **i32), "the tile edges"))
    err = max(err, check_b1(q_main, ldb, f"the {N_LARGE}-object catalog"))
    sel_t = torch.from_numpy(rng.choice(N_LARGE, B2_SLOTS, replace=False)
                             .astype(np.int32)).to(dev)
    b2_ms = cuda_ms(lambda: seg.object_top1_gathered(q_main, ldb, sel_t))
    b2_plain_ms = cuda_ms(
        lambda: seg.object_top1_gathered_torch(q_main, ldb, sel_t),
        runs=TWIN_RUNS, warmup=1)
    b2_pairs = Q * sum(ldb.rows_host[o] for o in sel_t.tolist())
    q_c = q_main[::2].contiguous()
    err = max(err, check_b1(q_c, cdb, f"the {N_LARGE}-object coarse DB"))
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

    # ---- 3f. N1, the threefry + Gumbel noise, against its twins ----------
    n1 = check_n1(dev, card)

    # ---- 4. the main path -------------------------------------------------
    frames = [det.prepare_frame(fx["images"][f], fx["depths"][f], fx["K"])
              for f in range(len(fx["images"]))]
    compacted = [stage_features_compact(*frame, cfg) for frame in frames]
    for f, port in enumerate(compacted):
        missing = compaction_mismatches(port, fx, f)
        log(f"main: frame {f}: {missing} of {int(fx['ref_ok'][f].sum())} "
            "reference keypoints not reproduced bit for bit")
        if missing > MAX_KEYPOINT_SWAPS:
            raise AssertionError(f"frame {f}: {missing} keypoints differ "
                                 "from the reference's compaction")
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches = {"4": read_counts()}
    check_launches("main", len(frames), launches["4"], full=0)
    found4 = found
    for f, res in enumerate(found):
        check_frame(f, res, fx)
    log("main: every placement within 2 cm; accepted objects and poses "
        "agree with the reference")
    noise_cost(det, frames[0], f"ORB full sweep, {N_OBJECTS} objects", card)

    # ---- 4b. coarse->fine against the reference's stream, 100 objects ----
    stream = FusedDetector(catalog, cfg_cf, seed=0, device=dev)
    # B1 at the coarse pass's own shape: every other query of a frame
    for f, port in enumerate(compacted):
        q_f = port[2][::cfg_cf.coarse_q_stride].contiguous()
        for db, n in ((stream.cdb, N_OBJECTS), (cdb, N_LARGE)):
            err = max(err, check_b1(
                q_f, db, f"frame {f}'s coarse queries, {n}-object coarse DB"))
    n_stream = len(sfx["frame_image"])
    reset_counts()
    for f in range(n_stream):
        image = int(sfx["frame_image"][f])
        res = stream.detect(*frames[image])
        check_stream_slab(f, stream.slab, sfx, "stream")
        check_frame(f, res, fx, sfx, image, "stream")
    launches["4b"] = read_counts()
    check_launches("stream", n_stream, launches["4b"], full=0, gathered=1)
    log("stream: every frame's slab and masks equal to the reference's; "
        "every placement within 2 cm; accepted objects and poses agree with "
        "the reference")
    noise_cost(stream, frames[0], f"ORB frontier, {N_OBJECTS} objects", card)

    # ---- 4c. coarse->fine at catalog scale, 1000 objects -----------------
    reset_counts()
    first = scale_stream(cf, frames, fx, STREAM, "scale")
    launches["4c"] = read_counts()
    present = sorted({str(o) for ids in fx["gt_ids"] for o in ids})
    log(f"scale: {N_LARGE} objects, discovery frame per present object: "
        + ", ".join(f"{o} {first.get(o, 'never')}" for o in present))
    check_launches("scale", STREAM, launches["4c"], full=0, gathered=1)
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

    # the card's bounds for B1 and B2 at the timed shapes: the int8 or the
    # 1-bit tensor-core product, whichever is less (hamming_bound)
    b1_bound = hamming_bound(pairs, matcher_bytes(
        Q, 32, 32, pairs // Q, sdb.n_objects, sdb.n_objects))
    b2_bound = hamming_bound(b2_pairs, matcher_bytes(
        Q, 32, 32, b2_pairs // Q, B2_SLOTS, N_LARGE))
    del sweep
    torch.cuda.empty_cache()
    b5, t1 = global_phases(dev, card, fx, frames, large, launches)
    del large
    torch.cuda.empty_cache()
    b3, b4 = sift_phases(dev, card, fx, frames, launches)
    torch.cuda.empty_cache()
    b5_dedup = train_phases(dev, card, fx, frames, launches)
    torch.cuda.empty_cache()
    cells_phases(dev, card, fx, frames, found4, launches)
    torch.cuda.empty_cache()
    sift_graph_phase(dev, card, fx, launches)
    torch.cuda.empty_cache()
    a16_phases(dev, card, fx, frames, launches)
    torch.cuda.empty_cache()
    b5_graph = a13_phases(dev, card, fx, launches)
    torch.cuda.empty_cache()
    a14_phases(dev, card, fx, frames, launches)
    torch.cuda.empty_cache()
    legacy_phases(dev, card, fx, launches)
    torch.cuda.empty_cache()
    cv2_free_phases(dev, card, fx, found4, launches)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    def total(k: int) -> int:
        return sum(counts[k] for counts in launches.values())

    log(json.dumps({"kernels": [
        {"name": "B1 segmented per-object Hamming top-1", "route": "cuda",
         "source": SOURCE, "replaces": B1_REPLACES, "launches": total(0),
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": None, "design_pr": 7},
        {"name": "B2 gathered per-object Hamming top-1", "route": "cuda",
         "source": SOURCE, "replaces": B2_REPLACES, "launches": total(1),
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms,
         "bound_ms": b2_bound[0], "bound_by": b2_bound[1],
         "library_ms": None, "design_pr": 8},
        {"name": "B3 segmented per-object int8 squared-L2 top-1",
         "route": "cuda", "source": SOURCE_L2, "replaces": B3_REPLACES,
         "launches": total(2), "library_ms": None, "design_pr": 6, **b3},
        {"name": "B4 gathered per-object int8 squared-L2 top-1",
         "route": "cuda", "source": SOURCE_L2, "replaces": B4_REPLACES,
         "launches": total(3), "library_ms": None, "design_pr": 7, **b4},
        {"name": "B5 radius k-NN Hamming over the whole DB", "route": "cuda",
         "source": SOURCE_B5, "replaces": B5_REPLACES, "launches": total(4),
         "library_ms": None, "design_pr": 6,
         **{**b5, **b5_dedup, **b5_graph, "max_abs_err": max(
             b5["max_abs_err"], b5_dedup["dedup_max_abs_err"])}},
        {"name": "T1 isolation bench: B5's sweep without extraction "
         "(dist_sum timed; every mode in modes_ms)", "route": "cuda",
         "source": SOURCE_B5, "replaces": T1_REPLACES, "launches": total(5),
         "library_ms": None, "design_pr": 5, **t1},
        {"name": "N1 threefry-2x32 + Gumbel RANSAC noise (replaces "
         "jax.random.gumbel, fused by XLA: not a Pallas kernel)",
         "route": "cuda", "source": SOURCE_N1, "replaces": N1_REPLACES,
         "launches": total(6), "library_ms": None,
         "yardstick": "torch.rand at the same shape (Philox: not the same "
         "function)", "design_pr": 8,
         **{**n1, "max_abs_err": max([n1["max_abs_err"], *NOISE_ERR])}}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
