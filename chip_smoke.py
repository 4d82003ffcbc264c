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
3g.         the features' kernels: L1 (csrc/orientation.cu, the keypoint
            orientation fused from the level image: its integral images,
            then the moments at the keypoints and glibc's atan2f; two
            kernels a call) at every level of frame 0's ORB, SIFT and
            training features, at 720p's level 0 and at keypoints on every
            border, against its plain version on the CPU bit for bit;
            timed at each ORB level and at 720p's level 0 (each kernel's
            device time from the profiler)
            beside the parent's route on the card (the dense moments, ~760
            launches a level, and L1e) and F.conv2d + torch.atan2. At the
            SIFT main path's level-0 shape (frame 0, 5000 features: 1978
            keypoints x 1369 pixels): L1e (csrc/libm_f32.cu, the host
            libm's atan2f elementwise) on those gradients, 10^6 random
            pairs and the special values, and L2 (csrc/sift_descriptor.cu,
            the fused SIFT descriptor: from the level image to the
            normalised 128 floats) at K = 1978, at each summation order of
            the contraction and at the trainer's batch of 12, both against
            their plain versions on the CPU bit for bit; L1e timed at the
            level's keypoint count and at the gradients, L2 beside its
            plain chain on the card, the chain's producers (gradients and
            soft bins, with L1e), torch.atan2 / torch.einsum, and their
            bounds.
3h.         kernel L3 (csrc/l2_distances.cu, the L2 matcher's distance tile
            in the compiled reference's order) against its plain tile bit
            for bit at 7e's shape (frame 0's 5000 SIFT descriptors x the
            first DB chunk of 4096 model rows) and at 16384 x 4096, and at
            one query ("vector") and the "lanes" and "parity" widths;
            timed beside the plain tile and torch.matmul with the formula
            (the library column: another rounding). Then the fused L3
            (tod_l2_topk, the whole matcher in one call) against the chunk
            loop and its CPU path, distances and rows bit for bit, at 7e's
            shape, a cut DB, ties, 1, 7, 513 and 16,384 queries; timed
            beside the loop's parts and torch.matmul + torch.topk.
3i.         kernel P1 (csrc/p3p.cu, a group of 4 lanes a sample) against
            its plain version on the CPU bit for bit (NaN where NaN) on
            16,384, 8,192 and 8,191 seeded samples with degenerate ones
            (collinear and repeated points, repeated, zero and NaN rays),
            timed, with ptxas's registers, frame and spills; L4
            (csrc/libm_f32.cu: glibc's cosf, sincosf, powf and XLA's log)
            on 10^6 floats, the special values and the 2D path's ranges,
            timed beside torch.cos, sin, pow and log (the library column:
            another rounding); P2 (csrc/gauss_newton.cu) at a 2D chunk's
            shape and past its shared memory (the rows in a global
            scratch).
3j.         kernels M1 and M2 (csrc/mirror.cu: the 2D path's mirror pose
            and model normal, a thread a pose or matrix) against their
            plain versions on the CPU bit for bit at a chunk's 32 objects
            x 8 poses and a tail of 5, with the edge cases (no turn, s at
            1e-6, T = 0, a NaN pose; isotropic, rank-0 and rank-1
            covariances); timed beside their plain versions on the card
            (the parent's chain of launches) and the CPU, M2 beside
            torch.linalg.eigh. Both run inside R1 on the 2D path.
3l.         kernel R1 (csrc/consensus.cu: the 2D path's reprojection
            consensus) against its plain versions bit for bit in every
            mode (the counts of every pose, the selection with the model
            normal and the mirrors, the masks and the truncated SSE) at a
            chunk's 32 objects x 4,096 poses x 1,024 matches, a tile's
            tail (1,030 matches) and small shapes, with the edge cases
            (camera z at +-1e-9 and 1e-6, points behind the camera, a NaN
            pose, invalid matches, an object with none); each mode timed
            beside its plain version on the card, with its bound.
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
            stage against the reference's (keypoints, 3D points, ok and
            quantised descriptors bit for bit); one L1 launch a level for
            the orientations and one L2 launch (the fused descriptor) a
            level, none for the gradients; every detection the reference
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
            valid masks, world points, descriptors and their quantised
            entries equal to the reference's (L2 in the order of the
            reference's 12-view batch; one L1 and one L2 launch a level).

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
            the L2 matcher, kernel L3) over the three SIFT smoke models and
            both frames, against the reference graph's rows and accepts
            (tests/data/torch_jpeg_fixture.npz sift_graph_*): the MatchSet
            exact, every distance bit for bit; the reference's accepts at
            its poses; N1, L1 and L2 (the features) and L3 (a launch a DB
            chunk) a positive multiple of the frames.
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
            (logged); one B5 launch a frame and one N1 launch a round; R1
            five launches a round and chunk (two in the consensus), M1 and
            M2 none (they run inside R1); B5
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
9c. devices frame 0's catalog object obj002, all 5 rounds of the 2D path on
            the card and on this machine's CPU from the same inputs: every
            stage's output (graph, triples, P1's candidates, counts and top
            8, mirrors, refined poses and SSE, accepts) bit for bit.

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
            queries: the ORB frontier recipe at 1000 objects over 32
            frames (B1, B2, N1; 64 before the script neared its time
            limit), the ORB full sweep at 100 objects, the
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
            poses; the same for the progressive files cut short that
            libjpeg block-smooths (tests/data/torch_jpeg_smoothing_
            fixture.npz, tools/make_torch_jpeg_smoothing_fixture.py: every
            cut of every sampling and gray, two subsets that are not
            prefixes, scene 0 cut after 1 and 9 of its 10 scans, and a
            recording of the scenes cut after 9 scans through ``cli
            ingest`` and conf/detection.ork to the reference's MatchSet and
            accepts); a legacy CouchDB with obj000's three views as JPEG
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
JPEG_SMOOTHING_FIXTURE = os.path.join(DATA,
                                      "torch_jpeg_smoothing_fixture.npz")
SIZES_FIXTURE = os.path.join(DATA, "torch_sizes_fixture.npz")
SMALL_SIZES_FIXTURE = os.path.join(DATA, "torch_small_sizes_fixture.npz")
P3P_FIXTURE = os.path.join(DATA, "torch_p3p_fixture.npz")
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
SOURCE_L1 = "tod_tpu_torch/csrc/orientation.cu"
SOURCE_LIBM = "tod_tpu_torch/csrc/libm_f32.cu"
SOURCE_SIFT = "tod_tpu_torch/csrc/sift_descriptor.cu"
SOURCE_L3 = "tod_tpu_torch/csrc/l2_distances.cu"
# the keypoint orientation: XLA's cumsums, shifted differences and fused
# multiply-adds of the dense moments and its call of the host libm's atan2f
# (not a Pallas kernel)
L1_REPLACES = "tod_tpu/ops/orb.py:112-163"
# XLA's atan2 (a call of the host libm's atan2f): the 2D path's mirror and
# the reference's arccos form, both run inside M1 and M2 since their
# redesign (the gradients' orientations run in L2)
L1E_REPLACES = "tod_tpu/geometry/detection2d.py:183"
SOURCE_MIRROR = "tod_tpu_torch/csrc/mirror.cu"
# the reference's mirror branch (XLA's fusions of the dots, the cross
# product, the libm atan2f / sinf / cosf calls and the two 3x3 products) and
# its eigh of the model points' covariance (not Pallas kernels)
M1_REPLACES = "tod_tpu/geometry/detection2d.py:172-186"
M2_REPLACES = "tod_tpu/geometry/detection2d.py:164-169"
# operations of M1 a pose, counted from its source: float32 outside the
# libm calls (the normal's and T's dots, the reflection, the cross product,
# the clamps and divisions, ax ax, Q and Q R) 190 plus atan2f's L1_OPS; in
# float64 sincosf's LIBM_OPS
M1_F32_OPS = 190
# float32 operations of M2 (LAPACK's ssyevd at n = 3, csrc/mirror.cu), counted
# from its source: a matrix's fixed part (the symmetrisation, the norm and
# scaling tests, ssytd2's reflector and update, sorm2r) 90; each plane
# rotation (slartg) 14, each 2x2 eigensystem (slaev2) 30, each column
# pair a rotation mixes 18; the data decide how many (m2_operations)
M2_FIXED_OPS = 90
M2_LARTG_OPS = 14
M2_LAEV2_OPS = 30
M2_ROTATE_OPS = 18
MIRROR_SHAPES = ((32, 8), (5, 8))   # a 2D chunk's objects x N_REFINE; a tail
SOURCE_R1 = "tod_tpu_torch/csrc/consensus.cu"
# the reference's consensus: `count` over every P3P candidate, `trunc_sse`
# and the mirror branch with its counts (XLA's fusions of `project`, its
# reduces over the matches, the mirror's dots and libm calls; not Pallas
# kernels)
R1_REPLACES = "tod_tpu/geometry/detection2d.py:116-124,141-145,172-190"
# float32 operations of R1 a (pose, match) pair, counted from
# csrc/consensus.cu `reproject` (an FMA two): R X + T 18, the projection's
# two products, two divisions, two adds and two subtractions 8, fma(dv, dv,
# du du) 3, the front, |z| and threshold tests 3
R1_PAIR_OPS = 32
# (objects, poses, matches): a 2D chunk's consensus (32 objects x 512
# hypotheses x 8 P3P candidates, 1,024 match slots), the tile's tail, small
R1_SHAPES = ((32, 4096, 1024), (3, 136, 1030), (4, 48, 40), (2, 8, 1))
# R1's launches a 2D round and chunk: the consensus's counts and selection,
# the refinement's two recounts and its SSE
R1_PER_CHUNK = 5
# the reference's SIFT descriptor from the patches to the normalisation:
# XLA's fusions, the libm atan2f call and the tables' dot (not a Pallas
# kernel)
L2_REPLACES = "tod_tpu/ops/sift.py:93-134"
# the L2 matcher's norms, dot and distance (XLA's reduces, dot and fusion;
# not a Pallas kernel)
L3_REPLACES = "tod_tpu/ops/matching.py:107-141"
SOURCE_P1 = "tod_tpu_torch/csrc/p3p.cu"
SOURCE_P2 = "tod_tpu_torch/csrc/gauss_newton.cu"
# the reference's refinement: XLA's fusions, jax.jacfwd's Jacobian, LAPACK's
# solve and the Rodrigues update (not a Pallas kernel)
P2_REPLACES = "tod_tpu/geometry/pnp.py:225-280"
# float32 operations of P2 a match and iteration, counted from its source:
# the residual and Jacobian rows 48, the 21 + 6 products and pairwise sums
# of its two rows 108
P2_OPS = 48 + 108
P2_SHAPE = (32, 16, 1024)       # a 2D chunk's refinement: objects x poses x M
P2_LARGE_SHAPE = (2, 8, 5000)    # a large N: six register levels, four stacked
P2_ODD_SHAPE = (3, 5, 777)      # an odd N: carried rows at several levels
# the reference's vmapped P3P up to the Horn fit: XLA's fusions and its
# libm calls (not a Pallas kernel)
P1_REPLACES = "tod_tpu/geometry/pnp.py:119-222"
# XLA's cos, pow and sin/cos of the 2D path: calls of the host libm's cosf,
# powf and sincosf (not a Pallas kernel), and its log
L4_REPLACES = ("tod_tpu/geometry/pnp.py:54,67,241-242,"
               "tod_tpu/geometry/detection2d.py:85-95,178-181")
# float32 operations of one P3P sample in p3p.cu, counted from its source:
# sides and cosines 47, the coefficients 118, Ferrari 73 with two powf,
# acosf and cosf (~150 as float-equivalents), six polishes of 4 roots 432,
# the 4 roots' back-substitution 48, 8 candidates x (8 Newton steps x 81 +
# the gate 27 + 3)
P1_OPS = 47 + 118 + 73 + 150 + 432 + 48 + 8 * (8 * 81 + 30)
P1_BYTES = 72 + 96 + 8          # a sample's inputs and outputs
P1_SAMPLES = 16384              # 32 objects x 512 hypotheses: a 2D chunk
LIBM_N = 1_000_000              # random floats of phase 3i
# double operations of glibc's longest float paths (reduce + polynomial:
# sincosf ~16, powf ~24; XLA's log ~20 float), counted at the float64 rate
# (NVIDIA H100 SXM data sheet: 34 TFLOP/s outside the tensor cores)
LIBM_OPS = 24
F64_OPS_S = 34e12
L3_K = 5                        # the graph's knnMatch(k=5)
# float32 operations of atan2f's longest branch (the reduction 4, the two
# polynomials 20, the products and sums around them 6, y / x and the
# quadrant fix 3), at the published float32 rate (NVIDIA H100 SXM data
# sheet, 67 TFLOP/s)
L1_OPS = 33
F32_OPS_S = 67e12
# float32 operations of L1's two moments at a keypoint: 30 differences, a
# product and 29 FMAs (2 each) a moment
L1_MOMENT_OPS = 2 * (30 + 1 + 2 * 29)
# float32 operations of L2 at a tapped pixel besides atan2f's: the two
# differences, the sum of squares and its root (3), the relative angle and
# its remainder (3), floor, frac and the two weights (4)
L2_PIXEL_OPS = 12
L3_Q = 16384               # phase 3h's larger tile: queries x one chunk
L1_PAIRS = 1_000_000       # random pairs of phase 3g
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
A13_GAPS: dict = {}       # accepts off the reference's (ROADMAP queue C)
A13_OBJECT = (0, "obj002")   # phase 9c: the frame and object held
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
# Phase 13: camera sizes (tests/data/torch_sizes_fixture.npz; the scenes,
# cameras and digests in tod_tpu_torch/utils/camera_sizes.py)
SIZE_LEVELS = 8         # the grid's deepest pyramid (cv::ORB's default)
SIZE_RUNS = 10          # timed features-stage calls at each size
SIZE_TURNS = 10         # timed 720p and VGA detect calls, in turns


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
    r"object_top1_gathered_tc_kernel|object_top1_tc_kernel|threefry_kernel|"
    r"gauss_newton_kernel|libm_kernel|atan2f_kernel|p3p_kernel|"
    r"integral_kernel|angles_kernel)"
    r"(I((?:L[ib]\d+E)+)E)?")


def ptxas_entries(report: str) -> list:
    """(kernel, figures) of each registers or spills line of ``nvcc -Xptxas
    -v``'s report, the kernel named with its template arguments (B5/T1:
    route, mode, k)."""
    entry, out = None, []
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            kernel = KERNEL_NAMES.search(found.group(1))
            entry = found.group(1)[:40] if kernel is None else (
                kernel.group(1) + "<" + ",".join(
                    re.findall(r"L[ib](\d+)E", kernel.group(3) or "")) + ">")
        elif entry and ("registers" in line or "spill" in line):
            out.append((entry, line.split(":", 1)[-1].strip()))
    return out


def log_ptxas(name: str, report: str) -> None:
    """One line per kernel of ``nvcc -Xptxas -v``'s report: its registers,
    shared memory and spills (:func:`ptxas_entries`)."""
    for entry, figures in ptxas_entries(report):
        log(f"ptxas: {name}: {entry}: {figures}")


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


def int_mm_ms(q, sdb, objects=None) -> float:
    """Milliseconds of ``torch._int_mm`` over the (Q, 128) x (128, rows)
    int8 product of ``q`` against ``sdb``'s real rows (of ``objects`` only,
    where given: B4's slab), in row chunks of INT_MM_ROWS (the int32
    product of all rows would not fit): a yardstick for B3's or B4's
    product alone, not a library call of the same function."""
    pick = range(len(sdb.rows_host)) if objects is None else objects
    real = torch.cat([sdb.rows[sdb.starts_host[o]:sdb.starts_host[o]
                               + sdb.rows_host[o]] for o in pick
                      if sdb.rows_host[o]])
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
    keypoints, 3D points, ok and quantised descriptors bit for bit."""
    xy, qp, dsc, ok = (t.cpu().numpy() for t in port)
    exact = (np.array_equal(xy, sx["ref_xy"][f])
             and np.array_equal(qp, sx["ref_qp"][f], equal_nan=True)
             and np.array_equal(ok, sx["ref_ok"][f]))
    diff = dsc.astype(np.int32) - sx["ref_dsc"][f].astype(np.int32)
    log(f"sift: frame {f}: keypoints, 3D points and ok equal to the "
        f"reference's: {exact}; {int((diff != 0).sum())} of {diff.size} "
        f"quantised entries differ in {int((diff != 0).any(1).sum())} of "
        f"{int(ok.sum())} descriptors")
    if not exact or diff.any():
        raise AssertionError(f"sift: frame {f}: compaction differs from "
                             "the reference's")


def check_sift_floats(gray, cfg, sx, f: int) -> None:
    """The port's float SIFT descriptors of frame ``f`` before quantisation
    (every slot, at the served config) against the digest of the
    reference's, bit for bit."""
    from tod_tpu_torch.ops.sift import sift_detect_and_compute
    from tod_tpu_torch.utils.camera_sizes import digest

    _, desc = sift_detect_and_compute(
        gray, n_features=cfg.n_features, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor, fast_threshold=cfg.fast_threshold)
    same = digest(desc.cpu().numpy()) == str(sx["ref_desc_digest"][f])
    log(f"sift: frame {f}: the {tuple(desc.shape)} float descriptors before "
        f"quantisation equal to the reference's, by digest: {same}")
    if not same:
        raise AssertionError(f"sift: frame {f}: float descriptors differ "
                             "from the reference's")


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
    """The kernel wrappers, B1..B5, T1, N1, L1 (the fused keypoint
    orientation), L2, L3 (the fused matcher), L3t (its distance tile), P1,
    L4 (libm's cosf / sincosf / powf, XLA's log), P2 (the Gauss-Newton
    refinement), L1e (the elementwise atan2f), M1 (the 2D path's mirror),
    M2 (its model normal) and R1 (its reprojection consensus)."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry import pnp
    from tod_tpu_torch.ops import hamming as ham
    from tod_tpu_torch.ops import libm
    from tod_tpu_torch.ops import orb
    from tod_tpu_torch.ops import matching
    from tod_tpu_torch.ops import segmented as seg
    from tod_tpu_torch.ops import segmented_l2 as l2
    from tod_tpu_torch.ops import sift
    from tod_tpu_torch.utils import prng

    return (seg.object_top1, seg.object_top1_gathered, l2.object_top1_l2,
            l2.object_top1_l2_gathered, ham.hamming_topk_fused,
            ham.hamming_probe, prng.gumbel, orb.orb_angles,
            sift.sift_descriptors, matching.l2_topk_fused,
            matching.l2_distances, pnp.p3p_distances, libm.libm_f32,
            pnp.gauss_newton_pose, libm.atan2f, td.mirror_poses,
            td.sym3_smallest_vector, td.consensus_kernel)


# the names of :func:`wrappers`' kernels, in the order of :func:`read_counts`
COUNTED_KERNELS = [f"B{i + 1}" for i in range(5)] + [
    "T1", "N1", "L1", "L2", "L3", "L3t", "P1", "L4", "P2", "L1e", "M1", "M2",
    "R1"]
N_MATCH_NOISE = 7          # B1..B5, T1 and N1: the counts before L1-L4


def reset_counts() -> None:
    for fn in wrappers():
        fn.launches = 0


def read_counts():
    """Launches of (B1, B2, B3, B4, B5, T1, N1, L1, L2, L3, L3t, P1, L4,
    P2, L1e, M1, M2, R1) since :func:`reset_counts`."""
    return tuple(fn.launches for fn in wrappers())


def matcher_counts(counts) -> list:
    """The counts of B1..B5, T1 and N1 of :func:`read_counts`' tuple."""
    return list(counts[:N_MATCH_NOISE])


def check_feature_counts(what: str, n_frames: int, counts,
                         sift: bool, l3: bool = False) -> None:
    """The path's features went through L1 (the fused keypoint
    orientation) and, with SIFT, L2 (the fused descriptor): a positive
    multiple of the frames each, one of each a level on a SIFT path (L1 =
    L2: no separate launch for the gradients' orientations), and no L2
    without SIFT; L3 (the fused L2 matcher) one a frame where ``l3``, else
    none; L4 (XLA's log of the RANSAC weights) the same number of times on
    every frame; never L3's tile (the orders the graph does not take), P1,
    P2, M1, M2 or R1 (the 2D path's), or L1e (on no path)."""
    l1, l2, l3_n, l3t, p1, l4, p2, l1e, m1, m2, r1 = counts[N_MATCH_NOISE:]
    if l1 < n_frames or l1 % n_frames or (l2 != l1 if sift else l2) or (
            l3_n != n_frames if l3 else l3_n) or l3t or p1 or l4 % n_frames \
            or p2 or l1e or m1 or m2 or r1:
        raise AssertionError(f"{what}: launches L1 {l1}, L2 {l2}, L3 {l3_n}, "
                             f"L3t {l3t}, P1 {p1}, L4 {l4}, P2 {p2}, L1e "
                             f"{l1e}, M1 {m1}, M2 {m2}, R1 {r1} for "
                             f"{n_frames} frames")


def check_launches(what: str, n_frames: int, counts, full: int,
                   gathered=None, sift=None, l3: bool = False) -> None:
    """One launch a frame of the kernels B<full + 1> and, on a coarse->fine
    path, B<gathered + 1>, and none of the others (T1 on no path); N1 the
    same number of times on every frame, at least once; the features' L1
    and L2 and the L2 matcher's L3 as :func:`check_feature_counts` has
    them, SIFT's when ``sift`` (by default, when the path matches with B3),
    L3 where ``l3``."""
    log(f"{what}: {n_frames} frames, launches "
        + ", ".join(f"{name} {n}"
                    for name, n in zip(COUNTED_KERNELS, counts)))
    *matchers, noise = counts[:N_MATCH_NOISE]
    want = [n_frames if i in (full, gathered) else 0
            for i in range(len(matchers))]
    if matchers != want or noise < n_frames or noise % n_frames:
        raise AssertionError(f"{what}: launches {list(counts)}, expected "
                             f"{want} and N1 a positive multiple of "
                             f"{n_frames} for {n_frames} frames")
    check_feature_counts(what, n_frames, counts,
                         full == 2 if sift is None else sift, l3)


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


def sift_level0(gray: torch.Tensor):
    """(blurred level 0, xy, angle) of the SIFT main path's first level on
    ``gray`` at the bench's SIFT point (5000 features, 3 levels)."""
    from tod_tpu_torch.ops import orb as torb
    from tod_tpu_torch.ops.image import gaussian_blur

    seen = []

    def describe(img, xy, angle):
        seen.append((gaussian_blur(img, 7, 1.6), xy, angle))
        return torch.zeros((len(xy), 128), device=img.device)

    torb.detect_and_describe(gray, describe, 5000, 3, 1.2, 20.0,
                             torb.EDGE_THRESHOLD)
    return seen[0]


def orientation_levels(gray: torch.Tensor, plans=None) -> list:
    """(what, level image, xy) of every call of ``keypoint_angles`` in the
    features of ``gray`` for each (what, detect, n_features) of ``plans``:
    by default the ORB and the SIFT features at the bench's point (5000
    features, 3 levels) and the trainer's ORB (600 features)."""
    from tod_tpu_torch.ops import orb as torb
    from tod_tpu_torch.ops import sift as tsift

    plans = plans or (("ORB", torb.orb_detect_and_compute, 5000),
                      ("SIFT", tsift.sift_detect_and_compute, 5000),
                      ("train ORB", torb.orb_detect_and_compute, 600))
    seen, original = [], torb.keypoint_angles

    def record(img, xy):
        seen.append((img.clone(), xy.clone()))
        return original(img, xy)

    out = []
    torb.keypoint_angles = record
    try:
        for what, detect, n in plans:
            seen.clear()
            detect(gray, n_features=n)
            out += [(f"{what} level {i}", img, xy)
                    for i, (img, xy) in enumerate(seen)]
    finally:
        torb.keypoint_angles = original
    return out


def moment_kernels(dev) -> torch.Tensor:
    """(2, 1, 31, 31) float32: the 31x31 circular patch weighted by dx (m10)
    and by dy (m01), for F.conv2d (the library yardstick)."""
    from tod_tpu_torch.ops import orb as torb

    r = torb.HALF_PATCH
    widths = torb._circle_half_widths()
    d = np.arange(-r, r + 1)
    inside = np.abs(d[None, :]) <= widths[:, None]       # (dy, dx)
    k10 = np.where(inside, d[None, :], 0)
    k01 = np.where(inside, d[:, None], 0)
    return torch.from_numpy(np.stack([k10, k01])[:, None].astype(
        np.float32)).to(dev)


def check_orientation(dev, card: str, gray: torch.Tensor) -> dict:
    """Phase 3g, L1: the fused keypoint orientation (csrc/orientation.cu)
    against its plain version on the CPU, bit for bit, at every level of
    ``gray``'s ORB, SIFT and training features, at 720p's level 0 and at
    keypoints on every border; timed at each ORB level of the VGA frame
    and at 720p's level 0 (its two kernels' device time, each kernel's
    from the profiler), beside the parent's
    route on the card (the dense moments, gathered, then L1e's atan2f: its
    device operations and time) and F.conv2d with the two moment kernels +
    torch.atan2 (the library yardstick: another rounding). Returns the
    ``kernels`` entry's measured fields."""
    import torch.nn.functional as F
    from tod_tpu_torch.ops import libm
    from tod_tpu_torch.ops import orb as torb

    def plain(img, xy):
        m10, m01 = torb.keypoint_moments_torch(img.cpu(), xy.cpu())
        return libm.atan2f_torch(m01, m10)

    def same(got, want, what):
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            bad = int((got.cpu().view(torch.int32)
                       != want.view(torch.int32)).sum())
            raise AssertionError(f"L1 at {what}: {bad} of {want.numel()} "
                                 "angles differ from the plain version")

    big = F.interpolate(gray[None, None], size=(720, 1280), mode="bilinear",
                        align_corners=False)[0, 0].contiguous()
    levels = orientation_levels(gray) + orientation_levels(
        big, (("720p", torb.orb_detect_and_compute, 5000),))[:1]
    h, w = gray.shape
    rng = np.random.default_rng(21)
    edge = np.stack([rng.integers(0, w, 400), rng.integers(0, h, 400)], -1)
    edge[:8] = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0), (w // 2, 0),
                (w // 2, h - 1), (0, h // 2), (w - 1, h // 2)]
    levels.append(("border keypoints", gray, torch.from_numpy(
        edge.astype(np.int32)).to(dev)))
    for what, img, xy in levels:
        same(torb.orb_angles(img, xy), plain(img, xy), what)
    log(f"kernels: L1 (fused orientation) equal to keypoint_moments_torch + "
        f"atan2f_torch bit for bit at "
        + ", ".join(f"{what} {tuple(img.shape)} K={len(xy)}"
                    for what, img, xy in levels))

    weights = moment_kernels(dev)
    timed = [lv for lv in levels if lv[0].startswith("ORB level")] + [
        lv for lv in levels if lv[0] == "720p level 0"]
    rows = {}
    for what, img, xy in timed:
        k = len(xy)
        hh, ww = img.shape
        row = {"ms": cuda_ms(lambda: torb.orb_angles(img, xy), queued=True)}
        row["host_ms"] = cuda_ms(lambda: torb.orb_angles(img, xy))
        ops, busy, _ = device_profile(lambda: torb.orb_angles(img, xy))
        split = kernel_device_ms(lambda: torb.orb_angles(img, xy))
        x, y = xy[:, 0].long(), xy[:, 1].long()

        def parent_route():
            m10, m01 = torb.orientation_moments(img)
            return libm.atan2f(m01[y, x].contiguous(),
                               m10[y, x].contiguous())

        same(parent_route(), plain(img, xy), f"{what} (the parent's route)")
        p_ops, p_busy, _ = device_profile(parent_route)
        row["parent_ms"] = cuda_ms(parent_route, runs=8)

        def library():
            m = F.conv2d(img[None, None], weights,
                         padding=torb.HALF_PATCH)[0]
            return torch.atan2(m[1, y, x], m[0, y, x])

        row["library_ms"] = cuda_ms(library, queued=True)
        row["plain_ms"] = cuda_ms(lambda: libm.atan2f_torch(
            *torb.keypoint_moments_torch(img, xy)[::-1]), runs=TWIN_RUNS,
            warmup=1)
        # the function's bytes: the level read once, each keypoint's xy
        # read and angle written; its operations: both integral images'
        # sums and the moments' chains and atan2f at each keypoint. Beside
        # it, the design's traffic: both integral images also written and
        # read back once (intermediates, which fit in the L2 cache)
        n_bytes = 4 * hh * ww + 12 * k
        design_bytes = n_bytes + 2 * 4 * ((hh + 1) * ww + hh * (ww + 1))
        n_ops = 2 * 2 * ((hh + 1) * ww + hh * (ww + 1)) \
            + k * (L1_MOMENT_OPS + L1_OPS)
        b_ms, o_ms = n_bytes / HBM_BYTES_S * 1e3, n_ops / F32_OPS_S * 1e3
        row.update(bound_ms=max(b_ms, o_ms),
                   bound_by="bytes" if b_ms >= o_ms else "operations",
                   design_bytes_ms=design_bytes / HBM_BYTES_S * 1e3,
                   device_ops=ops, busy_ms=busy, kernels_ms=split,
                   parent_device_ops=p_ops, parent_busy_ms=p_busy, k=k,
                   shape=f"{hh}x{ww}")
        rows[what] = row
        log(f"kernels: L1 at {what} ({hh}x{ww}, K = {k}): "
            f"{row['ms']:.4f} ms on the device ({ops} device operations, "
            f"{busy:.4f} ms busy: "
            + ", ".join(f"{n} {t:.4f}" for n, t in split.items()) + "; "
            f"the call with its host work {row['host_ms']:.4f}); the "
            f"parent's route (dense moments + L1e) {row['parent_ms']:.4f} ms, "
            f"{p_ops} device operations, {p_busy:.4f} ms busy; plain "
            f"version on the card {row['plain_ms']:.3f} ms; "
            f"F.conv2d + torch.atan2 (library; another rounding) "
            f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.6f} ms "
            f"by {row['bound_by']} (the design's traffic, the integral "
            f"images written and read back: {row['design_bytes_ms']:.6f} "
            f"ms); {card}")
    main = rows["ORB level 0"]
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], host_ms=main["host_ms"],
                parent_ms=main["parent_ms"],
                parent_device_ops=main["parent_device_ops"],
                design_bytes_ms=main["design_bytes_ms"], levels=rows,
                shape=f"frame 0's ORB / SIFT level 0, {main['shape']}, K = "
                f"{main['k']} (levels: each ORB level and 720p's level 0; "
                "library: F.conv2d + torch.atan2, another rounding)")


def kernel_device_ms(fn) -> dict:
    """{kernel name: device ms} of ``fn()``'s CUDA kernels under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^(?:void )?(?:\(anonymous namespace\)::)?", "",
                          e.name).split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def check_features(dev, card: str, gray: torch.Tensor):
    """Phase 3g: kernel L1 (the fused keypoint orientation,
    :func:`check_orientation`), L1e (the elementwise atan2f) and L2 against
    their plain versions on the CPU at the SIFT main path's level-0 shape
    of ``gray`` (L1e also on random pairs and the special values, L2 also
    in each summation order and at the trainer's batch), bit for bit; then
    timed beside the plain versions and one PyTorch call each. Returns
    their ``kernels`` entries' measured fields."""
    from tod_tpu_torch.ops import libm
    from tod_tpu_torch.ops import sift as tsift
    from tod_tpu_torch.ops.orb import angle_bins

    def same_bits(got, want, what):
        got, want = got.cpu(), want.cpu()
        nan = torch.isnan(want)
        ok = torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))
        if not ok:
            raise AssertionError(f"{what}: the kernel differs from its "
                                 "plain version")

    l1 = check_orientation(dev, card, gray)
    blurred, xy, angle = sift_level0(gray)
    gx, gy = tsift.gradients(blurred, xy)
    rng = np.random.default_rng(3)
    ry, rx = (torch.from_numpy((rng.standard_normal(L1_PAIRS) * 10.0 **
                                rng.uniform(-3, 3, L1_PAIRS))
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    special = torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                            1e-45, 2.0 ** 26, 2.0 ** 60, 2.0 ** -60],
                           device=dev)
    sy, sx = (a.reshape(-1) for a in torch.meshgrid(special, special,
                                                     indexing="ij"))
    for y, x, what in ((gy, gx, "L1e at the SIFT gradients"),
                       (ry, rx, f"L1e on {L1_PAIRS} random pairs"),
                       (sy, sx, "L1e at the special values")):
        same_bits(libm.atan2f(y, x), libm.atan2f_torch(y.cpu(), x.cpu()),
                  what)
    k_count = len(xy)
    host = [a.cpu() for a in (blurred, xy, angle)]
    orders = {}
    for k, batch in ((1, 1), (3, 1), (4, 1), (7, 1), (30, 1), (k_count, 1),
                     (k_count, 12)):
        got = tsift.sift_descriptors(blurred, xy[:k], angle[:k], batch)
        want = tsift.sift_describe_torch(host[0], host[1][:k], host[2][:k],
                                         batch)
        kind = tsift.contraction_order(k, batch)[0]
        orders[kind] = orders.get(kind, 0) + 1
        same_bits(got, want, f"L2 at K = {k}, batch {batch}")
    log(f"kernels: L1e equal to atan2f_torch bit for bit at frame 0's SIFT "
        f"level-0 gradients ({gy.numel()} pairs), {L1_PAIRS} random pairs "
        f"and {sy.numel()} special-value pairs; L2 (the fused descriptor) "
        f"equal to sift_describe_torch on the CPU bit for bit at K = 1 to "
        f"{k_count} in the orders {orders}")

    # L1e at its former main-path shape, a level's keypoints (the gradient at
    # each keypoint stands in for its moments), and at the gradients
    mid = tsift.PATCH_R                   # a patch's centre
    ay, ax = gy[:, mid, mid].contiguous(), gx[:, mid, mid].contiguous()
    # the kernels' device time (queued: the wrapper's host work hidden
    # behind a device sleep) and, beside it, the call's time with it
    l1_ms = cuda_ms(lambda: libm.atan2f(ay, ax), queued=True)
    l1_host = cuda_ms(lambda: libm.atan2f(ay, ax))
    l1_plain = cuda_ms(lambda: libm.atan2f_torch(ay, ax))
    l1_lib = cuda_ms(lambda: torch.atan2(ay, ax), queued=True)
    n = gy.numel()
    l1_grad_ms = cuda_ms(lambda: libm.atan2f(gy, gx), queued=True)
    l1_bytes_ms = 12 * k_count / HBM_BYTES_S * 1e3
    l1_ops_ms = L1_OPS * k_count / F32_OPS_S * 1e3
    log(f"kernels: L1e {l1_ms:.4f} ms median of {KERNEL_RUNS} on the device "
        f"at {k_count} pairs (launch-bound; the call with its host work "
        f"{l1_host:.4f} ms); plain {l1_plain:.4f} ms; torch.atan2 (library; "
        f"not the function) {l1_lib:.4f} ms; bound "
        f"{max(l1_bytes_ms, l1_ops_ms):.6f} ms; at the {n} gradient pairs "
        f"(its first shape) {l1_grad_ms:.4f} ms ({n / l1_grad_ms / 1e6:.1f} G "
        f"pairs/s); {card}")

    l2_ms = cuda_ms(lambda: tsift.sift_descriptors(blurred, xy, angle),
                    queued=True)
    l2_host = cuda_ms(lambda: tsift.sift_descriptors(blurred, xy, angle))
    # its scaling in K: the level's keypoints twice over (the pre-pass
    # groups them once; each block reads only its own item)
    xy2, angle2 = xy.repeat(2, 1), angle.repeat(2)
    same_bits(tsift.sift_descriptors(blurred, xy2, angle2),
              tsift.sift_describe_torch(host[0], xy2.cpu(), angle2.cpu()),
              f"L2 at K = {2 * k_count}")
    l2_ms2 = cuda_ms(lambda: tsift.sift_descriptors(blurred, xy2, angle2),
                     queued=True)
    l2_plain = cuda_ms(lambda: tsift.sift_describe_torch(blurred, xy, angle),
                       runs=TWIN_RUNS, warmup=1)
    producers_ms = cuda_ms(lambda: tsift.soft_bins(
        *tsift.gradients(blurred, xy), angle), runs=TWIN_RUNS, warmup=1)
    t = tsift.soft_bins(gx, gy, angle)
    tables = torch.from_numpy(tsift._spatial_tables()).to(dev)
    l2_lib = cuda_ms(lambda: torch.einsum("kpo,pq->kqo", t, tables),
                     queued=True)
    taps = tsift._contraction_taps(tsift.contraction_order(k_count))
    per_col = np.diff(taps.starts).reshape(-1, 4).sum(1)  # a column's taps
    bins_np = angle_bins(angle).cpu().numpy()
    cols = (bins_np[:, None] * 16 + np.arange(16)).ravel()
    # an FMA a tap and nonzero orientation: two of the eight (fma(W, +0,
    # acc) = acc is no work the function needs)
    fmas = 2 * int(per_col[cols].sum())
    pixels = int(np.diff(taps.pixel_starts)[bins_np].sum())
    l2_ops_ms = (2 * fmas + (L1_OPS + L2_PIXEL_OPS) * pixels
                 + 6 * 128 * k_count) / F32_OPS_S * 1e3
    # the level image, each keypoint's xy, angle and 128 outputs, and the
    # tap tables read once; beside it, the design's traffic: each patch
    # once and a block's bin's tables (weight, slot) and pixels once
    table_bytes = sum(a.nbytes for a in (taps.starts, taps.slots,
                                         taps.weights, taps.pixel_starts,
                                         taps.pixels))
    l2_bytes = 4 * blurred.numel() + k_count * (12 + 4 * 128) + table_bytes
    l2_bytes_ms = l2_bytes / HBM_BYTES_S * 1e3
    blocks = -(-np.bincount(bins_np, minlength=32)
               // tsift.DESCRIBE_PER_BLOCK)
    design_bytes = k_count * (4 * tsift.DEPTH + 12 + 4 * 128) + int(
        (blocks * (8 * np.diff(taps.starts[::64])
                   + 4 * np.diff(taps.pixel_starts))).sum())
    log(f"kernels: L2 (fused) {l2_ms:.4f} ms median of {KERNEL_RUNS} on the "
        f"device at K = {k_count} ({tsift.contraction_order(k_count)[0]}; "
        f"the call with its host work {l2_host:.4f} ms); at K = "
        f"{2 * k_count} (the keypoints twice, bit for bit) {l2_ms2:.4f} ms, "
        f"{l2_ms2 / l2_ms:.2f}x; the plain chain on the card {l2_plain:.3f} ms and its producers (patches, "
        f"gradients, soft bins with L1e) {producers_ms:.3f} ms, median of "
        f"{TWIN_RUNS}; torch.einsum over every angle bin (library) "
        f"{l2_lib:.4f} ms; bound {max(l2_bytes_ms, l2_ops_ms):.4f} ms "
        f"({l2_bytes} bytes {l2_bytes_ms:.4f} ms, {fmas} FMAs, {pixels} "
        f"tapped pixels and the norms {l2_ops_ms:.4f} ms; the design's "
        f"{design_bytes} bytes, whole patches and a block's tables, "
        f"{design_bytes / HBM_BYTES_S * 1e3:.4f} ms); {card}")
    return (l1,
            dict(max_abs_err=0.0, ms=l1_ms, plain_ms=l1_plain,
                 bound_ms=max(l1_bytes_ms, l1_ops_ms),
                 bound_by="bytes" if l1_bytes_ms >= l1_ops_ms
                 else "operations", library_ms=l1_lib,
                 host_ms=l1_host, gradients_ms=l1_grad_ms,
                 shape=f"{k_count} pairs (its former main-path shape: frame "
                 f"0's SIFT level-0 keypoint angles; gradients_ms: its {n} "
                 f"gradients)"),
            dict(max_abs_err=0.0, ms=l2_ms, plain_ms=l2_plain,
                 bound_ms=max(l2_bytes_ms, l2_ops_ms),
                 bound_by="bytes" if l2_bytes_ms >= l2_ops_ms
                 else "operations", library_ms=l2_lib,
                 host_ms=l2_host, producers_ms=producers_ms,
                 ms_twice_k=l2_ms2,
                 design_bytes_ms=design_bytes / HBM_BYTES_S * 1e3,
                 shape=f"K = {k_count} keypoints x 1369 pixels (frame 0's "
                 f"SIFT level 0)"))


def sift_graph_db(dev):
    """The SIFT graph's DB as 7e holds it: the three SIFT smoke models'
    float descriptors (/ 256) padded with zero rows to a multiple of 4,096;
    (padded rows, valid rows)."""
    s_models = load_fixture(SIFT_FIXTURE)[2]
    rows = np.concatenate([d for d, _ in s_models]).astype(np.float32) / 256
    n = len(rows)
    pad = np.zeros(((-n) % 4096, 128), np.float32)
    return torch.from_numpy(np.concatenate([rows, pad])).to(dev), n


def check_l3(dev, card: str, gray: torch.Tensor):
    """Phase 3h: the fused L2 matcher (kernel L3, ``l2_topk_fused``)
    against the parent's chunk loop (one L3 tile a chunk, ``stable_topk``,
    ``_merge_topk``: ``l2_topk_chunked``) and against its plain version
    (``_l2_topk_screened``, on the CPU), distances and rows bit for bit: at
    7e's shape (frame 0's 5000 SIFT descriptor slots x the three SIFT
    models' rows, a partial last chunk), at 1, 7 and 513 queries, at
    ``L3_Q`` queries, at a DB cut inside a chunk and at a DB of every row
    twice (ties: the lower row). Timed at 7e's shape beside the chunk loop
    (split into its tiles, sorts and merges) and ``torch.matmul`` with the
    formula and ``torch.topk`` (the library; another rounding). Then the
    tile itself (:func:`check_l3_tile`). Returns the ``kernels`` entries'
    measured fields of L3 and L3t."""
    from tod_tpu_torch.ops import matching as tm
    from tod_tpu_torch.ops import sift as tsift
    from tod_tpu_torch.ops.fast import stable_topk

    _, desc = tsift.sift_detect_and_compute(gray, n_features=5000)
    db, n_valid = sift_graph_db(dev)
    big_q = desc.repeat(-(-L3_Q // len(desc)), 1)[:L3_Q].contiguous()
    twice = torch.cat([db[:n_valid], db[:n_valid]])
    twice = torch.cat([twice, db[:(-len(twice)) % 4096]]).contiguous()
    cases = [(desc, db, n_valid, True), (desc[:1], db, n_valid, True),
             (desc[:7], db, n_valid, True), (desc[:513], db, n_valid, True),
             (big_q, db, n_valid, False), (desc, db[:3 * 4096], 2 * 4096 + 77,
                                           True),
             (desc[:513], twice, 2 * n_valid, True)]
    for q, rows, nv, plain in cases:
        got = tm.l2_topk_fused(q, rows, nv, L3_K)
        want = tm.l2_topk_chunked(q, rows, nv, L3_K, 4096, "chain")
        checks = [("the chunk loop", want)]
        if plain:
            checks.append(("its plain version", tm._l2_topk_screened(
                q.cpu(), rows.cpu(), nv, L3_K, "chain")))
        for what, (wd, wi) in checks:
            if not (torch.equal(got[0].view(torch.int32).cpu(),
                                wd.view(torch.int32).cpu())
                    and torch.equal(got[1].cpu(), wi.cpu())):
                raise AssertionError(f"L3 at {len(q)} queries x {nv} valid "
                                     f"rows differs from {what}")
        log(f"kernels: L3 (fused matcher) equal to the chunk loop"
            f"{' and its plain version' if plain else ''} bit for bit at "
            f"{len(q)} queries x {nv} valid rows of {len(rows)}, k {L3_K}")
    n_q = len(desc)
    fused_ms = cuda_ms(lambda: tm.l2_topk_fused(desc, db, n_valid, L3_K),
                       queued=True)
    fused_host = cuda_ms(lambda: tm.l2_topk_fused(desc, db, n_valid, L3_K))
    loop_ms = cuda_ms(lambda: tm.l2_topk_chunked(desc, db, n_valid, L3_K,
                                                 4096, "chain"), runs=8)
    chunk = db[:4096]
    dist = tm.l2_distances(desc, chunk, 4096, "chain")
    tile_ms = cuda_ms(lambda: tm.l2_distances(desc, chunk, 4096, "chain"),
                      queued=True)
    sort_ms = cuda_ms(lambda: stable_topk(-dist, L3_K), queued=True)
    best = stable_topk(-dist, L3_K)
    merge_ms = cuda_ms(lambda: tm._merge_topk(
        -best[0], best[1].int(), -best[0], best[1].int(), L3_K), queued=True)
    n_chunks = db.shape[0] // 4096
    t0 = time.perf_counter()
    tm._l2_topk_screened(desc.cpu(), db.cpu(), n_valid, L3_K, "chain")
    plain_ms = (time.perf_counter() - t0) * 1e3

    def library():
        q_sq, r_sq = (desc * desc).sum(1), (db[:n_valid] * db[:n_valid]).sum(1)
        d = torch.clamp_min((q_sq[:, None] + r_sq[None]) - 2.0 * (
            desc @ db[:n_valid].T), 0.0)
        return torch.topk(d, L3_K, dim=1, largest=False)

    lib_ms = cuda_ms(library, queued=True, runs=8)
    big_ms = cuda_ms(lambda: tm.l2_topk_fused(big_q, db, n_valid, L3_K),
                     queued=True, runs=8)
    pairs = n_q * n_valid
    ops_ms = 2 * 128 * pairs / F32_OPS_S * 1e3
    n_bytes = 512 * (n_q + n_valid) + 8 * n_q * L3_K
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"kernels: L3 (fused matcher) {fused_ms:.4f} ms median of "
        f"{KERNEL_RUNS} on the device at {n_q} x {n_valid} valid rows "
        f"({db.shape[0] // 4096} chunks), k {L3_K} "
        f"({2 * 128 * pairs / fused_ms / 1e9:.1f} TFLOP/s, "
        f"{bound_ms / fused_ms * 100:.1f} % of the bound {bound_ms:.4f} ms by "
        f"{'operations' if ops_ms >= bytes_ms else 'bytes'}; the call with "
        f"its host work {fused_host:.4f} ms); the parent's chunk loop "
        f"{loop_ms:.4f} ms whole (its parts a chunk: L3 tile {tile_ms:.4f}, "
        f"stable_topk {sort_ms:.4f}, _merge_topk {merge_ms:.4f} ms, x "
        f"{n_chunks} chunks); plain version (CPU) {plain_ms:.1f} ms; "
        f"torch.matmul with the formula + torch.topk (library; another "
        f"rounding) {lib_ms:.4f} ms; at {L3_Q} queries {big_ms:.4f} ms; "
        f"{card}")
    fused = dict(max_abs_err=0.0, ms=fused_ms, plain_ms=plain_ms,
                 bound_ms=bound_ms,
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                 library_ms=lib_ms, host_ms=fused_host, loop_ms=loop_ms,
                 loop_parts_ms=dict(tile=tile_ms, stable_topk=sort_ms,
                                    merge=merge_ms, chunks=n_chunks),
                 large_ms=big_ms, plain_on="cpu",
                 shape=f"{n_q} queries x {n_valid} valid rows, k {L3_K} "
                 f"(7e: frame 0's SIFT descriptor slots x the three SIFT "
                 f"models; large_ms: {L3_Q} queries)")
    return fused, check_l3_tile(dev, card, desc, db)


def check_p1(dev, card: str) -> tuple:
    """Phase 3i: kernel P1 against its plain version (on the CPU) bit for
    bit on seeded P3P samples (:func:`p3p_samples`: well-posed and random
    triples; then :func:`p3p_degenerate`'s), and L4 (glibc's cosf,
    sincosf, powf; XLA's log) against theirs on ``LIBM_N`` random floats,
    the special values and the ranges the 2D path reaches; each timed.
    Returns the ``kernels`` entries' fields of P1 and L4."""
    from tod_tpu_torch.geometry import pnp
    from tod_tpu_torch.ops import libm

    rng = np.random.default_rng(19)
    bear, pts = (torch.from_numpy(a) for a in p3p_samples(rng, P1_SAMPLES))
    b_dev, p_dev = bear.to(dev), pts.to(dev)
    s, ok = pnp.p3p_distances(b_dev, p_dev)
    t0 = time.perf_counter()
    s_w, ok_w = pnp.p3p_distances_torch(bear, pts)
    p1_plain = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(s.cpu().view(torch.int32), s_w.view(torch.int32))
            and torch.equal(ok.cpu(), ok_w)):
        bad = (s.cpu().view(torch.int32) != s_w.view(torch.int32)).any(-1)
        raise AssertionError(f"P1 differs from its plain version on "
                             f"{int(bad.sum())} of {bad.numel()} candidates")
    # degenerate samples at the 2D path's chunk sizes and an odd count (a
    # grid ending inside a block)
    from tod_tpu_torch import kernels

    def same_nan(got, want):
        got = got.cpu()
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))

    deg_b, deg_p = p3p_degenerate(bear.numpy(), pts.numpy())
    for n in (P1_SAMPLES, P1_SAMPLES // 2, P1_SAMPLES // 2 - 1):
        want_s, want_ok = pnp.p3p_distances_torch(deg_b[:n], deg_p[:n])
        got_s, got_ok = pnp.p3p_distances(deg_b[:n].to(dev),
                                          deg_p[:n].to(dev))
        if not (same_nan(got_s, want_s)
                and torch.equal(got_ok.cpu(), want_ok)):
            raise AssertionError(f"P1 differs from its plain version on {n} "
                                 "samples with degenerate ones")
    ptxas = [f"{e}: {f}" for e, f in ptxas_entries(
        kernels.build_log.get("p3p", "")) if e.startswith("p3p_kernel")]
    log(f"kernels: P1 equal to p3p_distances_torch bit for bit (NaN where "
        f"NaN) on {P1_SAMPLES}, {P1_SAMPLES // 2} and {P1_SAMPLES // 2 - 1} "
        f"samples with a degenerate one every 7 (collinear, repeated points, "
        f"repeated, zero and NaN rays); ptxas "
        f"{ptxas or 'not built in this run'}; {card}")
    p1_ms = cuda_ms(lambda: pnp.p3p_distances(b_dev, p_dev), queued=True)
    p1_host = cuda_ms(lambda: pnp.p3p_distances(b_dev, p_dev))
    ops_ms = P1_OPS * P1_SAMPLES / F32_OPS_S * 1e3
    bytes_ms = P1_BYTES * P1_SAMPLES / HBM_BYTES_S * 1e3
    log(f"kernels: P1 equal to p3p_distances_torch bit for bit on "
        f"{P1_SAMPLES} samples ({int(ok.sum())} of {ok.numel()} candidates "
        f"valid); {p1_ms:.4f} ms median of {KERNEL_RUNS} on the device "
        f"(the call with its host work {p1_host:.4f} ms); plain version "
        f"(CPU) {p1_plain:.1f} ms; bound {max(ops_ms, bytes_ms):.5f} ms "
        f"({P1_OPS} float operations a sample {ops_ms:.5f} ms, bytes "
        f"{bytes_ms:.5f} ms); {card}")
    p1 = dict(max_abs_err=0.0, ms=p1_ms, plain_ms=p1_plain,
              bound_ms=max(ops_ms, bytes_ms),
              bound_by="operations" if ops_ms >= bytes_ms else "bytes",
              library_ms=None, host_ms=p1_host, plain_on="cpu",
              ptxas=ptxas,
              shape=f"{P1_SAMPLES} samples (a 2D chunk: 32 objects x 512 "
              "hypotheses)")

    x = (rng.standard_normal(LIBM_N) * 10.0 ** rng.uniform(-6, 6, LIBM_N))
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                        1.17549435e-38, 2.0 ** -12, np.pi / 4, 119.99, 120.0,
                        3.4028235e38, -3.4028235e38, 1.0, -1.0, 0.5])
    ranges = np.concatenate([rng.uniform(0, np.pi / 3, 1000),    # theta / 3
                             rng.uniform(-np.pi, np.pi, 1000),   # the mirror
                             rng.uniform(0, 1e-3, 1000),         # GN steps
                             rng.uniform(0, 1e3, 1000)])         # cbrt
    x = torch.from_numpy(np.concatenate([x, special, ranges])
                         .astype(np.float32))
    y = torch.full_like(x, 1.0 / 3.0)
    x_dev, y_dev = x.to(dev), y.to(dev)
    plain = {0: lambda: libm.cosf_torch(x), 1: lambda: libm.sincosf_torch(x),
             2: lambda: libm.powf_torch(x.abs(), y),
             3: lambda: libm.log_xla_torch(x.abs())}
    args = {0: (x_dev,), 1: (x_dev,), 2: (x_dev.abs(), y_dev),
            3: (x_dev.abs(),)}
    times, want_all = {}, {}
    for fn, name in enumerate(("cosf", "sincosf", "powf", "log")):
        got = libm.libm_f32(fn, *args[fn])
        t0 = time.perf_counter()
        want = plain[fn]()
        plain_fn_ms = (time.perf_counter() - t0) * 1e3
        want_all[fn] = want if fn == 1 else (want,)
        for g, w in zip(*((got, want) if fn == 1 else ((got,), (want,)))):
            g = g.cpu()
            nan = torch.isnan(w)
            if not (torch.equal(torch.isnan(g), nan) and torch.equal(
                    g[~nan].view(torch.int32), w[~nan].view(torch.int32))):
                raise AssertionError(f"L4 {name} differs from its plain "
                                     "version")
        times[name] = (cuda_ms(lambda: libm.libm_f32(fn, *args[fn]),
                               queued=True), plain_fn_ms)
    # lengths that are no multiple of 4 and offset views: the float4 body
    # with its scalar tail (aligned arrays), and the scalar path (an array
    # offset by 1-3 floats)
    n = x.numel()
    views = ((0, n - 3, 0), (1, n - 2, 1), (3, n - 1, 3), (1, n - 1, 0),
             (2, 7, 2), (0, 3, 0))
    for fn, name in enumerate(("cosf", "sincosf", "powf", "log")):
        for lo, hi, y_lo in views:
            a = args[fn][0][lo:hi]
            b = args[2][1][y_lo:y_lo + hi - lo] if fn == 2 else None
            got = libm.libm_f32(fn, a, b)
            want = tuple(w[lo:hi] for w in want_all[fn])   # y is one value
            for g, w in zip(got if fn == 1 else (got,), want):
                g = g.cpu()
                nan = torch.isnan(w)
                if not (torch.equal(torch.isnan(g), nan) and torch.equal(
                        g[~nan].view(torch.int32), w[~nan].view(torch.int32))):
                    raise AssertionError(f"L4 {name} differs from its plain "
                                         f"version on x[{lo}:{hi}]")
    log(f"kernels: L4 equal to its plain versions on views (x from, to, y "
        f"from) {[(lo, hi, y_lo) for lo, hi, y_lo in views]}: lengths no "
        "multiple of 4, offset by 1-3 floats, y at another offset")
    # the 2D path's own sizes (launch-bound): each (function, floats) that
    # one depthless frame's rounds launch, timed beside PyTorch's
    sizes = l4_path_sizes(dev)
    path_ms = {}
    for fn, size in sizes:
        name = ("cosf", "sincosf", "powf", "log")[fn]
        reps = -(-size // n)
        a = args[fn][0].repeat(reps)[:size]
        b = args[2][1].repeat(reps)[:size] if fn == 2 else None
        lib = {0: lambda: torch.cos(a), 1: lambda: (torch.sin(a),
                                                    torch.cos(a)),
               2: lambda: torch.pow(a, b), 3: lambda: torch.log(a)}[fn]
        path_ms[f"{name} {size}"] = (
            cuda_ms(lambda: libm.libm_f32(fn, a, b), queued=True),
            cuda_ms(lib, queued=True))
    log("kernels: L4 at the 2D path's sizes (one depthless frame's calls: "
        "function floats: L4 / PyTorch ms on the device): " + ", ".join(
            f"{k}: {a:.4f} / {b:.4f}" for k, (a, b) in path_ms.items()))
    # the library column: one PyTorch call a function (another rounding)
    library = {"cosf": lambda: torch.cos(x_dev),
               "sincosf": lambda: (torch.sin(x_dev), torch.cos(x_dev)),
               "powf": lambda: torch.pow(args[2][0], y_dev),
               "log": lambda: torch.log(args[3][0])}
    lib_ms = {k: cuda_ms(f, queued=True) for k, f in library.items()}
    n = x.numel()
    l4_ops_ms = LIBM_OPS * n / F64_OPS_S * 1e3
    l4_bytes_ms = 12 * n / HBM_BYTES_S * 1e3
    log(f"kernels: L4 cosf, sincosf, powf, log equal to their plain "
        f"versions bit for bit on {n} floats (random over 12 decades, the "
        f"special values, the 2D path's ranges); device / plain (CPU) ms: "
        + ", ".join(f"{k} {a:.4f} / {b:.1f}" for k, (a, b) in times.items())
        + "; PyTorch's (another rounding) ms: "
        + ", ".join(f"{k} {a:.4f}" for k, a in lib_ms.items())
        + f"; bound (powf) {max(l4_ops_ms, l4_bytes_ms):.4f} ms; {card}")
    l4 = dict(max_abs_err=0.0, ms=times["powf"][0],
              plain_ms=times["powf"][1],
              bound_ms=max(l4_ops_ms, l4_bytes_ms),
              bound_by="operations" if l4_ops_ms >= l4_bytes_ms else "bytes",
              library_ms=lib_ms["powf"], plain_on="cpu",
              every_ms={k: a for k, (a, _) in times.items()},
              library_every_ms=lib_ms,
              path_ms={k: a for k, (a, _) in path_ms.items()},
              shape=f"{n} floats (powf timed; every_ms: each function; "
              "library: torch.pow, cos, sin and cos, log, another "
              "rounding)")
    return p1, l4, check_p2(dev, card)


def p3p_samples(rng: np.random.Generator, n: int) -> tuple:
    """``n`` float32 P3P samples (bearings (n, 3, 3), points (n, 3, 3)) from
    ``rng``: odd ones well posed (a pose, three points near a plane, their
    rays through a VGA camera), even ones random rays and points."""
    K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    bear, pts = [], []
    for i in range(n):
        if i % 2:          # a well-posed sample: a pose, 3 points, rays
            ax = rng.uniform(-0.4, 0.4, 3)
            th = np.linalg.norm(ax)
            k = ax / th
            kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                           [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
            T = np.array([*rng.uniform(-0.15, 0.15, 2), 0.9])
            X = rng.uniform(-0.12, 0.12, (3, 3))
            X[:, 2] *= 0.1
            uv = (X @ R.T + T) @ K.T
            b = np.concatenate([(uv[:, :2] / uv[:, 2:3] - K[:2, 2])
                                / np.diag(K)[:2], np.ones((3, 1))], 1)
        else:              # random rays and points
            b = rng.standard_normal((3, 3)) + [0, 0, 3]
            X = rng.standard_normal((3, 3)) * 0.2
        bear.append(b / np.linalg.norm(b, axis=1, keepdims=True))
        pts.append(X)
    return np.asarray(bear, np.float32), np.asarray(pts, np.float32)


def p3p_degenerate(bear: np.ndarray, pts: np.ndarray) -> tuple:
    """Copies of P3P samples with a degenerate one every 7: collinear
    points, a repeated point, a repeated ray, a NaN ray, a zero ray, all
    points at one place, in turn."""
    bear, pts = bear.copy(), pts.copy()
    line = np.linspace(-0.1, 0.1, 3)[:, None] * np.array([1.0, 0.5, 0.2])
    for i in range(0, len(bear), 7):
        kind = (i // 7) % 6
        if kind == 0:
            pts[i] = line
        elif kind == 1:
            pts[i, 1] = pts[i, 0]
        elif kind == 2:
            bear[i, 2] = bear[i, 1]
        elif kind == 3:
            bear[i, 0] = np.nan
        elif kind == 4:
            bear[i, 1] = 0.0
        else:
            pts[i] = pts[i, 0]
    return torch.from_numpy(bear), torch.from_numpy(pts)


def l4_path_sizes(dev) -> list:
    """The distinct (function, floats) of kernel L4's calls in one depthless
    frame of the 2D path (``conf/detection.ork`` over the smoke fixture's
    frame 0 on ``dev``), in order of first call."""
    import tempfile

    from tod_tpu_torch.ops import libm
    from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork

    fx, model_ids, models = load_fixture()
    ax = np.load(A13_FIXTURE)
    sizes = []
    names = ("cosf", "sincosf", "powf", "log_xla")
    wrapped = {name: getattr(libm, name) for name in names}

    def recorder(fn: int, name: str):
        def call(x, *rest):
            if (fn, x.numel()) not in sizes:
                sizes.append((fn, x.numel()))
            return wrapped[name](x, *rest)
        return call

    with tempfile.TemporaryDirectory() as tmp:
        db_params = write_catalog_db(tmp, model_ids, models)
        frames = write_frames(os.path.join(tmp, "depthless"), fx, True)
        p = build_pipeline_from_ork(os.path.join(ROOT, str(ax["ork"])), {
            "source1": {"path": frames, "loop": False},
            "pipeline1": {"db": db_params, "device": str(dev)}})
        try:
            for fn, name in enumerate(names):
                setattr(libm, name, recorder(fn, name))
            Scheduler(p.plasm).execute_iteration()
        finally:
            for name, f in wrapped.items():
                setattr(libm, name, f)
    return sizes


def p2_cases(seed: int = 29):
    """Kernel P2's inputs at ``P2_SHAPE``, ``P2_LARGE_SHAPE`` and
    ``P2_ODD_SHAPE`` in turn, from one generator: (shape, (R0 (o, p, 3,
    3), T0 (o, p, 3), K, X (o, 1, n, 3), uv (o, 1, n, 2), w (o, p, n)))
    float32 tensors: poses near the truth, noisy pixels, a fifth of the
    rows weighted out, a few points behind the camera."""
    rng = np.random.default_rng(seed)
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    for shape in (P2_SHAPE, P2_LARGE_SHAPE, P2_ODD_SHAPE):
        n_obj, n_pose, n = shape
        X = torch.from_numpy(rng.uniform(-0.12, 0.12, (n_obj, 1, n, 3))
                             .astype(np.float32))
        X[:, :, :, 2] += 0.8
        X[0, 0, :5, 2] = -0.5                      # behind the camera
        ang = rng.uniform(-0.03, 0.03, (n_obj, n_pose, 3))
        R0 = torch.from_numpy(np.stack([np.stack([cv_rodrigues(a)
                                                  for a in row])
                                        for row in ang]).astype(np.float32))
        T0 = torch.from_numpy(rng.uniform(-0.01, 0.01, (n_obj, n_pose, 3))
                              .astype(np.float32))
        uv = X[..., :2] / X[..., 2:3] * 525.0 + torch.tensor([319.5, 239.5])
        uv = uv + torch.from_numpy(rng.normal(0, 0.5, uv.shape).astype(
            np.float32))
        w = torch.from_numpy((rng.random((n_obj, n_pose, n)) > 0.2)
                             .astype(np.float32))
        yield shape, (R0, T0, K, X, uv, w)


def check_p2(dev, card: str) -> dict:
    """Phase 3i: kernel P2 (the fused Gauss-Newton refinement) against its
    plain version on the CPU, bit for bit, at a 2D chunk's shape
    (``P2_SHAPE``: objects x refined poses x matches; seeded poses near
    the truth, noisy pixels, a fifth of the rows weighted out, a few points
    behind the camera), at ``P2_LARGE_SHAPE`` (a large N: the same code
    path) and at ``P2_ODD_SHAPE`` (an odd N); each timed."""
    from tod_tpu_torch.geometry import pnp

    out = {}
    for shape, host_args in p2_cases():
        n_obj, n_pose, n = shape
        R0, T0, K, X, uv, w = host_args
        args = [t.to(dev) for t in host_args]
        R, T = pnp.gauss_newton_pose(*args)
        t0 = time.perf_counter()
        R_w, T_w = pnp.gauss_newton_pose_torch(R0, T0, K, X, uv, w)
        plain_ms = (time.perf_counter() - t0) * 1e3
        for got, want, what in ((R, R_w, "R"), (T, T_w, "T")):
            if not torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"P2 differs from its plain version in "
                                     f"{what} at {shape}")
        ms = cuda_ms(lambda: pnp.gauss_newton_pose(*args), queued=True)
        host = cuda_ms(lambda: pnp.gauss_newton_pose(*args))
        iters = 5
        ops_ms = P2_OPS * n_obj * n_pose * n * iters / F32_OPS_S * 1e3
        # X and uv once an object, w once a pose, R and T in and out
        bytes_ms = (4 * n_obj * n_pose * n + 20 * n_obj * n
                    + 48 * 2 * n_obj * n_pose) / HBM_BYTES_S * 1e3
        log(f"kernels: P2 equal to gauss_newton_pose_torch bit for bit at "
            f"{n_obj} x {n_pose} poses x {n} matches, 5 iterations; "
            f"{ms:.4f} ms median of {KERNEL_RUNS} on the device (the call "
            f"with its host work {host:.4f} ms); plain version (CPU) "
            f"{plain_ms:.1f} ms; bound {max(ops_ms, bytes_ms):.5f} ms "
            f"({100 * max(ops_ms, bytes_ms) / ms:.1f} %); {card}")
        out[shape] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(ops_ms, bytes_ms),
                          bound_by="operations" if ops_ms >= bytes_ms
                          else "bytes", host_ms=host)
    n_obj, n_pose, n = P2_SHAPE
    return dict(max_abs_err=0.0, **out[P2_SHAPE], library_ms=None,
                plain_on="cpu", large_ms=out[P2_LARGE_SHAPE]["ms"],
                odd_ms=out[P2_ODD_SHAPE]["ms"],
                shape=f"{n_obj} objects x {n_pose} poses x {n} matches, 5 "
                "iterations (a 2D chunk's refinement); large_ms: "
                + " x ".join(map(str, P2_LARGE_SHAPE)) + "; odd_ms: "
                + " x ".join(map(str, P2_ODD_SHAPE)))


def mirror_cases(rng: np.random.Generator, n_obj: int, n_pose: int
                 ) -> tuple:
    """Float32 inputs of M1 and M2 at a 2D chunk's shape: ``R`` (n_obj,
    n_pose, 3, 3) rotations near a camera's view of an object, ``T`` in
    front of it, an object's normal ``n`` (n_obj, 3), and ``cov`` (n_obj,
    3, 3) covariances of near-planar model points; with the edge cases:
    the normal along the viewing ray (``s = 0``, no turn), ``s`` just past
    and under 1e-6, ``T = 0``, a NaN pose, and an isotropic, a rank-0 and a
    rank-1 covariance."""
    ang = rng.uniform(-0.6, 0.6, (n_obj, n_pose, 3))
    R = np.stack([np.stack([cv_rodrigues(a) for a in row]) for row in ang])
    T = np.concatenate([rng.uniform(-0.2, 0.2, (n_obj, n_pose, 2)),
                        rng.uniform(0.5, 1.5, (n_obj, n_pose, 1))], -1)
    n = rng.standard_normal((n_obj, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    R[0, 0], T[0, 0], n[0] = np.eye(3), [0, 0, 1], [0, 0, 1]   # s = 0
    R[0, 1], T[0, 1] = np.eye(3), [0, 0, 0]                    # T = 0
    R[0, 2] = np.eye(3)                                        # s ~ 1e-6
    T[0, 2] = [2e-6, 0, 1]
    R[0, 3] = np.eye(3)
    T[0, 3] = [4e-7, 0, 1]
    R[0, 4, 0, 0] = np.nan
    pts = rng.uniform(-0.1, 0.1, (n_obj, 64, 3)) * [1, 1, 0.05]
    d = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("oki,okj->oij", d, d)
    cov[1] = np.eye(3) * 0.25                                  # isotropic
    cov[2] = 0.0                                               # rank 0
    cov[3] = np.outer([1, 2, 3], [1, 2, 3]) * 1e-3             # rank 1
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 for a in (R, T, n, cov))


def check_mirror(dev, card: str) -> tuple:
    """Phase 3j: kernels M1 (the 2D path's mirror) and M2 (its model
    normal, csrc/mirror.cu) against their plain versions on the CPU, bit
    for bit (NaN where NaN), at ``MIRROR_SHAPES`` with the edge cases of
    :func:`mirror_cases`; each timed on the device and with its host work,
    beside its plain version on the card (the parent's chain of tensor
    ops, with L1e's atan2f and L4's sincosf / cosf) and on the CPU, M2
    beside torch.linalg.eigh (the library column: another algorithm)."""
    from tod_tpu_torch.geometry import detection2d as td

    def same(got, want):
        got = got.cpu()
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int32), want[~nan].view(torch.int32))

    rng = np.random.default_rng(37)
    out = {}
    for shape in MIRROR_SHAPES:
        R, T, n, cov = mirror_cases(rng, *shape)
        want_r, want_t = td.mirror_poses(R, T, n)
        want_n = td.sym3_smallest_vector(cov)
        args = [x.to(dev) for x in (R, T, n)]
        cov_d = cov.to(dev)
        m1_before, m2_before = (td.mirror_poses.launches,
                                td.sym3_smallest_vector.launches)
        got_r, got_t = td.mirror_poses(*args)
        got_n = td.sym3_smallest_vector(cov_d)
        if (td.mirror_poses.launches, td.sym3_smallest_vector.launches) \
                != (m1_before + 1, m2_before + 1):
            raise AssertionError("M1 / M2: not one launch a call")
        for got, want, what in ((got_r, want_r, "M1 R"),
                                (got_t, want_t, "M1 T"),
                                (got_n, want_n, "M2")):
            if not same(got, want):
                raise AssertionError(f"{what} differs from its plain version "
                                     f"at {shape}")
        if shape != MIRROR_SHAPES[0]:
            continue
        n_pose, n_obj = shape[0] * shape[1], shape[0]
        for name, call, plain, on_cpu, library, ops_ms, n_bytes in (
                ("M1", lambda: td.mirror_poses(*args),
                 lambda: td.mirror_poses_torch(*args),
                 lambda: td.mirror_poses(R, T, n), None,
                 n_pose * ((M1_F32_OPS + L1_OPS) / F32_OPS_S
                           + LIBM_OPS / F64_OPS_S) * 1e3,
                 n_pose * 96 + n_obj * 12),
                ("M2", lambda: td.sym3_smallest_vector(cov_d),
                 None,
                 lambda: td.sym3_smallest_vector(cov),
                 lambda: torch.linalg.eigh(cov_d),
                 m2_operations(cov) / F32_OPS_S * 1e3,
                 n_obj * 48)):
            ms = cuda_ms(call, queued=True)
            host = cuda_ms(call)
            t0 = time.perf_counter()
            for _ in range(TWIN_RUNS):
                on_cpu()
            cpu_ms = (time.perf_counter() - t0) * 1e3 / TWIN_RUNS
            # M2's plain version is LAPACK's scalar code, a matrix at a
            # time on the host (geometry/lapack.py syevd3)
            plain_ms = cuda_ms(plain) if plain else cpu_ms
            lib_ms = cuda_ms(library) if library else None
            bytes_ms = n_bytes / HBM_BYTES_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            log(f"kernels: {name} equal to its plain version bit for bit at "
                f"{' and '.join(map(str, MIRROR_SHAPES))} with the edge "
                f"cases; at {shape}: {ms:.4f} ms median of {KERNEL_RUNS} on "
                f"the device (the call with its host work {host:.4f} ms); "
                + (f"the plain version on the card (the parent's chain) "
                   f"{plain_ms:.4f} ms, " if plain else "the plain version ")
                + f"on the CPU {cpu_ms:.3f} ms; "
                + (f"torch.linalg.eigh {lib_ms:.4f} ms; " if lib_ms else "")
                + f"bound {bound_ms:.7f} ms by "
                f"{'operations' if ops_ms >= bytes_ms else 'bytes'}; {card}")
            out[name] = dict(
                max_abs_err=0.0, ms=ms, host_ms=host, plain_ms=plain_ms,
                plain_on="cuda (the parent's chain of tensor ops with L1e "
                "and L4)" if plain else "cpu (LAPACK's scalar ssyevd)",
                plain_cpu_ms=cpu_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=lib_ms,
                shape=(f"{shape[0]} objects x {shape[1]} poses (a 2D "
                       "chunk's mirrors)" if name == "M1" else
                       f"{shape[0]} covariances (a 2D chunk's normals)"))
    return out["M1"], out["M2"]


def consensus_cases(rng: np.random.Generator, n_a: int, n_h: int, m: int
                    ) -> tuple:
    """Kernel R1's inputs, float32 and bool tensors on the CPU: ``R`` (n_a,
    n_h, 3, 3) and ``T`` (n_a, n_h, 3) candidate poses near each object's
    view (a fifth of them anywhere in front), ``K``, model points ``X``
    (n_a, m, 3), pixels ``xy`` (n_a, m, 2) (the true projections with
    noise, a quarter junk), ``valid`` (n_a, m) and ``pose_ok`` (n_a,
    n_h). With the edge cases: pose 0 of object 0 the identity at T = 0,
    under which points sit at camera z = +-1e-9, 1e-6 and their
    neighbours, 0 and behind the camera; a NaN pose; invalid matches and,
    with three objects or more, an object with none."""
    K = torch.tensor([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
    Kn = K.numpy()
    ang = rng.uniform(-0.5, 0.5, (n_a, 3))
    R0 = np.stack([cv_rodrigues(a) for a in ang])
    T0 = np.concatenate([rng.uniform(-0.1, 0.1, (n_a, 2)),
                         rng.uniform(0.5, 1.5, (n_a, 1))], -1)
    X = rng.uniform(-0.12, 0.12, (n_a, m, 3)) * [1, 1, 0.3]
    cam = np.einsum("aij,amj->ami", R0, X) + T0[:, None]
    uv = cam @ Kn.T
    xy = uv[..., :2] / uv[..., 2:3] + rng.normal(0, 2.0, (n_a, m, 2))
    junk = rng.random((n_a, m)) < 0.25
    xy[junk] = rng.uniform([0, 0], [640, 480], (int(junk.sum()), 2))
    dang = rng.normal(0, 0.01, (n_a, n_h, 3))
    far = rng.random((n_a, n_h)) < 0.2
    dang[far] = rng.uniform(-3, 3, (int(far.sum()), 3))
    R = np.stack([np.stack([cv_rodrigues(d) @ R0[a] for d in dang[a]])
                  for a in range(n_a)])
    T = T0[:, None] + rng.normal(0, 0.01, (n_a, n_h, 3))
    R, T, X, xy = (np.asarray(x, np.float32) for x in (R, T, X, xy))
    R[0, 0], T[0, 0] = np.eye(3), 0.0
    edges = np.array([1e-9, -1e-9, 1e-6, 0.0, -0.3], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges[:3], np.float32(1)),
                            np.nextafter(edges[:3], np.float32(0))])
    k = min(m, len(edges))
    X[0, :k, 2] = edges[:k]
    if n_h > 1:
        R[0, 1, 0, 0] = np.nan
    valid = rng.random((n_a, m)) < 0.85
    if n_a >= 3:
        valid[2] = False
    pose_ok = rng.random((n_a, n_h)) < 0.9
    return (torch.from_numpy(R), torch.from_numpy(T), K,
            torch.from_numpy(X), torch.from_numpy(xy),
            torch.from_numpy(valid), torch.from_numpy(pose_ok))


def check_r1(dev, card: str) -> dict:
    """Phase 3l: kernel R1 (the 2D path's reprojection consensus,
    csrc/consensus.cu) against its plain versions, bit for bit (NaN where
    NaN), in every mode at ``R1_SHAPES`` with :func:`consensus_cases`'
    edge cases: the counts of every pose, the selection (the top 8, the
    model normal, M1's mirrors, the 16 poses' inliers and counts), the
    masks and the truncated SSE of the 16; one launch a call. The plain
    versions run on this machine's CPU, at a chunk's shape on the card
    (the parent's route: 9c holds the card's plain path to the CPU's).
    Each mode timed on the device and with its host work at a chunk's
    shape, beside its plain version on the card."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.adjacency import ObjectMatches

    def same(got, want, what, shape):
        got = got.cpu()
        want = want.cpu()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"R1 {what} at {shape}: {got.dtype} "
                                 f"{tuple(got.shape)} against {want.dtype} "
                                 f"{tuple(want.shape)}")
        if got.is_floating_point():
            nan = torch.isnan(want)
            ok = torch.equal(torch.isnan(got), nan) and torch.equal(
                got[~nan].view(torch.int32), want[~nan].view(torch.int32))
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(f"R1 {what} differs from its plain version "
                                 f"at {shape}")

    rng = np.random.default_rng(41)
    thr2 = 16.0
    out = {}
    for shape in R1_SHAPES:
        R, T, K, X, xy, valid, pose_ok = consensus_cases(rng, *shape)
        big = shape == R1_SHAPES[0]
        on = dev if big else torch.device("cpu")
        host = [x.to(on) for x in (R, T, K, X, xy, valid, pose_ok)]
        card_in = [x.to(dev) for x in (R, T, K, X, xy, valid, pose_ok)]

        def matches(x, y, v):
            return ObjectMatches(query_idx=None, train_pts=x,
                                 query_pts=None, query_xy=y, valid=v)

        mh = matches(host[3], host[4], host[5])
        mc = matches(card_in[3], card_in[4], card_in[5])
        Rh, Th, Kh, Rc, Tc, Kc = (host[0], host[1], host[2], card_in[0],
                                  card_in[1], card_in[2])
        want_n = td.consensus_counts_torch(Rh, Th, Kh, mh, host[5], host[6],
                                           thr2)
        want_s = td.consensus_select_torch(want_n, Rh, Th, Kh, mh, host[5],
                                           host[6], thr2)
        want_m = td.count_inliers(want_s.R, want_s.T, Kh, mh, host[5], thr2)
        want_e = td.truncated_sse(want_s.R, want_s.T, Kh, mh, host[5], thr2)
        before = td.consensus_kernel.launches
        got_n = td.consensus_counts(Rc, Tc, Kc, mc, card_in[5], card_in[6],
                                    thr2)
        got_s = td.consensus_select(got_n, Rc, Tc, Kc, mc, card_in[5],
                                    card_in[6], thr2)
        s_R, s_T = got_s.R.clone(), got_s.T.clone()
        got_m, got_c = td.consensus_masks(s_R, s_T, Kc, mc, card_in[5], thr2)
        got_e = td.consensus_sse(s_R, s_T, Kc, mc, card_in[5], thr2)
        if td.consensus_kernel.launches != before + 4:
            raise AssertionError("R1: not one launch a call")
        same(got_n, want_n, "counts", shape)
        for name in td.Selection._fields:
            same(getattr(got_s, name), getattr(want_s, name),
                 f"selection {name}", shape)
        same(got_m, want_m, "masks", shape)
        same(got_c, want_m.sum(-1, dtype=torch.int32), "mask counts", shape)
        same(got_e, want_e, "SSE", shape)
        if not big:
            continue
        n_a, n_h, m = shape
        modes = (
            ("counts", lambda: td.consensus_counts(
                Rc, Tc, Kc, mc, card_in[5], card_in[6], thr2),
             lambda: td.consensus_counts_torch(
                 Rc, Tc, Kc, mc, card_in[5], card_in[6], thr2),
             n_a * n_h * m, 48 * n_a * n_h + 21 * n_a * m + 5 * n_a * n_h),
            ("select", lambda: td.consensus_select(
                got_n, Rc, Tc, Kc, mc, card_in[5], card_in[6], thr2),
             lambda: td.consensus_select_torch(
                 got_n, Rc, Tc, Kc, mc, card_in[5], card_in[6], thr2),
             n_a * 2 * td.N_REFINE * m, 5 * n_a * n_h + 21 * n_a * m
             + n_a * 2 * td.N_REFINE * (48 + m)),
            ("masks", lambda: td.consensus_masks(
                s_R, s_T, Kc, mc, card_in[5], thr2),
             lambda: td.count_inliers(s_R, s_T, Kc, mc, card_in[5], thr2),
             n_a * 2 * td.N_REFINE * m, 21 * n_a * m
             + n_a * 2 * td.N_REFINE * (52 + m)),
            ("sse", lambda: td.consensus_sse(
                s_R, s_T, Kc, mc, card_in[5], thr2),
             lambda: td.truncated_sse(s_R, s_T, Kc, mc, card_in[5], thr2),
             n_a * 2 * td.N_REFINE * m, 21 * n_a * m
             + n_a * 2 * td.N_REFINE * 52))
        for mode, call, plain, pairs, n_bytes in modes:
            ms = cuda_ms(call, queued=True)
            host_ms = cuda_ms(call)
            plain_ms = cuda_ms(plain, runs=3, warmup=1)
            ops_ms = pairs * R1_PAIR_OPS / F32_OPS_S * 1e3
            bytes_ms = n_bytes / HBM_BYTES_S * 1e3
            bound_ms = max(ops_ms, bytes_ms)
            log(f"kernels: R1 {mode} equal to its plain version bit for bit "
                f"at {' and '.join(map(str, R1_SHAPES))} with the edge "
                f"cases; at {shape}: {ms:.4f} ms median of {KERNEL_RUNS} on "
                f"the device (the call with its host work {host_ms:.4f} ms); "
                f"the plain version on the card {plain_ms:.3f} ms; bound "
                f"{bound_ms:.5f} ms by "
                f"{'operations' if ops_ms >= bytes_ms else 'bytes'} "
                f"({100 * bound_ms / ms:.1f} %); no library call computes "
                f"it; {card}")
            out[mode] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms,
                             bound_by="operations" if ops_ms >= bytes_ms
                             else "bytes")
        del card_in, host, mh, mc
        torch.cuda.empty_cache()
    n_a, n_h, m = R1_SHAPES[0]
    return dict(max_abs_err=0.0, **out["counts"], library_ms=None,
                plain_on="cuda (count_inliers, the parent's route)",
                modes_ms={k: v["ms"] for k, v in out.items()},
                modes_host_ms={k: v["host_ms"] for k, v in out.items()},
                modes_plain_ms={k: v["plain_ms"] for k, v in out.items()},
                modes_bound_ms={k: v["bound_ms"] for k, v in out.items()},
                shape=f"{n_a} objects x {n_h} poses x {m} matches (a 2D "
                "chunk's consensus; masks and SSE at its 16 refined poses)")


def m2_operations(cov: torch.Tensor) -> int:
    """Kernel M2's float32 operations on these matrices: ssyevd's fixed part
    each, plus the rotations, 2x2 eigensystems and column mixes that this
    data's QL/QR iterations take (counted by running the plain version)."""
    from tod_tpu_torch.geometry import lapack

    counts = Counter()
    wrapped = {k: getattr(lapack, k) for k in ("_lartg", "_laev2", "_rotate")}

    def counting(name):
        def call(*args):
            counts[name] += len(args[2]) if name == "_rotate" else 1
            return wrapped[name](*args)
        return call

    try:
        for k in wrapped:
            setattr(lapack, k, counting(k))
        lapack.smallest_eigenvector_torch(cov.cpu())
    finally:
        for k, f in wrapped.items():
            setattr(lapack, k, f)
    return (M2_FIXED_OPS * len(cov.reshape(-1, 9))
            + M2_LARTG_OPS * counts["_lartg"]
            + M2_LAEV2_OPS * counts["_laev2"]
            + M2_ROTATE_OPS * counts["_rotate"])


def check_lapack(dev, card: str) -> dict:
    """Phase 3k: the card against the reference's own outputs
    (``P3P_FIXTURE``, tools/make_torch_p3p_fixture.py). LAPACK's LU of
    kernels P1 and P2 (csrc/lapack_lu.cuh, through p3p.cu's check entry
    ``tod_lu_solve``) at n = 3 and 6, and kernel M2's normals, bit for bit
    (NaN where NaN): it raises otherwise. P1 (with the port's Horn fit)
    and P2 are counted against the reference's candidates and poses
    (ROADMAP queue C: their fusions are not all transcribed yet). Returns
    each kernel's ``fixture`` note."""
    import hashlib

    from tod_tpu_torch import kernels
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry import pnp

    fx = np.load(P3P_FIXTURE)

    def same(got, want) -> np.ndarray:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        return (got.view(np.int32) == want.view(np.int32)) | (
            np.isnan(got) & np.isnan(want))

    notes = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for n in (3, 6):
        M = torch.from_numpy(fx[f"lu{n}_M"]).to(dev).contiguous()
        F = torch.from_numpy(fx[f"lu{n}_F"]).to(dev).contiguous()
        x = torch.empty_like(F)
        kernels.call("p3p", "tod_lu_solve",
                     [M.data_ptr(), F.data_ptr(), x.data_ptr()],
                     [len(M), n], stream)
        hit = same(x.cpu(), fx[f"lu{n}_x"]).all(1)
        if not hit.all():
            raise AssertionError(f"the card's {n}x{n} LU differs from "
                                 f"jnp.linalg.solve on {int((~hit).sum())} "
                                 f"of {len(hit)} systems")
        notes[f"lu{n}"] = len(hit)
    normal = td.sym3_smallest_vector(torch.from_numpy(fx["cov"]).to(dev))
    hit = same(normal.cpu(), fx["normal"]).all(1)
    if not hit.all():
        raise AssertionError(f"M2 differs from jnp.linalg.eigh's column 0 "
                             f"on {int((~hit).sum())} of {len(hit)} "
                             "covariances")
    head = len(fx["p3p_valid_head"])
    bear, pts = p3p_samples(np.random.default_rng(int(fx["p3p_seed"])),
                            int(fx["p3p_n"]))
    if hashlib.sha256(np.concatenate([bear, pts]).tobytes()).hexdigest() \
            != str(fx["p3p_in_sha256"]):
        raise AssertionError("p3p_samples no longer gives the fixture's "
                             "inputs")
    sols = pnp.p3p(torch.from_numpy(bear[:head]).to(dev),
                   torch.from_numpy(pts[:head]).to(dev))
    valid = fx["p3p_valid_head"]
    p3p_equal = (same(sols.R.cpu(), fx["p3p_R_head"]).all((-1, -2))
                 & same(sols.T.cpu(), fx["p3p_T_head"]).all(-1)
                 & (sols.valid.cpu().numpy() == valid))
    p2_equal = []
    for k, (shape, host) in enumerate(p2_cases()):
        if k == len(fx["p2_shapes"]):
            break
        R, T = pnp.gauss_newton_pose(*[t.to(dev) for t in host])
        eq = (same(R[0].cpu(), fx[f"p2_R_head{k}"]).all((-1, -2))
              & same(T[0].cpu(), fx[f"p2_T_head{k}"]).all(-1))
        p2_equal.append((shape, int(eq.sum()), len(eq)))
    log(f"kernels: 3k against the reference's outputs (torch_p3p_fixture): "
        f"the card's LU = jnp.linalg.solve bit for bit on {notes['lu3']} "
        f"3x3 and {notes['lu6']} 6x6 systems; M2 = jnp.linalg.eigh's "
        f"column 0 (sign too) on {len(hit)} covariances; P1 + the Horn fit: "
        f"{int(p3p_equal.sum())} of {p3p_equal.size} candidates of "
        f"{head} samples the reference's bits ({int(p3p_equal[valid].sum())}"
        f" of {int(valid.sum())} valid ones); P2: "
        + ", ".join(f"{a} of {b} poses at {' x '.join(map(str, s))}"
                    for s, a, b in p2_equal)
        + f" the reference's bits (ROADMAP queue C); {card}")
    return dict(
        P1=f"LU {notes['lu3']} systems bit for bit; P3P "
           f"{int(p3p_equal.sum())} of {p3p_equal.size} candidates",
        P2=f"LU {notes['lu6']} systems bit for bit; poses "
           + ", ".join(f"{a} of {b}" for _, a, b in p2_equal),
        M2=f"{len(hit)} normals bit for bit")


def cv_rodrigues(ax) -> np.ndarray:
    """The rotation of axis-angle ``ax`` (numpy, float64)."""
    th = float(np.linalg.norm(ax))
    if th == 0.0:
        return np.eye(3)
    k = np.asarray(ax) / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def check_l3_tile(dev, card: str, desc: torch.Tensor, db: torch.Tensor):
    """Phase 3h: kernel L3's tile against its plain tile on the card, bit for
    bit, at 7e's shape (``desc``, frame 0's 5000 SIFT descriptor slots, x
    the first DB chunk of the three SIFT models' rows), at ``L3_Q`` queries, at one
    query and at a "lanes" and a "parity" width; timed at 7e's shape
    beside the plain tile and torch.matmul with the formula. Returns its
    ``kernels`` entry's measured fields."""
    from tod_tpu_torch.ops import matching as tm

    rows = db
    chunk = rows[:4096].contiguous()
    big_q = desc.repeat(-(-L3_Q // len(desc)), 1)[:L3_Q].contiguous()
    cases = [(desc, chunk, 4096), (big_q, rows[4096:8192].contiguous(),
                                   4000),
             (desc[:1], chunk, 4096), (desc[:333], chunk[:100], 100),
             (desc[:77], chunk[:150], 149)]
    for q, r, n_valid in cases:
        kind = tm.l2_order(len(q), len(r))
        got = tm.l2_distances(q, r, n_valid, kind)
        want = tm.l2_distances_torch(q, r, n_valid, kind)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"L3 at {tuple(q.shape)} x "
                                 f"{tuple(r.shape)} ({kind}) differs from "
                                 "its plain tile")
        log(f"kernels: L3 equal to l2_distances_torch bit for bit at "
            f"{len(q)} x {len(r)} ({kind}, {n_valid} valid rows)")
    n_q, kind = len(desc), tm.l2_order(len(desc), 4096)
    l3_ms = cuda_ms(lambda: tm.l2_distances(desc, chunk, 4096, kind),
                    queued=True)
    l3_host = cuda_ms(lambda: tm.l2_distances(desc, chunk, 4096, kind))
    l3_plain = cuda_ms(lambda: tm.l2_distances_torch(desc, chunk, 4096,
                                                     kind),
                       runs=TWIN_RUNS, warmup=1)

    def library():
        q_sq, r_sq = (desc * desc).sum(1), (chunk * chunk).sum(1)
        return torch.clamp_min((q_sq[:, None] + r_sq[None]) - 2.0 * (
            desc @ chunk.T), 0.0)

    l3_lib = cuda_ms(library, queued=True)
    big_ms = cuda_ms(lambda: tm.l2_distances(big_q, chunk, 4096, kind),
                     queued=True)
    l3_ops_ms = 2 * 128 * n_q * 4096 / F32_OPS_S * 1e3
    l3_bytes = 512 * (n_q + 4096) + 4 * n_q * 4096
    l3_bytes_ms = l3_bytes / HBM_BYTES_S * 1e3
    log(f"kernels: L3 {l3_ms:.4f} ms median of {KERNEL_RUNS} on the device "
        f"at {n_q} x 4096 ({kind}; {2 * 128 * n_q * 4096 / l3_ms / 1e9:.1f} "
        f"TFLOP/s; the call with its host work {l3_host:.4f} ms); "
        f"plain {l3_plain:.3f} ms median of {TWIN_RUNS}; torch.matmul with "
        f"the formula (library; another rounding) {l3_lib:.4f} ms; bound "
        f"{max(l3_ops_ms, l3_bytes_ms):.4f} ms ({l3_bytes} bytes "
        f"{l3_bytes_ms:.4f} ms, f32 FMAs {l3_ops_ms:.4f} ms); at {L3_Q} x "
        f"4096 {big_ms:.4f} ms; {card}")
    return dict(max_abs_err=0.0, ms=l3_ms, plain_ms=l3_plain,
                bound_ms=max(l3_ops_ms, l3_bytes_ms),
                bound_by="operations" if l3_ops_ms >= l3_bytes_ms
                else "bytes", library_ms=l3_lib, host_ms=l3_host,
                large_ms=big_ms,
                shape=f"{n_q} x 4096 (frame 0's SIFT descriptor slots x a "
                f"DB chunk; large_ms: {L3_Q} x 4096)")


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
    b4_mm_ms = int_mm_ms(q_main, ldb, sel_t.tolist())
    log(f"kernels: B4 {b4_ms:.3f} ms median of {KERNEL_RUNS} "
        f"({b4_pairs / b4_ms / 1e6:.1f} G pairs/s); twin {b4_plain_ms:.3f} "
        f"ms median of {TWIN_RUNS}; bound {b4_bound[0]:.3f} ms by "
        f"{b4_bound[1]}; Q={Q} x {B2_SLOTS} slots ({b4_pairs // Q} rows); "
        f"yardstick torch._int_mm on the slab's int8 product alone: "
        f"{b4_mm_ms:.3f} ms; {card}")
    log(f"kernels: coarse B3 {coarse_ms:.3f} ms "
        f"({coarse_pairs / coarse_ms / 1e6:.1f} G pairs/s) at "
        f"Q={q_c.shape[0]} x {sum(cdb.rows_host)} rows; full-sweep B3 "
        f"{sweep_ms:.3f} ms ({sweep_pairs / sweep_ms / 1e6:.1f} G pairs/s) "
        f"at Q={Q} x {sum(ldb.rows_host)} rows, {N_LARGE} objects; {card}")

    # ---- 4d. the SIFT main path: full sweep, 100 objects ------------------
    compacted = [stage_features_compact(*frame, cfg) for frame in frames]
    for f, port in enumerate(compacted):
        check_sift_compaction(port, sx, f)
        check_sift_floats(frames[f][0], cfg, sx, f)
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
                 bound_ms=b4_bound[0], bound_by=b4_bound[1],
                 int_mm_ms=b4_mm_ms))


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
            COUNTED_KERNELS, launches["6"])))
    want = [0, 0, 0, 0, 2 * len(model_ids), 0, 0]
    if matcher_counts(launches["6"]) != want:
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
    reset_counts()
    t0 = time.perf_counter()
    desc, world, valid = train_views(sv, feature_settings(
        {**TRAIN_FEATURES, "type": "SIFT"}), dev)
    sift_s = time.perf_counter() - t0
    launches["6c"] = read_counts()
    log(f"train sift: {len(sv)} views, launches " + ", ".join(
        f"{name} {n}" for name, n in zip(COUNTED_KERNELS, launches["6c"])))
    if any(launches["6c"][:N_MATCH_NOISE]):
        raise AssertionError(f"train sift: launches {list(launches['6c'])}"
                             ", expected the features' kernels alone")
    check_feature_counts("train sift", len(sv), launches["6c"], sift=True)
    flat = valid.reshape(-1)
    model = fill_model(model_ids[0], desc.reshape(-1, 128)[flat],
                       world.reshape(-1, 3)[flat])
    want_d, want_p = tx["sift0_desc"], tx["sift0_points"]
    exact = (np.array_equal(valid, unpacked(tx["sift0_valid"], n_feat))
             and np.array_equal(model.points, want_p))
    same = exact and np.array_equal(model.descriptors, want_d)
    diff = quantize_numpy(model.descriptors).astype(np.int32) \
        - quantize_numpy(want_d).astype(np.int32) if exact else None
    log(f"train: SIFT, {model_ids[0]} on {len(sv)} of {len(views[0])} "
        f"views (every {tx['sift_views'][1]}th): {model.n_points} rows; "
        f"valid masks and points equal to the reference's: {exact}; "
        f"descriptors bit for bit: {same}; "
        f"{int((diff != 0).sum()) if exact else 'all'} of "
        f"{want_d.size} quantised entries differ; trained in {sift_s:.3f} "
        f"s ({sift_s / len(sv) * 1e3:.2f} ms a view); {card}")
    if not same or diff.any():
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
                    COUNTED_KERNELS,
                    launches["7c"])) + f"; {card}")
        if not same:
            raise AssertionError("cells-train: the model differs from the "
                                 "reference's")
        if matcher_counts(launches["7c"]) != [0, 0, 0, 0, 1, 0, 0]:
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
        if matcher_counts(counts) != want:
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
    if not same or matcher_counts(launches["8a train"]) != [
            0, 0, 0, 0, 2, 0, 0]:
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


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of ``a`` whose bits differ from ``b``'s (NaN as NaN)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.numel(), b.numel(), 1)
    if a.is_floating_point():
        nan = torch.isnan(a) & torch.isnan(b)
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return int(((a.view(view) != b.view(view)) & ~nan).sum())
    return int((a != b).sum())


def check_devices_2d(inputs: dict, gg, sub, dev, card: str) -> None:
    """Phase 9c: ``A13_OBJECT``'s rounds of the port's 2D path on the card
    and on this machine's CPU from the same inputs and noise, every stage
    (the log-ratios, the sampling graph and its histogram, the weights and
    triples, P1's distances against its plain twin, the candidate poses,
    the counts and the top 8, the mirrors, the refined poses and the SSE,
    the round's pose, count and accept, the next round's valid mask)
    compared bit for bit; raises at any difference, naming the first
    stage where the devices part."""
    from tod_tpu_torch.geometry import detection2d as td
    from tod_tpu_torch.geometry.adjacency import ObjectMatches
    from tod_tpu_torch.geometry.ransac import ThreefryNoise

    f, name = A13_OBJECT
    _, clustered, cfg, K = replay_2d(gg, inputs, sub, dev)
    o = [str(x) for x in inputs["object_ids"]].index(name)
    part = ObjectMatches(*(x[o:o + 1] for x in clustered))
    part_cpu = ObjectMatches(*(x.cpu() for x in part))
    noise = ThreefryNoise(sub, cfg.max_instances, False, dev)
    n_obj, mcap = clustered.valid.shape
    valid, valid_cpu = part.valid, part.valid.cpu()
    t0 = time.perf_counter()
    stages = 0
    for i in range(cfg.max_instances):
        g = noise(f"round{i}", (n_obj, 3, cfg.n_hypotheses, mcap),
                  rows=np.array([o]))
        tr_card, tr_cpu = {}, {}
        out = td.ransac_round_2d(g, part, K, valid, cfg, trace=tr_card)
        out_cpu = td.ransac_round_2d(g.cpu(), part_cpu, K.cpu(), valid_cpu,
                                     cfg, trace=tr_cpu)
        accept = out[4] & (out[3] >= cfg.min_inliers)
        accept_cpu = out_cpu[4] & (out_cpu[3] >= cfg.min_inliers)
        valid = td.invalidate_keypoints(valid, part.query_idx, out[2], accept)
        valid_cpu = td.invalidate_keypoints(valid_cpu, part_cpu.query_idx,
                                            out_cpu[2], accept_cpu)
        tr_card.update(R=out[0], T=out[1], inliers=out[2], n_unique=out[3],
                       found=out[4], accept=accept, next_valid=valid)
        tr_cpu.update(R=out_cpu[0], T=out_cpu[1], inliers=out_cpu[2],
                      n_unique=out_cpu[3], found=out_cpu[4],
                      accept=accept_cpu, next_valid=valid_cpu)
        for stage, x in tr_card.items():
            n = bits_differ(x, tr_cpu[stage])
            stages += 1
            if n:
                raise AssertionError(
                    f"a13-devices: frame {f}, {name}, round {i}: the card "
                    f"and the CPU part at stage {stage} ({n} of "
                    f"{x.numel()} entries differ)")
        log(f"a13-devices: frame {f}, {name}, round {i}: {len(tr_card)} "
            f"stages equal on the card and the CPU bit for bit (found "
            f"{bool(out[4][0])}, {int(out[3][0])} unique inliers, accept "
            f"{bool(accept[0])})")
    log(f"a13-devices: {stages} stage outputs of {cfg.max_instances} rounds "
        f"equal on both devices in {time.perf_counter() - t0:.1f} s; {card}")


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
                COUNTED_KERNELS,
                launches["9a"])))
        if matcher_counts(launches["9a"]) != [0, 0, 0, 0, n_frames, 0,
                                    n_frames * rounds]:
            raise AssertionError(f"a13: launches {list(launches['9a'])}, "
                                 f"expected one B5 a frame and {rounds} N1 "
                                 "(one a round)")
        l3_n, l3t, p1_n, l4_n, p2_n, l1e_n, m1_n, m2_n, r1_n = \
            launches["9a"][N_MATCH_NOISE + 2:]
        if l3_n or l3t or p1_n < n_frames * rounds or l4_n < p1_n \
                or p2_n != 2 * p1_n or l1e_n or m1_n or m2_n \
                or r1_n != R1_PER_CHUNK * p1_n:
            raise AssertionError(f"a13: launches {list(launches['9a'])}, "
                                 "expected P1 at least once a round and "
                                 "chunk, L4 more often, P2 twice a P1, R1 "
                                 f"{R1_PER_CHUNK} times a P1 (the "
                                 "consensus's counts and selection, the "
                                 "refinement's two recounts and SSE), no "
                                 "M1 or M2 (the mirror and the model normal "
                                 "run inside R1), no L1e, no L3")
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

        # ---- 9c. the gap's object, every stage on the card and the CPU ---
        sub0 = prng.split(prng.prng_key(int(gg.params["seed"])))[1]
        check_devices_2d(inputs[A13_OBJECT[0]], gg, sub0, dev, card)

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
        self.total = [0] * len(COUNTED_KERNELS)

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
    names = COUNTED_KERNELS
    log("a14: launches of the sharded paths " + ", ".join(
        f"{name} {n}" for name, n in zip(names, counted.total)))
    missing = [name for name, n in zip(names[:N_MATCH_NOISE],
                                       counted.total)
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
            if matcher_counts(launches["11a-train"]) != [0, 0, 0, 0, 2, 0, 0]:
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
            ref_dist = ref["ref_dist"][f]
            off = int((m.dist.view(np.int32)
                       != ref_dist.view(np.int32)).sum())
            log(f"sift-graph: frame {f}: {m.dist.shape[0]} queries x k "
                f"{m.k}, {int(m.valid.sum())} in radius; query rows whose "
                f"matched rows differ from the reference's: {swapped}; the "
                f"rest of the MatchSet equal: {same}; distances not bit for "
                f"bit the reference's: {off} of {m.dist.size}; {secs:.2f} s; "
                f"{card}")
            if swapped or not same or off or m.dist.dtype != ref_dist.dtype:
                raise AssertionError(f"sift-graph: frame {f}'s MatchSet "
                                     "differs from the reference's")
            results.append(list(det.outputs["pose_results"]))
        launches["7e"] = read_counts()
        check_launches("sift-graph", len(results), launches["7e"], full=None,
                       sift=True, l3=True)
        for f, res in enumerate(results):
            check_frame(f, res, fx, ref, what="sift-graph")
        log("sift-graph: conf/detection.ork with SIFT on the card: every "
            "placement within 2 cm; the reference's accepts (every "
            "instance) at its poses within 1 cm and 2 degrees")
        del pipeline, sched, det


# ---- the last cv2 users: JPEG (A12g) and the synthetic renderer -----------

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


def blobs_of(data: np.ndarray, offsets: np.ndarray):
    return [data[a:b].tobytes() for a, b in zip(offsets[:-1], offsets[1:])]


def jpeg_cases(jx, card: str, what: str) -> None:
    """Every JPEG case of ``jx`` (``case_names``, ``case_blob``) decoded by
    utils/jpeg.py equal to cv2's pixels (arrays, or SHA-256 digests for the
    480 x 640 ones) under IMREAD_UNCHANGED and IMREAD_COLOR; the 480 x 640
    decodes timed on the host."""
    from tod_tpu_torch.utils.jpeg import decode_jpeg

    names = [str(n) for n in jx["case_names"]]
    vga = []
    for i, (name, data) in enumerate(zip(names, blobs_of(
            jx["case_blob"], jx["case_offsets"]))):
        for key, color in (("unchanged", False), ("color", True)):
            t0 = time.perf_counter()
            px = decode_jpeg(data, color=color)
            ms = (time.perf_counter() - t0) * 1e3
            if f"case{i}_{key}" in jx.files:
                same_array(px, jx[f"case{i}_{key}"], f"{what}: {name} ({key})")
            elif digest(px) != str(jx[f"case{i}_{key}_sha"]):
                raise AssertionError(f"{what}: {name} ({key}) differs from "
                                     "cv2's pixels")
            else:
                vga.append(f"{name} ({key}) {ms:.0f} ms")
    log(f"{what}: {len(names)} files decoded equal to cv2's pixels under "
        f"IMREAD_UNCHANGED and IMREAD_COLOR; host decode of a 480x640 "
        f"frame: {'; '.join(vga)}; {card}")


def jpeg_recording(dev, fx, jx, tmp: str, what: str, launches: dict
                   ) -> None:
    """``jx``'s two-frame "pairs" recording (``rec_color{f}`` JPEG,
    ``rec_depth{f}`` PNG) through ``cli ingest`` into tools/ingest_frames.py's
    frames (``rec_frames_json``), the first through conf/detection.ork on
    ``dev`` (B5, N1): its MatchSet equal to the reference graph's
    (``rec_match_json``), the reference's accepts (``rec_ref_*``) at its
    poses. Launches under ``launches[what + "-detect"]``."""
    import shutil

    from tod_tpu_torch import cli

    model_ids, models = load_fixture()[1:]
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
        raise AssertionError(f"{what}-ingest: the frames differ from "
                             "tools/ingest_frames.py's")
    log(f"{what}-ingest: {text.strip()}: a {n_rec}-frame pairs recording "
        f"(JPEG colour, PNG depth) in {ingest_s:.2f} s on the host; every "
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
    key = f"{what}-detect"
    launches[key] = read_counts()
    check_launches(key, 1, launches[key], full=4)
    m = pipeline.cells["pipeline1"].descriptor_matcher.outputs["matches"]
    want = json.loads(str(jx["rec_match_json"]))
    for name, sha in want.items():
        if digest(getattr(m, name)) != sha:
            raise AssertionError(f"{key}: MatchSet {name} differs from the "
                                 "reference graph's")
    ref = {k[len("rec_"):]: jx[k] for k in jx.files
           if k.startswith("rec_ref_")}
    check_frame(0, res[0], fx, ref, image=0, what=key)
    log(f"{key}: conf/detection.ork over the ingested JPEG frame: MatchSet "
        f"({int(m.valid.sum())} in radius) equal to the reference graph's; "
        "its accepts at the reference's poses")


def jpeg_phases(dev, card: str, fx, jx, launches: dict) -> None:
    """Phase 12a: the JPEG decoder against cv2's pixels, ``cli ingest`` of
    a JPEG recording, its frame through conf/detection.ork, the same for
    progressive files cut short, which libjpeg block-smooths
    (tests/data/torch_jpeg_smoothing_fixture.npz), and training from JPEG
    attachments of a legacy CouchDB."""
    import tempfile

    from tod_tpu_torch.db import ObjectDbParameters, load_models_for_objects

    jpeg_cases(jx, card, "jpeg")
    smooth = np.load(JPEG_SMOOTHING_FIXTURE)
    jpeg_cases(smooth, card, "jpeg-smoothing")
    with tempfile.TemporaryDirectory() as tmp:
        jpeg_recording(dev, fx, jx, os.path.join(tmp, "full"), "12a",
                       launches)
        jpeg_recording(dev, fx, smooth, os.path.join(tmp, "cut"),
                       "12a-smoothing", launches)

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
        if matcher_counts(launches["12a-train"]) != [0, 0, 0, 0, 1, 0, 0]:
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
    from tod_tpu_torch.utils.camera_sizes import bench_object, bench_scenes

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
    if matcher_counts(launches["12b-train"]) != [
            0, 0, 0, 0, 2 * len(objects), 0, 0]:
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


# ---- phase 13: camera sizes -------------------------------------------------

def kind_digest(t: torch.Tensor, kind: str) -> str:
    from tod_tpu_torch.utils.camera_sizes import digest

    return digest(t.cpu().numpy(), kind)


def same_digests(got: dict, want: dict, what: str) -> None:
    bad = sorted(k for k in want if k != "n_valid" and got[k] != want[k])
    if bad:
        raise AssertionError(f"{what}: {bad} differ from the reference's")


def size_grid_phase(dev, card: str, sx, cfg) -> None:
    """13a: at every frame size of the grid, the frame rendered on the host
    and the card's pyramid, ORB and SIFT keypoints against the reference's;
    the features stage timed."""
    from tod_tpu_torch.models.fused import (prepare_frame,
                                            stage_features_compact)
    from tod_tpu_torch.ops import image as timage
    from tod_tpu_torch.ops import orb as torb
    from tod_tpu_torch.ops import sift as tsift
    from tod_tpu_torch.utils import synthetic as syn
    from tod_tpu_torch.utils.camera_sizes import size_camera, size_scene

    grid = json.loads(str(sx["grid_json"]))
    for size, want in grid.items():
        h, w = (int(v) for v in size.split("x"))
        t0 = time.perf_counter()
        image, depth = size_scene(syn, h, w)
        render_ms = (time.perf_counter() - t0) * 1e3
        if (digest(image), digest(depth)) != (want["image"], want["depth"]):
            raise AssertionError(f"sizes: the {size} frame differs from the "
                                 "reference's render")
        gray, depth_t, K_t = prepare_frame(image, depth, size_camera(h, w),
                                           dev)
        levels = timage.build_pyramid(gray, SIZE_LEVELS, 1.2)
        moved = [i for i, lv in enumerate(levels)
                 if digest(lv.cpu().numpy()) != want["levels"][i]]
        if moved:
            raise AssertionError(f"sizes: {size} pyramid levels {moved} "
                                 "differ from the reference's")
        n_valid = {}
        for n in (3, SIZE_LEVELS):
            kps, desc = torb.orb_detect_and_compute(
                gray, n_features=5000, n_levels=n, scale_factor=1.2)
            same_digests({**{k: kind_digest(getattr(kps, k), k)
                             for k in ("valid", "xy", "level")},
                          "desc": kind_digest(desc, "desc")},
                         want[f"orb{n}"], f"sizes: {size} ORB {n} levels")
            kps, _ = tsift.sift_detect_and_compute(
                gray, n_features=2000, n_levels=n, scale_factor=1.2)
            same_digests({k: kind_digest(getattr(kps, k), k)
                          for k in ("valid", "xy", "level")},
                         want[f"sift{n}"], f"sizes: {size} SIFT {n} levels")
            n_valid[n] = (want[f"orb{n}"]["n_valid"],
                          want[f"sift{n}"]["n_valid"])
        lat = [synced_ms(lambda: stage_features_compact(gray, depth_t, K_t,
                                                        cfg))
               for _ in range(SIZE_RUNS + 1)][1:]
        log(f"sizes: {size}: frame rendered on the host ({render_ms:.0f} ms) "
            f"equal to the reference's; {SIZE_LEVELS} pyramid levels bit "
            f"for bit; ORB keypoints and descriptors in slot order and SIFT "
            f"keypoints equal at 3 and {SIZE_LEVELS} levels (valid ORB/SIFT "
            f"{n_valid[3]} and {n_valid[SIZE_LEVELS]}); features stage "
            f"(5000 ORB, 3 levels, compaction to {cfg.q_cap}) median "
            f"{np.median(lat):.2f} ms a frame over {SIZE_RUNS}; {card}")


def size_small_phase(dev, card: str) -> None:
    """13c: the small frame sizes (QQVGA and QCIF first) whose pyramids take
    Eigen's depth splits and oneDNN's kernel tails: the card's 8-level
    pyramid of each size's seeded frame, alone and in a batch of three,
    and at QQVGA and QCIF the rendered frame's ORB keypoints at 3 and 6
    levels, against tests/data/torch_small_sizes_fixture.npz
    (tools/make_torch_small_sizes_fixture.py)."""
    from tod_tpu_torch.models.fused import prepare_frame
    from tod_tpu_torch.ops import image as timage
    from tod_tpu_torch.ops import orb as torb
    from tod_tpu_torch.utils import synthetic as syn
    from tod_tpu_torch.utils.camera_sizes import (size_camera, size_scene,
                                                  small_frame)

    t0 = time.perf_counter()
    zx = np.load(SMALL_SIZES_FIXTURE)
    frames = json.loads(str(zx["frames_json"]))
    for size, want in frames.items():
        h, w = (int(v) for v in size.split("x"))
        for k, levels in enumerate([want["levels"]] + want["batch3"]):
            gray = torch.from_numpy(small_frame(h, w, max(k - 1, 0))).to(dev)
            got = timage.build_pyramid(gray, SIZE_LEVELS, 1.2,
                                       batch=1 if k == 0 else 3)
            moved = [i for i, lv in enumerate(got)
                     if digest(lv.cpu().numpy()) != levels[i]]
            if moved:
                raise AssertionError(
                    f"sizes: {size} pyramid levels {moved} differ from the "
                    "reference's" + ("" if k == 0 else
                                     f" (frame {k - 1} of a batch of 3)"))
    scenes = json.loads(str(zx["scenes_json"]))
    n_valid = {}
    for size, want in scenes.items():
        h, w = (int(v) for v in size.split("x"))
        image, depth = size_scene(syn, h, w)
        if (digest(image), digest(depth)) != (want["image"], want["depth"]):
            raise AssertionError(f"sizes: the {size} frame differs from the "
                                 "reference's render")
        gray = prepare_frame(image, depth, size_camera(h, w), dev)[0]
        for n in (3, 6):
            kps, desc = torb.orb_detect_and_compute(
                gray, n_features=5000, n_levels=n, scale_factor=1.2)
            same_digests({**{k: kind_digest(getattr(kps, k), k)
                             for k in ("valid", "xy", "level")},
                          "desc": kind_digest(desc, "desc")},
                         want[f"orb{n}"], f"sizes: {size} ORB {n} levels")
            n_valid[f"{size} {n}"] = want[f"orb{n}"]["n_valid"]
    log(f"sizes: small frames {', '.join(frames)}: {SIZE_LEVELS} pyramid "
        "levels bit for bit, alone and in a vmapped batch of 3; QQVGA and "
        "QCIF rendered frames' ORB keypoints and descriptors in slot order "
        f"at 3 and 6 levels (valid {n_valid}); "
        f"{time.perf_counter() - t0:.1f} s; {card}")


def size_main_phase(dev, card: str, fx, sx, cfg, launches: dict) -> None:
    """13b: the main path at 720x1280. Bench objects 0-2 rendered on the
    host (24 views each), trained on the card (B5's dedup, then 16x5),
    served in phase 12b's catalog (B1, N1) over two scenes, each step
    held to the reference's; a 720p detect timed in turns with a VGA
    frame."""
    from tod_tpu_torch.cells.trainer import fill_model, train_object
    from tod_tpu_torch.models.fused import (FusedDetector,
                                            stage_features_compact)
    from tod_tpu_torch.ops.compress import compress_model
    from tod_tpu_torch.types import Observation
    from tod_tpu_torch.utils import synthetic as syn
    from tod_tpu_torch.utils.camera_sizes import (HW720, K720, bench_object,
                                                  bench_scenes, rows_digest,
                                                  views_720p)

    main = json.loads(str(sx["main_json"]))
    objects = [bench_object(syn, i) for i in range(len(main["models"]))]
    trained, render_s, train_s = [], [], []
    for obj in objects:
        t0 = time.perf_counter()
        views = views_720p(syn, obj)
        render_s.append(time.perf_counter() - t0)
        want = main["views"][obj.object_id]
        got = {"n": len(views), **{k: digest(np.stack([o[k] for o in views]))
                                   for k in ("image", "depth", "mask")}}
        if got != want:
            raise AssertionError(f"sizes-train: {obj.object_id}'s 720p views "
                                 "differ from the reference's render")
        obs = [Observation(image=o["image"], depth=o["depth"], mask=o["mask"],
                           K=np.float32(o["K"]), R=np.float32(o["R"]),
                           T=np.float32(o["T"]),
                           frame_number=o["frame_number"]) for o in views]
        if not trained:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d8, p8 = train_object(obs, TRAIN_FEATURES, *TRAIN_DEDUP, device=dev)
        train_s.append(time.perf_counter() - t0)
        d16, p16 = compress_model(d8, p8.reshape(-1, 3), *RECOMPRESS,
                                  device=dev)
        want = main["models"][obj.object_id]
        got = {"rows8": len(d8), "desc8": digest(d8),
               "points8": digest(np.asarray(p8, np.float32).reshape(-1, 3)),
               "rows16": len(d16), "desc16": digest(d16),
               "points16": digest(np.asarray(p16, np.float32))}
        if got != want:
            moved = sorted(k for k in want if got[k] != want[k])
            raise AssertionError(
                f"sizes-train: {obj.object_id}'s model differs from the "
                f"reference's in {moved} ({got['rows8']} / {got['rows16']} "
                f"rows, the reference {want['rows8']} / {want['rows16']})")
        trained.append(fill_model(obj.object_id, d16, p16))
    launches["13-train"] = read_counts()
    if matcher_counts(launches["13-train"]) != [
            0, 0, 0, 0, 2 * len(objects), 0, 0]:
        raise AssertionError(f"sizes-train: launches "
                             f"{list(launches['13-train'])}, expected two B5 "
                             "an object")
    log(f"sizes-train: {len(objects)} objects x {len(views)} views of "
        f"720x1280 rendered on the host (" + ", ".join(
            f"{s:.1f}" for s in render_s) + " s an object), equal to the "
        f"reference's; trained on the card to the reference's models (dedup "
        f"8: " + ", ".join(str(main["models"][o.object_id]["rows8"])
                           for o in objects)
        + " rows; 16x5: " + ", ".join(str(len(m.descriptors))
                                      for m in trained)
        + ") in " + ", ".join(f"{s:.2f}" for s in train_s)
        + f" s an object; {card}")

    catalog = smoke_models([m.object_id for m in trained],
                           [(m.descriptors, m.points) for m in trained],
                           n_objects=main["catalog"])
    det = FusedDetector(catalog, cfg, seed=main["seed"], device=dev)
    scenes = bench_scenes(syn, objects, len(main["scenes"]), hw=HW720,
                          K=K720)
    frames = []
    for f, ((image, depth), want) in enumerate(zip(scenes, main["scenes"])):
        if (digest(image), digest(depth)) != (want["image"], want["depth"]):
            raise AssertionError(f"sizes-serve: scene {f} differs from the "
                                 "reference's render")
        frames.append(det.prepare_frame(image, depth, K720))
    reset_counts()
    found = [det.detect(*frame) for frame in frames]
    launches["13-serve"] = read_counts()
    check_launches("sizes-serve", len(frames), launches["13-serve"], full=0)
    ref = {"ref_" + k[len("det_"):]: sx[k] for k in sx.files
           if k.startswith("det_")}
    gt = {k: sx[k] for k in ("gt_ids", "gt_R", "gt_T")}
    for f, (frame, want) in enumerate(zip(frames, main["scenes"])):
        port = stage_features_compact(*frame, cfg)
        moved = [k for t, k in zip(port, ("xy", "qp", "dsc", "ok"))
                 if kind_digest(t, k) != want[k]]
        if moved:
            as_set = rows_digest(*(t.cpu().numpy() for t in port)) \
                == want["rows"]
            raise AssertionError(
                f"sizes-serve: scene {f}'s compacted queries differ from the "
                f"reference's slot by slot in {moved} (as a set: "
                f"{'equal' if as_set else 'unequal'})")
        mine = [i for i in range(len(sx["det_ids"]))
                if sx["det_frame"][i] == f]
        want_accepts = sorted((str(sx["det_ids"][i]), float(sx["det_conf"][i]))
                              for i in mine)
        got_accepts = sorted((r.object_id, float(r.confidence))
                             for r in found[f])
        if got_accepts != want_accepts:
            raise AssertionError(
                f"sizes-serve: scene {f}'s gated accepts (object, inliers) "
                f"{got_accepts} differ from the reference's {want_accepts}")
        check_frame(f, found[f], gt, ref, what="sizes-serve")
        gap = max([pose_error(r.R, r.T, sx["det_R"][i], sx["det_T"][i])
                   for i in mine for r in found[f]
                   if r.object_id == str(sx["det_ids"][i])]
                  or [(0.0, 0.0)])
        log(f"sizes-serve: scene {f}: {want['n_valid']} compacted queries "
            f"equal to the reference's slot by slot; gated accepts "
            f"(object, inliers) {got_accepts}, the reference's; largest "
            f"pose gap {gap[0] * 100:.4f} cm / {gap[1]:.4f} deg")

    vga = det.prepare_frame(fx["images"][0], fx["depths"][0], fx["K"])
    lat = {"720p": [], "VGA": []}
    for _ in range(2):                      # warm both shapes
        det.detect(*frames[0])
        det.detect(*vga)
    for _ in range(SIZE_TURNS):
        for name, frame in (("720p", frames[0]), ("VGA", vga)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det.detect(*frame)
            lat[name].append((time.perf_counter() - t0) * 1e3)
    log(f"sizes-time: detect at {main['catalog']} objects, median over "
        f"{SIZE_TURNS} frames each, in turns: 720x1280 "
        f"{np.median(lat['720p']):.2f} ms, 480x640 "
        f"{np.median(lat['VGA']):.2f} ms; {card}")
    del det, catalog


def size_phases(dev, card: str, fx, launches: dict) -> None:
    """Phase 13: camera sizes."""
    phase_t0 = time.perf_counter()
    sx = np.load(SIZES_FIXTURE)
    cfg = config(sx)
    size_grid_phase(dev, card, sx, cfg)
    size_small_phase(dev, card)
    size_main_phase(dev, card, fx, sx, cfg, launches)
    log(f"sizes: phase 13 took {time.perf_counter() - phase_t0:.1f} s")


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

    # ---- 3g. L1, L1e and L2, the features' kernels, against their plain
    # versions
    l1, l1e, l2 = check_features(dev, card, frames[0][0])
    # ---- 3h. L3, the L2 matcher's distance tile, against its plain tile
    l3, l3t = check_l3(dev, card, frames[0][0])
    # ---- 3i. P1 and L4, the 2D path's kernels, against their plain versions
    p1, l4, p2 = check_p1(dev, card)
    # ---- 3j. M1 and M2, the 2D path's mirror and model normal
    m1, m2 = check_mirror(dev, card)
    # ---- 3k. P1's and P2's LU and M2 against the reference's own outputs
    fixture_notes = check_lapack(dev, card)
    # ---- 3l. R1, the 2D path's reprojection consensus
    r1 = check_r1(dev, card)
    for entry, name in ((p1, "P1"), (p2, "P2"), (m2, "M2")):
        entry["fixture"] = fixture_notes[name]
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
    torch.cuda.empty_cache()
    size_phases(dev, card, fx, launches)

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
         **{**n1, "max_abs_err": max([n1["max_abs_err"], *NOISE_ERR])}},
        {"name": "L1 the keypoint orientation fused from the level image: "
         "the integral images in the compiled cumsum's order, the moments "
         "at the keypoints in its FMA order, glibc's atan2f; two kernels a "
         "call (redesigned; before: the dense moments, ~760 launches a "
         "level, then the elementwise atan2f, L1e) (replaces XLA's "
         "cumsums, fusions and libm call: not a Pallas kernel)",
         "route": "cuda", "source": SOURCE_L1, "replaces": L1_REPLACES,
         "launches": total(7), "design_pr": 21, **l1},
        {"name": "L1e the host libm's float32 atan2f elementwise (L1's "
         "first design; the 2D path's mirror and arccos took it until M1 "
         "and M2, which run it inside) (replaces XLA's atan2, a libm call: "
         "not a Pallas kernel)", "route": "cuda",
         "source": SOURCE_LIBM, "replaces": L1E_REPLACES,
         "launches": total(14), "design_pr": 17, **l1e},
        {"name": "L2 fused SIFT descriptor: patches, gradients, atan2f, soft "
         "bins, the tables' contraction in the reference's summation order "
         "and Lowe's normalisation (replaces XLA's fusions, libm call and "
         "dot: not a Pallas kernel)", "route": "cuda",
         "source": SOURCE_SIFT, "replaces": L2_REPLACES,
         "launches": total(8), "design_pr": 18,
         **l2},
        {"name": "L3 the fused L2 matcher: the k nearest rows over the whole "
         "DB, each squared distance in the reference's summation order "
         "(replaces XLA's reduces, dot, fusion and top-k: not a Pallas "
         "kernel)", "route": "cuda", "source": SOURCE_L3,
         "replaces": L3_REPLACES, "launches": total(9), "design_pr": 19,
         **l3},
        {"name": "L3t L3's distance tile, the orders the fused matcher does "
         "not take (one query; chunks other than 4,096)", "route": "cuda",
         "source": SOURCE_L3, "replaces": L3_REPLACES,
         "launches": total(10), "design_pr": 18, **l3t},
        {"name": "P1 Grunert's P3P up to the Horn fit: sides, quartic, "
         "Ferrari with glibc's powf and cosf, Newton polishes, the 3x3 "
         "Newton steps, the gate; a group of 4 lanes a sample, one root "
         "and both its branches a lane (redesigned; before: a thread a "
         "sample) (replaces "
         "XLA's fusions and libm calls: not a Pallas kernel)",
         "route": "cuda", "source": SOURCE_P1,
         "replaces": P1_REPLACES, "launches": total(11), "design_pr": 21,
         **p1},
        {"name": "L4 glibc's FMA builds of cosf, sincosf and powf, and "
         "XLA's log (replaces XLA's libm calls and log: not a Pallas "
         "kernel)",
         "route": "cuda", "source": SOURCE_LIBM, "replaces": L4_REPLACES,
         "launches": total(12), "design_pr": 20, **l4},
        {"name": "P2 the Gauss-Newton pose refinement, every iteration of "
         "a call in one launch: residuals, Jacobian, the normal equations "
         "in one pairwise-sum tree (registers, shared memory, warp "
         "shuffles), LAPACK's 6x6 LU by one thread, the Rodrigues update "
         "(replaces XLA's fusions, jacfwd and LAPACK's solve: not a Pallas "
         "kernel)",
         "route": "cuda", "source": SOURCE_P2, "replaces": P2_REPLACES,
         "launches": total(13), "design_pr": 20, **p2},
        {"name": "M1 the 2D path's mirror pose: the model normal reflected "
         "about the viewing ray, glibc's atan2f and sincosf, the turn and "
         "Q R, a thread a pose; folded into R1's selection, built and held "
         "on its own here (replaces XLA's fusions and libm calls: not a "
         "Pallas kernel)", "route": "cuda", "source": SOURCE_MIRROR,
         "replaces": M1_REPLACES, "launches": total(15), "design_pr": 22,
         **m1},
        {"name": "M2 the 2D path's model normal: the smallest eigenvector "
         "of a 3x3 covariance by LAPACK's ssyevd (redesigned; before: the "
         "characteristic cubic's closed form), a thread a matrix; its "
         "device code runs inside R1's selection on the 2D path "
         "(replaces jnp.linalg.eigh: not a Pallas kernel)", "route": "cuda",
         "source": SOURCE_MIRROR, "replaces": M2_REPLACES,
         "launches": total(16), "design_pr": 23, **m2},
        {"name": "R1 the 2D path's reprojection consensus: the counts of "
         "every P3P candidate (a block a tile of 128 poses and an object, "
         "the points staged in shared memory), the selection (the stable "
         "top 8, the model normal by M2's device code, M1's mirrors, the "
         "16 poses' inliers; a block an object), the refinement's masks "
         "and truncated SSE (a warp a pose); timed in counts mode, every "
         "mode in modes_ms (replaces XLA's fusions of project, its reduces "
         "over the matches and the mirror's: not a Pallas kernel)",
         "route": "cuda", "source": SOURCE_R1, "replaces": R1_REPLACES,
         "launches": total(17), "design_pr": 24, **r1}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
