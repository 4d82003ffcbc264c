"""The multi-device dry run (the reference's ``dryrun_multichip``,
tod_tpu's ``__graft_entry__.py``): every sharded entry point once, on tiny
shapes, over an n-device ('data', 'db') mesh.

    python -c "from tod_tpu_torch.parallel import dryrun_multichip; \\
        print(dryrun_multichip(4, ['cuda:0'] * 4))"
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import (ActivationConfig,
                                              GuessConfig)
from tod_tpu_torch.geometry.ransac import RansacConfig, SeedPose
from tod_tpu_torch.models.fused import FusedDetectorConfig, pack_models
from tod_tpu_torch.ops.segmented import subsample_models
from tod_tpu_torch.ops.segmented_l2 import quantize_descriptors
from tod_tpu_torch.parallel.detect import detect_batch_sharded
from tod_tpu_torch.parallel.mesh import make_mesh
from tod_tpu_torch.parallel.segmented import (pack_segmented_l2_sharded,
                                              pack_segmented_sharded,
                                              serving_step_sharded,
                                              sharded_object_top1)
from tod_tpu_torch.parallel.train import train_views_sharded
from tod_tpu_torch.types import TodModel
from tod_tpu_torch.utils import prng

H, W = 64, 96
K_TINY = [[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]]


def _tiny_models(rng, n_objects: int = 2, n_points: int = 96):
    return [TodModel(f"obj{i}",
                     rng.integers(0, 256, (n_points, 32), dtype=np.uint8),
                     rng.uniform(-0.1, 0.1, (n_points, 3)).astype(np.float32))
            for i in range(n_objects)]


def _unit_rows(rng, *shape) -> np.ndarray:
    d = rng.random(shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> Dict[str, tuple]:
    """Run the sharded training step, the batched detection step, the
    object-sharded matchers (ORB and SIFT) and the serving step (full
    sweep with a prescreen, coarse->fine, coarse->fine with tracked and
    exploration slots, SIFT coarse->fine) on an (n_devices / n_db, n_db)
    mesh, n_db 2 when n_devices is even. ``devices``: the mesh's devices
    (default: the CUDA devices; a list may repeat one). Returns each
    step's output shape."""
    rng = np.random.default_rng(0)
    n_db = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // n_db
    mesh = make_mesh(n_data=n_data, n_db=n_db, devices=devices)
    dev = mesh.first
    shapes = {}

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # ---- training step: views over 'data' --------------------------------
    v = n_data
    Ks = f32(np.broadcast_to(K_TINY, (v, 3, 3)))
    train = train_views_sharded(mesh, n_features=32, n_levels=1)
    desc, _, _ = train(f32(rng.uniform(0, 255, (v, H, W))),
                       torch.ones((v, H, W), dtype=torch.uint8, device=dev),
                       torch.full((v, H, W), 0.8, device=dev), Ks,
                       f32(np.broadcast_to(np.eye(3), (v, 3, 3))),
                       torch.zeros((v, 3), device=dev))
    shapes["train"] = tuple(desc.cpu().shape)

    # ---- detection step: frames over 'data', DB rows over 'db' -----------
    chunk = 128
    cfg = FusedDetectorConfig(
        n_features=64, n_levels=1, db_chunk=chunk,
        guess=GuessConfig(
            ransac=RansacConfig(n_hypotheses=32, max_instances=1),
            max_matches_per_object=32, object_batch=1))
    db, _ = pack_models(_tiny_models(rng, n_points=64), chunk * n_db,
                        device=dev)
    b = n_data
    det = detect_batch_sharded(
        mesh, prng.split(prng.prng_key(0), b),
        f32(rng.uniform(0, 255, (b, H, W))),
        torch.full((b, H, W), 800, dtype=torch.int32, device=dev), Ks, db,
        cfg)
    shapes["detect"] = tuple(det.accepted.cpu().shape)

    # ---- segmented matcher: objects over 'db', queries over 'data' -------
    # 2 * n_db + 1 objects (padded to 3 a shard): enough for the slots'
    # expanded prescreen below to rank some objects out
    smodels = _tiny_models(rng, n_objects=2 * n_db + 1, n_points=64)
    sdb, _ = pack_segmented_sharded(smodels, mesh, db_chunk=chunk)
    q = torch.as_tensor(rng.integers(0, 256, (n_data * 128, 32)),
                        dtype=torch.uint8, device=dev)
    shapes["object_top1"] = tuple(sharded_object_top1(mesh, q, sdb)[0]
                                  .cpu().shape)

    # ---- the serving step: tier 1 and tier 2 over 'db' --------------------
    scfg = FusedDetectorConfig(
        pipeline="segmented", radius=60.0, q_cap=128,
        activation=ActivationConfig(m_cap=32, n_hypotheses=32,
                                    object_batch=2, prescreen=n_db),
        guess=GuessConfig(
            ransac=RansacConfig(n_hypotheses=64, max_instances=1),
            max_matches_per_object=32, max_active_objects=n_db,
            object_batch=1))
    q_n = 128
    keys = prng.split(prng.prng_key(2), b)
    frame = (f32(rng.uniform(0, 96, (b, q_n, 2))),
             f32(rng.uniform(-0.1, 0.1, (b, q_n, 3))),
             torch.ones((b, q_n), dtype=torch.bool, device=dev),
             torch.as_tensor(rng.integers(0, 256, (b, q_n, 32)),
                             dtype=torch.uint8, device=dev))
    det = serving_step_sharded(mesh, scfg)(keys, *frame, sdb)
    shapes["serving"] = tuple(det.accepted.cpu().shape)

    # ---- coarse->fine: per-shard coarse sweep, slab, per-shard fine pass -
    cf_cfg = dataclasses.replace(
        scfg, coarse_stride=2, fine_width=n_db,
        activation=dataclasses.replace(scfg.activation, prescreen=0))
    csdb, _ = pack_segmented_sharded(subsample_models(smodels, 2), mesh,
                                     db_chunk=chunk)
    det = serving_step_sharded(mesh, cf_cfg)(keys, *frame, sdb, csdb)
    shapes["coarse_fine"] = tuple(det.accepted.cpu().shape)

    # ---- coarse->fine with tracked and exploration slots -----------------
    n_explore = n_db - 1          # none on a 1-shard mesh
    slots_cfg = dataclasses.replace(
        cf_cfg, fine_width=3 * n_db, track_width=1, explore_width=n_explore,
        activation=dataclasses.replace(cf_cfg.activation, prescreen=n_db))
    tracked = torch.tensor([[0]] + [[-1]] * (b - 1), dtype=torch.int32,
                           device=dev)
    explore = (torch.arange(1, 1 + n_explore, dtype=torch.int32,
                            device=dev).expand(b, n_explore)
               if n_explore else None)
    n_obj = sdb.n_objects
    seed_ok = torch.zeros((b, n_obj), dtype=torch.bool, device=dev)
    seed_ok[0, 0] = True
    seeds = SeedPose(R=torch.eye(3, device=dev).expand(b, n_obj, 3, 3),
                     T=torch.zeros((b, n_obj, 3), device=dev), ok=seed_ok)
    det, last_sel = serving_step_sharded(mesh, slots_cfg)(
        keys, *frame, sdb, csdb, tracked, explore, seeds)
    shapes["streaming_slots"] = tuple(det.accepted.cpu().shape)
    shapes["last_coarse_sel"] = tuple(last_sel.cpu().shape)

    # ---- SIFT: the L2 matcher and its coarse->fine step -------------------
    fmodels = [TodModel(f"fobj{i}", _unit_rows(rng, 64, 128),
                        rng.uniform(-0.1, 0.1, (64, 3)).astype(np.float32))
               for i in range(3)]
    sdb_f, _ = pack_segmented_l2_sharded(fmodels, mesh, db_chunk=chunk)
    qi = quantize_descriptors(f32(_unit_rows(rng, n_data * 128, 128)))
    shapes["object_top1_l2"] = tuple(sharded_object_top1(mesh, qi, sdb_f)[0]
                                     .cpu().shape)
    csdb_f, _ = pack_segmented_l2_sharded(subsample_models(fmodels, 2), mesh,
                                          db_chunk=chunk)
    cf_cfg_l2 = dataclasses.replace(cf_cfg, feature="SIFT", radius=0.9)
    dsc_l2 = quantize_descriptors(f32(_unit_rows(rng, b, q_n, 128)))
    det = serving_step_sharded(mesh, cf_cfg_l2)(
        keys, *frame[:3], dsc_l2, sdb_f, csdb_f)
    shapes["coarse_fine_l2"] = tuple(det.accepted.cpu().shape)
    return shapes
