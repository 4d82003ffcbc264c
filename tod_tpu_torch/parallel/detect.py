"""Batched detection over a mesh (tod_tpu/parallel/detect.py): frames over
``'data'``, the global-kNN DB's rows over ``'db'``.

Each frame's features (``models/fused.py stage_features``) run on its data
row's first device; the stacked (B * Q) query descriptors then meet the
row-sharded DB in :func:`~tod_tpu_torch.parallel.matching.
sharded_hamming_topk` (kernel B5 on every tile); each frame's geometry
(``stage_geometry``: the active set, clustering and multi-instance RANSAC)
runs on its row's first device with that frame's key. The reference's
``jit_detect_batch`` only placed inputs for its compiler; here every call
places its own, so it has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from tod_tpu_torch.geometry.ransac import ObjectDetections, ThreefryNoise
from tod_tpu_torch.models.fused import (FusedDetectorConfig, GeomDb, ModelDb,
                                        stage_features, stage_geometry)
from tod_tpu_torch.parallel.matching import sharded_hamming_topk
from tod_tpu_torch.parallel.mesh import Mesh, all_gather, split_even


def detect_batch_sharded(mesh: Mesh, keys: np.ndarray, grays: torch.Tensor,
                         depths: torch.Tensor, Ks: torch.Tensor, db: ModelDb,
                         cfg: FusedDetectorConfig) -> ObjectDetections:
    """Detect B frames: ``grays`` (B, H, W) f32, ``depths`` (B, H, W),
    ``Ks`` (B, 3, 3), ``keys`` (B, 2) uint32 (frame ``b``'s noise from
    ``keys[b]`` down the global path's key path). B must divide by the data
    axis; the DB's rows into ``'db'`` shards of whole ``cfg.db_chunk``s
    (``pack_models(models, db_chunk * n_db)``). Returns ObjectDetections
    (B, O, I, ...) on the mesh's first device."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    n_b = keys.shape[0]
    per = split_even(n_b, mesh.shape["data"], "frames over 'data'")
    feats = []
    for b in range(n_b):
        dev = mesh.device(b // per, 0)
        feats.append(stage_features(*(t[b].to(dev, non_blocking=True)
                                      for t in (grays, depths, Ks)), cfg))
    q = feats[0][1].shape[0]
    desc = all_gather([f[1] for f in feats], mesh.first)
    dist, rows = sharded_hamming_topk(mesh, desc, db.words, db.n_valid,
                                      k=cfg.k_matches, chunk=cfg.db_chunk,
                                      radius=cfg.radius)
    dets = []
    for b, (kps, _, query_pts) in enumerate(feats):
        dev = query_pts.device
        geom = GeomDb(*(t.to(dev, non_blocking=True) for t in
                        (db.points, db.obj_of_row, db.spans)))
        noise = ThreefryNoise(keys[b], cfg.guess.ransac.max_instances, False,
                              dev)
        part = slice(b * q, (b + 1) * q)
        dets.append(stage_geometry(
            noise, kps.xy, kps.valid, dist[part].to(dev, non_blocking=True),
            rows[part].to(dev, non_blocking=True), query_pts, geom, cfg))
    return ObjectDetections(*(torch.stack([x.to(mesh.first) for x in f])
                              for f in zip(*dets)))
