"""Streaming serving over a mesh (tod_tpu/parallel/serving.py): the host
state around :func:`~tod_tpu_torch.parallel.segmented.serving_step_sharded`.

:class:`ShardedServingDetector` serves ``mesh.shape['data']`` independent
camera streams against one object-sharded catalog, with the single-device
``FusedDetector``'s streaming state kept per stream: the frame key, the
frames since each object was last accepted, the last accepted poses (tier-2
seeds), last frame's coarse selection (needy-first tracked eviction) and
the exploration rotation over real catalog slots. The state updates are the
single-device functions of ``geometry/detection.py``, applied stream by
stream, so each stream evolves as a ``FusedDetector`` fed the same
compacted queries would.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import (AGE_NEVER, fold_best_pose,
                                              seeds_from_state,
                                              tracked_from_age,
                                              tracked_needy, update_age)
from tod_tpu_torch.geometry.ransac import ObjectDetections, SeedPose
from tod_tpu_torch.models.fused import gated_poses
from tod_tpu_torch.ops.segmented import DB_CHUNK, subsample_models
from tod_tpu_torch.parallel.mesh import Mesh
from tod_tpu_torch.parallel.segmented import (pack_segmented_l2_sharded,
                                              pack_segmented_sharded,
                                              serving_step_sharded)
from tod_tpu_torch.types import PoseResult, TodModel
from tod_tpu_torch.utils import prng


class ShardedServingDetector:
    """Streaming serving of ``mesh.shape['data']`` streams against one
    catalog sharded by object over ``'db'``.

    ``config``: a segmented ``FusedDetectorConfig``; with ``coarse_stride
    > 0``, ``track_width`` / ``explore_width`` reserve slab slots and
    tracked poses seed tier 2, as on one device. Stream ``b`` draws from
    ``prng_key(seed + b)``, as a ``FusedDetector`` built with ``seed + b``.

    :meth:`step` takes one compacted frame a stream (``stage_features_
    compact``'s outputs stacked, leading dim B = n_data) and returns
    ``ObjectDetections (B, O, I, ...)`` on the shard-major object axis
    (``object_ids``; ``None`` a padding slot), on the mesh's first
    device."""

    def __init__(self, mesh: Mesh, models: Sequence[TodModel], config,
                 seed: int = 0, db_chunk: int = DB_CHUNK):
        if config.pipeline != "segmented":
            raise ValueError("ShardedServingDetector serves the segmented "
                             "pipeline only")
        if (config.track_width or config.explore_width) \
                and config.coarse_stride <= 0:
            raise ValueError("track_width/explore_width require "
                             "coarse_stride > 0")
        self.config = cfg = config
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        models = list(models)
        pack = (pack_segmented_l2_sharded if cfg.feature == "SIFT"
                else pack_segmented_sharded)
        self.sdb, self.object_ids = pack(models, mesh, db_chunk=db_chunk)
        # the same round-robin split keeps the coarse and fine object axes
        # aligned (owner = id // o_local on both)
        self.cdb = (pack(subsample_models(models, cfg.coarse_stride), mesh,
                         db_chunk=db_chunk)[0]
                    if cfg.coarse_stride > 0 else None)
        self._step = serving_step_sharded(mesh, cfg)

        b, o = self.n_data, len(self.object_ids)
        dev = mesh.first
        self._keys = [prng.prng_key(seed + i) for i in range(b)]
        self._age = torch.full((b, o), AGE_NEVER, dtype=torch.int32,
                               device=dev)
        self._last_r = torch.zeros((b, o, 3, 3), device=dev)
        self._last_t = torch.zeros((b, o, 3), device=dev)
        self._last_sel: Optional[torch.Tensor] = None
        self._explore_pos = 0
        # exploration rotates over REAL catalog slots only (a padding slot
        # would spend its forced tier-1 entry on rows that never match)
        self._real_slots = np.asarray(
            [i for i, oid in enumerate(self.object_ids) if oid], np.int32)

    def _explore_ids(self) -> torch.Tensor:
        """The rotation's next ``explore_width`` slots, the same for every
        stream (as ``FusedDetector._explore_ids``)."""
        e, n = self.config.explore_width, len(self._real_slots)
        if e >= n:
            ids = np.concatenate([self._real_slots,
                                  np.full(e - n, -1, np.int32)])
        else:
            ids = self._real_slots[(self._explore_pos + np.arange(e)) % n]
            self._explore_pos = int((self._explore_pos + e) % n)
        return torch.from_numpy(ids).to(self.mesh.first).expand(
            self.n_data, e)

    def _tracked(self) -> torch.Tensor:
        cfg = self.config
        if self._last_sel is None:
            rows = [tracked_from_age(a, cfg.track_width, cfg.track_ttl)
                    for a in self._age]
        else:
            rows = [tracked_needy(a, s, cfg.track_width, cfg.track_ttl)
                    for a, s in zip(self._age, self._last_sel)]
        return torch.stack(rows)

    def step(self, xy: torch.Tensor, qp: torch.Tensor, ok: torch.Tensor,
             dsc: torch.Tensor) -> ObjectDetections:
        """One frame a stream (compacted queries in, full-object-axis
        detections out); advances every stream's state."""
        cfg = self.config
        track = cfg.track_width > 0
        subs = []
        for b in range(self.n_data):
            self._keys[b], sub = prng.split(self._keys[b])
            subs.append(sub)
        extra = {}
        if self.cdb is not None:
            extra["cdb"] = self.cdb
        if track:
            extra["tracked"] = self._tracked()
            seeds = [seeds_from_state(a, r, t, cfg.track_ttl) for a, r, t in
                     zip(self._age, self._last_r, self._last_t)]
            extra["seeds"] = SeedPose(*(torch.stack(f) for f in zip(*seeds)))
        if cfg.explore_width > 0:
            extra["explore"] = self._explore_ids()
        out = self._step(np.stack(subs), xy, qp, ok, dsc, self.sdb, **extra)
        if not track:
            return out
        det, self._last_sel = out
        self._age = torch.stack([
            update_age(a, ObjectDetections(*(f[b] for f in det)),
                       cfg.track_min_confidence)
            for b, a in enumerate(self._age)])
        poses = [fold_best_pose(r, t, ObjectDetections(*(f[b] for f in det)))
                 for b, (r, t) in enumerate(zip(self._last_r, self._last_t))]
        self._last_r = torch.stack([p[0] for p in poses])
        self._last_t = torch.stack([p[1] for p in poses])
        return det

    def results(self, det: ObjectDetections, stream: int) -> List[PoseResult]:
        """Stream ``stream``'s accepted poses at ``min_confidence`` and
        ``min_quality``, as ``FusedDetector.poses`` gates them (padding
        slots carry no accept)."""
        return gated_poses(ObjectDetections(*(f[stream] for f in det)),
                           self.object_ids, self.config)
