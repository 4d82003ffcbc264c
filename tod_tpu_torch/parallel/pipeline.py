"""Pipeline parallelism (tod_tpu/parallel/pipeline.py): the global-kNN
detector's three stages placed on three devices.

Features (``stage_features``) on ``devices[0]``, matching (kernel B5,
``match_against_db``) on ``devices[1]`` and geometry (``stage_geometry``)
on ``devices[2]``; fewer devices are cycled (one device: the plain staged
detector). The DB's matcher operand stays on the matching device and its
geometry operands on the geometry device. The copies between stages do not
wait on the host, so :meth:`PipelinedDetector.detect_stream` keeps
dispatching ahead: on distinct cards frame N's features overlap frame N-1's
matching and frame N-2's geometry.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tod_tpu_torch.geometry.ransac import ObjectDetections, ThreefryNoise
from tod_tpu_torch.models.fused import (FusedDetectorConfig, GeomDb,
                                        ModelDb, empty_detections,
                                        match_against_db, pack_models,
                                        prepare_frame, stage_features,
                                        stage_geometry)
from tod_tpu_torch.types import TodModel
from tod_tpu_torch.utils import prng


class PipelinedDetector:
    """The 3-stage device-pipelined global-kNN detector. ``devices``: the
    stage placement [features, matching, geometry], cycled when fewer are
    given; by default the first three CUDA devices. Frame keys follow
    ``FusedDetector(seed=seed)``'s: one ``split`` a frame."""

    def __init__(self, models: Sequence[TodModel],
                 config: Optional[FusedDetectorConfig] = None,
                 devices: Optional[Sequence] = None, seed: int = 0):
        self.config = cfg = config or FusedDetectorConfig()
        if cfg.pipeline != "global":
            raise ValueError("PipelinedDetector stages the global-kNN "
                             "pipeline")
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(min(3, torch.cuda.device_count()))]
        if not devices:
            raise ValueError("no CUDA device: name the stages' devices")
        devices = [torch.device(d) for d in devices]
        self.devices = [devices[i % len(devices)] for i in range(3)]
        db, self.object_ids = pack_models(list(models), cfg.db_chunk,
                                          device="cpu")
        d1, d2 = self.devices[1:]
        # the matcher's operands on the matching device, the geometry's on
        # the geometry device (match_against_db reads words and n_valid)
        self.db_match = ModelDb(
            words=db.words.to(d1), points=torch.zeros((0, 3), device=d1),
            obj_of_row=torch.zeros(0, dtype=torch.int32, device=d1),
            n_valid=db.n_valid, spans=torch.zeros(0, device=d1))
        self.db_geom = GeomDb(points=db.points.to(d2),
                              obj_of_row=db.obj_of_row.to(d2),
                              spans=db.spans.to(d2))
        self._key = prng.prng_key(seed)

    def prepare_frame(self, image: np.ndarray, depth: np.ndarray,
                      K: np.ndarray):
        """Upload one frame to the features device, as
        ``FusedDetector.prepare_frame`` does."""
        return prepare_frame(image, depth, K, self.devices[0])

    def detect_raw(self, gray: torch.Tensor, depth: torch.Tensor,
                   K: torch.Tensor):
        """One prepared frame through the three stages, no host wait:
        ``(keypoints on the features device, detections on the geometry
        device)``."""
        cfg = self.config
        _, d1, d2 = self.devices
        self._key, sub = prng.split(self._key)
        kps, desc, query_pts = stage_features(gray, depth, K, cfg)
        if not self.object_ids:
            return kps, empty_detections(0, cfg, d2)
        dist, rows = match_against_db(desc.to(d1, non_blocking=True),
                                      self.db_match, cfg)
        noise = ThreefryNoise(sub, cfg.guess.ransac.max_instances, False, d2)
        return kps, stage_geometry(
            noise, *(t.to(d2, non_blocking=True) for t in
                     (kps.xy, kps.valid, dist, rows, query_pts)),
            self.db_geom, cfg)

    def detect_stream(self, frames) -> List[ObjectDetections]:
        """Detect a sequence of prepared frames, dispatching each as soon
        as the last is queued."""
        return [self.detect_raw(*f)[1] for f in frames]
