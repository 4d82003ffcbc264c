"""The port's model holder and result type.

``TodModel`` mirrors tod_tpu/db/models.py (a trained model's attachments:
descriptors, points and the span prior); ``PoseResult`` mirrors
tod_tpu/cells/types.py. Both are plain numpy holders, neutral between the two
packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TodModel:
    """One trained object model: stacked descriptors + 3D points + span."""

    object_id: str
    # ORB: (N, 32) uint8, 256-bit packed, byte layout. SIFT: (N, 128) float32
    # unit-norm, or (N, 128) int8 already quantised (round(d * 256) in
    # [0, 127], see ops/segmented_l2.py), a quarter of the bytes.
    descriptors: np.ndarray
    points: np.ndarray       # (N, 3) float32 — object/world frame

    @property
    def n_points(self) -> int:
        return int(self.descriptors.shape[0])

    @property
    def span(self) -> float:
        """AABB-diagonal span of the model cloud (the adjacency gate's
        object-size prior)."""
        if self.points.size == 0:
            return 0.0
        mins = self.points.min(axis=0)
        maxs = self.points.max(axis=0)
        return float(np.sqrt(((maxs - mins) ** 2).sum()))


@dataclass
class PoseResult:
    """One detected object instance: object/world frame -> camera frame."""

    R: np.ndarray                 # (3,3)
    T: np.ndarray                 # (3,)
    object_id: str
    confidence: float = 0.0       # unique-inlier count
    rms_residual: float = 0.0     # RMS 3D residual (m) over the inliers
    clique_size: int = 0          # greedy inlier-clique statistic
    quality: float = 0.0          # fused confidence (confidence_v2)
