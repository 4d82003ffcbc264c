"""Shared cell-boundary types (tod_tpu/cells/types.py).

``PoseResult`` is :class:`tod_tpu_torch.types.PoseResult`, the one result
type of the package. ``MatchSet`` is the static-shape replacement for
OpenCV's ``vector<vector<DMatch>>`` + per-match 3D gather mats
(DescriptorMatcher.cpp:142-152): fixed (Q, k) arrays + validity masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tod_tpu_torch.types import PoseResult

__all__ = ["MatchSet", "PoseResult"]


@dataclass
class MatchSet:
    """Top-k matches of every query keypoint against the whole model DB.

    ``train_idx`` are *global* DB rows; ``obj_idx`` maps each match to the
    model it came from (the DMatch.imgIdx analog); ``local_idx`` is the row
    within that model (the DMatch.trainIdx analog).
    """

    dist: np.ndarray       # (Q, k) float32
    train_idx: np.ndarray  # (Q, k) int32 global DB row
    obj_idx: np.ndarray    # (Q, k) int32 model index
    local_idx: np.ndarray  # (Q, k) int32 row within the model
    valid: np.ndarray      # (Q, k) bool

    @property
    def k(self) -> int:
        return self.dist.shape[1]
