"""The port's model holder, observation record and result type.

``TodModel`` and ``Observation`` mirror tod_tpu/db/models.py (a trained
model's attachments: descriptors, points and the span prior; a turntable
view); ``PoseResult`` mirrors tod_tpu/cells/types.py. All are plain numpy
holders, neutral between the two packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
    document_id: Optional[str] = None   # the model document it was read from

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
    db_params: Optional[dict] = None  # the DB the model came from (cells)

    def set_R(self, R):  # the reference's setters
        self.R = np.asarray(R, np.float32).reshape(3, 3)

    def set_T(self, T):
        self.T = np.asarray(T, np.float32).reshape(3)

    def set_object_id(self, db_params, object_id):
        self.db_params = db_params
        self.object_id = object_id


@dataclass
class Observation:
    """One turntable view of an object: what the trainer reads."""

    image: np.ndarray        # (H,W,3) u8 RGB or (H,W) gray
    depth: np.ndarray        # (h,w) u16 millimeters (0 invalid) or f32 m
    mask: np.ndarray         # (H,W) u8, nonzero on the object
    K: np.ndarray            # (3,3) intrinsics
    R: np.ndarray            # (3,3) camera rotation
    T: np.ndarray            # (3,) camera translation
    frame_number: int = 0


def fixture_observations(fx, obj: int) -> List[Observation]:
    """Object ``obj``'s views from a training fixture
    (tools/make_torch_train_fixture.py): gray stored as one channel and
    given back as the renders' three equal channels, the mask unpacked
    from its bits."""
    gray, depth, masks, value, K, R, T, frame = (
        fx[f"{name}{obj}"] for name in ("gray", "depth", "mask",
                                        "mask_value", "K", "R", "T",
                                        "frame"))
    bits = np.unpackbits(masks, axis=-1, count=gray.shape[-1],
                         bitorder="little").astype(bool)
    return [Observation(image=np.repeat(gray[v][..., None], 3, axis=-1),
                        depth=depth[v],
                        mask=np.where(bits[v], value, 0).astype(value.dtype),
                        K=K[v], R=R[v], T=T[v], frame_number=int(frame[v]))
            for v in range(len(gray))]
