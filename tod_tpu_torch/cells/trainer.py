"""Training: a TOD model from turntable observations, as plain functions
(the body of tod_tpu/cells/trainer.py Trainer.process and ModelFiller).

Per view, masked ORB or SIFT, keypoint validation against the eroded mask
and the depth, back-projection and camera -> world
(``parallel/train.py``); the valid rows stacked in view order (mergePoints,
training.cpp:147-173); for binary descriptors an optional dedup
(``ops/compress.py``, kernel B5). The Trainer / ModelFiller cells, the DB
and the ModelWriter need the cell graph and are not ported (ROADMAP A12b);
nor are the Trainer's debug images, written through cv2.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from tod_tpu_torch.ops.compress import compress_model
from tod_tpu_torch.ops.depth import rescale_depth
from tod_tpu_torch.ops.image import rgb_to_gray_fused
from tod_tpu_torch.parallel.train import train_views_step
from tod_tpu_torch.types import Observation, TodModel


def feature_settings(feature_params: Union[str, Dict]) -> Dict:
    """The Trainer's feature parameters (its ``json_feature_params``, a
    JSON string or a dict) with the reference's defaults: ``type`` ORB or
    SIFT, ``n_features`` 1000, ``n_levels`` 3, ``scale_factor`` 1.2,
    ``fast_threshold`` 20."""
    feat = json.loads(feature_params) if isinstance(feature_params, str) \
        else dict(feature_params)
    kind = feat.get("type", "ORB")
    if kind not in ("ORB", "SIFT"):
        raise ValueError(f"training supports ORB or SIFT features, "
                         f"not {kind!r}")
    if feat.get("subpixel", False):
        raise NotImplementedError(
            "tod_tpu_torch: sub-pixel model points are ROADMAP A16")
    return dict(feature_type=kind,
                n_features=int(feat.get("n_features", 1000)),
                n_levels=int(feat.get("n_levels", 3)),
                scale_factor=float(feat.get("scale_factor", 1.2)),
                fast_threshold=float(feat.get("fast_threshold", 20)))


def _depth_for_upload(depth) -> np.ndarray:
    """Integer depth goes up as int32 millimeters (as serving's
    prepare_frame sends it: CUDA has no uint16 arithmetic)."""
    depth = np.asarray(depth)
    if not np.issubdtype(depth.dtype, np.floating):
        depth = depth.astype(np.int32)
    return np.ascontiguousarray(depth)


def train_views(observations: Sequence[Observation], settings: Dict,
                device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch of same-shaped views through :func:`train_views_step` on
    ``device``: (V,K,D) descriptors, (V,K,3) world points, (V,K) valid, on
    the host."""
    images = torch.from_numpy(np.stack([o.image for o in observations]))
    images = images.to(device)
    img_hw = tuple(images.shape[1:3])
    grays = torch.stack([rgb_to_gray_fused(im) for im in images]) \
        if images.dim() == 4 else images.to(torch.float32)
    depths = torch.stack([rescale_depth(torch.from_numpy(
        _depth_for_upload(o.depth)).to(device), img_hw)
        for o in observations])
    masks = torch.from_numpy(np.stack([o.mask for o in observations]))

    def cams(name, shape):
        return torch.from_numpy(np.stack([
            np.asarray(getattr(o, name), np.float32).reshape(shape)
            for o in observations])).to(device)

    out = train_views_step(grays, masks.to(device), depths,
                           cams("K", (3, 3)), cams("R", (3, 3)),
                           cams("T", (3,)), **settings)
    return tuple(t.cpu().numpy() for t in out)


def train_object(observations: Sequence[Observation],
                 feature_params: Union[str, Dict] = '{"type": "ORB"}',
                 dedup_hamming: int = 0, dedup_point_m: float = 0.005,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """A model from one object's observations: ``(descriptors (N, D),
    points (1, N, 3) float32)``, the Trainer's outputs. Views are read in
    frame-number order (the DB view's), each group of one image and depth
    shape as one batch; ``dedup_hamming > 0`` drops rows within that many
    bits and ``dedup_point_m`` meters of an earlier row (binary descriptors
    only)."""
    settings = feature_settings(feature_params)
    groups: Dict[tuple, List[Observation]] = {}
    for obs in sorted(observations, key=lambda o: o.frame_number):
        key = (np.shape(obs.image), np.shape(obs.depth))
        groups.setdefault(key, []).append(obs)
    desc_all, pts_all = [], []
    for group in groups.values():
        desc, world, valid = train_views(group, settings, device)
        flat = valid.reshape(-1)
        if flat.any():
            desc_all.append(desc.reshape(-1, desc.shape[-1])[flat])
            pts_all.append(world.reshape(-1, 3)[flat])
    if desc_all:
        descriptors = np.concatenate(desc_all)
        points = np.concatenate(pts_all).astype(np.float32)
    else:
        descriptors = np.zeros((0, 32), np.uint8)
        points = np.zeros((0, 3), np.float32)
    if dedup_hamming > 0 and len(descriptors) > 1 \
            and descriptors.dtype == np.uint8:
        descriptors, points = compress_model(
            descriptors, points, hamming_threshold=int(dedup_hamming),
            point_threshold=float(dedup_point_m), device=device)
    return descriptors, points.reshape(1, -1, 3)


def fill_model(object_id: str, descriptors: np.ndarray,
               points: np.ndarray) -> TodModel:
    """The ModelFiller: uint8 descriptors (float32 for SIFT) and (N, 3)
    float32 points in a :class:`TodModel`."""
    desc = np.asarray(descriptors)
    if desc.dtype != np.float32:
        desc = desc.astype(np.uint8)
    return TodModel(object_id, desc,
                    np.asarray(points, np.float32).reshape(-1, 3))


class Trainer:
    """The reference's Trainer cell: needs the cell graph and the DB."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "tod_tpu_torch: the Trainer / ModelFiller cells and the DB are "
            "ROADMAP A12b; call train_object and fill_model")
