"""Training: a TOD model from turntable observations
(tod_tpu/cells/trainer.py), as plain functions and as the Trainer and
ModelFiller cells.

Per view, masked ORB or SIFT, keypoint validation against the eroded mask
and the depth, back-projection and camera -> world
(``parallel/train.py``); the valid rows stacked in view order (mergePoints,
training.cpp:147-173); for binary descriptors an optional dedup
(``ops/compress.py``, kernel B5). The cells read the observations from the
DB and hand a filled model document to the ModelWriter
(``models/trainer.py TodTrainer``). Not ported: the Trainer's debug images,
written through cv2.
"""

from __future__ import annotations

import json
import warnings
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from tod_tpu_torch.cells.features import declare_device
from tod_tpu_torch.cells.guess import no_visualize
from tod_tpu_torch.db import (Document, ObjectDbParameters,
                              observations_for_object)
from tod_tpu_torch.ops.compress import compress_model
from tod_tpu_torch.ops.depth import rescale_depth
from tod_tpu_torch.ops.image import rgb_to_gray_fused
from tod_tpu_torch.parallel.train import train_views_step
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.types import Observation, TodModel


def feature_settings(feature_params: Union[str, Dict]) -> Dict:
    """The Trainer's feature parameters (its ``json_feature_params``, a
    JSON string or a dict) with the reference's defaults: ``type`` ORB or
    SIFT, ``n_features`` 1000, ``n_levels`` 3, ``scale_factor`` 1.2,
    ``fast_threshold`` 20, ``subpixel`` off (sub-pixel model points, ORB
    only: SIFT warns and keeps integer coords, as the reference does)."""
    feat = json.loads(feature_params) if isinstance(feature_params, str) \
        else dict(feature_params)
    kind = feat.get("type", "ORB")
    if kind not in ("ORB", "SIFT"):
        raise ValueError(f"training supports ORB or SIFT features, "
                         f"not {kind!r}")
    subpixel = bool(feat.get("subpixel", False))
    if subpixel and kind != "ORB":
        warnings.warn(f"feature param subpixel=true is only implemented for "
                      f"ORB; {kind} training keeps integer coordinates")
    return dict(feature_type=kind,
                n_features=int(feat.get("n_features", 1000)),
                n_levels=int(feat.get("n_levels", 3)),
                scale_factor=float(feat.get("scale_factor", 1.2)),
                fast_threshold=float(feat.get("fast_threshold", 20)),
                subpixel=subpixel and kind == "ORB")


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
    out = train_views_step(*view_batch(observations, device), **settings)
    return tuple(t.cpu().numpy() for t in out)


def view_batch(observations: Sequence[Observation], device
               ) -> Tuple[torch.Tensor, ...]:
    """:func:`train_views_step`'s inputs on ``device``: (V,H,W) grays (the
    fused gray of color views), masks and depths rescaled to the image,
    (V,3,3) K and R, (V,3) T."""
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

    return (grays, masks.to(device), depths, cams("K", (3, 3)),
            cams("R", (3, 3)), cams("T", (3,)))


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


class Trainer(Cell):
    """The reference's Trainer cell (Trainer.cpp): the observations of
    ``object_id`` from the DB through :func:`train_object` on the cell's
    device."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("json_feature_params",
                  'Feature params JSON: {"type": "ORB", "n_features": ...,'
                  ' "n_levels": ..., "scale_factor": ...}',
                  default='{"type": "ORB"}', required=True)
        p.declare("json_descriptor_params",
                  'Descriptor params JSON: {"type": "ORB", ...}',
                  default='{"type": "ORB"}', required=True)
        p.declare("visualize", "Debug images (not ported: raises if set).",
                  default=False)
        p.declare("dedup_hamming",
                  "Model compression: drop descriptors within this Hamming "
                  "distance of an earlier one at (near) the same 3D point. "
                  "0 disables (reference-parity). Shrinks the matcher DB "
                  "2-4x on turntable captures.", default=0)
        p.declare("dedup_point_m",
                  "3D distance (meters) for the dedup same-place test.",
                  default=0.005)
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("json_db", "The parameters of the DB as a JSON string.",
                  required=True)
        i.declare("object_id", "The id of the object in the DB.",
                  required=True)
        o.declare("descriptors", "The stacked descriptors (N,32) u8.")
        o.declare("points", "The 3d positions (1,N,3) f32, world frame.")

    def configure(self) -> None:
        no_visualize(self.params["visualize"])
        feature_settings(self.params["json_feature_params"])   # validate

    def process(self) -> None:
        db = ObjectDbParameters(self.inputs["json_db"]).generate_db()
        observations = observations_for_object(db, self.inputs["object_id"])
        descriptors, points = train_object(
            observations, self.params["json_feature_params"],
            dedup_hamming=int(self.params["dedup_hamming"]),
            dedup_point_m=float(self.params["dedup_point_m"]),
            device=torch.device(self.params["device"]))
        self.outputs["descriptors"] = descriptors
        self.outputs["points"] = points


class ModelFiller(Cell):
    """Packs points + descriptors into a DB document
    (src/training/ModelFiller.cpp:11-26)."""

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("points", "The 3d position of the points.")
        i.declare("descriptors", "The descriptors.")
        o.declare("db_document", "The filled document.")

    def process(self) -> None:
        doc = Document(fields={"Type": "Model", "method": "TOD"})
        desc = np.asarray(self.inputs["descriptors"])
        if desc.dtype != np.float32:  # binary ORB bits; floats = SIFT path
            desc = desc.astype(np.uint8)
        doc.set_attachment("descriptors", desc)
        doc.set_attachment("points",
                           np.asarray(self.inputs["points"], np.float32))
        self.outputs["db_document"] = doc
