"""Training: a TOD model from turntable observations
(tod_tpu/cells/trainer.py), as plain functions and as the Trainer and
ModelFiller cells.

Per view, masked ORB or SIFT, keypoint validation against the eroded mask
and the depth, back-projection and camera -> world
(``parallel/train.py``); the valid rows stacked in view order (mergePoints,
training.cpp:147-173); for binary descriptors an optional dedup
(``ops/compress.py``, kernel B5). The cells read the observations from the
DB and hand a filled model document to the ModelWriter
(``models/trainer.py TodTrainer``). With ``visualize`` the Trainer writes
each object's first four views with their valid model points projected
back into them, ``<prefix>_<object_id>_v<nn>.png``, as the reference does.
"""

from __future__ import annotations

import functools
import json
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tod_tpu_torch.cells.features import declare_device
from tod_tpu_torch.cells.viz import DEFAULT_TRAIN_PREFIX, viz_prefix
from tod_tpu_torch.db import (Document, ObjectDbParameters,
                              observations_for_object)
from tod_tpu_torch.ops.compress import compress_model
from tod_tpu_torch.ops.depth import rescale_depth
from tod_tpu_torch.ops.image import rgb_to_gray_fused
from tod_tpu_torch.parallel.train import train_views_step
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.types import Observation, TodModel
from tod_tpu_torch.utils.png import write_png
from tod_tpu_torch.utils.visualize import draw_keypoints


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


ViewSink = Callable[[Sequence[Observation], np.ndarray, np.ndarray], None]


def write_view_pngs(prefix: str, object_id: str,
                    group: Sequence[Observation], world: np.ndarray,
                    valid: np.ndarray) -> None:
    """The headless form of the reference Trainer's observation windows
    (Trainer.cpp:173-180): the first four views of a batch with their
    valid model points projected back into them (float32 on the host, as
    the reference computes them), ``<prefix>_<object_id>_v<nn>.png``."""
    for v in range(min(len(group), 4)):
        obs = group[v]
        R = np.asarray(obs.R, np.float32).reshape(3, 3)
        T = np.asarray(obs.T, np.float32).reshape(3)
        K = np.asarray(obs.K, np.float32).reshape(3, 3)
        cam = world[v][valid[v]] @ R.T + T
        pix = cam @ K.T
        xy = pix[:, :2] / np.maximum(pix[:, 2:3], 1e-6)
        overlay = draw_keypoints(np.asarray(obs.image), xy)
        write_png(f"{prefix}_{object_id}_v{v:02d}.png",
                  overlay if overlay.ndim == 2 else overlay[..., ::-1])


def train_object(observations: Sequence[Observation],
                 feature_params: Union[str, Dict] = '{"type": "ORB"}',
                 dedup_hamming: int = 0, dedup_point_m: float = 0.005,
                 device="cuda", view_sink: Optional[ViewSink] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A model from one object's observations: ``(descriptors (N, D),
    points (1, N, 3) float32)``, the Trainer's outputs. Views are read in
    frame-number order (the DB view's), each group of one image and depth
    shape as one batch; ``dedup_hamming > 0`` drops rows within that many
    bits and ``dedup_point_m`` meters of an earlier row (binary descriptors
    only). ``view_sink`` (e.g. :func:`write_view_pngs`) is called with each
    batch's observations, (V, K, 3) world points and (V, K) valid, on the
    host."""
    settings = feature_settings(feature_params)
    groups: Dict[tuple, List[Observation]] = {}
    for obs in sorted(observations, key=lambda o: o.frame_number):
        key = (np.shape(obs.image), np.shape(obs.depth))
        groups.setdefault(key, []).append(obs)
    desc_all, pts_all = [], []
    for group in groups.values():
        desc, world, valid = train_views(group, settings, device)
        if view_sink is not None:
            view_sink(group, world, valid)
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
        p.declare("visualize", "Debug images: false, true (PNGs under "
                  "/tmp/tod_tpu_train) or a PNG path prefix.", default=False)
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
        feature_settings(self.params["json_feature_params"])   # validate

    def process(self) -> None:
        db = ObjectDbParameters(self.inputs["json_db"]).generate_db()
        observations = observations_for_object(db, self.inputs["object_id"])
        descriptors, points = train_object(
            observations, self.params["json_feature_params"],
            dedup_hamming=int(self.params["dedup_hamming"]),
            dedup_point_m=float(self.params["dedup_point_m"]),
            device=torch.device(self.params["device"]),
            view_sink=self._view_sink())
        self.outputs["descriptors"] = descriptors
        self.outputs["points"] = points

    def _view_sink(self) -> Optional[ViewSink]:
        viz = self.params["visualize"]
        if not viz:
            return None
        return functools.partial(
            write_view_pngs, viz_prefix(viz, DEFAULT_TRAIN_PREFIX),
            self.inputs["object_id"])


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
