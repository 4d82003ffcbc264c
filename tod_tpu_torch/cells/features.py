"""Feature / depth cells (tod_tpu/cells/features.py).

The ecto_opencv cells the reference detector wires up
(python/object_recognition_tod/detector.py:26-31): ``FeatureDescriptor``
(ORB or SIFT detect + describe), ``RescaledRegisteredDepth`` and
``DepthTo3d``. The math is the port's ``ops/``; each cell computes on its
``device`` (the card unless the caller names another) and hands numpy
arrays on, read back once at the end of ``process``.

The reference runs the features compiled and the depth cells eagerly, and
each rounds as the reference does: the depth cells divide millimeters by
1000 (the compiled programs multiply by the reciprocal instead).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.depth import depth_to_3d, rescale_depth
from tod_tpu_torch.ops.image import rgb_to_gray
from tod_tpu_torch.ops.orb import Keypoints, orb_detect_and_compute
from tod_tpu_torch.ops.sift import sift_detect_and_compute
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.utils.config import parse_json_params


def declare_device(p: Tendrils) -> None:
    p.declare("device", 'The torch device the cell computes on ("cuda", '
              '"cuda:1", "cpu").', default="cuda")


def to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The tensors as numpy arrays: the cell's one wait for its device."""
    return tuple(t.cpu().numpy() for t in tensors)


def upload(array, device: torch.device | str,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array on ``device``; integer depth goes as int32 (CUDA has no
    uint16 arithmetic)."""
    a = np.ascontiguousarray(array)
    if a.dtype == np.uint16:
        a = a.astype(np.int32)
    elif not a.flags.writeable:     # torch takes writable arrays only
        a = a.copy()
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def metric_depth_eager(depth: torch.Tensor) -> torch.Tensor:
    """``to_metric_depth`` as the reference's eager cells round it: integer
    millimeters divided by 1000 (a device scalar, so that CUDA divides
    rather than multiplying by the reciprocal)."""
    if depth.is_floating_point():
        return depth.to(torch.float32)
    d = depth.to(torch.float32)
    invalid = (d <= 0.0) | (d >= 65535.0)
    per = torch.full((), 1000.0, dtype=torch.float32, device=d.device)
    return torch.where(invalid, torch.full((), torch.nan, device=d.device),
                       d / per)


class FeatureDescriptor(Cell):
    """ORB (or SIFT) keypoints + descriptors (the ecto_opencv
    FeatureDescriptor cell, detector.py:27; feature params from
    conf/detection.ork:26-28)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("json_feature_params",
                  "Feature parameters as a JSON string (type/n_features/"
                  "n_levels/scale_factor).",
                  default='{"type": "ORB"}')
        p.declare("json_descriptor_params",
                  "Descriptor parameters as a JSON string.",
                  default='{"type": "ORB"}')
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("image", "The input image (H,W,3) u8 or (H,W) gray.")
        i.declare("mask", "Optional detection mask (H,W).")
        i.declare("depth", "Optional depth (unused; parity with ecto port).")
        o.declare("keypoints", "Keypoints structure (padded, masked), numpy.")
        o.declare("descriptors", "(K,32) uint8 ORB bits, or (K,128) float32 "
                  "SIFT descriptors when feature type is SIFT.")

    def configure(self) -> None:
        feat = parse_json_params(self.params["json_feature_params"])
        self._type = feat.get("type", "ORB")
        if self._type not in ("ORB", "SIFT"):
            raise ValueError(
                f"feature type {self._type!r} not implemented "
                "(ORB and SIFT are supported, doc/source/index.rst:45)")
        if feat.get("subpixel", False):
            raise NotImplementedError(
                "tod_tpu_torch: sub-pixel keypoints are ROADMAP A16")
        self._settings = dict(
            n_features=int(feat.get("n_features", 1000)),
            n_levels=int(feat.get("n_levels", 3)),
            scale_factor=float(feat.get("scale_factor", 1.2)),
            fast_threshold=float(feat.get("fast_threshold", 20)))
        self._device = torch.device(self.params["device"])

    def process(self) -> None:
        gray = rgb_to_gray(upload(self.inputs["image"], self._device))
        mask = self.inputs["mask"]
        if mask is not None:
            mask = upload(mask, self._device)
        detect = (sift_detect_and_compute if self._type == "SIFT"
                  else orb_detect_and_compute)
        kps, desc = detect(gray, mask=mask, **self._settings)
        *fields, desc = to_host(*kps, desc)
        self.outputs["keypoints"] = Keypoints(*fields)
        self.outputs["descriptors"] = desc


class RescaledRegisteredDepth(Cell):
    """Rescale a registered depth map to the RGB image size
    (ecto_image_pipeline RescaledRegisteredDepth, detector.py:26; semantics
    of the trainer's rescale_depth, src/training/Trainer.cpp:63-81)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("image", "The RGB image whose size the depth must match.")
        i.declare("depth_in", "The raw depth map (u16 mm or f32 m).")
        o.declare("depth", "(H,W) float32 metric depth with NaN invalids.")

    def process(self) -> None:
        image = np.asarray(self.inputs["image"])
        raw = self.inputs["depth_in"]
        depth = (np.zeros((0, 0), np.float32) if raw is None
                 else np.asarray(raw))
        if depth.size == 0:  # depthless frame: propagate empty (2D-only path)
            self.outputs["depth"] = np.zeros((0, 0), np.float32)
            return
        metric = metric_depth_eager(upload(depth, self.params["device"]))
        out = rescale_depth(metric, image.shape[:2])
        self.outputs["depth"], = to_host(out)


class DepthTo3d(Cell):
    """Dense back-projection depth -> (H,W,3) point cloud (ecto_opencv
    calib.DepthTo3d, detector.py:62)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("depth", "(H,W) float32 metric depth.")
        i.declare("K", "(3,3) camera intrinsics.")
        o.declare("points3d", "(H,W,3) float32 camera-frame points.")

    def process(self) -> None:
        depth = np.asarray(self.inputs["depth"])
        if depth.size == 0:  # depthless frame: empty cloud (2D-only path)
            self.outputs["points3d"] = np.zeros((0, 0, 3), np.float32)
            return
        device = self.params["device"]
        d = metric_depth_eager(upload(depth, device))
        K = upload(np.asarray(self.inputs["K"], np.float32), device)
        self.outputs["points3d"], = to_host(depth_to_3d(d, K))
