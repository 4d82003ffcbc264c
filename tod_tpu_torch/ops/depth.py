"""Depth ops: metric conversion, rescale to the image's size, validity and
pinhole back-projection (tod_tpu/ops/depth.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.image import resize_nearest


def to_metric_depth(depth: torch.Tensor) -> torch.Tensor:
    """Depth map to float32 meters with NaN for invalid pixels. Integer maps
    are millimeters; 0, saturated u16 (65535) and non-positive values are
    invalid. Float maps pass through, non-finite or non-positive -> NaN."""
    nan = torch.full((), torch.nan, device=depth.device)
    d = depth.to(torch.float32)
    if not depth.is_floating_point():
        invalid = (d <= 0.0) | (d >= 65535.0)
        # millimeters times the f32 reciprocal of 1000: the reference's
        # compiled program rewrites its division by the constant so
        per_mm = torch.full((), np.float32(1.0) / np.float32(1000.0),
                            device=depth.device)
        return torch.where(invalid, nan, d * per_mm)
    return torch.where(torch.isfinite(d) & (d > 0), d, nan)


def rescale_depth(depth: torch.Tensor,
                  image_hw: Tuple[int, int]) -> torch.Tensor:
    """Metric depth at the image's size (Trainer.cpp:63-81): when the sizes
    differ, nearest-resized by the width ratio into the top rows of an
    image-sized NaN canvas (aspect ratio kept)."""
    d = to_metric_depth(depth)
    ih, iw = image_hw
    dh, dw = depth.shape
    if (dh, dw) == (ih, iw):
        return d
    sub_h = min(ih, int(dh * (float(iw) / float(dw))))
    out = torch.full((ih, iw), torch.nan, dtype=torch.float32,
                     device=depth.device)
    out[:sub_h] = resize_nearest(d, (sub_h, iw))
    return out


def is_valid_depth(depth_m: torch.Tensor) -> torch.Tensor:
    """Validity of metric depth: finite (NaN marks invalid)."""
    return torch.isfinite(depth_m)


def depth_to_3d_sparse(depth_m: torch.Tensor, K: torch.Tensor,
                       xy: torch.Tensor) -> torch.Tensor:
    """Back-project pixel coords (N,2) through the pinhole: (N,3)
    camera-frame points, NaN where the depth is invalid."""
    K = K.to(torch.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    h, w = depth_m.shape
    xi = torch.round(xy[:, 0]).long().clamp(0, w - 1)
    yi = torch.round(xy[:, 1]).long().clamp(0, h - 1)
    z = depth_m[yi, xi]
    x = (xy[:, 0].to(torch.float32) - cx) * z / fx
    y = (xy[:, 1].to(torch.float32) - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def depth_to_3d(depth_m: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Dense back-projection: (H,W) depth -> (H,W,3) camera-frame points."""
    K = K.to(torch.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    h, w = depth_m.shape
    us = torch.arange(w, dtype=torch.float32, device=depth_m.device)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=depth_m.device)[:, None]
    x = (us - cx) * depth_m / fx
    y = (vs - cy) * depth_m / fy
    return torch.stack([x, y, depth_m], dim=-1)
