"""Depth ops: metric conversion and pinhole back-projection
(tod_tpu/ops/depth.py)."""

from __future__ import annotations

import numpy as np
import torch


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
