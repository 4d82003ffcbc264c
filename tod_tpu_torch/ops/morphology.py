"""Binary erosion and keypoint validation against the object mask and depth
(tod_tpu/ops/morphology.py; the reference's training.cpp:57-145): erode the
mask 4 times with a 3x3 element, keep a keypoint at its rounded pixel when
that pixel is in the mask or snap it to the nearest in-mask pixel of a
+/-2 px window, then require valid depth there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tod_tpu_torch.ops.depth import is_valid_depth
from tod_tpu_torch.ops.image import fma_f32


def erode(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with a 3x3 rect element, ``iterations`` times: one
    ``(2 it + 1)^2`` AND-window. Pixels outside the image do not erode the
    inside (cv::erode's default border): the window is a max-pool of the
    complement, whose -inf padding never wins. Returns (H,W) bool."""
    k = 2 * iterations + 1
    outside = (mask <= 0).to(torch.float32)[None, None]
    hit = F.max_pool2d(outside, k, stride=1, padding=iterations)[0, 0]
    return hit == 0


class ValidatedKeypoints(NamedTuple):
    """Result of mask + depth validation; all length K, masked."""

    xy: torch.Tensor      # (K,2) int32 snapped integer pixel coords
    z: torch.Tensor       # (K,) float32 metric depth at the snapped coords
    valid: torch.Tensor   # (K,) bool


def validate_keypoints(xy: torch.Tensor, kp_valid: torch.Tensor,
                       mask: torch.Tensor, depth_m: torch.Tensor,
                       window: int = 2,
                       erode_iterations: int = 4) -> ValidatedKeypoints:
    """validateKeyPoints (training.cpp:57-145), vectorised over K.

    ``xy`` (K,2) float coords, ``kp_valid`` (K,) bool, ``mask`` (H,W),
    ``depth_m`` (H,W) float32 meters. On the mask eroded
    ``erode_iterations`` times: a keypoint whose rounded pixel (half to
    even, clipped to the image) is in the mask stays there; otherwise it
    goes to the in-mask pixel of the ``(2 window + 1)^2`` neighbourhood
    nearest its float coords, the first in x-major then y scan order on
    ties; then the depth there must be valid."""
    h, w = mask.shape
    dev = xy.device
    eroded = erode(mask, erode_iterations)
    x0 = torch.round(xy[:, 0]).clamp(0, w - 1).to(torch.int64)
    y0 = torch.round(xy[:, 1]).clamp(0, h - 1).to(torch.int64)
    center_in = eroded[y0, x0]

    offs = torch.arange(-window, window + 1, device=dev)
    ox = offs.repeat_interleave(2 * window + 1)     # x-major: -2,-2,...
    oy = offs.repeat(2 * window + 1)
    cx = (x0[:, None] + ox[None, :]).clamp(0, w - 1)          # (K, 25)
    cy = (y0[:, None] + oy[None, :]).clamp(0, h - 1)
    cand_in = eroded[cy, cx]
    dx = cx.to(torch.float32) - xy[:, 0:1]
    dy = cy.to(torch.float32) - xy[:, 1:2]
    # the compiled reference fuses the sum: fma(dx, dx, dy^2), which
    # decides ties such as (-1, 0) against (0, -1) at coords (.2, .2)
    dist_sq = fma_f32(dx, dx, dy * dy)
    dist_sq = torch.where(cand_in, dist_sq,
                          torch.full((), torch.inf, device=dev))
    best = torch.argmin(dist_sq, dim=1, keepdim=True)   # first on ties
    snap_x = torch.gather(cx, 1, best)[:, 0]
    snap_y = torch.gather(cy, 1, best)[:, 0]
    snapped_ok = cand_in.any(dim=1)

    out_x = torch.where(center_in, x0, snap_x)
    out_y = torch.where(center_in, y0, snap_y)
    z = depth_m[out_y, out_x]
    valid = kp_valid & (center_in | snapped_ok) & is_valid_depth(z)
    return ValidatedKeypoints(
        xy=torch.stack([out_x, out_y], dim=-1).to(torch.int32),
        z=torch.where(valid, z, torch.full((), torch.nan, device=dev)),
        valid=valid)
