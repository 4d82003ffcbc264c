"""FAST-9/16 corner scores, Harris response, 3x3 NMS and top-K selection.

Port of tod_tpu/ops/fast.py: dense score maps followed by a per-level
top-K. ``stable_topk`` is the one top-k of the port: it keeps
``jax.lax.top_k``'s order on ties (the lower index first), which
``torch.topk`` does not promise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The 16-pixel Bresenham circle of radius 3 in circular order (dx, dy),
# starting at 12 o'clock and going clockwise (the standard FAST ordering).
FAST_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis in descending order, ties broken by the
    lower index (``jax.lax.top_k`` semantics). Floats (f32 only) are ranked
    in ``top_k``'s total order, in which +0.0 beats -0.0 and NaN beats
    everything: the sort runs on their bits mapped to monotone integers."""
    key = x
    if x.is_floating_point():
        if x.dtype != torch.float32:
            raise TypeError(f"stable_topk ranks float32 only, got {x.dtype}")
        bits = x.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def _circular_window_min9(diff: torch.Tensor) -> torch.Tensor:
    """Sliding circular-window minimum of length 9 along axis 0 (length 16)."""
    m2 = torch.minimum(diff, torch.roll(diff, -1, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
    return torch.minimum(m8, torch.roll(diff, -8, dims=0))


def fast_score(img: torch.Tensor,
               threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense FAST-9/16 score map: ``(score, is_corner)`` where score is the
    largest threshold at which the pixel is still a FAST corner."""
    h, w = img.shape
    img = img.to(torch.float32)
    padded = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    shifted = torch.stack([padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                           for dx, dy in FAST_CIRCLE])        # (16, H, W)
    diff = shifted - img[None]
    score_bright = _circular_window_min9(diff).amax(dim=0)
    score_dark = _circular_window_min9(-diff).amax(dim=0)
    score = torch.maximum(score_bright, score_dark)
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[3:h - 3, 3:w - 3] = True
    score = torch.where(interior, score, torch.zeros((), device=img.device))
    return score, score > threshold


def _box_sum_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """``lax.reduce_window(add, (size, size), "SAME")`` with zero padding,
    accumulated in the window's row-major order."""
    h, w = x.shape
    lo = (size - 1) // 2
    xp = F.pad(x, (lo, size - 1 - lo, lo, size - 1 - lo))
    acc = xp[0:h, 0:w]
    for dy in range(size):
        for dx in range(size):
            if dy or dx:
                acc = acc + xp[dy:dy + h, dx:dx + w]
    return acc


def harris_response(img: torch.Tensor, block_size: int = 7,
                    harris_k: float = 0.04) -> torch.Tensor:
    """Dense Harris corner response (cv::ORB HarrisResponses): central
    differences, a block_size^2 box window, det(M) - k*trace(M)^2."""
    img = img.to(torch.float32)
    ix = F.pad(img[:, 2:] - img[:, :-2], (1, 1, 0, 0))
    iy = F.pad(img[2:] - img[:-2], (0, 0, 1, 1))
    a = _box_sum_same(ix * ix, block_size)
    b = _box_sum_same(iy * iy, block_size)
    c = _box_sum_same(ix * iy, block_size)
    scale = 1.0 / (4.0 * block_size * 255.0)
    return (a * b - c * c - harris_k * (a + b) ** 2) * scale**4


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """A pixel survives iff its score equals its 3x3 neighbourhood max
    (-inf padding; ties keep both)."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= pooled


def select_topk_keypoints(fast: torch.Tensor, harris: torch.Tensor,
                          is_corner: torch.Tensor, k: int,
                          edge_threshold: int = 31,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k corners by Harris response after FAST-score NMS, only where
    ``mask > 0`` when a (H,W) ``mask`` is given. Returns ``(xy int32 (k,2),
    response (k,), valid (k,))``."""
    h, w = fast.shape
    keep = is_corner & nms3x3(fast)
    inside = torch.zeros((h, w), dtype=torch.bool, device=fast.device)
    inside[edge_threshold:h - edge_threshold,
           edge_threshold:w - edge_threshold] = True
    keep = keep & inside
    if mask is not None:
        keep = keep & (mask > 0)
    ranked = torch.where(keep, harris,
                         torch.full((), -torch.inf, device=fast.device))
    resp, idx = stable_topk(ranked.reshape(-1), k)
    valid = torch.isfinite(resp)
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.int32)
    return xy, resp, valid


def subpixel_offsets(score: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sub-pixel corner localisation: per axis, the vertex of the 3-point
    parabola through the score map at the integer keypoint and its two
    neighbours (coords clipped one pixel inside the map). Returns (K, 2)
    float32 offsets in [-0.5, 0.5]; 0 where the parabola is flat (|second
    difference| <= 1e-6). The products by 2 and 0.5 are exact and the
    division is a true tensor division, as the compiled reference rounds
    them."""
    h, w = score.shape
    x = xy[:, 0].long().clamp(1, w - 2)
    y = xy[:, 1].long().clamp(1, h - 2)
    one = torch.ones((), device=score.device)
    zero = torch.zeros((), device=score.device)

    def parab(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        curved = torch.abs(denom) > 1e-6
        off = torch.where(curved,
                          0.5 * (sm - sp) / torch.where(curved, denom, one),
                          zero)
        return torch.clamp(off, -0.5, 0.5)

    ox = parab(score[y, x - 1], score[y, x], score[y, x + 1])
    oy = parab(score[y - 1, x], score[y, x], score[y + 1, x])
    return torch.stack([ox, oy], dim=-1)


# Copied from tod_tpu/ops/fast.py:138 (features_per_level), numpy only.
def features_per_level(n_features: int, n_levels: int,
                       scale_factor: float) -> Tuple[int, ...]:
    """cv::ORB's geometric per-level feature budget."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1 - factor) / (1 - factor**n_levels)
    counts = []
    remaining = n_features
    for level in range(n_levels - 1):
        c = min(remaining, int(round(n_desired * factor**level)))
        counts.append(c)
        remaining -= c
    counts.append(remaining)
    return tuple(counts)
