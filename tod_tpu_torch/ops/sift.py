"""SIFT-style float descriptors at FAST/Harris keypoints.

Port of tod_tpu/ops/sift.py: the classic 4x4-spatial x 8-orientation
gradient histogram (Lowe 2004) over 37x37 patches of the level blurred at
sigma 1.6, at the keypoints of the shared FAST+Harris detector. Gradient
orientations are taken relative to the keypoint angle exactly; only the
rotated 4x4 spatial grid is quantised, into the 32 angle bins of the steered
BRIEF, as per-bin weight tables applied in one contraction over pixels.

The contraction sums 1,369 pixels in float32 in PyTorch's order, which is
not XLA's, so descriptors agree with the reference's to a few 1e-7, not bit
for bit (see tests/test_torch_sift.py); keypoints, angles and angle bins are
the exactly-held functions of ``ops/fast.py`` and ``ops/orb.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.image import gaussian_blur
from tod_tpu_torch.ops.orb import (EDGE_THRESHOLD, N_ANGLE_BINS, PATCH_R,
                                   PATCH_W, Keypoints, angle_bins,
                                   detect_and_describe, extract_patches)

N_SPATIAL = 4            # 4x4 spatial grid
N_ORI = 8                # 8 orientation bins
DESC_DIM = N_SPATIAL * N_SPATIAL * N_ORI   # 128
SUPPORT_R = 12.0         # descriptor support radius in patch pixels


# Copied from tod_tpu/ops/sift.py:55 (_spatial_tables), numpy only.
@functools.lru_cache(maxsize=None)
def _spatial_tables(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(PATCH_W^2, n_bins * 16) float32: for angle bin b, column b*16+s holds
    pixel p's bilinear weight in rotated spatial cell s (Gaussian-windowed,
    sigma = half the support, per Lowe)."""
    w = PATCH_W
    ys, xs = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    tables = np.zeros((w * w, n_bins * 16), np.float32)
    cell = 2.0 * SUPPORT_R / N_SPATIAL
    for b in range(n_bins):
        theta = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(theta), np.sin(theta)
        # rotate pixel offsets INTO the keypoint frame (by -theta)
        rx = xs * ca + ys * sa
        ry = -xs * sa + ys * ca
        # continuous cell coords in [0, 4); center of grid at 0
        cx = rx / cell + N_SPATIAL / 2.0 - 0.5
        cy = ry / cell + N_SPATIAL / 2.0 - 0.5
        win = np.exp(-(rx**2 + ry**2) / (2.0 * SUPPORT_R**2))
        x0 = np.floor(cx).astype(int)
        y0 = np.floor(cy).astype(int)
        fx = cx - x0
        fy = cy - y0
        for dy in (0, 1):
            for dx in (0, 1):
                xb = x0 + dx
                yb = y0 + dy
                inside = (xb >= 0) & (xb < N_SPATIAL) & (yb >= 0) \
                    & (yb < N_SPATIAL)
                wgt = np.where(inside,
                               win * np.abs(1 - dx - fx) * np.abs(1 - dy - fy),
                               0.0)
                s = np.clip(yb, 0, 3) * N_SPATIAL + np.clip(xb, 0, 3)
                np.add.at(tables, (np.arange(w * w),
                                   b * 16 + s.ravel()), wgt.ravel())
    return tables


def sift_descriptors(img: torch.Tensor, xy: torch.Tensor,
                     angle: torch.Tensor) -> torch.Tensor:
    """(K, 128) float32 SIFT descriptors at integer level coords ``xy`` with
    orientations ``angle`` (radians)."""
    k_count = xy.shape[0]
    patches = extract_patches(img, xy)                    # (K, 37, 37)
    # central-difference gradients (zero border)
    pad = torch.nn.functional.pad
    gx = pad(patches[:, :, 2:] - patches[:, :, :-2], (1, 1, 0, 0))
    gy = pad(patches[:, 2:, :] - patches[:, :-2, :], (0, 0, 1, 1))
    mag = torch.sqrt(gx * gx + gy * gy).reshape(k_count, -1)   # (K, P)
    ori = torch.atan2(gy, gx).reshape(k_count, -1)             # (K, P)

    # orientation relative to the keypoint angle, soft-binned into 8 bins
    rel = (ori - angle[:, None]) * (N_ORI / (2.0 * np.pi))
    rel = torch.remainder(rel, N_ORI)                          # [0, 8]
    bin0 = torch.floor(rel)
    frac = rel - bin0
    b0 = bin0.long() % N_ORI
    b1 = (b0 + 1) % N_ORI
    # mag * ((b0 == o) * (1 - frac) + (b1 == o) * frac) for each bin o:
    # every pixel feeds two distinct bins, so a scatter writes the same sums
    t = torch.zeros(mag.shape + (N_ORI,), dtype=mag.dtype, device=mag.device)
    t.scatter_(2, b0[:, :, None], (mag * (1.0 - frac))[:, :, None])
    t.scatter_(2, b1[:, :, None], (mag * frac)[:, :, None])    # (K, P, 8)

    tables = torch.from_numpy(_spatial_tables()).to(img.device)  # (P, B*16)
    # one contraction over pixels for all angle bins at once, then the
    # keypoint's own bin
    d_all = torch.einsum("kpo,pq->kqo", t, tables)             # (K, B*16, 8)
    d_all = d_all.reshape(k_count, N_ANGLE_BINS, 16, N_ORI)
    desc = d_all[torch.arange(k_count, device=img.device),
                 angle_bins(angle)].reshape(k_count, -1)

    # Lowe normalization: unit norm, clip 0.2, renormalize
    norm = torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-9
    desc = torch.clamp(desc / norm, max=0.2)
    norm = torch.linalg.norm(desc, dim=1, keepdim=True) + 1e-9
    return (desc / norm).to(torch.float32)


def sift_detect_and_compute(gray: torch.Tensor, n_features: int = 500,
                            n_levels: int = 3, scale_factor: float = 1.2,
                            fast_threshold: float = 20.0,
                            edge_threshold: int = EDGE_THRESHOLD,
                            mask: Optional[torch.Tensor] = None
                            ) -> Tuple[Keypoints, torch.Tensor]:
    """FAST/Harris keypoints + SIFT-128 float descriptors, (n_features, 128)
    float32, with orb_detect_and_compute's contract (padded slots,
    ``valid``), restricted to ``mask`` when one is given."""
    return detect_and_describe(
        gray, lambda img, xy, angle: sift_descriptors(
            gaussian_blur(img, 7, 1.6), xy, angle),   # Lowe's octave sigma
        n_features, n_levels, scale_factor, fast_threshold, edge_threshold,
        mask)
