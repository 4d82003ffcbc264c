"""Dense image ops: grayscale, separable Gaussian blur, pyramid resize.

Port of tod_tpu/ops/image.py. Arithmetic follows the reference's order
(separate multiply and add passes, f32 throughout) so that results agree
with it to the last bit where the reference's own order is fixed.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """BT.601 luma, matching cv::cvtColor RGB2GRAY. Accepts (H,W,3) u8/float,
    returns (H,W) float32 in the input's value range."""
    img = image.to(torch.float32)
    if img.dim() == 2:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


# Copied from tod_tpu/ops/image.py:29 (_gaussian_kernel1d), numpy only.
def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    # Same formula as cv::getGaussianKernel.
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _weighted_taps(taps: List[torch.Tensor], k: np.ndarray) -> torch.Tensor:
    acc = taps[0] * float(k[0])
    for i in range(1, len(taps)):
        acc = acc + taps[i] * float(k[i])
    return acc


def gaussian_blur(image: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate (edge) borders."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = image.shape
    x = image.to(torch.float32)
    xp = F.pad(x[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    x = _weighted_taps([xp[:, i:i + w] for i in range(ksize)], k)
    xp = F.pad(x[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    return _weighted_taps([xp[i:i + h] for i in range(ksize)], k)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of ``jax.image.resize(method="linear")`` along
    one axis: a triangle kernel widened by in/out when downsampling (the
    antialiasing that plain bilinear interpolation lacks), each output
    column normalised to sum 1 (jax/_src/image/scale.py
    compute_weight_mat).

    Rounded as the reference's compiled program rounds them: XLA fuses
    ``(i + 0.5) * inv_scale - 0.5`` into one multiply-add (emulated here by
    an exact f64 product and one rounding) and divides by the constant
    kernel scale as a multiply by its f32 reciprocal. Plain f32 steps give
    sample positions up to 2e-5 off at 640 px, and the resized level then
    differs by up to 4e-3 grey levels."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.float32(max(1.0 / scale, 1.0))
    centers = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    sample_f = (centers.astype(np.float64) * np.float64(inv_scale)
                - 0.5).astype(np.float32)
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         * (np.float32(1.0) / kernel_scale))
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, np.float32(1)),
                       np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0)).astype(np.float32)


def resize_bilinear(image: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased linear resize, the ``jax.image.resize(method="linear")``
    op the reference uses (not ``F.interpolate``, which does not low-pass
    when downsampling)."""
    x = image.to(torch.float32)
    (h, w), (oh, ow) = x.shape, out_hw
    if oh != h:
        wy = torch.from_numpy(resize_weights(h, oh)).to(x.device)
        x = wy.T @ x
    if ow != w:
        wx = torch.from_numpy(resize_weights(w, ow)).to(x.device)
        x = x @ wx
    return x


# Copied from tod_tpu/ops/image.py:74 (pyramid_shapes), numpy only.
@functools.lru_cache(maxsize=None)
def pyramid_shapes(height: int, width: int, n_levels: int,
                   scale_factor: float) -> Tuple[Tuple[int, int], ...]:
    """Static per-level image shapes: level l is (H,W)/scale^l, rounded, as in
    cv::ORB's pyramid."""
    shapes: List[Tuple[int, int]] = []
    for level in range(n_levels):
        s = scale_factor**level
        shapes.append((max(8, int(round(height / s))),
                       max(8, int(round(width / s)))))
    return tuple(shapes)


def build_pyramid(gray: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """Image pyramid; each level resized from level 0."""
    h, w = gray.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [gray.to(torch.float32)]
    for hw in shapes[1:]:
        levels.append(resize_bilinear(gray, hw))
    return levels
