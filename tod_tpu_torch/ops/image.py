"""Dense image ops: grayscale, separable Gaussian blur, pyramid resize.

Port of tod_tpu/ops/image.py. Arithmetic follows the reference's order,
f32 throughout, and rounds as the reference rounds where it runs: serving
converts frames to gray eagerly (separate multiply and add passes), while
the compiled programs fuse multiply-adds (:func:`fma_f32`), so that results
agree with it to the last bit where the reference's own order is fixed.
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


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add, on any
    device: the product is exact in f64, the f64 sum is rounded to odd (an
    inexact sum with an even last bit moves one ulp toward its TwoSum
    error), and rounding that to f32 is then correct."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    p = a.to(torch.float64) * b
    c = c.to(torch.float64)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    bits = s.view(torch.int64)
    step = torch.where((err != 0) & ((bits & 1) == 0),
                       torch.where((err > 0) == (s > 0), 1, -1), 0)
    return (bits + step).view(torch.float64).to(torch.float32)


def rgb_to_gray_fused(image: torch.Tensor) -> torch.Tensor:
    """:func:`rgb_to_gray` as the reference's compiled programs round it
    (the trainer's, tod_tpu/cells/trainer.py:49; serving converts eagerly):
    XLA fuses the weighted sum into ``fma(0.114, b, fma(0.299, r, 0.587
    g))``."""
    img = image.to(torch.float32)
    if img.dim() == 2:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    c = [torch.full((), v, dtype=torch.float32, device=img.device)
         for v in (0.299, 0.587, 0.114)]
    return fma_f32(c[2], b, fma_f32(c[0], r, c[1] * g))


# Copied from tod_tpu/ops/image.py:29 (_gaussian_kernel1d), numpy only.
def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    # Same formula as cv::getGaussianKernel.
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _fused_taps(taps: List[torch.Tensor], k: np.ndarray) -> torch.Tensor:
    acc = fma_f32(taps[0], float(k[0]), taps[1] * float(k[1]))
    for i in range(2, len(taps)):
        acc = fma_f32(taps[i], float(k[i]), acc)
    return acc


def gaussian_blur(image: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate (edge) borders, rounded as the
    reference's compiled programs round it (ORB and SIFT describe inside
    them, at serving and at training): LLVM fuses each pass's sum of
    products into ``fma(k0, t0, k1 t1)``, then ``fma(ki, ti, acc)`` tap by
    tap."""
    k = _gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = image.shape
    x = image.to(torch.float32)
    xp = F.pad(x[None, None], (pad, pad, 0, 0), mode="replicate")[0, 0]
    x = _fused_taps([xp[:, i:i + w] for i in range(ksize)], k)
    xp = F.pad(x[None, None], (0, 0, pad, pad), mode="replicate")[0, 0]
    return _fused_taps([xp[i:i + h] for i in range(ksize)], k)


def _fma_f32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the f32
    product is exact in extended precision."""
    ld = np.longdouble
    return (np.asarray(a, np.float32).astype(ld) * ld(b)
            + np.asarray(c, np.float32).astype(ld)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) f32 weights of ``jax.image.resize(method="linear")`` along
    one axis: a triangle kernel widened by in/out when downsampling (the
    antialiasing that plain bilinear interpolation lacks), each output
    column normalised to sum 1 (jax/_src/image/scale.py
    compute_weight_mat).

    Rounded as the reference's compiled CPU program rounds them. XLA
    computes the numerators and the column totals in two loops over the
    columns, divides by the constant kernel scale as a multiply by its
    reciprocal ``c``, and LLVM compiles each column one of two ways:
    - in a vectorised loop body, the sample position ``(i + 0.5) *
      inv_scale - 0.5`` is one fused multiply-add, and ``1 - |y * c|`` is
      not fused (an ``fabs`` sits between the product and the difference);
    - in columns that LLVM unrolled, the sample position is folded to a
      constant rounded twice, and ``1 - |y| * c`` is one fused multiply-add.
    The numerators' loop runs 8 columns a step (unrolled from ``out // 8 *
    8`` on), the totals' loop 32 (unrolled from ``out // 32 * 32`` on, or
    entirely below 352 columns). Each total is a reduce-window: 32-row
    blocks summed in order, then the blocks in order. Read off the
    optimised LLVM IR (``XLA_FLAGS=--xla_dump_to``) and bit-equal to the
    compiled reference at the 3-level 480x640 pyramid's four sizes."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    c = f32(1.0) / f32(max(1.0 / scale, 1.0))
    centers = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_vec = _fma_f32(centers, inv_scale, np.full(out_size, -0.5, f32))
    sample_const = centers * inv_scale + f32(-0.5)
    rows = np.arange(in_size, dtype=f32)[:, None]

    def taps(sample_f, unrolled):
        y = np.abs(sample_f[None, :] - rows)
        if unrolled:
            return np.maximum(f32(0), _fma_f32(-y, c, np.ones_like(y)))
        return np.maximum(f32(0), f32(1) - np.abs(y * c))

    def loop(unrolled):
        """(weights, sample positions) of a loop whose columns ``unrolled``
        (bool (out,)) were unrolled by LLVM."""
        return (np.where(unrolled[None, :], taps(sample_const, True),
                         taps(sample_vec, False)),
                np.where(unrolled, sample_const, sample_vec))

    col = np.arange(out_size)
    weights, sample_f = loop(col >= out_size // 8 * 8)
    summed, _ = loop(col >= (0 if out_size < 352 else out_size // 32 * 32))
    total = np.zeros(out_size, f32)
    for b in range(0, in_size, 32):
        part = np.zeros(out_size, f32)
        for row in summed[b:b + 32]:
            part = part + row
        total = total + part
    eps = f32(1000.0 * np.finfo(f32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


# How XLA's CPU GEMM (Eigen) sums each output of a resize product of shape
# (rows, depth, cols), read off the compiled reference for the 3-level
# 480x640 pyramid: "split" restarts the multiply-add chain at that depth and
# adds the two chains; "parity" keeps one chain for even and one for odd
# depths and adds them. Other shapes sum in one chain.
_GEMM_ORDER = {(400, 480, 640): ("split", 240), (333, 480, 640): ("split", 240),
               (400, 640, 533): ("parity", 2), (333, 640, 444): ("split", 512)}


@functools.lru_cache(maxsize=None)
def _tap_tables(in_size: int, out_size: int, gemm: Tuple[int, int, int],
                device: torch.device):
    """(2, out, T) input indices and weights of each output's taps, split
    into the two chains of the product's summation order, increasing
    index within a chain, zero weight where a chain has fewer taps."""
    w = resize_weights(in_size, out_size)
    how, at = _GEMM_ORDER.get(gemm, ("split", in_size))
    chains = [[[], []] for _ in range(out_size)]
    for o in range(out_size):
        for i in np.nonzero(w[:, o])[0]:
            g = (i >= at) if how == "split" else i % at
            chains[o][int(g)].append(i)
    t = max(1, max(len(c) for ch in chains for c in ch))
    idx = np.zeros((2, out_size, t), np.int64)
    wt = np.zeros((2, out_size, t), np.float64)
    for o, ch in enumerate(chains):
        for g, taps in enumerate(ch):
            idx[g, o, :len(taps)] = taps
            wt[g, o, :len(taps)] = w[taps, o]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device))


def _resize_rows(x: torch.Tensor, out_size: int,
                 gemm: Tuple[int, int, int]) -> torch.Tensor:
    """``W^T @ x`` for the (in, out) resize weights of x's first axis, summed
    as the reference's GEMM of shape ``gemm`` sums: per chain, one rounding
    per multiply-add (f32 products are exact in f64), then chain 0 +
    chain 1."""
    idx, wt = _tap_tables(x.shape[0], out_size, gemm, x.device)
    x64 = x.to(torch.float64)
    acc = torch.zeros((2, out_size, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for t in range(idx.shape[2]):
        acc = (wt[:, :, t, None] * x64[idx[:, :, t]]
               + acc.to(torch.float64)).to(torch.float32)
    return acc[0] + acc[1]


def resize_bilinear(image: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased linear resize, the ``jax.image.resize(method="linear")``
    op the reference uses (not ``F.interpolate``, which does not low-pass
    when downsampling): rows first, then columns, each a banded product
    summed as the compiled reference sums it (``_GEMM_ORDER``)."""
    x = image.to(torch.float32)
    (h, w), (oh, ow) = x.shape, out_hw
    if oh != h:
        x = _resize_rows(x, oh, (oh, h, w))
    if ow != w:
        x = _resize_rows(x.T, ow, (x.shape[0], w, ow)).T
    return x


@functools.lru_cache(maxsize=None)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output along one axis of
    ``jax.image.resize(method="nearest")``: ``floor((i + 0.5) * m / n)`` in
    f32 (jax/_src/image/scale.py ``_resize_nearest``), as the compiled
    reference evaluates it: XLA folds ``* m / n`` into one multiply by the
    f32 constant ``m * (1 / n)`` (at 480 -> 400 that is 1.19999993, and
    output 2 reads row 2, not 3)."""
    f32 = np.float32
    scale = f32(f32(in_size) * (f32(1) / f32(out_size)))
    centers = np.arange(out_size, dtype=f32) + f32(0.5)
    return np.floor(centers * scale).astype(np.int64)


def resize_nearest(image: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of the two leading axes (CV_INTER_NN, used
    for depth and masks so that edges do not blend), with the compiled
    reference's source indices (:func:`nearest_indices`)."""
    (h, w), (oh, ow) = image.shape[:2], out_hw
    x = image
    if oh != h:
        x = x[torch.from_numpy(nearest_indices(h, oh)).to(x.device)]
    if ow != w:
        x = x[:, torch.from_numpy(nearest_indices(w, ow)).to(x.device)]
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
