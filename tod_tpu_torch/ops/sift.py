"""SIFT-style float descriptors at FAST/Harris keypoints.

Port of tod_tpu/ops/sift.py: the classic 4x4-spatial x 8-orientation
gradient histogram (Lowe 2004) over 37x37 patches of the level blurred at
sigma 1.6, at the keypoints of the shared FAST+Harris detector. Gradient
orientations are taken relative to the keypoint angle exactly; only the
rotated 4x4 spatial grid is quantised, into the 32 angle bins of the steered
BRIEF, as per-bin weight tables applied in one contraction over pixels.

Every step rounds as the compiled reference rounds it, so descriptors equal
the reference's bit for bit: the gradient magnitude is ``sqrt(fma(gx, gx,
gy * gy))`` (LLVM contracts the sum of squares), its orientation the host
libm's ``atan2f`` (``ops/libm.py``), the contraction over 1,369 pixels
sums in the order of the oneDNN kernel that XLA's CPU dot runs at that
shape (:func:`contraction_groups`), and the norms add their squares in
32-wide windows in order, then the four windows in order (XLA's
reduce-window rewrite). Only the nonzero taps of the keypoint's own angle
bin are summed: every term is >= +0, and the reference's one-hot selection
of the bin adds exact zeros. :func:`sift_descriptors` runs all of it as
one kernel on the card (L2, ``csrc/sift_descriptor.cu``); its plain
version is :func:`sift_describe_torch`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.image import fma_f32, gaussian_blur, gemm_order
from tod_tpu_torch.ops.libm import atan2f
from tod_tpu_torch.ops.orb import (_BIN_SCALE, EDGE_THRESHOLD, N_ANGLE_BINS,
                                   PATCH_R, PATCH_W, Keypoints, angle_bins,
                                   detect_and_describe, extract_patches)
from tod_tpu_torch.ops.reduce import square_norms

N_SPATIAL = 4            # 4x4 spatial grid
N_ORI = 8                # 8 orientation bins
DESC_DIM = N_SPATIAL * N_SPATIAL * N_ORI   # 128
SUPPORT_R = 12.0         # descriptor support radius in patch pixels
DEPTH = PATCH_W * PATCH_W                  # 1,369 pixels a patch
N_GROUPS = 4             # the contraction's partial sums an output
MAX_PIXELS = 912         # most pixels an angle bin's cells read (901)
MAX_BIN_TAPS = 2560      # most nonzero taps of an angle bin's 16 cells (2304)
DESCRIBE_PER_BLOCK = 4   # keypoints a block of kernel L2 (kPerBlock)
# float32 bits of angle_bins' scale and of soft_bins' N_ORI / (2 pi), the
# constants kernel L2 takes (a python float meets a float32 tensor as its
# float32 rounding)
_BIN_SCALE_BITS = int(np.float32(_BIN_SCALE).view(np.int32))
_REL_SCALE_BITS = int(np.float32(N_ORI / (2.0 * np.pi)).view(np.int32))


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


def contraction_order(k_count: int, batch: int = 1) -> Tuple[str, int]:
    """(kind, block) of the order in which the compiled reference sums the
    descriptor contraction of ``k_count`` keypoints in each of ``batch``
    images: XLA's CPU dot of the (512, 1369) tables by the (1369, 8 batch
    k_count) weights (a program vmapped over a batch of images, as the
    trainer's over its views, folds the batch into the columns), whose
    oneDNN kernel follows the columns as a resize's column product follows
    its output columns (:func:`tod_tpu_torch.ops.image.gemm_order`; read
    off by ``tools/fit_sift_order.py``)."""
    return gemm_order(DEPTH, N_ORI * batch * k_count, False,
                      rows=N_ANGLE_BINS * N_SPATIAL * N_SPATIAL)


def contraction_groups(taps: np.ndarray, kind: str, block: int
                       ) -> np.ndarray:
    """Partial sum (0-3) of each depth of ``taps`` (ascending): "lanes":
    depth mod 4; "parity": 2 x its block of ``block`` depths + its parity;
    "chain": its block of ``block`` depths. Each partial is one fused
    multiply-add chain in ascending depth from +0, and an output is
    ``(p0 + p1) + (p2 + p3)``: the lanes' sum, the two parity blocks' sums
    added in order, and the chain blocks added in order (p3 is empty). The
    kernels' tails (the lanes' last depth 1368, a parity block's depths
    past its multiple of 8) hold no nonzero tap of the tables, which this
    checks."""
    if kind == "lanes":
        tail = taps >= DEPTH // 4 * 4
        groups = taps % 4
    elif kind == "parity":
        start = taps // block * block
        tail = taps - start >= (np.minimum(block, DEPTH - start) & ~7)
        groups = 2 * (taps // block) + taps % 2
    else:
        tail = np.zeros(taps.shape, bool)
        groups = taps // block
    if tail.any() or (groups >= N_GROUPS).any():
        raise ValueError(f"{kind} order: taps {taps[tail]} outside the "
                         f"{N_GROUPS} partial sums")
    return groups


class Taps(NamedTuple):
    """A contraction order's tap tables (:func:`_contraction_taps`)."""
    starts: np.ndarray        # (512 x 4 + 1,) int32
    weights: np.ndarray       # (taps,) float32
    slots: np.ndarray         # (taps,) int32, its pixel's place in pixels
    pixel_starts: np.ndarray  # (33,) int32
    pixels: np.ndarray        # (sum of the bins' pixels,) int32
    idx: np.ndarray           # (4, 512, most taps of a partial) int64
    wt: np.ndarray            # (4, 512, most taps of a partial) float32


@functools.lru_cache(maxsize=None)
def _contraction_taps(order: Tuple[str, int]) -> Taps:
    """The nonzero taps of each table column (angle bin x 16 + cell) split
    into the order's partial sums. Flat, as kernel L2 reads them: column
    c's partial g holds taps ``starts[4 c + g] .. starts[4 c + g + 1]``,
    ascending depth, each tap's weight and its ``slot`` in the pixels
    (depths) that the 16 columns of its angle bin read (bin b's:
    ``pixels[pixel_starts[b] .. pixel_starts[b + 1]]``, ascending; at most
    :data:`MAX_PIXELS`, the kernel describes only those; a bin's taps
    are contiguous, at most :data:`MAX_BIN_TAPS`).
    Padded, for the plain version: ``(idx, wt)``, (4, 512, most taps of a
    partial), weight 0 past a partial's taps."""
    tables = _spatial_tables()
    cells = N_SPATIAL * N_SPATIAL
    bin_pixels = [np.nonzero(tables[:, b * cells:(b + 1) * cells]
                             .any(1))[0] for b in range(N_ANGLE_BINS)]
    if max(len(p) for p in bin_pixels) > MAX_PIXELS \
            or max(np.count_nonzero(tables[:, b * cells:(b + 1) * cells])
                   for b in range(N_ANGLE_BINS)) > MAX_BIN_TAPS:
        raise ValueError(f"an angle bin reads more than {MAX_PIXELS} pixels "
                         f"or {MAX_BIN_TAPS} taps")
    parts = []                    # (column, partial) in the kernel's order
    for col in range(tables.shape[1]):
        taps = np.nonzero(tables[:, col])[0]
        groups = contraction_groups(taps, *order)
        parts += [(col, taps[groups == g]) for g in range(N_GROUPS)]
    width = max(len(sel) for _, sel in parts)
    idx = np.zeros((N_GROUPS, tables.shape[1], width), np.int64)
    wt = np.zeros(idx.shape, np.float32)
    for i, (col, sel) in enumerate(parts):
        idx[i % N_GROUPS, col, :len(sel)] = sel
        wt[i % N_GROUPS, col, :len(sel)] = tables[sel, col]
    return Taps(
        starts=np.cumsum([0] + [len(sel) for _, sel in parts])
        .astype(np.int32),
        weights=np.concatenate([tables[sel, col] for col, sel in parts])
        .astype(np.float32),
        slots=np.concatenate([np.searchsorted(bin_pixels[col // cells], sel)
                              for col, sel in parts]).astype(np.int32),
        pixel_starts=np.cumsum([0] + [len(p) for p in bin_pixels])
        .astype(np.int32),
        pixels=np.concatenate(bin_pixels).astype(np.int32),
        idx=idx, wt=wt)


@functools.lru_cache(maxsize=None)
def _device_taps(order: Tuple[str, int], device: torch.device) -> Taps:
    """:func:`_contraction_taps` as tensors on ``device``, uploaded once."""
    return Taps(*(torch.from_numpy(a).to(device)
                  for a in _contraction_taps(order)))


def sift_contract_torch(t: torch.Tensor, bins: torch.Tensor,
                        batch: int = 1) -> torch.Tensor:
    """(K, 16, 8) histograms: for each keypoint k, cell s and orientation o
    the sum over pixels p of ``tables[p, 16 bins[k] + s] * t[k, p, o]``,
    summed as the compiled reference sums it (:func:`contraction_order`,
    :func:`contraction_groups`), one rounding a tap (``fma_f32``); the plain
    version of kernel L2's contraction. ``t`` is the (K, 1369, 8) float32
    soft-binned gradient weights, ``bins`` the (K,) angle bins, ``batch``
    the images the reference describes at once."""
    k_count = t.shape[0]
    taps = _device_taps(contraction_order(k_count, batch), t.device)
    idx, wt = taps.idx, taps.wt
    cols = bins.long()[:, None] * (N_SPATIAL * N_SPATIAL) \
        + torch.arange(N_SPATIAL * N_SPATIAL, device=t.device)   # (K, 16)
    rows = torch.arange(k_count, device=t.device)[None, :, None]
    acc = torch.zeros((N_GROUPS, k_count, N_SPATIAL * N_SPATIAL, N_ORI),
                      dtype=torch.float32, device=t.device)
    for step in range(idx.shape[2]):
        x = t[rows, idx[:, :, step][:, cols]]                # (4, K, 16, 8)
        acc = fma_f32(x, wt[:, :, step][:, cols, None], acc)
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on any device (PyTorch's CPU
    float32 ``sqrt`` is not; the f64 root rounds to the same float)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _norm(desc: torch.Tensor) -> torch.Tensor:
    """(K,) L2 norms of (K, 128) rows, summed as the compiled reference's
    ``jnp.linalg.norm``: the squares rounded, added in order within each
    32-wide window from +0, the four windows added in order, the root."""
    return _sqrt_f32(square_norms(desc))


def sift_normalize_torch(desc: torch.Tensor) -> torch.Tensor:
    """Lowe's normalisation of (K, 128) histograms, in the reference's
    order: unit norm (+1e-9), clip at 0.2, unit norm again; the plain
    version of kernel L2's epilogue."""
    desc = torch.clamp(desc / (_norm(desc) + 1e-9)[:, None], max=0.2)
    return desc / (_norm(desc) + 1e-9)[:, None]


def gradients(img: torch.Tensor, xy: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy), each (K, 37, 37): the central-difference gradients (zero
    border) of the patches of ``img`` at integer level coords ``xy``."""
    patches = extract_patches(img, xy)                    # (K, 37, 37)
    pad = torch.nn.functional.pad
    gx = pad(patches[:, :, 2:] - patches[:, :, :-2], (1, 1, 0, 0))
    gy = pad(patches[:, 2:, :] - patches[:, :-2, :], (0, 0, 1, 1))
    return gx, gy


def soft_bins(gx: torch.Tensor, gy: torch.Tensor,
              angle: torch.Tensor) -> torch.Tensor:
    """(K, 1369, 8) float32 weights: each pixel's gradient magnitude split
    between the two orientation bins (of 8) around its orientation
    relative to the keypoint ``angle``."""
    k_count = gx.shape[0]
    mag = _sqrt_f32(fma_f32(gx, gx, gy * gy)).reshape(k_count, DEPTH)  # (K, P)
    ori = atan2f(gy, gx).reshape(k_count, DEPTH)                       # (K, P)
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
    t.scatter_(2, b1[:, :, None], (mag * frac)[:, :, None])
    return t


def sift_describe_torch(img: torch.Tensor, xy: torch.Tensor,
                        angle: torch.Tensor, batch: int = 1) -> torch.Tensor:
    """:func:`sift_descriptors` as a chain of PyTorch ops (the patches'
    gradients, their soft bins through :func:`atan2f`, the contraction and
    the normalisation): the plain version of kernel L2."""
    t = soft_bins(*gradients(img, xy), angle)
    return sift_normalize_torch(sift_contract_torch(
        t, angle_bins(angle), batch).reshape(len(xy), DESC_DIM))


def sift_descriptors(img: torch.Tensor, xy: torch.Tensor,
                     angle: torch.Tensor, batch: int = 1) -> torch.Tensor:
    """(K, 128) float32 SIFT descriptors at integer level coords ``xy``
    (K, 2) with orientations ``angle`` (radians) on the (H, W) float32
    level ``img``, bit for bit the compiled reference's when it describes
    ``batch`` such images in one vmapped program (the trainer's view
    batch; 1 for one image). Kernel L2 on a CUDA tensor (one call, which
    queues its one-block grouping pre-pass and the kernel, counted once in
    ``sift_descriptors.launches``; a failed launch raises),
    :func:`sift_describe_torch` on a CPU tensor."""
    k_count = xy.shape[0]
    if img.dtype != torch.float32 or img.dim() != 2 \
            or min(img.shape) < PATCH_W or tuple(xy.shape) != (k_count, 2) \
            or angle.shape != (k_count,) or angle.dtype != torch.float32 \
            or not img.device == xy.device == angle.device:
        raise ValueError(f"sift_descriptors: img {tuple(img.shape)} "
                         f"{img.dtype} on {img.device}, xy {tuple(xy.shape)} "
                         f"on {xy.device}, angle {tuple(angle.shape)} "
                         f"{angle.dtype} on {angle.device}")
    if img.device.type == "cpu":
        return sift_describe_torch(img, xy, angle, batch)
    if img.device.type != "cuda":
        raise ValueError(f"no SIFT descriptor path for {img.device}")
    out = torch.empty((k_count, DESC_DIM), dtype=torch.float32,
                      device=img.device)
    if k_count:
        # the kernel's pre-pass groups the keypoints by angle bin here
        scratch = torch.empty(k_count + 2 * (N_ANGLE_BINS + 1),
                              dtype=torch.int32, device=img.device)
        taps = _device_taps(contraction_order(k_count, batch), img.device)
        img = img.contiguous()
        xy32 = xy.to(torch.int32).contiguous()
        angle = angle.contiguous()
        kernels.call("sift_descriptor", "tod_sift_describe",
                     [img.data_ptr(), xy32.data_ptr(), angle.data_ptr(),
                      taps.starts.data_ptr(), taps.slots.data_ptr(),
                      taps.weights.data_ptr(), taps.pixel_starts.data_ptr(),
                      taps.pixels.data_ptr(), scratch.data_ptr(),
                      out.data_ptr()],
                     [img.shape[0], img.shape[1], k_count, _BIN_SCALE_BITS,
                      _REL_SCALE_BITS],
                     torch.cuda.current_stream(img.device).cuda_stream)
        sift_descriptors.launches += 1
    return out


sift_descriptors.launches = 0


def sift_detect_and_compute(gray: torch.Tensor, n_features: int = 500,
                            n_levels: int = 3, scale_factor: float = 1.2,
                            fast_threshold: float = 20.0,
                            edge_threshold: int = EDGE_THRESHOLD,
                            mask: Optional[torch.Tensor] = None,
                            batch: int = 1
                            ) -> Tuple[Keypoints, torch.Tensor]:
    """FAST/Harris keypoints + SIFT-128 float descriptors, (n_features, 128)
    float32, with orb_detect_and_compute's contract (padded slots,
    ``valid``), restricted to ``mask`` when one is given; ``batch`` as
    :func:`sift_descriptors` and
    :func:`tod_tpu_torch.ops.orb.detect_and_describe` take it."""
    return detect_and_describe(
        gray, lambda img, xy, angle: sift_descriptors(
            gaussian_blur(img, 7, 1.6), xy, angle,   # Lowe's octave sigma
            batch),
        n_features, n_levels, scale_factor, fast_threshold, edge_threshold,
        mask, batch=batch)
