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

from tod_tpu_torch.ops.reduce import tree_sum


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """BT.601 luma, matching cv::cvtColor RGB2GRAY. Accepts (H,W,3) u8/float,
    returns (H,W) float32 in the input's value range."""
    img = image.to(torch.float32)
    if img.dim() == 2:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _fma_f32_odd(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """:func:`fma_f32` by rounding to odd, branch-free on any device: the
    product is exact in f64, the f64 sum is rounded to odd (an inexact sum
    with an even last bit moves one ulp toward its TwoSum error), and
    rounding that to f32 is then correct."""
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


_F64_TIE = 1 << 28          # f64 significand bits below f32's: a half ulp
_F64_LOW = (1 << 29) - 1


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add, on any
    device. On a CUDA tensor, :func:`_fma_f32_odd` (no host wait). On a
    CPU tensor the f64 sum ``s`` of the exact product and ``c`` rounds
    to f32 as the exact sum does unless ``s`` is an f32 half-way point
    (every f32 value and half-way point is an f64 value, and rounding is
    monotonic): only those elements, and those in the f32 subnormal range,
    take :func:`_fma_f32_odd`; the same bits at half the cost. A
    sum past the f32 range (its f64 at or above 2^128) rounds to an
    infinity directly, as the FMA does; the round-to-odd form would give
    NaN there, so a CUDA tensor's sum that overflows f32 is NaN (the paths
    that use it stay far from 2^128)."""
    if a.device.type != "cpu":
        return _fma_f32_odd(a, b, c)
    b64 = b.to(torch.float64) if isinstance(b, torch.Tensor) else b
    s = a.to(torch.float64) * b64 + c.to(torch.float64)
    bits = s.view(torch.int64)
    exp = (bits >> 52) & 0x7FF
    # below 897: |s| < 2^-126, f32's subnormal range; an exact zero is exact
    slow = ((bits & _F64_LOW) == _F64_TIE) | ((exp < 897) & (s != 0))
    out = s.to(torch.float32)
    if bool(slow.any()):
        at = slow.nonzero(as_tuple=True)
        pick = lambda x: torch.broadcast_to(x, s.shape)[at]  # noqa: E731
        out[at] = _fma_f32_odd(pick(a), pick(b64) if isinstance(
            b64, torch.Tensor) else b64, pick(c))
    return out


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


# The reference's rounding below is its compiled CPU program's on the host its
# tests run on: x86-64 with AVX-512 and FMA, 48 KiB of L1d and 2 MiB of L2 a
# core, jax 0.9.0. LLVM's loop shapes and Eigen's blocking depend on these, so
# the rules hold for that host; ROADMAP queue C says what they were checked on.


def _tree_sum(x: np.ndarray) -> np.ndarray:
    """Column sums of float32 ``x`` as the reference's compiled reduce sums
    them (:func:`ops.reduce.tree_sum`: 32-row windows, padded in front by
    half the padding, then the windows' sums the same way)."""
    return tree_sum(torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                    0).numpy()


def _vector_columns(out_size: int, step: int) -> int:
    """Columns that an LLVM loop of ``step`` columns an iteration computes
    in its vector body: all whole steps, unless the loop runs 10 steps or
    fewer, which LLVM unrolls fully (its unroll analysis looks at loops of
    up to 10 iterations) and so folds every column's constants."""
    steps = out_size // step
    return 0 if steps <= 10 else steps * step


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
    - in columns whose index LLVM made a constant (the epilogue after the
      vector body, or every column of a loop it unrolled fully), the sample
      position is folded to a constant rounded twice, and ``1 - |y| * c``
      is one fused multiply-add.
    The weights' loop runs 8 columns a step and the totals' loop 32
    (:func:`_vector_columns`). Each total is summed as :func:`_tree_sum`
    sums. Read off the optimised LLVM IR and HLO (``XLA_FLAGS=
    --xla_dump_to``), and bit-equal to the compiled reference at every
    axis of the 3- and 8-level pyramids (scale 1.2) of 240x320, 480x640,
    480x848, 720x1280, 960x1280 and 1080x1920, and at upsampling."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    c = f32(1.0) / f32(max(1.0 / scale, 1.0))
    centers = np.arange(out_size, dtype=f32) + f32(0.5)
    sample_vec = _fma_f32(centers, inv_scale, np.full(out_size, -0.5, f32))
    sample_const = centers * inv_scale + f32(-0.5)
    rows = np.arange(in_size, dtype=f32)[:, None]

    def taps(sample_f, folded):
        y = np.abs(sample_f[None, :] - rows)
        if folded:
            return np.maximum(f32(0), _fma_f32(-y, c, np.ones_like(y)))
        return np.maximum(f32(0), f32(1) - np.abs(y * c))

    def loop(step):
        """(weights, sample positions) of a loop of ``step`` columns an
        iteration."""
        folded = np.arange(out_size) >= _vector_columns(out_size, step)
        return (np.where(folded[None, :], taps(sample_const, True),
                         taps(sample_vec, False)),
                np.where(folded, sample_const, sample_vec))

    weights, sample_f = loop(8)
    total = _tree_sum(loop(32)[0])
    eps = f32(1000.0 * np.finfo(f32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


# How XLA's CPU dot sums each output of a resize product. The reference's
# Eigen contraction hands blocks of the product to oneDNN's sgemm, and the
# order over the depth k is one of three:
# - "chain": one fused multiply-add chain a block of ``block`` depths, the
#   blocks' sums added in order;
# - "parity": in each block of ``block`` depths, one chain over the even and
#   one over the odd depths, added; the blocks added in order; an odd depth's
#   last product, rounded, added last;
# - "lanes": four chains over k mod 4 up to the depth's last multiple of
#   4, then (k0 + k1) + (k2 + k3); the 1-3 products past it, each rounded,
#   summed in order and added last.
# The row product (the weights on the right, XLA's rows pass) chains:
# Eigen's multi-threaded blocking caps a depth block at 320, and the
# contraction kernel cuts the depth into equal slices, rounded up to 8
# (_row_slice), unless Eigen splits the depth (eigen_order). The column
# product (the weights on the left) runs one oneDNN call over the whole
# depth, whose kernel follows the product's rows (the resize's output
# columns) in 16-row steps: ((cols - 1) // 16) mod 4 picks lanes, parity,
# lanes, chain (_COLUMN_KERNELS); chain blocks are 512 deep and parity
# blocks 1024. Both were read off the compiled reference
# (tools/fit_resize_order.py): at every product of the grid above and of
# 120x160, 360x640, 540x960, 600x800, 600x1024, 768x1024 and 1200x1600 (3
# and 8 levels), the row rule at every depth from 322 to 474 in steps of
# 8, the column rule at every width from 80 to 271 at depths 320, 336, 480
# and 640; the kernels' tails at depths that are no multiple of 4
# (tools/fit_pyramid_shards.py, on dense random products). The column
# product of a level of 50 image rows or fewer runs another kernel: one
# chain over the whole depth, whatever its width (tools/fit_sift_order.py
# --short, 20 frame sizes from 48x64 to 180x320 at 3 and 8 levels).
_COLUMN_KERNELS = ("lanes", "parity", "lanes", "chain")
_BLOCK = {"chain": 512, "parity": 1024}
_SHORT_ROWS = 50
# Past a width the kernels change (read off at 512 rows, the SIFT tables',
# by tools/fit_sift_order.py at widths that are multiples of 8): from
# 7,336 columns the second lanes class chains, from 10,952 the first takes
# parity, from 43,784 every class chains. (widest width of the old
# kernel, the class it moves, its new kernel)
_WIDE_KERNELS = ((7280, 2, "chain"), (10896, 0, "parity"),
                 (43744, 0, "chain"), (43744, 1, "chain"))


def _column_kernel(cols: int) -> str:
    """The kernel of a column product of more than 50 rows into ``cols``
    outputs: lanes at 24 or fewer, else by the 16-column step
    (``_COLUMN_KERNELS``), changed past the widths of ``_WIDE_KERNELS``."""
    if cols <= 24:
        return "lanes"
    step = (cols - 1) // 16 % 4
    kind = _COLUMN_KERNELS[step]
    for widest, moved, new in _WIDE_KERNELS:
        if step == moved and cols > widest:
            kind = new
    return kind


def _row_slice(depth: int) -> int:
    """Depth block of the row product: ``depth`` cut into ceil(depth / 320)
    equal slices, rounded up to a multiple of 8 (Eigen's multi-threaded
    ``k_cache`` cap and the contraction kernel's equal k-slices, rounded to
    its packet of at least 8)."""
    slices = -(-depth // 320)
    return -(-(depth // slices) // 8) * 8


# Eigen's thread-pool contraction (TensorContractionThreadPool.h
# evalProductImpl, which XLA's CPU dot runs) splits a product over its depth
# when its cost model gives the depth more threads than the outputs: the
# depth in blocks of max(96, ceil(depth / threads) rounded up to 8), each
# block's partial sum in a buffer of its own, the buffers added to the
# first in order. The constants are the reference's build and host: Eigen
# for AVX without FMA (8-float packets; gebp's mr 16, nr 4), 8 intra-op
# threads (any pool of 6 or more decides alike at the pyramid's sizes),
# 48 KiB of L1d and 2 MiB of L2; TSL's oneDNN blocking (its M unroll 48, N
# unroll 24, M scaled by 1.5).
_THREADS, _PACKET, _MR, _NR = 8, 8, 16, 4
_L1, _L2 = 48 * 1024, 2 * 1024 * 1024
# The host these rules were read on (tests/test_torch_premise.py holds a
# host to it): the CPU flags its oneDNN kernels and XLA's code take, and
# the least pool that decides alike
_HOST_FLAGS = ("avx512f", "fma")
_POOL_ALIKE = 6
_BYTE_CYCLES = 11 / 64        # Eigen's TensorCostModel: a byte from L2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blocking(k: int, m: int, n: int, by_col: bool) -> Tuple[int, int, int]:
    """(kc, mc, nc) of TSL's TensorContractionBlocking for oneDNN at 2
    threads: Eigen's computeProductBlockingSizes (its multi-threaded
    branch), then oneDNN's unrolls and equal k-slices."""
    def eigen(k, m, n):
        k_cache = max(8, min((_L1 - _MR * _NR * 4) // (4 * (_MR + _NR)), 320))
        if k_cache < k:
            k = k_cache - k_cache % 8
        n_cache = (_L2 - _L1) // (_NR * 4 * k)
        per = _cdiv(n, 2)
        n = n_cache - n_cache % _NR if n_cache <= per \
            else min(n, per + _NR - 1 - (per + _NR - 1) % _NR)
        per = _cdiv(m, 2)
        return k, min(m, per + _MR - 1 - (per + _MR - 1) % _MR), n
    if by_col:
        kc, mc, nc = eigen(k, m, n)
    else:
        kc, nc, mc = eigen(k, n, m)
    mc = min(m, _cdiv(int(mc * 1.5), 48) * 48)
    nc = min(n, _cdiv(nc, 24) * 24)
    slices = max(1, _cdiv(k, kc))
    return min(k, _cdiv(k // slices, 8) * 8), mc, nc


def _bandwidth(short: bool, bk: int) -> float:
    """Eigen's computeBandwidth without FMA: cycles a multiply-add."""
    return 4.0 if bk == 1 else 2.0 if short else 1.0


def depth_shard(m: int, n: int, k: int) -> int:
    """The depth block in which Eigen's thread pool splits an (m x k) by (k
    x n) product (column-major: m is the output's fastest dimension), or 0
    where it does not split the depth (see ``_THREADS``)."""
    # the threads over the outputs: shardByCol at 2 threads, the blocking,
    # contractionCost and TensorCostModel::numThreads
    by_col = not ((m // 2 >= _NR and (n // 2 < _NR or (
        n // 2 < 4 * _NR and n % (2 * _NR) != 0
        and (m % (2 * _NR) == 0 or m // n >= 6))))
        or (n // 2 < 16 * _NR and m > n * 32))
    bk, bm, bn = _blocking(k, m, n, by_col)
    per_out = (bk * _bandwidth(bm < _NR or bn < _MR, bk) / _PACKET
               + 4 * _BYTE_CYCLES
               + 4 * _BYTE_CYCLES * (bk / m if by_col else bk / n))
    threads = min(_THREADS, max(1, int((m * n * per_out - 1e5) / 1e5 + 0.9)))
    # the threads over the depth: numThreadsInnerDim
    per_k = (_bandwidth(n < _NR or m < _MR, k) * m * n / _PACKET
             + 4 * _BYTE_CYCLES + 4 * n * _BYTE_CYCLES)
    total = k * per_k
    reduce = m * n * (3 * _BYTE_CYCLES + 1 / _PACKET)
    by_k, best = 1, total
    for t in range(2, _THREADS + 1, 2):
        cost = total / t + 1e5 + t * (reduce + 3000)
        if cost < best:
            by_k, best = t, cost
    # shardByInnerDim (the L3 bound on the buffers never binds here)
    if n == 1 or by_k < 2 or by_k < threads or k // by_k < 2 * _NR:
        return 0
    if not (max(m, n) // threads < _NR or (k // by_k > 8 * _NR and (
            min(m, n) < 2 * _NR or by_k > threads))):
        return 0
    return min(k, max(12 * _PACKET, _cdiv(_cdiv(k, by_k), 8) * 8))


def eigen_order(depth: int, m: int, n: int) -> Tuple[str, int]:
    """The summation order of a product that XLA's CPU dot hands to Eigen's
    thread pool with a transposed operand (the resize's row product, and
    both products where the columns go first), of an (n, m) output: one
    multiply-add chain a depth block, the blocks added in order. The blocks
    are :func:`_row_slice`'s, or where Eigen splits the depth
    (:func:`depth_shard`) its blocks, each one chain (no split block is
    deeper than 320 at any frame of 48 to 2,200 rows and columns). An
    output's taps span two blocks at most, so the order in which Eigen adds
    the blocks' buffers does not move its bits."""
    return "chain", depth_shard(m, n, depth) or _row_slice(depth)


def gemm_order(depth: int, cols: int, rows_pass: bool,
               rows: int = 0) -> Tuple[str, int]:
    """(kind, block) of the summation order of a product of depth ``depth``
    into ``cols`` outputs (see ``_COLUMN_KERNELS``): a resize's row product
    (``rows_pass``; unsplit, see :func:`eigen_order`), or a column
    product, a resize's or the SIFT contraction's, of ``rows`` rows (0:
    more than 50). A column product of 50 rows or fewer is one chain; of
    more rows, see :func:`_column_kernel`."""
    if rows_pass:
        return "chain", _row_slice(depth)
    if 0 < rows <= _SHORT_ROWS:
        return "chain", depth
    kind = _column_kernel(cols)
    return kind, _BLOCK.get(kind, depth)


def _tap_groups(in_size: int, taps: np.ndarray, kind: str, block: int
                ) -> np.ndarray:
    """Group of each tap (ascending depths) of one output: the chain it is
    summed in. "chain": its block, counted from the output's first;
    "parity": 3 per block (even, odd, and an odd depth's last tap);
    "lanes": k mod 4, and 4 past the depth's last multiple of 4."""
    if kind == "lanes":
        return np.where(taps < in_size & ~3, taps % 4, 4)
    first = taps[0] // block
    if kind == "chain":
        return taps // block - first
    cls = np.where(taps < in_size & ~1, taps % 2, 2)     # blocks are even
    return 3 * (taps // block - first) + cls


@functools.lru_cache(maxsize=None)
def _tap_tables(in_size: int, out_size: int, order: Tuple[str, int],
                device: torch.device):
    """(G, out, T) input indices and f64 weights of each output's taps, one
    row a group of :func:`_tap_groups`, ascending depth within a group,
    zero weight where a group has fewer taps; and each group's most taps
    of any output, the steps its chain needs."""
    w = resize_weights(in_size, out_size)
    kind, block = order
    groups = []
    for o in range(out_size):
        taps = np.nonzero(w[:, o])[0]
        g = _tap_groups(in_size, taps, kind, block) if len(taps) else taps
        groups.append((taps, g))
    n_groups = max([5 if kind == "lanes" else 1]
                   + [int(g.max()) + 1 for t, g in groups if len(t)])
    if kind == "parity":
        n_groups = -(-n_groups // 3) * 3
    steps = tuple(max(int((g == j).sum()) for _, g in groups)
                  for j in range(n_groups))
    idx = np.zeros((n_groups, out_size, max((1,) + steps)), np.int64)
    wt = np.zeros(idx.shape, np.float64)
    for o, (taps, g) in enumerate(groups):
        for j in range(n_groups):
            sel = taps[g == j]
            idx[j, o, :len(sel)] = sel
            wt[j, o, :len(sel)] = w[sel, o]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device), steps)


def _chain(x: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor,
           acc: torch.Tensor, steps: int) -> torch.Tensor:
    """``acc = fma(w_t, x[idx_t], acc)`` over a table's first ``steps``
    taps in order, one rounding each (a zero weight leaves acc as it
    is)."""
    for t in range(steps):
        acc = fma_f32(x[idx[..., t]], wt[..., t, None], acc)
    return acc


def _products_sum(x: torch.Tensor, idx: torch.Tensor, wt: torch.Tensor,
                  steps: int) -> torch.Tensor:
    """``sum_t w_t x[idx_t]`` over a table's first ``steps`` taps, each
    product rounded, added in order (a kernel's tail past its unroll)."""
    acc = x[idx[..., 0]] * wt[..., 0, None].to(torch.float32)
    for t in range(1, steps):
        acc = acc + x[idx[..., t]] * wt[..., t, None].to(torch.float32)
    return acc


def _resize_rows(x: torch.Tensor, out_size: int,
                 order: Tuple[str, int]) -> torch.Tensor:
    """``W^T @ x`` for the (in, out) resize weights of x's first axis,
    summed in the reference's ``order`` (:func:`gemm_order`). A group's
    chain runs only as many steps as its outputs have taps, so a group
    that no output reaches (a kernel's tail when the depth is a multiple of
    its unroll) costs nothing."""
    idx, wt, steps = _tap_tables(x.shape[0], out_size, order, x.device)
    zero = torch.zeros((out_size, x.shape[1]), dtype=torch.float32,
                       device=x.device)
    kind = order[0]
    if kind == "lanes":
        lane = _chain(x, idx[:4], wt[:4], zero.expand(4, -1, -1),
                      max(steps[:4]))
        out = (lane[0] + lane[1]) + (lane[2] + lane[3])
        if steps[4]:
            out = out + _products_sum(x, idx[4], wt[4], steps[4])
        return out
    if kind == "chain":
        part = _chain(x, idx, wt, zero.expand(idx.shape[0], -1, -1),
                      max(steps))
        out = part[0]
        for p in part[1:]:
            out = out + p
        return out
    out = None
    for b in range(0, idx.shape[0], 3):
        even_odd = _chain(x, idx[b:b + 2], wt[b:b + 2],
                          zero.expand(2, -1, -1), max(steps[b:b + 2]))
        acc = even_odd[0] + even_odd[1]
        out = acc if out is None else out + acc
    for b in range(2, idx.shape[0], 3):
        if steps[b]:
            out = out + _products_sum(x, idx[b], wt[b], steps[b])
    return out


def resize_bilinear(image: torch.Tensor, out_hw: Tuple[int, int],
                    batch: int = 1) -> torch.Tensor:
    """Antialiased linear resize, the ``jax.image.resize(method="linear")``
    op the reference uses (not ``F.interpolate``, which does not low-pass
    when downsampling): rows first, then columns, or columns first where
    the output is narrower than tall (the path the reference's one
    ``jnp.einsum`` takes, the cheaper), each a banded product summed as
    the compiled reference sums it when it resizes ``batch`` such images in
    one vmapped program (XLA folds the batch into each product's free
    dimension; 1 for one image). XLA's CPU dot runs the column product
    that follows the rows as a plain product (:func:`gemm_order`'s
    kernels) and the others, which have a transposed operand, through
    Eigen's thread pool (:func:`eigen_order`, given each product's output:
    its columns, the fastest, then its rows)."""
    x = image.to(torch.float32)
    (h, w), (oh, ow) = x.shape, out_hw
    if oh != h and ow != w and ow < oh:
        # dot(W_w, x) into (ow, h), then dot(W_h, that) into (oh, ow)
        x = _resize_rows(x.T, ow, eigen_order(w, batch * h, ow)).T
        return _resize_rows(x, oh, eigen_order(h, batch * ow, oh))
    if oh != h:
        x = _resize_rows(x, oh, eigen_order(h, batch * w, oh))  # (oh, w)
    if ow != w:
        x = _resize_rows(x.T, ow, gemm_order(w, ow, False,
                                             rows=batch * oh)).T
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


def build_pyramid(gray: torch.Tensor, n_levels: int, scale_factor: float,
                  batch: int = 1) -> List[torch.Tensor]:
    """Image pyramid; each level resized from level 0, as the compiled
    reference resizes it in a vmapped batch of ``batch`` images
    (:func:`resize_bilinear`)."""
    h, w = gray.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [gray.to(torch.float32)]
    for hw in shapes[1:]:
        levels.append(resize_bilinear(gray, hw, batch))
    return levels
