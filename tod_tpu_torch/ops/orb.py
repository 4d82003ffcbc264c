"""ORB: pyramid -> FAST/Harris -> orientation -> steered BRIEF-256.

Port of tod_tpu/ops/orb.py with the reference's private descriptor format
(seeded Gaussian pattern, 32 angle bins, bf16-rounded blurred intensities).
The reference evaluates every angle bin's bit tests as one matrix product
against +1/-1 difference tables; a column holds +1 at p2 and -1 at p1, so
its product is exactly I(p2) - I(p1) and bit = I(p2) > I(p1). The port reads
the two intensities of the keypoint's own bin with a gather instead, which
gives the same bits without the (K, 1369) x (1369, 8192) product.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.fast import (fast_score, features_per_level,
                                    harris_response, select_topk_keypoints,
                                    subpixel_offsets)
from tod_tpu_torch.ops.image import (build_pyramid, fma_f32,
                                     gaussian_blur, resize_nearest)
from tod_tpu_torch.ops.libm import atan2f_torch
from tod_tpu_torch.ops.matching import pack_bits

HALF_PATCH = 15          # orientation patch radius (cv::ORB half_patch_size)
PATCH_RADIUS = 13        # rBRIEF sample coordinates live in [-13, 13]
EDGE_THRESHOLD = 31      # keypoint margin (cv::ORB edgeThreshold default)
N_BITS = 256
N_ANGLE_BINS = 32        # steered-BRIEF orientation quantization
PATCH_R = 18             # rotated pattern radius: 13*sqrt(2) ~ 18.4, clipped
PATCH_W = 2 * PATCH_R + 1


class Keypoints(NamedTuple):
    """A fixed-capacity batch of keypoints (padded; use ``valid``)."""

    xy: torch.Tensor        # (K,2) float32 — level-0 pixel coords
    response: torch.Tensor  # (K,) float32 — Harris response
    angle: torch.Tensor     # (K,) float32 — orientation, radians
    level: torch.Tensor     # (K,) int32 — pyramid level
    valid: torch.Tensor     # (K,) bool


# Copied from tod_tpu/ops/orb.py:59 (brief_pattern, its default Gaussian
# construction), numpy only.
@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 1234, n_bits: int = N_BITS) -> np.ndarray:
    """(n_bits, 2, 2) int32 point-pair test pattern: seeded i.i.d. Gaussian
    pairs, sigma = patch/5, clipped to +/-PATCH_RADIUS, degenerate pairs
    rejected deterministically."""
    rs = np.random.RandomState(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pairs = np.zeros((n_bits, 2, 2), np.int32)
    n_done = 0
    while n_done < n_bits:
        cand = np.clip(np.round(rs.normal(0.0, sigma, size=(4,))),
                       -PATCH_RADIUS, PATCH_RADIUS).astype(np.int32)
        p1, p2 = cand[:2], cand[2:]
        if (p1 == p2).all():
            continue
        pairs[n_done, 0] = p1
        pairs[n_done, 1] = p2
        n_done += 1
    return pairs


# Copied from tod_tpu/ops/orb.py:178 (_binned_diff_tables): the same rotated
# and clipped sample positions, kept as indices instead of +1/-1 columns.
@functools.lru_cache(maxsize=None)
def _binned_pattern_indices(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(n_bins, 256, 2) int64 patch-local flat indices of rotated (p1, p2)
    for each angle bin."""
    pattern = brief_pattern().astype(np.float64)          # (256, 2, 2)
    out = np.zeros((n_bins, N_BITS, 2), np.int64)
    for b in range(n_bins):
        theta = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(theta), np.sin(theta)
        rx = np.clip(np.round(pattern[..., 0] * ca - pattern[..., 1] * sa),
                     -PATCH_R, PATCH_R).astype(int)
        ry = np.clip(np.round(pattern[..., 0] * sa + pattern[..., 1] * ca),
                     -PATCH_R, PATCH_R).astype(int)
        out[b] = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)   # (256, 2)
    return out


@functools.lru_cache(maxsize=None)
def _circle_half_widths() -> np.ndarray:
    """Circle half-width per row offset (cv::ORB IC_Angle's u_max table)."""
    dys = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return np.round(np.sqrt(HALF_PATCH**2
                            - np.minimum(dys**2, HALF_PATCH**2))).astype(int)


def scan_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums along axis 0, added as the reference's
    compiled CPU ``cumsum`` adds them (XLA rewrites the full-length
    reduce-window into blocks of 16): each block of 16 summed in order,
    the blocks' totals prefix-summed the same way, then each block's
    exclusive offset added once."""
    n = x.shape[0]
    if n <= 16:
        rows = [x[0]]
        for i in range(1, n):
            rows.append(rows[-1] + x[i])
        return torch.stack(rows)
    m = -(-n // 16)
    blocks = torch.nn.functional.pad(
        x.reshape(n, -1), (0, 0, 0, m * 16 - n)).reshape(m, 16, -1)
    cols = [blocks[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + blocks[:, j])
    prefix = torch.stack(cols, 1)
    totals = scan_sum(prefix[:, 15])
    offsets = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (prefix + offsets[:, None]).reshape(m * 16, *x.shape[1:])[:n]


def _integral_images(img: torch.Tensor, pad: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The orientation's integral images by :func:`scan_sum`, zero-padded
    by ``pad`` on every side: ``v`` down the columns of the image with a
    zero first row ((H+1) x W before the padding), ``hc`` along its rows
    with a zero first column (H x (W+1))."""
    x = img.to(torch.float32)
    zpad = torch.nn.functional.pad
    v = zpad(scan_sum(zpad(x, (0, 0, 1, 0))), (pad, pad, pad, pad))
    hc = zpad(scan_sum(zpad(x, (1, 0, 0, 0)).T).T, (pad, pad, pad, pad))
    return v, hc


def orientation_moments(img: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (m10, m01) intensity-centroid moment maps of the 31x31 circular
    patch, from integral images (zero borders), rounded as the reference's
    compiled programs round them: the integral images by :func:`scan_sum`,
    and each moment's 30 weighted terms fused into ``fma(-15, t0, -14 t1)``,
    then ``fma(d, t, acc)`` term by term (the two moments side by side)."""
    widths = _circle_half_widths()
    h, w = img.shape
    pad = HALF_PATCH + 1
    v, hc = _integral_images(img, pad)

    def vslice(arr, dy, dx):
        return arr[pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    terms = []
    for d in range(-HALF_PATCH, HALF_PATCH + 1):
        hw = int(widths[d + HALF_PATCH])
        if d != 0:
            col_sum = vslice(v, hw + 1, d) - vslice(v, -hw, d)
            row_sum = vslice(hc, d, hw + 1) - vslice(hc, d, -hw)
            terms.append((float(d), torch.stack([col_sum, row_sum])))
    (d0, t0), (d1, t1) = terms[:2]
    acc = fma_f32(t0, d0, t1 * d1)
    for d, t in terms[2:]:
        acc = fma_f32(t, d, acc)
    return acc[0], acc[1]


def keypoint_moments_torch(img: torch.Tensor, xy: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`orientation_moments` at integer keypoint coords ``xy`` (K, 2)
    alone, bit for bit: the same integral images and zero padding, the 60
    differences a keypoint gathered, the same fused chain over (2, K). The
    plain version of kernel L1 (``csrc/orientation.cu``)."""
    widths = _circle_half_widths()
    pad = HALF_PATCH + 1
    v, hc = _integral_images(img, pad)
    d = np.array([d for d in range(-HALF_PATCH, HALF_PATCH + 1) if d])
    hw = widths[d + HALF_PATCH]
    d_t = torch.as_tensor(d, device=img.device)
    hw_t = torch.as_tensor(hw, device=img.device)
    x = xy[:, 0].long()[:, None] + pad                    # (K, 1)
    y = xy[:, 1].long()[:, None] + pad
    col_sum = v[y + hw_t + 1, x + d_t] - v[y - hw_t, x + d_t]   # (K, 30)
    row_sum = hc[y + d_t, x + hw_t + 1] - hc[y + d_t, x - hw_t]
    t = torch.stack([col_sum, row_sum])                   # (2, K, 30)
    acc = fma_f32(t[..., 0], float(d[0]), t[..., 1] * float(d[1]))
    for i in range(2, len(d)):
        acc = fma_f32(t[..., i], float(d[i]), acc)
    return acc[0], acc[1]


def orb_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Kernel L1 (``csrc/orientation.cu tod_orb_angles``) on a CUDA level
    image: the angles of :func:`keypoint_angles` at ``xy``, fused from the
    image of any strides (its integral images, then the moments at the
    keypoints and ``atan2f``: two kernels, one call, counted in
    ``orb_angles.launches``; a failed launch raises)."""
    if img.dim() != 2 or xy.dim() != 2 or xy.shape[-1] != 2:
        raise ValueError(f"orb_angles: image {tuple(img.shape)}, xy "
                         f"{tuple(xy.shape)}")
    if img.device.type != "cuda" or xy.device != img.device:
        raise ValueError(f"orb_angles: image on {img.device}, xy on "
                         f"{xy.device}; the kernel takes CUDA tensors")
    img = img.to(torch.float32)     # any strides: a level may be transposed
    xy = xy.to(torch.int32).contiguous()
    h, w = img.shape
    k = xy.shape[0]
    out = torch.empty(k, dtype=torch.float32, device=img.device)
    if k:
        v = torch.empty((h + 1, w), dtype=torch.float32, device=img.device)
        hc = torch.empty((h, w + 1), dtype=torch.float32, device=img.device)
        kernels.call("orientation", "tod_orb_angles",
                     [img.data_ptr(), xy.data_ptr(), v.data_ptr(),
                      hc.data_ptr(), out.data_ptr()],
                     [h, w, *img.stride(), k],
                     torch.cuda.current_stream(img.device).cuda_stream)
        orb_angles.launches += 1
    return out


orb_angles.launches = 0


def keypoint_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Orientation at integer keypoint coords: atan2(m01, m10), as the host
    libm's ``atan2f`` rounds it: kernel L1 (:func:`orb_angles`) on a CUDA
    tensor, :func:`keypoint_moments_torch` and ``atan2f_torch`` on a CPU
    tensor."""
    if img.device.type == "cpu":
        m10, m01 = keypoint_moments_torch(img, xy)
        return atan2f_torch(m01, m10)
    return orb_angles(img, xy)


# The bin rule's divisor 2 pi / 32 as the compiled reference applies it: XLA
# rewrites the division by a constant into a multiply by its float32
# reciprocal, 5.0929580 (which sends exact half-bin angles such as 7.5 and
# 14.5 steps to the lower bin, where a true division rounds them up).
_BIN_SCALE = float(np.float32(1.0) / np.float32(2.0 * np.pi / N_ANGLE_BINS))


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF bin of each angle: round(angle / (2 pi / 32)) mod 32,
    rounded half to even, as the compiled reference evaluates it (a
    multiply by the reciprocal, ``_BIN_SCALE``)."""
    return torch.remainder(torch.round(angle * _BIN_SCALE),
                           N_ANGLE_BINS).long()


def extract_patches(image: torch.Tensor, xy: torch.Tensor,
                    radius: int = PATCH_R) -> torch.Tensor:
    """(K, 2R+1, 2R+1) patches centred on integer ``xy``. Starts are clamped
    into the image as the reference's ``dynamic_slice`` clamps them (real
    keypoints sit EDGE_THRESHOLD from the border, where the clamp never
    binds)."""
    h, w = image.shape
    size = 2 * radius + 1
    offs = torch.arange(size, device=image.device)
    sy = (xy[:, 1].long() - radius).clamp(0, h - size)
    sx = (xy[:, 0].long() - radius).clamp(0, w - size)
    rows = sy[:, None] + offs                             # (K, size)
    cols = sx[:, None] + offs
    return image[rows[:, :, None], cols[:, None, :]]


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 for keypoints at integer level coords: bit i is
    bf16(I(p2_i)) > bf16(I(p1_i)) in the keypoint's angle bin, packed 8 per
    byte LSB-first. Returns (K, 32) uint8."""
    k_count = xy.shape[0]
    table = torch.from_numpy(_binned_pattern_indices()).to(blurred.device)
    local = table[angle_bins(angle)].reshape(k_count, -1)  # (K, 512)
    patches = extract_patches(blurred.to(torch.bfloat16), xy)
    vals = torch.gather(patches.reshape(k_count, -1), 1, local)
    vals = vals.reshape(k_count, N_BITS, 2)
    return pack_bits(vals[..., 1] > vals[..., 0])


def detect_and_describe(gray: torch.Tensor, describe: Callable,
                        n_features: int, n_levels: int, scale_factor: float,
                        fast_threshold: float, edge_threshold: int,
                        mask: Optional[torch.Tensor] = None,
                        subpixel: bool = False, batch: int = 1
                        ) -> Tuple[Keypoints, torch.Tensor]:
    """FAST/Harris keypoints over the pyramid with exactly ``n_features``
    padded slots, each level's descriptors from ``describe(level image, xy,
    angle)`` (zero on invalid slots). Keypoint coords are integer level
    coords scaled to level 0; ``subpixel`` adds each keypoint's
    :func:`subpixel_offsets` on its level's FAST score map before the
    scaling (orientation and descriptors still sample the integer pixel).
    A (H,W) ``mask`` (nonzero = allowed; training's object mask)
    restricts detection: each level tests it nearest-resized to the
    level's size as a float (tod_tpu/ops/orb.py:289-294). ``batch`` is
    the images the reference detects in one vmapped program (the trainer's
    view batch; 1 for one image), whose pyramid sums in that batch's order
    (:func:`build_pyramid`)."""
    levels = build_pyramid(gray, n_levels, scale_factor, batch)
    counts = features_per_level(n_features, n_levels, scale_factor)
    kxs: List[torch.Tensor] = []
    all_desc: List[torch.Tensor] = []
    all_resp, all_angle, all_level, all_valid = [], [], [], []
    for lvl, (img, k_lvl) in enumerate(zip(levels, counts)):
        if k_lvl == 0:
            continue
        score, is_corner = fast_score(img, fast_threshold)
        harris = harris_response(img)
        lvl_mask = mask
        if mask is not None and img.shape != mask.shape:
            lvl_mask = resize_nearest(mask.to(torch.float32), img.shape)
        xy, resp, valid = select_topk_keypoints(score, harris, is_corner,
                                                k_lvl, edge_threshold,
                                                lvl_mask)
        angle = keypoint_angles(img, xy)
        desc = describe(img, xy, angle)
        desc = torch.where(valid[:, None], desc,
                           torch.zeros((), dtype=desc.dtype,
                                       device=desc.device))
        xy_f = xy.to(torch.float32)
        if subpixel:
            xy_f = xy_f + subpixel_offsets(score, xy)
        kxs.append(xy_f * scale_factor**lvl)
        all_resp.append(resp)
        all_angle.append(angle)
        all_level.append(torch.full((k_lvl,), lvl, dtype=torch.int32,
                                    device=gray.device))
        all_valid.append(valid)
        all_desc.append(desc)
    kps = Keypoints(xy=torch.cat(kxs), response=torch.cat(all_resp),
                    angle=torch.cat(all_angle), level=torch.cat(all_level),
                    valid=torch.cat(all_valid))
    return kps, torch.cat(all_desc)


def orb_detect_and_compute(gray: torch.Tensor, n_features: int = 500,
                           n_levels: int = 3, scale_factor: float = 1.2,
                           fast_threshold: float = 20.0,
                           edge_threshold: int = EDGE_THRESHOLD,
                           mask: Optional[torch.Tensor] = None,
                           subpixel: bool = False, batch: int = 1
                           ) -> Tuple[Keypoints, torch.Tensor]:
    """ORB keypoints + 256-bit descriptors, (n_features, 32) uint8
    (:func:`detect_and_describe` with steered BRIEF on the level blurred at
    sigma 2), restricted to ``mask`` when one is given; ``subpixel``
    refines the reported coords and ``batch`` is the vmapped batch
    (:func:`detect_and_describe`)."""
    return detect_and_describe(
        gray, lambda img, xy, angle: brief_descriptors(
            gaussian_blur(img, 7, 2.0), xy, angle),
        n_features, n_levels, scale_factor, fast_threshold, edge_threshold,
        mask, subpixel, batch)
