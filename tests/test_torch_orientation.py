"""The keypoint orientation (``tod_tpu_torch/ops/orb.py keypoint_angles``)
on the CPU, bit for bit: its plain version ``keypoint_moments_torch`` (the
moments at the keypoints alone, the plain version of kernel L1,
``csrc/orientation.cu``) against the dense ``orientation_moments`` gathered
at the keypoints, at the ORB levels of a VGA frame, at 720p's level 0, at
sizes around multiples of 16 and at keypoints on the border; the angles
against ``jax.jit`` of the reference's ``keypoint_angles``; a step-by-step
model of the kernel's integral-image scan against ``scan_sum``; and
the kernel's constants against the package's."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.ops import orb as jorb
from tod_tpu_torch.ops import orb as torb

torch.set_num_threads(1)

CSRC = Path(torb.__file__).resolve().parent.parent / "csrc" / "orientation.cu"
# the ORB levels of a VGA frame at scale 1.2, 720p's level 0, and heights
# and widths about multiples of 16 (the integral images add a row or a
# column: 15 -> 16, 16 -> 17, 255 -> 256)
SIZES = [(480, 640), (400, 533), (333, 444), (720, 1280), (15, 17),
         (16, 31), (31, 255), (47, 256), (255, 32), (256, 47), (1, 1)]


def _level(h: int, w: int, seed: int) -> np.ndarray:
    """A float32 level image: smooth structure, texture and fractions."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 110 + 60 * np.sin(xx / 7.0) * np.cos(yy / 11.0) \
        + rng.normal(0, 12, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def _keypoints(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """(n, 2) int32 (x, y) anywhere in the image, the four corners and
    points on each border first."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], -1)
    edge = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0),
            (w // 2, 0), (w // 2, h - 1), (0, h // 2), (w - 1, h // 2),
            (min(15, w - 1), min(15, h - 1)), (min(16, w - 1), h - 1)]
    xy[:len(edge)] = edge[:n]
    return xy.astype(np.int32)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("h, w", SIZES)
def test_keypoint_moments_equal_the_dense_moments(h, w):
    img = torch.from_numpy(_level(h, w, h * 7 + w))
    xy = torch.from_numpy(_keypoints(h, w, 300, h + w))
    m10, m01 = torb.orientation_moments(img)
    got = torb.keypoint_moments_torch(img, xy)
    x, y = xy[:, 0].long(), xy[:, 1].long()
    assert _same_bits(got[0], m10[y, x]) and _same_bits(got[1], m01[y, x])


@pytest.mark.parametrize("h, w", [(480, 640), (400, 533), (333, 444),
                                  (120, 160)])
def test_keypoint_angles_equal_the_reference(h, w):
    """On the CPU, bit for bit against the compiled reference (its dense
    moments, cumsum and libm ``atan2f``), keypoints anywhere in the image,
    borders included."""
    img = _level(h, w, h)
    xy = _keypoints(h, w, 300, w)
    want = np.asarray(jax.jit(jorb.keypoint_angles)(jnp.asarray(img),
                                                    jnp.asarray(xy)))
    before = torb.orb_angles.launches
    got = torb.keypoint_angles(torch.from_numpy(img), torch.from_numpy(xy))
    assert torb.orb_angles.launches == before      # the CPU's plain path
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _kernel_scan(x: np.ndarray) -> np.ndarray:
    """``integral_kernel``'s scan of one line, step by step in float32:
    each block of 16 summed in order, each complete block's total carried
    up the levels (``carry_up``), the scanned value coming back the next
    block's offset, added once; a line of 16 or fewer summed in order with
    no offset."""
    f32 = np.float32
    n = len(x)
    top, m = 0, n
    while m > 16:
        m, top = -(-m // 16), top + 1
    p, off, c = [f32(0)] * 8, [f32(0)] * 8, [0] * 8
    out = np.zeros(n, np.float32)
    off0 = f32(0)
    for b in range(0, n, 16):
        p0 = f32(0)
        for k in range(16):
            xi = x[b + k] if b + k < n else f32(0)
            p0 = xi if k == 0 else f32(p0 + xi)
            if b + k < n:
                out[b + k] = p0 if top == 0 else f32(p0 + off0)
        if top > 0 and b + 16 <= n:
            carry = p0
            for level in range(1, 8):
                p[level] = carry if c[level] == 0 else f32(p[level] + carry)
                c[level] += 1
                s = p[level] if level == top else f32(p[level] + off[level])
                if level == 1:
                    off0 = s
                else:
                    off[level - 1] = s
                if level == top or c[level] < 16:
                    break
                c[level] = 0
                carry = p[level]
    return out


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 31, 32, 33, 255, 256, 257,
                               272, 273, 481, 641, 721, 1281, 4096, 4097,
                               4113])
def test_kernel_scan_equals_scan_sum(n):
    """The kernel's integral-image scan (in-block sums, then the block
    totals carried up the levels) equals ``scan_sum`` bit for bit at
    lengths about 16, 256 and 4,096 (one, two and three levels of block
    totals) and the pyramid's heights and widths plus one; the values span
    8 decades so that every rounding shows."""
    rng = np.random.default_rng(n)
    x = (rng.random(n) * 10.0 ** rng.uniform(-3, 5, n)).astype(np.float32)
    x[0] = 0.0                             # the zero first element
    want = torb.scan_sum(torch.from_numpy(x)[:, None])[:, 0].numpy()
    np.testing.assert_array_equal(_kernel_scan(x).view(np.int32),
                                  want.view(np.int32))


def test_kernel_constants_match_the_package():
    """``orientation.cu``'s circle table, scan block and patch radius are
    ``ops/orb.py``'s."""
    src = CSRC.read_text()
    table = re.search(r"kHalfWidth\[[^\]]*\] = \{([^}]*)\}", src).group(1)
    widths = [int(v) for v in table.replace("\n", " ").split(",")]
    assert widths == [int(v) for v in torb._circle_half_widths()]
    assert re.search(r"kScanBlock = (\d+);", src).group(1) == "16"
    assert int(re.search(r"kHalfPatch = (\d+);", src).group(1)) \
        == torb.HALF_PATCH


def test_orb_angles_takes_cuda_tensors_only():
    """The kernel's wrapper refuses a CPU tensor (the plain path takes it
    through ``keypoint_angles``) and a malformed ``xy``."""
    img = torch.from_numpy(_level(40, 50, 1))
    xy = torch.from_numpy(_keypoints(40, 50, 20, 2))
    with pytest.raises(ValueError):
        torb.orb_angles(img, xy)
    with pytest.raises(ValueError):
        torb.orb_angles(img, xy[:, :1])
    assert torb.keypoint_angles(img, xy[:0]).shape == (0,)
