"""The port's image pyramid against the compiled reference at every camera
size of the grid.

The grid: frames of 240x320 (Kinect v1 / Xtion QVGA), 480x640, 480x848 and
720x1280 (RealSense D4xx), 960x1280 and 1080x1920 (Kinect v2), each with
the 3-level pyramid at scale 1.2 that every ``conf/*.ork`` uses and
cv::ORB's default 8 levels. The reference's linear resize is
``jax.image.resize`` compiled by XLA for an x86-64 CPU with AVX-512; the
port copies its rounding (``tod_tpu_torch/ops/image.py``: the weights'
loop shapes and the products' summation orders). Contracts: weights and
levels bit for bit, ORB keypoints and descriptors in slot order exactly,
SIFT keypoints, angles and descriptors exactly. The feature checks run here
at the shapes that fit the file's time, and ``test_torch_sizes_720p.py`` holds
the trainer's step and the detector at 720x1280.

``TORCH_SIZES_FRAMES=HxW,...`` runs the weight and pyramid cases at those
frame sizes instead, and the ORB and SIFT cases at each of them with 3 and
8 levels (``tools/fit_resize_order.py --tests`` sets it).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.ops import image as jimage
from tod_tpu.ops import orb as jorb
from tod_tpu.ops import sift as jsift
from tod_tpu.utils import synthetic as jsyn
from tod_tpu_torch.ops import image as timage
from tod_tpu_torch.ops import orb as torb
from tod_tpu_torch.ops import sift as tsift
from tod_tpu_torch.utils import synthetic as tsyn
from tod_tpu_torch.utils.camera_sizes import GRID, SMALL, size_scene
from test_torch_sift import assert_same_descriptors

torch.set_num_threads(1)

LEVELS = (3, 8)
SCALE = 1.2
_ASKED = os.environ.get("TORCH_SIZES_FRAMES")
FRAMES = ([tuple(int(v) for v in f.split("x")) for f in _ASKED.split(",")]
          if _ASKED else list(GRID))
_EVERY = [(hw, n) for hw in FRAMES for n in LEVELS] if _ASKED else None
ORB_CASES = _EVERY or [((240, 320), 8), ((480, 848), 3)]
SIFT_CASES = _EVERY or [((240, 320), 3), ((240, 320), 8)]


def _axis_pairs():
    pairs = set()
    for h, w in FRAMES:
        for oh, ow in timage.pyramid_shapes(h, w, max(LEVELS), SCALE)[1:]:
            pairs.update({(h, oh), (w, ow)})
    return sorted(pairs)


_scene = functools.lru_cache(maxsize=None)(size_scene)


@functools.lru_cache(maxsize=None)
def rendered_gray(h: int, w: int) -> np.ndarray:
    """Bench objects 0 and 1 rendered at (h, w) by the reference's renderer
    (the port's renders the same pixels), as the reference's serving gray."""
    image, _ = _scene(jsyn, h, w)
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(image)))


@pytest.mark.parametrize("in_out", _axis_pairs())
def test_resize_weights_match_compiled_reference(in_out):
    """Read off ``jax.image.resize`` of an identity: each output row of the
    product is one weight column, summed with zeros, so exact."""
    n_in, n_out = in_out
    eye = jnp.eye(n_in, dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda x: jax.image.resize(
        x, (n_out, n_in), method="linear"))(eye)).T
    np.testing.assert_array_equal(timage.resize_weights(n_in, n_out), ref)


@pytest.mark.parametrize("n_levels", LEVELS)
@pytest.mark.parametrize("hw", FRAMES)
def test_pyramid_levels_match_compiled_reference(hw, n_levels):
    """Both renderers' frame, both grays, then every level bit for bit."""
    h, w = hw
    image_j, depth_j = _scene(jsyn, h, w)
    image_t, depth_t = _scene(tsyn, h, w)
    np.testing.assert_array_equal(image_t, image_j)
    np.testing.assert_array_equal(depth_t, depth_j)
    gray = rendered_gray(h, w)
    np.testing.assert_array_equal(
        timage.rgb_to_gray(torch.from_numpy(image_t)).numpy(), gray)
    ref = jax.jit(lambda g: jimage.build_pyramid(g, n_levels, SCALE))(
        jnp.asarray(gray))
    got = timage.build_pyramid(torch.from_numpy(gray.copy()), n_levels, SCALE)
    assert [tuple(a.shape) for a in got] == [a.shape for a in ref]
    for level, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      f"level {level}")


def test_gemm_orders():
    """The row product chains over equal depth slices (ceil(depth / 320)
    slices, rounded up to 8); the column product's kernel follows its
    output columns in 16-column steps (lanes, parity, lanes, chain)."""
    assert [timage._row_slice(d) for d in (120, 240, 360, 480, 1080)] \
        == [120, 240, 184, 240, 272]
    assert timage.gemm_order(1080, 900, True) == ("chain", 272)
    kinds = [timage.gemm_order(640, c, False) for c in (80, 81, 96, 97, 113,
                                                       128, 129)]
    assert kinds == [("lanes", 640), ("parity", 1024), ("parity", 1024),
                     ("lanes", 640), ("chain", 512), ("chain", 512),
                     ("lanes", 640)]
    # 50 rows or fewer: one chain; 24 columns or fewer: lanes (the SIFT
    # contraction's 8 K columns at K <= 3); the wide products' kernels
    assert timage.gemm_order(640, 97, False, rows=50) == ("chain", 640)
    widths = (8, 24, 32, 56, 7280, 7336, 10896, 10952, 43744, 43784, 43800)
    assert [timage.gemm_order(1369, c, False, rows=512)[0]
            for c in widths] == ["lanes", "lanes", "parity", "chain", "lanes",
                                 "chain", "lanes", "parity", "parity",
                                 "chain", "chain"]


def test_short_column_product_is_a_known_gap():
    """The column product of a level of 50 image rows or fewer runs another
    oneDNN kernel than wider levels': one fused multiply-add chain over the
    whole depth. At 120x160 with 8 levels, level 7 (34 x 45) sums in that
    chain where the rule for taller levels takes four lanes (635 of its
    1,530 pixels differed when the port took the lanes); every level is
    now the reference's bit for bit."""
    rng = np.random.default_rng(5)
    gray = (rng.random((120, 160)) * 255).astype(np.float32)
    ref = jax.jit(lambda g: jimage.build_pyramid(g, 8, SCALE))(
        jnp.asarray(gray))
    got = timage.build_pyramid(torch.from_numpy(gray), 8, SCALE)
    unequal = [int((a.numpy() != np.asarray(b)).sum())
               for a, b in zip(got, ref)]
    assert unequal == [0] * 8
    assert timage.gemm_order(160, 45, False, rows=34) == ("chain", 160)
    assert timage.gemm_order(160, 45, False, rows=51)[0] == "lanes"


@pytest.mark.parametrize("hw", [(120, 160), (60, 80), (176, 144),
                                (160, 120)])
def test_vmapped_pyramid_folds_the_batch(hw):
    """The reference vmapped over a batch of 3 images (as its trainer is
    over the views) folds the batch into each column product's rows, so a
    level of 50 rows or fewer whose 3 x rows are more sums as a taller
    level's; ``build_pyramid(batch=3)`` follows it at every level of the
    8 (at 120x160, taken one image at a time, level 7 differed in 635
    pixels; at 60x80, levels 1 and 3-7). The portrait frames (QCIF 176x144,
    QQVGA 160x120) fold it into the free dimension of both transposed
    products, which moves Eigen's split of their depth (ops/image.py
    eigen_order)."""
    rng = np.random.default_rng(5)
    grays = (rng.random((3,) + hw) * 255).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda g: jimage.build_pyramid(g, 8, SCALE)))(
        jnp.asarray(grays))
    for v in range(3):
        got = timage.build_pyramid(torch.from_numpy(grays[v]), 8, SCALE,
                                   batch=3)
        for level, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b[v]),
                                          f"image {v}, level {level}")


# Small frames whose 8-level pyramids have levels of 50 rows or fewer, and
# whose every level the port reproduces: a sample of the 11 of the 20 frame
# sizes of tools/fit_sift_order.py --short
SHORT_FRAMES = [(60, 80), (96, 128), (90, 160), (180, 240), (180, 320)]
# The other 9 of the survey (utils/camera_sizes.py SMALL), among them the
# QQVGA (160x120) and QCIF (176x144) sensor formats: their pyramids take
# Eigen's split of a product's depth or oneDNN's kernel tails (ops/image.py
# depth_shard, eigen_order, _tap_groups). SMALL_FRAME_GAPS holds what
# differs from the compiled reference (frame -> {level of the 8-level
# pyramid: pixels}): nothing.
SMALL_FRAME_GAPS = {}


def _small_frame_levels(hw, n_levels):
    """The port's and the compiled reference's levels of the survey's
    seeded frame of size ``hw``."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    gray = (rng.random(hw) * 255).astype(np.float32)
    ref = jax.jit(lambda g: jimage.build_pyramid(g, n_levels, SCALE))(
        jnp.asarray(gray))
    got = timage.build_pyramid(torch.from_numpy(gray), n_levels, SCALE)
    return [(a.numpy(), np.asarray(b)) for a, b in zip(got, ref)]


@pytest.mark.parametrize("hw", SHORT_FRAMES)
def test_short_levels_match_compiled_reference(hw):
    """Every level of the 3- and 8-level pyramids of a small frame, bit for
    bit, on a seeded random frame."""
    assert timage.pyramid_shapes(*hw, max(LEVELS), SCALE)[-1][0] <= 50
    for n_levels in LEVELS:
        for level, (a, b) in enumerate(_small_frame_levels(hw, n_levels)):
            np.testing.assert_array_equal(a, b, f"{hw} {n_levels} "
                                          f"level {level}")


@pytest.mark.parametrize("hw", sorted(SMALL))
def test_small_frame_pyramids_known_gaps(hw):
    """The surveyed small frames whose pyramids take the depth splits and
    the kernels' tails: exactly the levels of ``SMALL_FRAME_GAPS`` differ
    (none), each in its stated number of pixels, and every other level of
    the 8-level pyramid is bit for bit; the 3-level pyramid too."""
    unequal = {level: int((a != b).sum()) for level, (a, b)
               in enumerate(_small_frame_levels(hw, max(LEVELS)))}
    assert {k: v for k, v in unequal.items() if v} \
        == SMALL_FRAME_GAPS.get(hw, {})
    for level, (a, b) in enumerate(_small_frame_levels(hw, min(LEVELS))):
        np.testing.assert_array_equal(a, b, f"{hw} 3 levels, level {level}")


@pytest.mark.parametrize("hw", [(160, 120), (176, 144)])
def test_small_sizes_fixture_holds_the_port(hw):
    """tests/data/torch_small_sizes_fixture.npz (the reference's digests,
    tools/make_torch_small_sizes_fixture.py; chip_smoke.py phase 13c holds
    the card to it) against the port on the CPU: every small frame's
    levels alone and in a batch of three, and at QQVGA and QCIF the
    rendered frame and its ORB keypoints at 3 and 6 levels."""
    import json
    from pathlib import Path

    from tod_tpu_torch.utils.camera_sizes import digest, small_frame

    zx = np.load(Path(__file__).parent / "data"
                 / "torch_small_sizes_fixture.npz")
    frames = json.loads(str(zx["frames_json"]))
    assert sorted(frames) == sorted(f"{h}x{w}" for h, w in SMALL)
    want = frames[f"{hw[0]}x{hw[1]}"]
    for k, levels in enumerate([want["levels"]] + want["batch3"]):
        got = timage.build_pyramid(torch.from_numpy(small_frame(
            *hw, max(k - 1, 0))), 8, SCALE, batch=1 if k == 0 else 3)
        assert [digest(a.numpy()) for a in got] == levels, k
    scene = json.loads(str(zx["scenes_json"]))[f"{hw[0]}x{hw[1]}"]
    image, depth = _scene(tsyn, *hw)
    assert (digest(image), digest(depth)) == (scene["image"], scene["depth"])
    gray = timage.rgb_to_gray(torch.from_numpy(np.ascontiguousarray(image)))
    for n in (3, 6):
        kps, desc = torb.orb_detect_and_compute(
            gray, n_features=5000, n_levels=n, scale_factor=SCALE)
        got = {k: digest(getattr(kps, k).numpy(), k)
               for k in ("valid", "xy", "level")}
        got["desc"] = digest(desc.numpy(), "desc")
        got["n_valid"] = int(kps.valid.sum())
        assert got == scene[f"orb{n}"], n


@pytest.mark.parametrize("hw, n_levels", ORB_CASES)
def test_orb_matches_in_slot_order(hw, n_levels):
    gray = rendered_gray(*hw)
    k_j, d_j = jax.jit(lambda g: jorb.orb_detect_and_compute(
        g, n_features=5000, n_levels=n_levels, scale_factor=SCALE))(
        jnp.asarray(gray))
    k_t, d_t = torb.orb_detect_and_compute(
        torch.from_numpy(gray.copy()), n_features=5000, n_levels=n_levels,
        scale_factor=SCALE)
    assert int(k_t.valid.sum()) > 300
    for name in ("valid", "level", "xy", "angle"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("hw, n_levels", SIFT_CASES)
def test_sift_matches(hw, n_levels):
    gray = rendered_gray(*hw)
    k_j, d_j = jax.jit(lambda g: jsift.sift_detect_and_compute(
        g, n_features=2000, n_levels=n_levels, scale_factor=SCALE))(
        jnp.asarray(gray))
    k_t, d_t = tsift.sift_detect_and_compute(
        torch.from_numpy(gray.copy()), n_features=2000, n_levels=n_levels,
        scale_factor=SCALE)
    assert int(k_t.valid.sum()) > 300
    for name in ("valid", "level", "xy", "angle"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    assert_same_descriptors(d_t, d_j)
