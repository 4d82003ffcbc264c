"""The cv2 raster operations of tod_tpu_torch/utils/raster.py bit for bit
against cv2 on seeded inputs: both resize paths, the drawing primitives
(degenerate and off-image ones too), the perspective fit, the 3x3
inverse, both warps (quads that leave the image, ROI crops) and the 8-bit
Gaussian blur."""

import cv2
import numpy as np
import pytest

from tod_tpu_torch.utils import raster


@pytest.mark.parametrize("size", [160, 256, 384, 97])
def test_resize_linear_f32(size):
    """make_texture's upscales (6/12/24/48 cells) and a few others."""
    rng = np.random.default_rng(size)
    for cells in (6, 12, 24, 48, 2, 7):
        layer = rng.normal(size=(cells, cells)).astype(np.float32)
        got = raster.resize_linear(layer, (size, size))
        ref = cv2.resize(layer, (size, size), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, ref)
    wide = rng.normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        raster.resize_linear(wide, (size, 31)),
        cv2.resize(wide, (size, 31), interpolation=cv2.INTER_LINEAR))


def test_resize_linear_u8():
    """degrade_frame's occluder: a 160 x 160 texture to 60-139 pixels a
    side, and up- and down-scales of other shapes (an upscale's first and
    last rows keep their fraction, unlike its columns)."""
    rng = np.random.default_rng(1)
    for _ in range(60):
        img = rng.integers(0, 256, (160, 160), np.uint8)
        w, h = (int(v) for v in rng.integers(60, 140, 2))
        np.testing.assert_array_equal(
            raster.resize_linear(img, (w, h)),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))
    for shape, dsize in (((7, 13), (40, 21)), ((50, 33), (17, 90)),
                         ((2, 2), (5, 3)), ((160, 160), (320, 320)),
                         ((30, 30), (12, 40))):
        img = rng.integers(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(
            raster.resize_linear(img, dsize),
            cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR))


def _shapes(rng, size):
    """make_texture's draw calls, at and past the image's edges."""
    for _ in range(60):
        shade = int(rng.integers(0, 256))
        x, y = (int(v) for v in rng.integers(-20, size + 20, 2))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            w, h = (int(v) for v in rng.integers(0, 40, 2))
            yield ("rectangle", (x, y), (x + w, y + h), shade, -1)
        elif kind == 1:
            yield ("circle", (x, y), int(rng.integers(0, 20)), shade, -1)
        elif kind == 2:
            x2, y2 = (int(v) for v in rng.integers(-20, size + 20, 2))
            yield ("line", (x, y), (x2, y2), shade, int(rng.integers(2, 5)))
        else:
            pts = np.stack([rng.integers(x - 30, x + 30, 3),
                            rng.integers(y - 30, y + 30, 3)], -1)
            if rng.random() < 0.3:          # degenerate: repeated vertices
                pts[int(rng.integers(0, 3))] = pts[int(rng.integers(0, 3))]
            if rng.random() < 0.2:          # degenerate: collinear
                pts[2] = 2 * pts[1] - pts[0]
            # vertices on the image (fill_poly raises for others)
            yield ("fill_poly", np.clip(pts, 0, size - 1).astype(np.int32),
                   shade)


@pytest.mark.parametrize("seed", range(4))
def test_drawing_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    size = 128
    got = rng.integers(0, 256, (size, size), np.uint8)
    ref = got.copy()
    for call in _shapes(rng, size):
        name, args = call[0], call[1:]
        if name == "fill_poly":
            cv2.fillPoly(ref, [args[0]], args[1])
            raster.fill_poly(got, args[0], args[1])
        else:
            getattr(cv2, name)(ref, *args)
            getattr(raster, name)(got, *args)
        np.testing.assert_array_equal(got, ref, err_msg=str(call))


def test_fill_poly_small_triangles():
    """Many small triangles inside the image, as make_texture draws them
    (vertices within 30 pixels), including flat and repeated ones."""
    rng = np.random.default_rng(9)
    for t in range(1500):
        size = 96
        x, y = rng.integers(10, size - 10, 2)
        pts = np.stack([rng.integers(max(x - 30, 0), min(x + 30, size), 3),
                        rng.integers(max(y - 30, 0), min(y + 30, size), 3)],
                       -1).astype(np.int32)
        if t % 5 == 0:
            pts[1] = pts[0]
        if t % 7 == 0:
            pts[2, 1] = pts[0, 1]
        a = np.zeros((size, size), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts], 200)
        raster.fill_poly(b, pts, 200)
        np.testing.assert_array_equal(b, a, err_msg=str(pts.tolist()))
    with pytest.raises(ValueError, match="on the image"):
        raster.fill_poly(np.zeros((8, 8), np.uint8), [[1, 1], [9, 2], [3, 5]],
                         1)


def _quad(rng, ts, spread):
    src = np.array([[0, 0], [ts - 1, 0], [ts - 1, ts - 1], [0, ts - 1]],
                   np.float32)
    centre = np.array([[rng.uniform(-60, 700), rng.uniform(-60, 540)]])
    dst = (centre + rng.uniform(-spread, spread, (4, 2))).astype(np.float32)
    return src, dst


def test_perspective_fit_and_invert():
    rng = np.random.default_rng(2)
    for _ in range(300):
        src, dst = _quad(rng, int(rng.choice([160, 256, 384])), 300)
        H = raster.get_perspective_transform(src, dst)
        np.testing.assert_array_equal(H, cv2.getPerspectiveTransform(src,
                                                                     dst))
        np.testing.assert_array_equal(raster.invert(H), cv2.invert(H)[1])
    for _ in range(300):
        M = rng.normal(size=(3, 3)) * rng.choice([1e-3, 1.0, 100.0], (3, 3))
        np.testing.assert_array_equal(raster.invert(M), cv2.invert(M)[1])
    np.testing.assert_array_equal(raster.invert(np.ones((3, 3))),
                                  cv2.invert(np.ones((3, 3)))[1])
    flat = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="singular"):
        raster.get_perspective_transform(flat, flat)


@pytest.mark.parametrize("seed", range(3))
def test_warp_perspective_matches_cv2(seed):
    """Both interpolations over 480 x 640, quads inside, across and off
    the image; a ROI of the warp equals the same pixels of the whole."""
    rng = np.random.default_rng(seed)
    for i in range(12):
        ts = int(rng.choice([160, 256, 384]))
        src, dst = _quad(rng, ts, 350 if i % 3 else 120)
        H = cv2.getPerspectiveTransform(src, dst)
        tex = rng.integers(0, 256, (ts, ts), np.uint8)
        for flags, nearest in ((cv2.INTER_LINEAR, False),
                               (cv2.INTER_NEAREST, True)):
            ref = cv2.warpPerspective(tex, H, (640, 480), flags=flags)
            got = raster.warp_perspective(tex, H, (640, 480), nearest)
            np.testing.assert_array_equal(got, ref)
            roi = (slice(37, 301), slice(250, 611))
            np.testing.assert_array_equal(
                raster.warp_perspective(tex, H, (640, 480), nearest, roi),
                ref[roi])


def test_gaussian_blur_u8_matches_cv2():
    """compose_scene's background (90-110 noise, 5 x 5, sigma 3) and
    other sizes, sigmas and images."""
    rng = np.random.default_rng(99)
    img = rng.integers(90, 110, (480, 640), np.uint8)
    np.testing.assert_array_equal(raster.gaussian_blur_u8(img, 5, 3.0),
                                  cv2.GaussianBlur(img, (5, 5), 3.0))
    assert raster.gaussian_kernel_u8(5, 3.0) == (46, 54, 56, 54, 46)
    for ksize, sigma in ((3, 0.8), (5, 1.1), (7, 2.0), (9, 5.0)):
        h, w = (int(v) for v in rng.integers(ksize, 90, 2))
        img = rng.integers(0, 256, (h, w), np.uint8)
        np.testing.assert_array_equal(
            raster.gaussian_blur_u8(img, ksize, sigma),
            cv2.GaussianBlur(img, (ksize, ksize), sigma))
