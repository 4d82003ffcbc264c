"""Parity of the port's feature stage (tod_tpu_torch.ops) with tod_tpu.ops.

Both packages get the same 160x120 frame, made with numpy from a seed, on
the CPU. Integer and boolean outputs must be equal; float maps are held to
the tolerance stated at each assert, with its reason.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.ops import depth as jdepth
from tod_tpu.ops import fast as jfast
from tod_tpu.ops import image as jimage
from tod_tpu.ops import matching as jmatching
from tod_tpu.ops import orb as jorb
from tod_tpu_torch.ops import depth as tdepth
from tod_tpu_torch.ops import fast as tfast
from tod_tpu_torch.ops import image as timage
from tod_tpu_torch.ops import matching as tmatching
from tod_tpu_torch.ops import orb as torb

torch.set_num_threads(1)

H, W = 120, 160


def _frame(seed=3):
    """RGB u8 frame of random flat rectangles (many FAST corners) over a
    gradient, plus a u16 depth map with holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([40 + 0.5 * xx, 60 + 0.4 * yy, 90 + 0.2 * (xx + yy)], -1)
    for _ in range(70):
        y0, x0 = rng.integers(0, H - 4), rng.integers(0, W - 4)
        h, w = rng.integers(3, 18), rng.integers(3, 18)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, 3)
    img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    depth = rng.integers(600, 1400, (H, W)).astype(np.uint16)
    depth[rng.random((H, W)) < 0.05] = 0
    depth[:5, :5] = 65535
    return img, depth


def _t(x):
    return torch.from_numpy(np.array(x))


def _gray():
    img, _ = _frame()
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))


def test_gray_and_blur_match():
    img, _ = _frame()
    g_j = np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))
    g_t = timage.rgb_to_gray(_t(img)).numpy()
    # same three products and two sums in the same order: exact
    np.testing.assert_array_equal(g_t, g_j)
    b_j = np.asarray(jax.jit(lambda x: jimage.gaussian_blur(x, 7, 2.0))(
        jnp.asarray(g_j)))
    b_t = timage.gaussian_blur(_t(g_j), 7, 2.0).numpy()
    # 14 taps fused into multiply-adds as the compiled reference (every
    # program that blurs) fuses them: exact
    np.testing.assert_array_equal(b_t, b_j)


@pytest.mark.parametrize("out_hw", [(100, 133), (83, 111), (120, 80)])
def test_resize_is_antialiased_linear(out_hw):
    g = _gray()
    r_j = np.asarray(jimage.resize_bilinear(jnp.asarray(g), out_hw))
    r_t = timage.resize_bilinear(_t(g), out_hw).numpy()
    # weights equal up to an ulp and the contraction sums in another
    # order: a few f32 ulps of values in [0, 255] (2e-4 ~ 8 ulp at 255)
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=2e-4)
    # and the op is not plain bilinear: F.interpolate differs by far more
    plain = torch.nn.functional.interpolate(
        _t(g)[None, None], size=out_hw, mode="bilinear",
        align_corners=False)[0, 0].numpy()
    if out_hw[0] < H:
        assert np.abs(plain - r_j).max() > 1.0


# (in, out) axis sizes of the bench's 3-level 480x640 pyramid (scale 1.2)
PYRAMID_AXES = [(480, 400), (480, 333), (640, 533), (640, 444)]


@pytest.mark.parametrize("in_out", PYRAMID_AXES)
def test_resize_weights_against_compiled_reference(in_out):
    """The weights of the bench's 3-level 480x640 pyramid against the
    compiled reference's own, bit for bit, read off ``jax.image.resize`` of
    an identity (each output row of the product is one weight column); then
    the resized level of both fixture frames, bit for bit, against the
    compiled reference (the products sum in its GEMM order)."""
    n_in, n_out = in_out
    eye = jnp.eye(n_in, dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda x: jax.image.resize(
        x, (n_out, n_in), method="linear"))(eye)).T
    np.testing.assert_array_equal(timage.resize_weights(n_in, n_out), ref)
    if n_in != 480:
        return
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    hw = {400: (400, 533), 333: (333, 444)}[n_out]
    for image in fx["images"]:
        gray = jax.jit(jimage.rgb_to_gray)(jnp.asarray(image))
        lv_j = jax.jit(lambda g: jimage.resize_bilinear(g, hw))(gray)
        np.testing.assert_array_equal(
            timage.resize_bilinear(_t(gray), hw).numpy(), np.asarray(lv_j))


def test_pyramid_shapes_and_budget_match():
    assert timage.pyramid_shapes(480, 640, 3, 1.2) == \
        jimage.pyramid_shapes(480, 640, 3, 1.2)
    assert tfast.features_per_level(5000, 3, 1.2) == \
        jfast.features_per_level(5000, 3, 1.2)
    lv_j = jimage.build_pyramid(jnp.asarray(_gray()), 3, 1.2)
    lv_t = timage.build_pyramid(_t(_gray()), 3, 1.2)
    for a, b in zip(lv_j, lv_t):
        assert tuple(a.shape) == tuple(b.shape)
        # the weights and the products' summation order are the compiled
        # reference's (ops/image.py gemm_order): bit for bit
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_fast_harris_nms_match():
    g = _gray()
    s_j, c_j = jfast.fast_score(jnp.asarray(g), 20.0)
    s_t, c_t = tfast.fast_score(_t(g), 20.0)
    # differences of the same f32 pixels, then mins and maxes: exact
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.sum() > 50
    hr_j = np.asarray(jfast.harris_response(jnp.asarray(g)))
    hr_t = tfast.harris_response(_t(g)).numpy()
    # the 7x7 box sums may add in another order: relative f32 rounding of
    # det - k*tr^2, bounded at 1e-4 of the map's scale
    np.testing.assert_allclose(hr_t, hr_j, rtol=0,
                               atol=1e-4 * np.abs(hr_j).max())
    np.testing.assert_array_equal(tfast.nms3x3(s_t).numpy(),
                                  np.asarray(jfast.nms3x3(s_j)))


def test_select_topk_keypoints_is_stable_on_ties():
    g = _gray()
    s_j, c_j = jfast.fast_score(jnp.asarray(g), 20.0)
    hr_j = jfast.harris_response(jnp.asarray(g))
    # flatten Harris to a few levels so that ties are the common case
    hr_q = jnp.round(hr_j / (jnp.abs(hr_j).max() + 1e-30) * 4.0)
    for harris in (hr_j, hr_q):
        xy_j, r_j, v_j = jfast.select_topk_keypoints(s_j, harris, c_j, 60,
                                                     edge_threshold=8)
        xy_t, r_t, v_t = tfast.select_topk_keypoints(
            _t(s_j), _t(harris), _t(c_j), 60, edge_threshold=8)
        np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    # top_k's total order: +0.0 above -0.0, NaN above all, index order on
    # equal keys
    x = np.array([1.0, 3.0, -0.0, 3.0, 0.0, -np.inf, np.nan, -0.0, 0.0, 3.0],
                 np.float32)
    v_j, i_j = jax.lax.top_k(jnp.asarray(x), 10)
    v_t, i_t = tfast.stable_topk(_t(x), 10)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(np.signbit(v_t.numpy()),
                                  np.signbit(np.asarray(v_j)))


def test_orientation_matches():
    g = _gray()
    m10_j, m01_j = jorb.orientation_moments(jnp.asarray(g))
    m10_t, m01_t = torb.orientation_moments(_t(g))
    # differences of f32 integral images: XLA's cumsum adds in another
    # order than torch's, and its entries reach 160*255 (ulp 0.004); 30
    # terms weighted by |d| <= 15 bound the gap well under 1.0 (moments
    # reach ~1e6)
    for a, b in ((m10_j, m10_t), (m01_j, m01_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1.0)
    rng = np.random.default_rng(1)
    xy = np.stack([rng.integers(16, W - 16, 40),
                   rng.integers(16, H - 16, 40)], -1).astype(np.int32)
    a_j = np.asarray(jorb.keypoint_angles(jnp.asarray(g), jnp.asarray(xy)))
    a_t = torb.keypoint_angles(_t(g), _t(xy)).numpy()
    # a gap of <= 1.0 in each moment turns the angle by at most about
    # 2 / |m| radians (plus atan2's own f32 rounding)
    mag = np.hypot(np.asarray(m10_j)[xy[:, 1], xy[:, 0]],
                   np.asarray(m01_j)[xy[:, 1], xy[:, 0]])
    assert (np.abs(a_t - a_j) <= 2.0 / mag + 1e-6).all()


def test_extract_patches_and_brief_match():
    g = _gray()
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(g), 7, 2.0))
    rng = np.random.default_rng(2)
    n = 64
    # Starts below 0 are left out: the reference's vmapped dynamic_slice
    # sends a negative start to the far edge, the port clamps it to 0. No
    # valid keypoint meets either (EDGE_THRESHOLD 31 > PATCH_R 18). Starts
    # past the far edge clamp alike in both.
    xy = np.stack([rng.integers(torb.PATCH_R, W, n),
                   rng.integers(torb.PATCH_R, H, n)], -1).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # half-bin angles: the round-half-even bin rule must agree as well, as
    # the compiled reference applies it (a multiply by the step's
    # reciprocal, which sends 7.5 steps to bin 7 where a division sends it
    # to 8)
    angle[:8] = (np.arange(8) + 0.5) * np.float32(2 * np.pi / 32)
    p_j = np.asarray(jorb.extract_patches(jnp.asarray(blurred),
                                          jnp.asarray(xy)))
    p_t = torb.extract_patches(_t(blurred), _t(xy)).numpy()
    np.testing.assert_array_equal(p_t, p_j)
    d_j = np.asarray(jax.jit(jorb.brief_descriptors)(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle)))
    d_t = torb.brief_descriptors(_t(blurred), _t(xy), _t(angle)).numpy()
    # bf16-rounded intensities compared exactly: byte-identical
    np.testing.assert_array_equal(d_t, d_j)


def test_bit_helpers_match():
    rng = np.random.default_rng(4)
    d = rng.integers(0, 256, (17, 32), dtype=np.uint8)
    bits_j = np.asarray(jmatching.unpack_bits(jnp.asarray(d), jnp.float32))
    bits_t = tmatching.unpack_bits(_t(d)).numpy()
    np.testing.assert_array_equal(bits_t, bits_j)
    np.testing.assert_array_equal(
        tmatching.popcount_rows(_t(d)).numpy(),
        np.asarray(jmatching.popcount_rows(jnp.asarray(d))))
    np.testing.assert_array_equal(
        tmatching.pack_bits(_t(bits_j)).numpy(), d)


def test_depth_matches():
    _, depth = _frame()
    k = np.array([[140.0, 0, 80.5], [0, 141.0, 60.5], [0, 0, 1]], np.float32)
    # compiled, as the reference serves it: XLA turns the division by the
    # constant 1000 into a multiply by its f32 reciprocal, and so does the
    # port (eager JAX divides, and differs by an ulp)
    dm_j = np.asarray(jax.jit(jdepth.to_metric_depth)(jnp.asarray(depth)))
    dm_t = tdepth.to_metric_depth(_t(depth.astype(np.int32))).numpy()
    np.testing.assert_array_equal(dm_t, dm_j)
    f = dm_j.copy()
    f[0, 7] = -1.0
    np.testing.assert_array_equal(
        tdepth.to_metric_depth(_t(f)).numpy(),
        np.asarray(jdepth.to_metric_depth(jnp.asarray(f))))
    rng = np.random.default_rng(5)
    xy = np.stack([rng.integers(0, W, 200), rng.integers(0, H, 200)],
                  -1).astype(np.float32) * np.float32(1.2)
    p_j = np.asarray(jdepth.depth_to_3d_sparse(jnp.asarray(dm_j),
                                               jnp.asarray(k),
                                               jnp.asarray(xy)))
    p_t = tdepth.depth_to_3d_sparse(_t(dm_j), _t(k), _t(xy)).numpy()
    np.testing.assert_array_equal(p_t, p_j)
    assert np.isnan(p_t[:, 2]).any() and np.isfinite(p_t[:, 2]).any()


def test_orb_detect_and_compute_matches():
    g = _gray()
    kps_j, d_j = jorb.orb_detect_and_compute(jnp.asarray(g), n_features=300,
                                             n_levels=3, scale_factor=1.2)
    kps_t, d_t = torb.orb_detect_and_compute(_t(g), n_features=300,
                                             n_levels=3, scale_factor=1.2)
    assert int(kps_t.valid.sum()) > 40
    np.testing.assert_array_equal(kps_t.valid.numpy(), np.asarray(kps_j.valid))
    np.testing.assert_array_equal(kps_t.level.numpy(), np.asarray(kps_j.level))
    np.testing.assert_array_equal(kps_t.xy.numpy(), np.asarray(kps_j.xy))
    # responses carry the Harris rounding bound of test_fast_harris_nms_match
    r_j = np.asarray(kps_j.response)
    fin = np.isfinite(r_j)
    np.testing.assert_allclose(kps_t.response.numpy()[fin], r_j[fin], rtol=0,
                               atol=1e-4 * np.abs(r_j[fin]).max())
    # Byte-identical descriptors. A bf16 near-tie in a resized level could
    # flip a bit; none does on this frame, and any flip fails this test
    # (to be recorded in ROADMAP queue C, not absorbed).
    flips = np.unpackbits(d_t.numpy() ^ np.asarray(d_j)).sum()
    assert flips == 0, f"{flips} descriptor bits differ"
