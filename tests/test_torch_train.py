"""Training (ROADMAP A9): tod_tpu_torch against tod_tpu on the CPU.

Each module of the slice on the same seeded inputs in both packages, or the
port against the reference's stored outputs in
tests/data/torch_train_fixture.npz (tools/make_torch_train_fixture.py: the
bench's objects 0-2, 60 views each, trained by the reference's batched
program). Contracts: integer outputs, masks and kept rows bit for bit;
float points bit for bit (camera_to_world from K = 40 rows on, the shapes
the trainer meets); SIFT descriptors and their quantised rows bit for bit
(test_torch_sift.py). The reference's training runs compiled
(``jax.jit``), so the reference side here is compiled too.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.cells.trainer import _jitted_train_views
from tod_tpu.geometry import transforms as jtf
from tod_tpu.ops import compress as jcompress
from tod_tpu.ops import depth as jdepth
from tod_tpu.ops import image as jimage
from tod_tpu.ops import morphology as jmorph
from tod_tpu.ops import orb as jorb
from tod_tpu.ops import sift as jsift
from tod_tpu_torch.cells import trainer as ttrainer
from tod_tpu_torch.geometry import transforms as ttf
from tod_tpu_torch.ops import compress as tcompress
from tod_tpu_torch.ops import depth as tdepth
from tod_tpu_torch.ops import image as timage
from tod_tpu_torch.ops import morphology as tmorph
from tod_tpu_torch.ops import orb as torb
from tod_tpu_torch.ops import sift as tsift
from tod_tpu_torch.parallel import train as ttrain
from tod_tpu_torch.types import fixture_observations
from tod_tpu_torch.utils.smoke_catalog import dedup_case_arrays
from test_torch_features import _frame
from test_torch_sift import assert_same_descriptors
from torch_parity import native_library

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_train_fixture.npz")
N_FEATURES = 600
VIEWS = 6


@pytest.fixture(scope="session", autouse=True)
def _native_library():
    """The reference's dedup reaches tod_tpu.native: build it safely."""
    native_library()


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _bits(packed, n):
    return np.unpackbits(packed, axis=-1, count=n,
                         bitorder="little").astype(bool)


# ---- numerics ---------------------------------------------------------------

@pytest.mark.parametrize("in_hw, out_hw", [
    ((480, 640), (400, 533)), ((480, 640), (333, 444)),
    ((240, 320), (480, 640)), ((120, 160), (100, 133)),
    ((120, 160), (83, 111)), ((37, 100), (100, 37))])
def test_resize_nearest_matches_compiled_reference(in_hw, out_hw):
    """The source index of every output pixel: XLA folds ``* m / n`` into
    one constant (480 -> 400 reads row 2 at output 2, not 3)."""
    h, w = in_hw
    idx = np.arange(h * w, dtype=np.int32).reshape(h, w)
    want = np.asarray(jax.jit(lambda x: jimage.resize_nearest(x, out_hw))(
        jnp.asarray(idx)))
    got = timage.resize_nearest(torch.from_numpy(idx), out_hw).numpy()
    np.testing.assert_array_equal(got, want)
    # as the trainer uses it: a float mask per pyramid level
    mask = (np.random.default_rng(h).random((h, w)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        timage.resize_nearest(torch.from_numpy(mask), out_hw).numpy(),
        np.asarray(jax.jit(lambda x: jimage.resize_nearest(x, out_hw))(
            jnp.asarray(mask))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rgb_to_gray_fused_matches_compiled_reference(seed):
    """The trainer converts inside its compiled program, where XLA fuses
    the weighted sum; serving converts eagerly (rgb_to_gray)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    img[0] = img[0, ..., :1]                       # gray renders
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: jimage.rgb_to_gray(x.astype(jnp.float32))))(img))
    got = torch.stack([timage.rgb_to_gray_fused(torch.from_numpy(i))
                       for i in img]).numpy()
    np.testing.assert_array_equal(got, want)
    eager = np.asarray(jimage.rgb_to_gray(jnp.asarray(img[1], jnp.float32)))
    np.testing.assert_array_equal(
        timage.rgb_to_gray(torch.from_numpy(img[1])).numpy(), eager)
    assert (got != np.stack([timage.rgb_to_gray(torch.from_numpy(i)).numpy()
                             for i in img])).any()


@pytest.mark.parametrize("seed, iterations", [(0, 1), (1, 4), (2, 4),
                                              (3, 2)])
def test_erode_matches(seed, iterations):
    """Random blobs touching the border: outside pixels never erode."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((40, 56)) < 0.8).astype(np.uint8) * 255
    mask[:, :12] = 255
    mask[25:, 30:] = 0
    want = np.asarray(jax.jit(lambda m: jmorph.erode(m, iterations))(
        jnp.asarray(mask)))
    got = tmorph.erode(torch.from_numpy(mask), iterations)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[:, 0].any() and not got.numpy().all()


def _diagonal_keypoints(level: int, edge: int) -> np.ndarray:
    """Pyramid coords (integer level coords x 1.2^level in float32, as
    ORB reports them) in [256, 440) whose rounded pixel lies just outside
    the eroded half-plane ``x + y <= edge``: (-1, 0) and (0, -1) of the snap
    window are in the mask at distances that tie but for the rounding of
    the sum (at 1.2, 28 of 111 snap otherwise without the reference's fused
    multiply-add)."""
    s = np.float32(1.2) ** level
    grid = np.arange(0, 400, dtype=np.float32) * s
    x, y = np.meshgrid(grid, grid)
    xy = np.stack([x.ravel(), y.ravel()], -1)
    inside = (xy >= 256).all(-1) & (xy < 440).all(-1)
    return xy[inside & (np.round(xy).sum(-1) == edge + 1)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_validate_keypoints_matches(seed):
    """Keypoints inside, beside and far from a mask whose edges run
    through their windows, on half-pixel coordinates (round half to even,
    equal distances in the snap window: the first in x-major order wins),
    on pyramid coordinates just outside a diagonal edge (distances that
    tie but for the rounding of the reference's fused sum), at the image
    border (clipping) and on NaN depth."""
    rng = np.random.default_rng(seed)
    h = w = 440
    k = 1000
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (xx + yy < 688)                # eroded 4 times: x + y <= 679
    mask &= ((yy - 150) ** 2 / 1600 + (xx - 150) ** 2 / 3600) > 1
    mask = mask.astype(np.uint8) * 255
    mask[rng.integers(200, 300), rng.integers(200, 300)] = 0    # a hole
    depth = rng.uniform(0.5, 1.5, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = np.nan
    xy = np.stack([rng.uniform(-3, w + 2, k), rng.uniform(-3, h + 2, k)], -1)
    xy[: k // 2] = np.round(xy[: k // 2] * 2) / 2          # half pixels
    xy = np.concatenate([xy.astype(np.float32),
                         _diagonal_keypoints(1, 679),
                         _diagonal_keypoints(2, 679)])
    kp_valid = rng.random(len(xy)) < 0.9
    want = jax.jit(jmorph.validate_keypoints)(
        jnp.asarray(xy), jnp.asarray(kp_valid), jnp.asarray(mask),
        jnp.asarray(depth))
    got = tmorph.validate_keypoints(
        torch.from_numpy(xy), torch.from_numpy(kp_valid),
        torch.from_numpy(mask), torch.from_numpy(depth))
    for name in ("xy", "z", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.xy.dtype == torch.int32
    valid = got.valid.numpy()
    assert 100 < valid.sum() < len(xy) - 100


@pytest.mark.parametrize("depth_hw, image_hw", [
    ((48, 64), (48, 64)), ((24, 32), (48, 64)), ((20, 32), (48, 64)),
    ((240, 320), (480, 640))])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_rescale_depth_matches(depth_hw, image_hw, dtype):
    """Same size: the metric conversion alone; another size: the NaN
    canvas with the nearest-resized depth in its top rows."""
    rng = np.random.default_rng(depth_hw[0])
    d = rng.integers(0, 3000, depth_hw).astype(np.float64)
    d[rng.random(depth_hw) < 0.05] = 0
    d[0, :3] = 65535
    d = d.astype(dtype) if dtype == np.uint16 else (d / 1000).astype(dtype)
    want = np.asarray(jax.jit(lambda x: jdepth.rescale_depth(x, image_hw))(
        jnp.asarray(d)))
    got = tdepth.rescale_depth(torch.from_numpy(d), image_hw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tdepth.is_valid_depth(torch.from_numpy(got)).numpy(),
        np.asarray(jdepth.is_valid_depth(jnp.asarray(want))))


def test_depth_to_3d_matches():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.4, 2.0, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.1] = np.nan
    K = np.array([[525.0, 0, 31.5], [0, 520.0, 23.5], [0, 0, 1]], np.float32)
    want = np.asarray(jax.jit(jdepth.depth_to_3d)(jnp.asarray(depth),
                                                  jnp.asarray(K)))
    got = tdepth.depth_to_3d(torch.from_numpy(depth), torch.from_numpy(K))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_points", list(range(1, 65)) + [600, 1000, 1003])
def test_camera_to_world_matches_compiled_reference(n_points):
    """Bit for bit against the compiled dot at every row count, one view
    alone and a vmapped batch of views (the trainer's form), which XLA
    orders otherwise at 36-39 rows."""
    rng = np.random.default_rng(n_points)
    V = 3
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(V)]).astype(np.float32)
    T = rng.normal(size=(V, 3)).astype(np.float32)
    P = (rng.normal(size=(V, n_points, 3)) * 0.3
         + (0, 0, 0.8)).astype(np.float32)
    batched = np.asarray(jax.jit(jax.vmap(jtf.camera_to_world))(R, T, P))
    single = jax.jit(jtf.camera_to_world)
    for v in range(V):
        args = [torch.from_numpy(a[v]) for a in (R, T, P)]
        np.testing.assert_array_equal(
            ttf.camera_to_world(*args, views=V).numpy(), batched[v])
        np.testing.assert_array_equal(
            ttf.camera_to_world(*args).numpy(),
            np.asarray(single(R[v], T[v], P[v])))


@pytest.mark.parametrize("shape", [(480, 640), (400, 533), (333, 444),
                                   (37, 41)])
@pytest.mark.parametrize("sigma", [2.0, 1.6])
def test_gaussian_blur_matches_compiled_reference(shape, sigma):
    """The blur ORB (sigma 2) and SIFT (1.6) describe on, as the
    reference's compiled programs round it, one level alone and batched."""
    img = (np.random.default_rng(shape[0]).random(shape) * 255).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: jimage.gaussian_blur(x, 7, sigma)))(img[None]))[0]
    np.testing.assert_array_equal(want, np.asarray(jax.jit(
        lambda x: jimage.gaussian_blur(x, 7, sigma))(img)))
    got = timage.gaussian_blur(torch.from_numpy(img), 7, sigma)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fma_f32_rounds_once():
    """Against the product and sum in extended precision, where the
    inputs' exact result needs more than double's 53 bits."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=20000).astype(np.float32)
    b = rng.normal(size=20000).astype(np.float32)
    c = (rng.normal(size=20000) * 10.0 ** rng.integers(-12, 4, 20000)
         ).astype(np.float32)
    want = (a.astype(np.longdouble) * b.astype(np.longdouble)
            + c.astype(np.longdouble)).astype(np.float32)
    got = timage.fma_f32(*(torch.from_numpy(x) for x in (a, b, c)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- features on the masked views -----------------------------------------

@pytest.mark.parametrize("obj, view", [(0, 0), (1, 36)])
def test_masked_orb_matches_on_fixture_views(fx, obj, view):
    """ORB at the trainer's operating point on a 480x640 view and its
    object mask: each level tests the mask nearest-resized as a float.
    Object 1's view 36 holds two descriptors that the eager blur's rounding
    flips by a bit (the blur of eager rounding)."""
    obs = fixture_observations(fx, obj)[view]
    gray = obs.image[..., 0].astype(np.float32)
    kw = dict(n_features=N_FEATURES, n_levels=3, scale_factor=1.2,
              fast_threshold=20.0)
    k_j, d_j = jax.jit(lambda g, m: jorb.orb_detect_and_compute(
        g, mask=m, **kw))(jnp.asarray(gray), jnp.asarray(obs.mask))
    k_t, d_t = torb.orb_detect_and_compute(
        torch.from_numpy(gray), mask=torch.from_numpy(obs.mask), **kw)
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    # every keypoint on the object
    xy = k_t.xy.numpy()[k_t.valid.numpy()].round().astype(int)
    assert (obs.mask[xy[:, 1], xy[:, 0]] > 0).mean() > 0.95
    # sub-pixel coords on the masked view (test_torch_subpixel.py): the
    # compiled reference's, the descriptors unchanged
    k_j, _ = jax.jit(lambda g, m: jorb.orb_detect_and_compute(
        g, mask=m, subpixel=True, **kw))(jnp.asarray(gray),
                                         jnp.asarray(obs.mask))
    k_s, d_s = torb.orb_detect_and_compute(
        torch.from_numpy(gray), mask=torch.from_numpy(obs.mask),
        subpixel=True, **kw)
    np.testing.assert_array_equal(k_s.xy.numpy(), np.asarray(k_j.xy))
    assert torch.equal(d_s, d_t)


def test_masked_sift_matches():
    """SIFT with a mask on the small seeded frame: keypoints, descriptors
    and their quantised rows bit for bit."""
    img, _ = _frame()
    gray = np.array(jimage.rgb_to_gray(jnp.asarray(img)))
    mask = np.zeros(gray.shape, np.uint8)
    mask[20:100, 30:125] = 255
    kw = dict(n_features=300, edge_threshold=20)
    k_j, d_j = jax.jit(lambda g, m: jsift.sift_detect_and_compute(
        g, mask=m, **kw))(jnp.asarray(gray), jnp.asarray(mask))
    k_t, d_t = tsift.sift_detect_and_compute(
        torch.from_numpy(gray), mask=torch.from_numpy(mask), **kw)
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    assert_same_descriptors(d_t, d_j)
    unmasked, _ = tsift.sift_detect_and_compute(torch.from_numpy(gray), **kw)
    assert 50 < int(k_t.valid.sum()) < int(unmasked.valid.sum())


# ---- the training step ------------------------------------------------------

def _batch(observations):
    """train_views_step's inputs, as cells/trainer.py train_views makes
    them (the fused gray, the rescaled depth)."""
    images = torch.from_numpy(np.stack([o.image for o in observations]))
    grays = torch.stack([timage.rgb_to_gray_fused(i) for i in images])
    depths = torch.stack([tdepth.rescale_depth(torch.from_numpy(o.depth),
                                               tuple(images.shape[1:3]))
                          for o in observations])
    masks = torch.from_numpy(np.stack([o.mask for o in observations]))
    cams = [torch.from_numpy(np.stack([getattr(o, n) for o in observations]))
            for n in "KRT"]
    return grays, masks, depths, *cams


def test_train_views_step_matches_stored_reference(fx):
    """Object 0's first views: descriptors, world points (also of the rows
    that fail validation) and valid masks equal the reference's batched
    program's, stored in the fixture."""
    obs = fixture_observations(fx, 0)[:VIEWS]
    desc, world, valid = ttrain.train_views_step(
        *_batch(obs), n_features=N_FEATURES)
    want_valid = _bits(fx["views0_valid"], N_FEATURES)[:VIEWS]
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(desc.numpy(), fx["views0_desc"][:VIEWS])
    np.testing.assert_array_equal(world.numpy(), fx["views0_world"][:VIEWS])
    assert desc.dtype == torch.uint8 and want_valid.sum() > VIEWS * 300
    # sub-pixel model points (test_torch_subpixel.py): the same
    # descriptors; the mask snap starts from the fractional coords, and the
    # points leave the integer pixels
    d_s, w_s, v_s = ttrain.train_views_step(*_batch(obs[:1]),
                                            n_features=N_FEATURES,
                                            subpixel=True)
    both = v_s & valid[:1]
    assert torch.equal(d_s, desc[:1]) and both.sum() > 300
    assert not torch.equal(w_s[both], world[:1][both])


@pytest.mark.parametrize("feature_type", ["ORB", "SIFT"])
def test_small_view_batch_matches_compiled_reference(fx, feature_type):
    """Three of object 0's views taken every 3rd pixel (160x214), trained
    at 8 levels, where level 7 (45 x 60) has 50 rows or fewer but the
    batch's 3 x rows do not: descriptors, world points and valid masks
    equal ``jax.jit`` of the reference's vmapped step bit for bit (its
    column products fold the batch into their rows, as
    ``train_views_step`` passes it; such a level is narrower than twice
    the 31-pixel keypoint margin, so it yields no keypoint either way)."""
    from tod_tpu.parallel.train import train_views_step as ref_step

    grays, masks, depths, Ks, Rs, Ts = _batch(
        fixture_observations(fx, 0)[:3])
    grays, masks, depths = (a[:, ::3, ::3].contiguous()
                            for a in (grays, masks, depths))
    Ks = Ks.clone()
    Ks[:, :2] /= 3
    kw = dict(n_features=200, n_levels=8, feature_type=feature_type)
    inputs = (grays, masks, depths, Ks, Rs, Ts)
    want = jax.jit(lambda *a: ref_step(*a, **kw))(
        *(jnp.asarray(t.numpy()) for t in inputs))
    got = ttrain.train_views_step(*inputs, **kw)
    for g, w, name in zip(got, want, ("descriptors", "world", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[2].sum()) > 100


def test_sift_training_view_matches_stored_reference(fx):
    """Object 0's first SIFT view, trained by the reference's program over
    its batch of 12 views (stored in the fixture): the view's valid mask,
    and its masked SIFT descriptors described in that batch's summation
    order, bit for bit, and so their quantised rows."""
    view = int(fx["sift_views"][0])
    obs = fixture_observations(fx, 0)[view:view + 1]
    grays, masks = _batch(obs)[:2]
    _, _, valid = ttrain.train_views_step(
        *_batch(obs), n_features=N_FEATURES, feature_type="SIFT")
    want_valid = _bits(fx["sift0_valid"], N_FEATURES)[0]
    np.testing.assert_array_equal(valid.numpy()[0], want_valid)
    rows = int(want_valid.sum())
    assert rows > 300
    _, desc = tsift.sift_detect_and_compute(
        grays[0], n_features=N_FEATURES, mask=masks[0],
        batch=len(fx["sift_views"]))
    assert_same_descriptors(desc[torch.from_numpy(want_valid)],
                            fx["sift0_desc"][:rows])


def test_fixture_is_self_consistent(fx):
    """The stacked model is the per-view outputs' valid rows in view
    order; the keep masks give rows the smoke fixture's models end with."""
    valid = _bits(fx["views0_valid"], N_FEATURES).reshape(-1)
    np.testing.assert_array_equal(
        fx["stacked0_desc"], fx["views0_desc"].reshape(-1, 32)[valid])
    np.testing.assert_array_equal(
        fx["stacked0_points"], fx["views0_world"].reshape(-1, 3)[valid])
    smoke = np.load(os.path.join(os.path.dirname(FIXTURE),
                                 "torch_smoke_fixture.npz"))
    for i in range(3):
        d, p = fx[f"stacked{i}_desc"], fx[f"stacked{i}_points"]
        k8 = _bits(fx[f"keep8_{i}"], len(d))
        k16 = _bits(fx[f"keep16_{i}"], int(k8.sum()))
        np.testing.assert_array_equal(d[k8][k16], smoke[f"desc{i}"])
        np.testing.assert_array_equal(p[k8][k16], smoke[f"points{i}"])
    cfg = json.loads(str(fx["config_json"]))
    assert cfg["n_features"] == N_FEATURES and cfg["dedup"] == [8, 0.005]


# ---- the dedup --------------------------------------------------------------

def _dedup_case(n):
    if n >= 64:
        return dedup_case_arrays(n, n)
    d, p = dedup_case_arrays(1, 64)
    if n == 2:                               # the second row duplicates
        d, p = d[[0, 0]], p[[0, 0]]
    return d[:n], p[:n]


@pytest.mark.parametrize("n", [0, 1, 2, 64, 400, 2000])
@pytest.mark.parametrize("hamming, point", [(8, 0.005), (16, 0.005),
                                            (12, 0.002)])
def test_compress_model_matches_reference(n, hamming, point):
    """Kept rows equal the reference's (its native exact k-NN), row for
    row: planted duplicates either side of both thresholds, chains whose
    suppressor is suppressed, more equal rows than k and equal-distance
    ties."""
    d, p = _dedup_case(n)
    want = jcompress.compress_model(d, p, hamming, point)
    got = tcompress.compress_model(d, p, hamming, point, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if n == 2:
        assert len(got[0]) == 1
    if n >= 400:                           # the dedup does drop rows
        assert len(d) // 3 < len(got[0]) < len(d) * 0.9


def test_self_knn_is_the_reference_top_k_within_the_radius():
    """B5's twin over the model against itself: the leading entries of
    the native unrestricted top-8 that lie within the radius, then holes."""
    from tod_tpu.native import hamming_knn_cpu

    d, _ = dedup_case_arrays(4, 1000)
    idx_r, dist_r = hamming_knn_cpu(d, d, k=8)
    for radius in (8, 16):
        idx, dist = tcompress.self_knn(d, 8, radius, device="cpu")
        inside = dist_r <= radius
        np.testing.assert_array_equal(idx, np.where(inside, idx_r, -1))
        np.testing.assert_array_equal(
            dist, np.where(inside, dist_r, 1e9).astype(np.float32))


# ---- the trainer ------------------------------------------------------------

def test_train_object_matches_reference(fx):
    """train_object on a few views with the Trainer's dedup against the
    reference's own program over the same views, then its compress_model;
    and fill_model's TodModel."""
    obs = fixture_observations(fx, 1)[:VIEWS]
    images = np.stack([o.image for o in obs])
    run = _jitted_train_views("ORB", N_FEATURES, 3, 1.2, 20.0,
                              images.shape[1:3], True, False)
    desc, world, valid = (np.asarray(a) for a in run(
        jnp.asarray(images), jnp.asarray(np.stack([o.mask for o in obs])),
        jnp.asarray(np.stack([o.depth for o in obs])),
        *(jnp.asarray(np.stack([getattr(o, n) for o in obs]))
          for n in "KRT")))
    flat = valid.reshape(-1)
    want = jcompress.compress_model(desc.reshape(-1, 32)[flat],
                                    world.reshape(-1, 3)[flat], 8, 0.005)
    # views in another order: the trainer reads them by frame number
    got_d, got_p = ttrainer.train_object(
        obs[::-1], json.dumps({"type": "ORB", "n_features": N_FEATURES}),
        dedup_hamming=8, device="cpu")
    np.testing.assert_array_equal(got_d, want[0])
    np.testing.assert_array_equal(got_p, want[1].reshape(1, -1, 3))
    assert len(want[0]) < flat.sum()
    model = ttrainer.fill_model("obj001", got_d, got_p)
    assert model.object_id == "obj001" and model.n_points == len(want[0])
    assert model.points.shape == (len(want[0]), 3)
    assert model.descriptors.dtype == np.uint8


def test_trainer_options_and_unported_parts():
    s = ttrainer.feature_settings('{"type": "SIFT", "n_features": 50}')
    assert s == dict(feature_type="SIFT", n_features=50, n_levels=3,
                     scale_factor=1.2, fast_threshold=20.0, subpixel=False)
    with pytest.raises(ValueError, match="ORB or SIFT"):
        ttrainer.feature_settings({"type": "AKAZE"})
    assert ttrainer.feature_settings({"type": "ORB", "subpixel": True})[
        "subpixel"] is True
    # the Trainer cell came with the cell graph (A12b): it trains on the
    # card by default; its view PNGs came with the overlays (A12d), so a
    # visualize prefix configures (test_torch_visualize.py draws them)
    assert ttrainer.Trainer("t").params["device"] == "cuda"
    viz = ttrainer.Trainer("t", visualize="/x/prefix", device="cpu")
    viz.ensure_configured()
    viz.inputs["object_id"] = "o"
    assert viz._view_sink().args == ("/x/prefix", "o")
    ttrainer.Trainer("t", json_feature_params='{"subpixel": true}',
                     device="cpu").ensure_configured()
    empty = ttrainer.train_object([], {"type": "ORB"}, device="cpu")
    assert empty[0].shape == (0, 32) and empty[1].shape == (1, 0, 3)
    sift = ttrainer.fill_model("s", np.zeros((2, 128), np.float32),
                               np.zeros((1, 2, 3)))
    assert sift.descriptors.dtype == np.float32
    assert sift.points.dtype == np.float32
