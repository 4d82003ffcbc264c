"""Sub-pixel keypoints and sub-pixel models: tod_tpu_torch against tod_tpu.

``subpixel=True`` moves each ORB keypoint's reported coords by the vertex of
a parabola through its level's FAST score map (``ops/fast.py
subpixel_offsets``); orientation and descriptors still sample the integer
pixel, and SIFT keeps integer coords, as in the reference. The trainer keeps
the fraction on top of the mask-snapped pixel. The reference runs compiled
(``jax.jit``) wherever it serves or trains, so the reference side here is
compiled too: the offsets, the keypoints, the training step and the
compaction are held to it bit for bit.
"""

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tod_tpu.cells as rc
from tod_tpu.cells.trainer import _jitted_train_views
from tod_tpu.models.fused import FusedDetectorConfig, _stage_features_compact
from tod_tpu.ops import compress as jcompress
from tod_tpu.ops import fast as jfast
from tod_tpu.ops import image as jimage
from tod_tpu.ops import orb as jorb
import tod_tpu_torch.cells as tc
from tod_tpu_torch import convert
from tod_tpu_torch.cells import trainer as ttrainer
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import fast as tfast
from tod_tpu_torch.ops import image as timage
from tod_tpu_torch.ops import orb as torb
from tod_tpu_torch.parallel import train as ttrain
from tod_tpu_torch.types import fixture_observations
from test_torch_features import _frame
from test_torch_train import _batch
from torch_parity import native_library

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
N_FEATURES = 600
VIEWS = 3


@pytest.fixture(scope="session", autouse=True)
def _native_library():
    """The reference's dedup reaches tod_tpu.native: build it safely."""
    native_library()


@pytest.fixture(scope="module")
def smoke():
    return np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))


def _smoke_gray(smoke, f=0):
    return np.asarray(jimage.rgb_to_gray(
        jnp.asarray(smoke["images"][f], jnp.float32)))


def _score_maps():
    """FAST score maps of the seeded 160x120 frame's pyramid levels (the
    maps the detector refines on) and a map with flat and near-flat
    parabolas: a constant block, a ramp and steps of 1e-7 (|second
    difference| at and below the 1e-6 cut)."""
    g = np.asarray(jimage.rgb_to_gray(jnp.asarray(_frame()[0], jnp.float32)))
    levels = timage.build_pyramid(torch.from_numpy(g), 3, 1.2)
    maps = [tfast.fast_score(lvl, 20.0)[0].numpy() for lvl in levels]
    flat = np.zeros((40, 50), np.float32)
    flat[:, 20:] = np.arange(30, dtype=np.float32)[None, :] * 3.0
    flat[10:20, 5:15] = 7.0
    flat[30:, :10] = 1.0 + np.arange(10, dtype=np.float32) * 1e-7
    return maps + [flat]


@pytest.mark.parametrize("case", range(4))
def test_subpixel_offsets_match_compiled_reference(case):
    """Every pixel of each map (and coords past every edge, which both
    clip one pixel inside): bit for bit against ``jax.jit`` of the
    reference's ``subpixel_offsets`` (the products by 2 and 0.5 are exact;
    the division is a true division in both)."""
    score = _score_maps()[case]
    h, w = score.shape
    ys, xs = np.mgrid[-1:h + 1, -1:w + 1]
    xy = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)
    want = np.asarray(jax.jit(jfast.subpixel_offsets)(jnp.asarray(score),
                                                      jnp.asarray(xy)))
    got = tfast.subpixel_offsets(torch.from_numpy(score),
                                 torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= 0.5 and (got != 0).any()


def test_orb_subpixel_keypoints_match(smoke):
    """ORB at the serving point (5000 features) on a 480x640 smoke frame:
    sub-pixel coords, responses' order, levels, validity and descriptors
    equal the compiled reference's; the descriptors equal the integer
    run's (they sample the integer pixel)."""
    gray = _smoke_gray(smoke)
    kw = dict(n_features=5000, n_levels=3, scale_factor=1.2,
              fast_threshold=20.0)
    k_j, d_j = jax.jit(lambda g: jorb.orb_detect_and_compute(
        g, subpixel=True, **kw))(jnp.asarray(gray))
    k_t, d_t = torb.orb_detect_and_compute(torch.from_numpy(gray),
                                           subpixel=True, **kw)
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    k_i, d_i = torb.orb_detect_and_compute(torch.from_numpy(gray), **kw)
    assert torch.equal(d_i, d_t) and torch.equal(k_i.valid, k_t.valid)
    moved = (k_t.xy != k_i.xy).any(-1) & k_t.valid
    assert moved.float().mean() > 0.5


def test_subpixel_coords_round_half_to_even():
    """``snapped + (xy - round(xy))`` at .5 fractions (an offset clipped to
    +-0.5 at level 0) and around them: torch.round and jnp.round both round
    half to even."""
    xy = np.array([[10.5, 11.5], [-0.5, 0.5], [2.5, 3.5], [4.4999995, 5.5],
                   [7.25, 8.75], [100.5, 101.0]], np.float32)
    snapped = np.array([[11, 12], [0, 0], [2, 4], [5, 6], [7, 9], [100, 101]],
                       np.float32)
    want = np.asarray(jnp.asarray(snapped) + (jnp.asarray(xy)
                                              - jnp.round(jnp.asarray(xy))))
    got = ttrain.subpixel_coords(torch.from_numpy(snapped),
                                 torch.from_numpy(xy)).numpy()
    np.testing.assert_array_equal(got, want)
    # 10.5 rounds to 10 and 11.5 to 12: the fraction is +0.5 and -0.5
    np.testing.assert_array_equal(got[:3], [[11.5, 11.5], [-0.5, 0.5],
                                            [2.5, 3.5]])


def _views():
    fx = np.load(os.path.join(DATA, "torch_train_fixture.npz"))
    return fixture_observations(fx, 0)[:VIEWS]


def test_train_views_step_subpixel_matches_reference():
    """Object 0's first views through the sub-pixel training step:
    descriptors, valid masks and world points (NaN in the same slots) equal
    the reference's compiled batched program's; the points moved off the
    integer run's; then the model after the Trainer's dedup (8 bits / 5 mm,
    kernel B5's twin) equals the reference's native dedup of the same
    rows."""
    obs = _views()
    images = np.stack([o.image for o in obs])
    run = _jitted_train_views("ORB", N_FEATURES, 3, 1.2, 20.0,
                              images.shape[1:3], True, True)
    desc, world, valid = (np.asarray(a) for a in run(
        jnp.asarray(images), jnp.asarray(np.stack([o.mask for o in obs])),
        jnp.asarray(np.stack([o.depth for o in obs])),
        *(jnp.asarray(np.stack([getattr(o, n) for o in obs]))
          for n in "KRT")))
    feat = {"type": "ORB", "n_features": N_FEATURES, "subpixel": True}
    settings = ttrainer.feature_settings(feat)
    assert settings["subpixel"] is True
    d_t, w_t, v_t = ttrainer.train_views(obs, settings, "cpu")
    np.testing.assert_array_equal(v_t, valid)
    np.testing.assert_array_equal(d_t, desc)
    np.testing.assert_array_equal(w_t, world)
    d_i, w_i, _ = ttrainer.train_views(
        obs, ttrainer.feature_settings(dict(feat, subpixel=False)), "cpu")
    assert np.array_equal(d_i, d_t) and not np.array_equal(w_i[v_t],
                                                           w_t[v_t])
    flat = valid.reshape(-1)
    want = jcompress.compress_model(desc.reshape(-1, 32)[flat],
                                    world.reshape(-1, 3)[flat], 8, 0.005)
    got_d, got_p = ttrainer.train_object(obs, feat, dedup_hamming=8,
                                         dedup_point_m=0.005, device="cpu")
    np.testing.assert_array_equal(got_d, want[0])
    np.testing.assert_array_equal(got_p.reshape(-1, 3), want[1])


def test_sift_training_keeps_integer_coords():
    """SIFT with ``subpixel`` set: the settings warn and drop it, and the
    training step's world points equal the integer run's, as the
    reference's step ignores it for SIFT (parallel/train.py)."""
    obs = _views()[:1]
    with pytest.warns(UserWarning, match="integer coordinates"):
        s = ttrainer.feature_settings({"type": "SIFT", "n_features": 200,
                                       "subpixel": True})
    assert s["subpixel"] is False
    batch = ttrainer.train_views(obs, s, "cpu")
    with_sub = ttrain.train_views_step(*_batch(obs), n_features=200,
                                       feature_type="SIFT", subpixel=True)
    np.testing.assert_array_equal(with_sub[1].numpy(), batch[1])


def test_compaction_subpixel_matches_reference(smoke):
    """FusedDetector's compaction with ``subpixel`` (ORB): keypoints, 3D
    points (back-projected through the fractional coords), descriptors and
    ok equal the compiled reference's stage on both smoke frames; with
    SIFT the flag changes nothing, as in the reference."""
    cfg = FusedDetectorConfig(n_features=3000, pipeline="segmented",
                              q_cap=1024, bucket_grid=(6, 8), subpixel=True)
    stage = jax.jit(lambda g, d, k: _stage_features_compact(g, d, k, cfg))
    port_cfg = convert.config_from_dict(dataclasses.asdict(cfg))
    det = tfused.FusedDetector([], port_cfg, device="cpu")
    for f in range(2):
        gray = _smoke_gray(smoke, f)
        ref = stage(jnp.asarray(gray), jnp.asarray(smoke["depths"][f]),
                    jnp.asarray(smoke["K"]))
        port = tfused.stage_features_compact(
            *det.prepare_frame(smoke["images"][f], smoke["depths"][f],
                               smoke["K"]), port_cfg)
        for name, a, b in zip(("xy", "qp", "dsc", "ok"), ref, port):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        xy = port[0].numpy()[port[3].numpy()]
        assert (xy != np.round(xy)).any()
    sift = dataclasses.replace(port_cfg, feature="SIFT", n_features=500,
                               q_cap=512)
    frame = det.prepare_frame(smoke["images"][0], smoke["depths"][0],
                              smoke["K"])
    a = tfused.stage_features_compact(*frame, sift)
    b = tfused.stage_features_compact(
        *frame, dataclasses.replace(sift, subpixel=False))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_cells_serve_subpixel(smoke):
    """The FeatureDescriptor cell with ``subpixel`` equals the reference's
    cell on ORB (coords and descriptors) and warns on SIFT, as the
    reference's does; the SegmentedDetector cell passes it to its
    detector; the Trainer cell takes it (and warns on SIFT)."""
    feat = json.dumps({"type": "ORB", "n_features": 500, "subpixel": True})
    out = []
    for cell in (rc.FeatureDescriptor("f", json_feature_params=feat),
                 tc.FeatureDescriptor("f", json_feature_params=feat,
                                      device="cpu")):
        cell.ensure_configured()
        cell.inputs["image"] = smoke["images"][1]
        cell.process()
        out.append((cell.outputs["keypoints"], cell.outputs["descriptors"]))
    (rk, rd), (pk, pd) = out
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(pk, name),
                                      np.asarray(getattr(rk, name)), name)
    np.testing.assert_array_equal(pd, rd)
    assert (pk.xy != np.round(pk.xy)).any()
    sift = json.dumps({"type": "SIFT", "subpixel": True})
    for make in (rc.FeatureDescriptor, tc.FeatureDescriptor):
        with pytest.warns(UserWarning, match="integer coordinates"):
            make("f", json_feature_params=sift).ensure_configured()
    seg = tc.SegmentedDetector("s", json_feature_params=feat, device="cpu")
    seg.ensure_configured()
    assert seg._detector.config.subpixel is True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tc.Trainer("t", json_feature_params=feat,
                   device="cpu").ensure_configured()
    with pytest.warns(UserWarning, match="integer coordinates"):
        tc.Trainer("t", json_feature_params=sift,
                   device="cpu").ensure_configured()
