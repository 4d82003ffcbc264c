"""The SIFT/L2 serving path: tod_tpu_torch against tod_tpu.

Features (``ops/sift.py``) on the small seeded frame of
test_torch_features.py, then ``FusedDetector(feature="SIFT")`` as a whole,
full sweep and coarse->fine with tracked and exploration slots, on the SIFT
fixture's three trained models (every 4th row kept, so that it runs in
seconds) with five seeded fillers over the smoke fixture's frames.

Float descriptors are not bit-equal: the reference contracts 1,369 pixels in
float32 in XLA's order, PyTorch in its own, and the keypoint angle enters the
orientation histogram as a continuous value (it agrees to ~5e-6 rad, see
test_torch_features.py::test_orientation_matches). Quantisation then moves
an int8 entry by one wherever ``d * 256`` lies that close to a half. So the
float descriptors are held to a stated tolerance, the quantised ones to
"equal, or off by one in a stated share", and wherever the matcher, the slab
or the geometry is held exactly the reference's quantised queries are handed
to the port, as its RANSAC draws are (torch_parity).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu.ops import image as jimage
from tod_tpu.ops import orb as jorb
from tod_tpu.ops import sift as jsift
from tod_tpu.ops.pallas import segmented_l2 as jl2
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import segmented_l2 as tl2
from tod_tpu_torch.ops import sift as tsift
from tod_tpu_torch.utils.smoke_catalog import L2_NOISE, smoke_catalog
from test_torch_features import _frame, _t
from test_torch_geometry import _pose_close
from torch_parity import JaxReplayNoise, frame_keys

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 5
# Float descriptors (unit norm, entries <= ~0.3): the angle's ~5e-6 rad gap
# moves the soft orientation bins by ~6e-6 of a bin and the contraction's
# order adds a few ulps; 2e-5 bounds both (5.8e-6 seen on the small frame).
DESC_ATOL = 2e-5
# Quantised entries that may differ, by one, from the reference's: seen 0 of
# 38,400 on the small frame and 7 and 10 of 262,144 on the fixture's frames.
QUANT_SHARE = 2e-4


def _gray():
    img, _ = _frame()
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))


def _quant_gap(port_i8: np.ndarray, ref_i8: np.ndarray) -> float:
    """Share of int8 entries that differ; none may differ by more than 1."""
    diff = port_i8.astype(np.int32) - ref_i8.astype(np.int32)
    assert np.abs(diff).max() <= 1
    return float((diff != 0).mean())


def test_spatial_tables_equal():
    np.testing.assert_array_equal(tsift._spatial_tables(),
                                  jsift._spatial_tables())
    assert (tsift.N_SPATIAL, tsift.N_ORI, tsift.DESC_DIM, tsift.SUPPORT_R) \
        == (jsift.N_SPATIAL, jsift.N_ORI, jsift.DESC_DIM, jsift.SUPPORT_R)


def test_sift_descriptors_match():
    """The same keypoints and angles through both: the descriptor alone."""
    g = _gray()
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(g), 7, 1.6))
    rng = np.random.default_rng(2)
    n = 96
    xy = np.stack([rng.integers(jorb.PATCH_R, 160 - jorb.PATCH_R, n),
                   rng.integers(jorb.PATCH_R, 120 - jorb.PATCH_R, n)],
                  -1).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # half-bin angles (the spatial table's round-half-even rule) and +-pi
    angle[:8] = (np.arange(8) + 0.5) * np.float32(2 * np.pi / 32)
    angle[8:10] = [np.pi, -np.pi]
    # Run eagerly, as test_torch_features.py runs brief_descriptors: compiled,
    # XLA turns the bin rule's division by a constant into a multiply by its
    # reciprocal, which sends the exact half-bin angle 7.5 * (2 pi / 32) to
    # bin 7, not 8 (3 of 100,000 seeded angles, all of them exact half
    # bins; the moments of real keypoints do not produce one).
    d_j = np.asarray(jsift.sift_descriptors(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle)))
    d_t = tsift.sift_descriptors(_t(blurred), _t(xy), _t(angle))
    assert d_t.dtype == torch.float32 and tuple(d_t.shape) == (n, 128)
    # equal inputs: only the contraction's order and atan2's rounding differ
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(d_t.numpy(), axis=1), 1.0,
                               atol=1e-5)
    q_j = np.asarray(jl2.quantize_descriptors(jnp.asarray(d_j)))
    assert _quant_gap(tl2.quantize_descriptors(d_t).numpy(), q_j) \
        <= QUANT_SHARE


def test_sift_detect_and_compute_matches():
    g = _gray()
    kw = dict(n_features=300, edge_threshold=20)
    k_j, d_j = jax.jit(lambda x: jsift.sift_detect_and_compute(x, **kw))(
        jnp.asarray(g))
    k_t, d_t = tsift.sift_detect_and_compute(_t(g), **kw)
    valid = np.asarray(k_j.valid)
    assert valid.sum() > 150
    # keypoints come from the exactly-held detector: equal
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    # responses carry the Harris rounding bound of test_torch_features.py
    r_j = np.asarray(k_j.response)[valid]
    np.testing.assert_allclose(k_t.response.numpy()[valid], r_j, rtol=0,
                               atol=1e-4 * np.abs(r_j).max())
    # the angle within test_orientation_matches' bound (2 / |moment|)
    np.testing.assert_allclose(k_t.angle.numpy()[valid],
                               np.asarray(k_j.angle)[valid], atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=DESC_ATOL)
    assert not d_t.numpy()[~valid].any()
    q_j = np.asarray(jl2.quantize_descriptors(d_j))
    assert _quant_gap(tl2.quantize_descriptors(d_t).numpy(), q_j) \
        <= QUANT_SHARE
    # a keypoint mask (training's) restricts detection as the reference's
    mask = np.zeros(g.shape, np.uint8)
    mask[20:100, 30:125] = 255
    k_jm, _ = jax.jit(lambda x, m: jsift.sift_detect_and_compute(
        x, mask=m, **kw))(jnp.asarray(g), jnp.asarray(mask))
    k_tm, _ = tsift.sift_detect_and_compute(_t(g), mask=_t(mask), **kw)
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(k_tm, name).numpy(),
                                      np.asarray(getattr(k_jm, name)), name)
    assert int(k_tm.valid.sum()) < int(valid.sum())


# ---- the SIFT slice as a whole ---------------------------------------------

N_FRAMES = 4


def _config(**change):
    """A small cut of the bench's SIFT operating point (bench.py
    build_config under BENCH_FEATURE=SIFT): radius 0.9, bucketed compaction,
    prescreen, three instance rounds, the tight final fit and the gate."""
    return FusedDetectorConfig(**{**dict(
        n_features=2000, feature="SIFT", pipeline="segmented", q_cap=1024,
        bucket_grid=(6, 8), radius=0.9, k_matches=8,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                    prescreen=3, active_reserve=1),
        guess=GuessConfig(
            ransac=RansacConfig(n_hypotheses=256, continuation_hypotheses=64,
                                min_inliers=8, max_instances=3,
                                tight_final_fit=True),
            max_matches_per_object=256, max_active_objects=3),
        min_quality=100.0), **change})


# The frontier recipe (docs/SERVING.md) cut to a small catalog: coarse stride
# 4, a 6-slot slab of 2 coarse + 2 tracked + 2 exploration slots, a 1-wide
# prescreen (so the forced slots widen it); coarse_slack stays at its SIFT
# default of 0.15.
STREAMING = dict(coarse_stride=4, fine_width=6, coarse_q_stride=2,
                 track_width=2, explore_width=2, track_ttl=2,
                 track_min_confidence=16.0,
                 activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                             prescreen=1, active_reserve=1))


@pytest.fixture(scope="module")
def world():
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    real = [(sx[f"desc{i}"][::4], sx[f"points{i}"][::4]) for i in range(3)]
    ids, arrays = smoke_catalog([str(s) for s in sx["model_ids"]], real,
                                n_objects=8)
    assert arrays[3][0].dtype == np.int8
    step = arrays[3][0].astype(int) - real[0][0].astype(int)
    assert np.abs(step).max() <= L2_NOISE and step.any()
    # both packages serve q / 256, exact in f32: the port also takes q itself
    jmodels = [JaxModel(i, d.astype(np.float32) / 256.0, p)
               for i, (d, p) in zip(ids, arrays)]
    tmodels = convert.models_from_numpy(ids, [d for d, _ in arrays],
                                        [p for _, p in arrays])
    frames = [(fx["images"][f % 2], fx["depths"][f % 2])
              for f in range(N_FRAMES)]
    return dict(fx=fx, jmodels=jmodels, tmodels=tmodels, frames=frames,
                keys=frame_keys(SEED, N_FRAMES))


def _pair(world, cfg):
    jd = FusedDetector(world["jmodels"], cfg, seed=SEED)
    td = tfused.FusedDetector(
        world["tmodels"], convert.config_from_dict(dataclasses.asdict(cfg)),
        seed=SEED, device="cpu")
    return jd, td


def _reference_queries(jd, world, f):
    image, depth = world["frames"][f]
    return jd._stages[0](*jd.prepare_frame(image, depth, world["fx"]["K"]))


def _inject(monkeypatch, ref):
    """Hand the port the reference's compaction outputs (xy, 3D points,
    quantised descriptors, ok) in place of its own."""
    out = tuple(torch.from_numpy(np.array(a)) for a in ref)
    monkeypatch.setattr(tfused, "stage_features_compact", lambda *a: out)


def _assert_same_detections(td, det_t, det_j, what):
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)),
                                      f"{what} {name}")
    ref = td.poses(tran.ObjectDetections(
        *(torch.from_numpy(np.array(a)) for a in det_j)))
    port = td.poses(det_t)
    key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
    assert sorted(map(key, port)) == sorted(map(key, ref)), what
    for r_t in port:
        r_j = next(r for r in ref if key(r) == key(r_t))
        _pose_close(r_t.R, r_t.T, r_j.R, r_j.T)      # 1e-5
    return port


def test_packed_dbs_equal_the_reference(world):
    """Models travel as int8 q and are served as q / 256: the packed full
    and coarse DBs of both packages are equal by construction."""
    jd, td = _pair(world, _config(**STREAMING))
    assert isinstance(td.sdb, tl2.SegmentedDbF)
    for jdb, tdb in ((jd.sdb, td.sdb), (jd.cdb, td.cdb)):
        got = convert.segmented_db_f_from_jax(
            {k: np.asarray(v) for k, v in jdb._asdict().items()}, "cpu")
        for name in ("rows", "norm_sq", "points", "obj_start", "n_rows",
                     "spans"):
            assert torch.equal(getattr(got, name), getattr(tdb, name)), name
        assert got.db_chunk == tdb.db_chunk
    # float models quantise to the same DB
    floats = tfused.FusedDetector(
        [tfused.TodModel(m.object_id, np.asarray(m.descriptors), m.points)
         for m in world["jmodels"]], td.config, device="cpu")
    assert torch.equal(floats.sdb.rows, td.sdb.rows)
    assert torch.equal(floats.cdb.norm_sq, td.cdb.norm_sq)


def test_compaction_matches_at_small_size(world):
    """The port's own features against the reference's: keypoints, 3D points
    and ok equal; quantised descriptors off by one in at most QUANT_SHARE
    of the entries."""
    jd, td = _pair(world, _config())
    for f in range(2):
        xy, qp, dsc, ok = (np.asarray(a) for a in
                           _reference_queries(jd, world, f))
        image, depth = world["frames"][f]
        port = [t.numpy() for t in tfused.stage_features_compact(
            *td.prepare_frame(image, depth, world["fx"]["K"]), td.config)]
        np.testing.assert_array_equal(port[0], xy)
        np.testing.assert_array_equal(port[1], qp)
        np.testing.assert_array_equal(port[3], ok)
        assert port[2].dtype == np.int8 and ok.sum() > 900
        share = _quant_gap(port[2], dsc)
        print(f"frame {f}: quantised entries off by one: {share:.2e}")
        assert share <= QUANT_SHARE


def test_full_sweep_detector_matches_reference(world, monkeypatch):
    cfg = _config()
    jd, td = _pair(world, cfg)
    found = []
    for f in range(2):
        image, depth = world["frames"][f]
        ref = _reference_queries(jd, world, f)
        _inject(monkeypatch, ref)
        td.noise = JaxReplayNoise(world["keys"][f],
                                  cfg.guess.ransac.max_instances)
        d_j, r_j = jd._stages[1](ref[2], jd.sdb)
        d_t, r_t = tfused.match_full(torch.from_numpy(np.array(ref[2])),
                                     td.sdb)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        _, det_j = jd.detect_raw(image, depth, world["fx"]["K"])
        _, det_t = td.detect_raw(image, depth, world["fx"]["K"])
        found += _assert_same_detections(td, det_t, det_j, f"frame {f}")
    print("gated:", [(r.object_id, r.quality) for r in found])
    assert len({r.object_id for r in found}) >= 2


def test_streaming_detector_matches_reference(world, monkeypatch):
    cfg = _config(**STREAMING)
    jd, td = _pair(world, cfg)
    slabs = []
    c1, c2, c3 = jd._coarse

    def recording_c1(*a):
        out = c1(*a)
        slabs.append(out)
        return out

    jd._coarse = (recording_c1, c2, c3)
    n_acc = 0
    for f, (image, depth) in enumerate(world["frames"]):
        _inject(monkeypatch, _reference_queries(jd, world, f))
        td.noise = JaxReplayNoise(world["keys"][f],
                                  cfg.guess.ransac.max_instances)
        _, det_j = jd.detect_raw(image, depth, world["fx"]["K"])
        _, det_t = td.detect_raw(image, depth, world["fx"]["K"])
        for name, a, b in zip(("sel", "force", "force_act"), slabs[f],
                              td.slab):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          f"frame {f} {name}")
        n_acc += len(_assert_same_detections(td, det_t, det_j, f"frame {f}"))
        np.testing.assert_array_equal(td._age.numpy(), np.asarray(jd._age),
                                      f"frame {f} age")
        assert td._explore_pos == jd._explore_pos
        np.testing.assert_array_equal(td._last_coarse_sel.numpy(),
                                      np.asarray(jd._last_coarse_sel))
    # the stream detects, tracks (ages 0) and explores (the cursor moved)
    assert n_acc >= N_FRAMES
    assert (td._age.numpy() == 0).any()
    assert td._explore_pos == (2 * N_FRAMES) % 8


def test_sift_config_and_unported_paths(world):
    cfg = convert.config_from_dict(dataclasses.asdict(_config()))
    assert cfg.resolved_coarse_slack == 0.15
    models = world["tmodels"][:1]
    with pytest.raises(ValueError, match="segmented"):
        tfused.FusedDetector(models, dataclasses.replace(
            cfg, pipeline="global"), device="cpu")
    # subpixel is ported for ORB; SIFT keeps integer coords, as the
    # reference does (test_torch_subpixel.py holds its compaction)
    sub = tfused.FusedDetector(models, dataclasses.replace(
        cfg, subpixel=True), device="cpu")
    assert torch.equal(sub.sdb.rows, tfused.FusedDetector(
        models, cfg, device="cpu").sdb.rows)
    # catalog capacity pads with empty SIFT slots, reserved rows poisoned
    cap = tfused.FusedDetector(models, dataclasses.replace(
        cfg, catalog_capacity=3, reserve_rows=64), device="cpu")
    assert cap.object_ids == [models[0].object_id, "", ""]
    assert cap.sdb.rows_host[1:] == (0, 0)
    assert (cap.sdb.norm_sq[cap.sdb.starts_host[1]:] == tl2.PAD_NORM).all()
    assert tfused.FusedDetector([], cfg, device="cpu").detect(
        *world["frames"][0], world["fx"]["K"]) == []
    # the stored fixture config is the bench's SIFT operating point
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    stored = convert.config_from_dict(json.loads(str(sx["config_json"])))
    assert (stored.feature, stored.radius, stored.q_cap, stored.n_features,
            stored.min_quality) == ("SIFT", 0.9, 2048, 5000, 156.0)
