"""The SIFT/L2 serving path: tod_tpu_torch against tod_tpu.

Features (``ops/sift.py``) on the small seeded frame of
test_torch_features.py, then ``FusedDetector(feature="SIFT")`` as a whole,
full sweep and coarse->fine with tracked and exploration slots, on the SIFT
fixture's three trained models (every 4th row kept, so that it runs in
seconds) with five seeded fillers over the smoke fixture's frames.

Keypoint angles, float descriptors and their quantised rows equal the
compiled reference's bit for bit: the port takes the host libm's ``atan2f``
(``ops/libm.py``), the reference's fused sum of squares, and the summation
order of the oneDNN kernel under XLA's dot, which depends on the product's
width (``contraction_order``: lanes, parity or chain). The detectors run on
the port's own compacted queries (each frame's computed once and shared by
the tests, ``_own_compaction``), with the reference's RANSAC draws injected
(torch_parity).
"""

import dataclasses
import json
import os
import re

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
# Keypoint counts of the exact-descriptor cases and the order that XLA's
# dot sums each in (its 8 K columns: 24 or fewer chain in lanes, then
# ((8 K - 1) // 16) mod 4 picks lanes, parity, lanes, chain, which change
# past 7,280 and 10,896 columns: the serving levels of 5000 features)
ORDER_CASES = [(1, "lanes"), (3, "lanes"), (4, "parity"), (7, "chain"),
               (30, "lanes"), (96, "chain"), (1374, "chain"),
               (1978, "parity")]


def _gray():
    img, _ = _frame()
    return np.asarray(jimage.rgb_to_gray(jnp.asarray(img)))


def assert_same_descriptors(d_t: torch.Tensor, d_j) -> None:
    """Float descriptors and their quantised int8 rows, bit for bit."""
    d_j = np.asarray(d_j)
    assert d_t.dtype == torch.float32 and tuple(d_t.shape) == d_j.shape
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_array_equal(
        tl2.quantize_descriptors(d_t).numpy(),
        np.asarray(jl2.quantize_descriptors(jnp.asarray(d_j))))


def test_spatial_tables_equal():
    np.testing.assert_array_equal(tsift._spatial_tables(),
                                  jsift._spatial_tables())
    assert (tsift.N_SPATIAL, tsift.N_ORI, tsift.DESC_DIM, tsift.SUPPORT_R) \
        == (jsift.N_SPATIAL, jsift.N_ORI, jsift.DESC_DIM, jsift.SUPPORT_R)


def _describe_case(n: int, seed: int):
    g = _gray()
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(g), 7, 1.6))
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(jorb.PATCH_R, 160 - jorb.PATCH_R, n),
                   rng.integers(jorb.PATCH_R, 120 - jorb.PATCH_R, n)],
                  -1).astype(np.int32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return blurred, xy, angle


def test_sift_descriptors_match():
    """The same keypoints and angles through both: the descriptor alone,
    against the compiled reference, with half-bin angles and +-pi."""
    blurred, xy, angle = _describe_case(96, 2)
    # half-bin angles (the spatial table's round-half-even rule, applied as
    # the compiled reference applies it: a multiply by the step's
    # reciprocal sends 7.5 steps to bin 7) and +-pi
    angle[:8] = (np.arange(8) + 0.5) * np.float32(2 * np.pi / 32)
    angle[8:10] = [np.pi, -np.pi]
    d_j = jax.jit(jsift.sift_descriptors)(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle))
    d_t = tsift.sift_descriptors(_t(blurred), _t(xy), _t(angle))
    assert_same_descriptors(d_t, d_j)
    np.testing.assert_allclose(np.linalg.norm(d_t.numpy(), axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("n, kind", ORDER_CASES)
def test_sift_descriptors_exact_in_each_order(n, kind):
    """Descriptors of ``n`` keypoints bit for bit, for each summation order
    of the reference's contraction."""
    assert tsift.contraction_order(n)[0] == kind
    blurred, xy, angle = _describe_case(n, 10 + n)
    d_j = jax.jit(jsift.sift_descriptors)(
        jnp.asarray(blurred), jnp.asarray(xy), jnp.asarray(angle))
    assert_same_descriptors(
        tsift.sift_descriptors(_t(blurred), _t(xy), _t(angle)), d_j)


def test_serving_float_descriptors_match_fixture_digest():
    """At the served SIFT config (5000 features, 3 levels) on the smoke
    fixture's frame 0, prepared as ``FusedDetector`` prepares it, the
    port's float descriptors before quantisation, every slot, have the
    digest of the reference's (``ref_desc_digest``, written by
    tools/make_torch_sift_fixture.py): their level-0 and level-1
    contractions are 8 K = 10,992 and 15,824 columns wide, orders that the
    int8 rows alone could not tell apart (chip_smoke.py phase 4d holds
    both frames on the card)."""
    from tod_tpu_torch.utils.camera_sizes import digest

    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    cfg = json.loads(str(sx["config_json"]))
    gray = tfused.prepare_frame(fx["images"][0], fx["depths"][0], fx["K"],
                                "cpu")[0]
    _, desc = tsift.sift_detect_and_compute(
        gray, n_features=cfg["n_features"], n_levels=cfg["n_levels"],
        scale_factor=cfg["scale_factor"],
        fast_threshold=cfg["fast_threshold"])
    assert digest(desc.numpy()) == str(sx["ref_desc_digest"][0])


def test_contraction_taps_and_histograms():
    """The tap tables hold every nonzero table entry once, in its partial
    sum, with its slot in the pixels its angle bin reads (every pixel that
    a cell of the bin reads, and no other), a bin's taps within
    ``MAX_BIN_TAPS``; the CPU wrapper is the plain chain (kernel L2's plain
    version); the wrapper refuses what it cannot take."""
    tables = tsift._spatial_tables()
    for kind, block in {tsift.contraction_order(k) for k in (1, 4, 7)}:
        taps_ = tsift._contraction_taps((kind, block))
        starts, weights = taps_.starts, taps_.weights
        idx, wt = taps_.idx, taps_.wt
        # each tap's pixel, from its slot in its column's bin's pixels
        bin_of_tap = np.repeat(np.arange(512) // 16,
                               np.diff(starts[::4]))
        depths = taps_.pixels[taps_.pixel_starts[bin_of_tap] + taps_.slots]
        assert starts[-1] == len(depths) == np.count_nonzero(tables)
        for b in range(32):
            pixels = taps_.pixels[taps_.pixel_starts[b]:
                                  taps_.pixel_starts[b + 1]]
            assert len(pixels) <= tsift.MAX_PIXELS
            assert starts[64 * b + 64] - starts[64 * b] <= tsift.MAX_BIN_TAPS
            np.testing.assert_array_equal(
                pixels, np.nonzero(tables[:, 16 * b:16 * b + 16].any(1))[0])
        for col in (0, 77, 511):
            seg = starts[4 * col:4 * col + 5]
            taps = depths[seg[0]:seg[-1]]
            assert sorted(taps) == list(np.nonzero(tables[:, col])[0])
            for g in range(4):
                part = depths[seg[g]:seg[g + 1]]
                assert (np.diff(part) > 0).all()
                assert (tsift.contraction_groups(part, kind, block) == g).all()
                np.testing.assert_array_equal(idx[g, col, :len(part)], part)
                assert not wt[g, col, len(part):].any()
            np.testing.assert_array_equal(weights[seg[0]:seg[-1]],
                                          tables[taps, col])
    blurred, xy, angle = (_t(a) for a in _describe_case(5, 3))
    assert torch.equal(tsift.sift_descriptors(blurred, xy, angle),
                       tsift.sift_describe_torch(blurred, xy, angle))
    before = tsift.sift_descriptors.launches
    assert tsift.sift_descriptors(blurred, xy[:0], angle[:0]).shape == (0, 128)
    assert tsift.sift_descriptors.launches == before   # no kernel on a CPU
    with pytest.raises(ValueError):
        tsift.sift_descriptors(blurred[:30], xy, angle)
    with pytest.raises(ValueError):
        tsift.sift_descriptors(blurred, xy, angle.double())
    with pytest.raises(ValueError):
        tsift.sift_descriptors(blurred.to("meta"), xy.to("meta"),
                               angle.to("meta"))


def test_describe_kernel_constants_match_the_package():
    """Kernel L2's compile-time sizes (csrc/sift_descriptor.cu) are the
    ones ops/sift.py builds its tables for and chip_smoke.py's bound
    counts with."""
    from tod_tpu_torch import kernels

    text = (kernels.CSRC / "sift_descriptor.cu").read_text()
    got = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert {k: got[k] for k in ("kPatchR", "kOri", "kGroups", "kBins",
                                "kMaxPixels", "kMaxTaps", "kPerBlock")} == {
        "kPatchR": tsift.PATCH_R, "kOri": tsift.N_ORI,
        "kGroups": tsift.N_GROUPS, "kBins": tsift.N_ANGLE_BINS,
        "kMaxPixels": tsift.MAX_PIXELS, "kMaxTaps": tsift.MAX_BIN_TAPS,
        "kPerBlock": tsift.DESCRIBE_PER_BLOCK}
    assert tsift.DEPTH == (2 * tsift.PATCH_R + 1) ** 2


def test_sift_detect_and_compute_matches():
    g = _gray()
    kw = dict(n_features=300, edge_threshold=20)
    k_j, d_j = jax.jit(lambda x: jsift.sift_detect_and_compute(x, **kw))(
        jnp.asarray(g))
    k_t, d_t = tsift.sift_detect_and_compute(_t(g), **kw)
    valid = np.asarray(k_j.valid)
    assert valid.sum() > 150
    # keypoints come from the exactly-held detector, angles from the host
    # libm's atan2f: equal
    for name in ("xy", "level", "valid", "angle"):
        np.testing.assert_array_equal(getattr(k_t, name).numpy(),
                                      np.asarray(getattr(k_j, name)), name)
    # responses carry the Harris rounding bound of test_torch_features.py
    r_j = np.asarray(k_j.response)[valid]
    np.testing.assert_allclose(k_t.response.numpy()[valid], r_j, rtol=0,
                               atol=1e-4 * np.abs(r_j).max())
    assert_same_descriptors(d_t, d_j)
    assert not d_t.numpy()[~valid].any()
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


_COMPACTED = {}
_own_features = tfused.stage_features_compact


def _own_compaction(gray, depth, K, cfg):
    """The port's own compaction outputs, each frame's computed once for
    the module (the tests' configs share their feature and compaction
    fields)."""
    key = (gray.numpy().tobytes(), depth.numpy().tobytes(),
           K.numpy().tobytes(), cfg.feature, cfg.n_features, cfg.n_levels,
           cfg.scale_factor, cfg.fast_threshold, cfg.q_cap, cfg.bucket_grid)
    if key not in _COMPACTED:
        _COMPACTED[key] = _own_features(gray, depth, K, cfg)
    return tuple(t.clone() for t in _COMPACTED[key])


@pytest.fixture
def own_features(monkeypatch):
    monkeypatch.setattr(tfused, "stage_features_compact", _own_compaction)


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
    """The port's own features against the reference's: keypoints, 3D
    points, quantised descriptors and ok equal."""
    jd, td = _pair(world, _config())
    for f in range(2):
        xy, qp, dsc, ok = (np.asarray(a) for a in
                           _reference_queries(jd, world, f))
        image, depth = world["frames"][f]
        port = [t.numpy() for t in _own_compaction(
            *td.prepare_frame(image, depth, world["fx"]["K"]), td.config)]
        np.testing.assert_array_equal(port[0], xy)
        np.testing.assert_array_equal(port[1], qp)
        np.testing.assert_array_equal(port[3], ok)
        assert port[2].dtype == np.int8 and ok.sum() > 900
        np.testing.assert_array_equal(port[2], dsc)


def test_full_sweep_detector_matches_reference(world, own_features):
    cfg = _config()
    jd, td = _pair(world, cfg)
    found = []
    for f in range(2):
        image, depth = world["frames"][f]
        ref = _reference_queries(jd, world, f)
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


def test_streaming_detector_matches_reference(world, own_features):
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
