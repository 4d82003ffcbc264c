"""Batched detection (``FusedDetector.detect_batch_raw``) on the three
serving paths: tod_tpu_torch against tod_tpu on the CPU.

The reference's ``detect_batch_raw`` splits its key once a batch, ``keys =
split(sub, B)``, and runs row b as its per-frame stages would with
``keys[b]``, under the batched config (``fixed_refine_loop=True``, the
masked refinement loop; the segmented paths run the full exact sweep). Its
vmapped geometry is not compiled here (it has compiled for minutes); as its
own test does (tests/test_e2e.py), each batched row of the port is held to
the reference's compiled per-frame stage with ``keys[b]``, and to the
port's own per-frame path (the global-kNN path in
test_torch_batch_global.py). Both frames of the smoke fixture, each ORB or
SIFT model with every 4th row kept and seeded fillers (as
test_torch_sift.py cuts them). Against the reference, its own test's
tolerance: the same accepted instances, inlier counts and clique sizes, R
and T within ``POSE_ATOL`` for the accepts at the quality gate (junk
accepts of 8-18 inliers refit ~2e-5 apart, as everywhere in these tests).
Against the port's per-frame path: every field bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.utils import prng
from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 6
B = 2
POSE_ATOL = 1e-5
RANSAC = dict(n_hypotheses=256, continuation_hypotheses=64, min_inliers=8,
              max_instances=3, tight_final_fit=True, fixed_refine_loop=True)


def _segmented(**change):
    """A small cut of the bench's serving point (test_torch_slice.py's)."""
    return FusedDetectorConfig(**{**dict(
        n_features=1500, pipeline="segmented", q_cap=1024,
        bucket_grid=(6, 8), radius=50.0,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                    prescreen=3),
        guess=GuessConfig(ransac=RansacConfig(**RANSAC),
                          max_matches_per_object=256, max_active_objects=3),
        min_quality=100.0), **change})


@pytest.fixture(scope="module")
def smoke():
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))

    def catalog(xf, scale):
        real = [(xf[f"desc{i}"][::4], xf[f"points{i}"][::4])
                for i in range(3)]
        ids, arrays = smoke_catalog([str(s) for s in xf["model_ids"]], real,
                                    n_objects=6)
        jmodels = [JaxModel(i, d.astype(np.float32) / scale if scale else d,
                            p) for i, (d, p) in zip(ids, arrays)]
        return jmodels, convert.models_from_numpy(
            ids, [d for d, _ in arrays], [p for _, p in arrays])

    frames = [(fx["images"][f], fx["depths"][f]) for f in range(B)]
    return dict(K=fx["K"], frames=frames, orb=catalog(fx, None),
                sift=catalog(sx, 256.0))


def _keys():
    """The port's batch keys for a detector at SEED: split(sub, B)."""
    return prng.split(prng.split(prng.prng_key(SEED))[1], B)


def _pair(smoke, cfg, feature="orb"):
    jmodels, tmodels = smoke[feature]
    jd = FusedDetector(jmodels, cfg, seed=SEED)
    td = tfused.FusedDetector(
        tmodels, convert.config_from_dict(dataclasses.asdict(cfg)),
        seed=SEED, device="cpu")
    return jd, td


def _stacked_frames(td, smoke):
    frames = [td.prepare_frame(image, depth, smoke["K"])
              for image, depth in smoke["frames"]]
    return frames, [torch.stack(t) for t in zip(*frames)]


def _row(det, b):
    return type(det)(*(x[b] for x in det))


def _same(port, ref, gate, what):
    """The reference's tolerance (module docstring); returns the largest
    R/T gap at the gate."""
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      f"{what} {name}")
    quality = (port.n_inliers + tfused.CLIQUE_WEIGHT
               * port.clique_size).numpy()
    acc = port.accepted.numpy() & (quality >= gate)
    assert acc.any(), f"{what}: nothing accepted at the gate"
    gap = 0.0
    for name in ("R", "T"):
        a, b = getattr(port, name).numpy()[acc], np.asarray(
            getattr(ref, name))[acc]
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL,
                                   err_msg=f"{what} {name}")
        gap = max(gap, float(np.abs(a - b).max(initial=0.0)))
    return gap


def _equal(port, mine):
    """Batched row and per-frame detections, every field bit for bit."""
    for name, a, b in zip(port._fields, port, mine):
        assert torch.equal(a, b), name


def _segmented_case(smoke, feature, cfg, monkeypatch):
    jd, td = _pair(smoke, cfg, feature)
    frames, stacked = _stacked_frames(td, smoke)
    s1, s2, s3 = jd._stages
    refs = [s1(*jd.prepare_frame(image, depth, smoke["K"]))
            for image, depth in smoke["frames"]]
    if feature == "sift":
        # the reference's quantised queries, as test_torch_sift.py hands
        # them (its descriptors differ from the port's in the last bits)
        queue = [tuple(torch.from_numpy(np.array(a)) for a in r)
                 for r in refs]
        monkeypatch.setattr(tfused, "stage_features_compact",
                            lambda *a: queue.pop(0))
    kps, batch = td.detect_batch_raw(*stacked)
    assert kps is None and batch.accepted.shape == (
        B, 6, cfg.guess.ransac.max_instances)
    keys = _keys()
    gap = 0.0
    for b, ref in enumerate(refs):
        dist, rows = s2(ref[2], jd.sdb)
        det_j = s3(jnp.asarray(keys[b]), *ref[:2], ref[3], dist, rows,
                   jd.sdb.points, jd.sdb.obj_start, jd.sdb.spans)
        row = _row(batch, b)
        gap = max(gap, _same(row, det_j, cfg.min_quality,
                             f"{feature} frame {b}"))
        # the port's own per-frame path with keys[b]
        xy, qp, dsc, ok = (torch.from_numpy(np.array(a)) for a in ref)
        d_t, r_t = tfused.match_full(dsc, td.sdb)
        _, det_t = tdet.detect_frame_segmented(
            ThreefryNoise(keys[b], cfg.guess.ransac.max_instances, True,
                          "cpu"), d_t, r_t, ok, qp, xy, td.sdb.points,
            td.sdb.obj_start, td.sdb.spans, td.config.guess,
            td.config.activation, cfg.radius)
        _equal(row, det_t)
    print(f"{feature}: largest R/T gap {gap:.3g}")


def test_batch_orb_segmented(smoke, monkeypatch):
    _segmented_case(smoke, "orb", _segmented(), monkeypatch)


def test_batch_sift_segmented(smoke, monkeypatch):
    _segmented_case(smoke, "sift", _segmented(
        n_features=2000, feature="SIFT", radius=0.9,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                    prescreen=3, active_reserve=1)),
        monkeypatch)


def test_batch_launches_and_state(smoke, monkeypatch):
    """One matcher call a batch and as many noise draws a batch as one
    frame makes (on a card: one B1/B3/B5 launch, one N1 launch a stage);
    the key splits once a batch; coarse->fine detectors run the full sweep
    (rows equal to a full-sweep detector's) and keep their streaming state;
    an empty catalog gives (B, 0, I); a test's noise callback is
    refused."""
    calls = {"match": 0, "noise": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tfused, "match_full",
                        counted("match", tfused.match_full))
    monkeypatch.setattr(tfused, "match_against_db",
                        counted("match", tfused.match_against_db))
    monkeypatch.setattr(prng, "gumbel", counted("noise", prng.gumbel))
    cfg = _segmented()
    _, td = _pair(smoke, cfg)
    frames, stacked = _stacked_frames(td, smoke)
    td.detect_raw(*frames[0])
    per_frame = dict(calls)
    assert per_frame == {"match": 1, "noise": 4}
    td._key = prng.prng_key(SEED)
    _, full = td.detect_batch_raw(*stacked)
    assert calls == {"match": 2, "noise": 8}
    cf = tfused.FusedDetector(
        smoke["orb"][1], dataclasses.replace(
            td.config, coarse_stride=4, fine_width=4, track_width=1,
            explore_width=1), seed=SEED, device="cpu")
    before = {n: getattr(cf, n).clone() for n in ("_age", "_last_R",
                                                   "_last_T")}
    cf._key = prng.prng_key(SEED)
    _, rows_cf = cf.detect_batch_raw(*stacked)
    for name in ("accepted", "n_inliers", "R", "T"):
        assert torch.equal(getattr(rows_cf, name), getattr(full, name)), name
    assert all(torch.equal(getattr(cf, n), t) for n, t in before.items())
    assert cf._explore_pos == 0 and cf._last_coarse_sel is None
    np.testing.assert_array_equal(cf._key,
                                  prng.split(prng.prng_key(SEED))[0])
    for pipeline in ("segmented", "global"):
        empty = tfused.FusedDetector([], dataclasses.replace(
            td.config, pipeline=pipeline), device="cpu")
        _, det = empty.detect_batch_raw(*stacked)
        assert det.accepted.shape == (B, 0, cfg.guess.ransac.max_instances)
    td.noise = lambda stage, shape: None
    with pytest.raises(ValueError, match="noise"):
        td.detect_batch_raw(*stacked)
