"""The port's FusedDetector API in the reference's forms: ``detect_raw``
returns the reference's ``(keypoints, detections)`` pair on the segmented
paths (keypoints None) and for an empty catalog, and ``confidence_v2``
takes the reference's four arguments.

The catalog is the streaming test's (the smoke fixture's three trained
models, every 8th row, with five seeded fillers); one fixture frame goes
through both packages with the reference's RANSAC draws handed to the port.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.models import FusedDetector
from tod_tpu.models import fused as jfused
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.utils.smoke_catalog import smoke_catalog
from test_torch_streaming import SEED, _streaming_config
from torch_parity import JaxReplayNoise, frame_keys

torch.set_num_threads(1)

FULL_SWEEP = dict(coarse_stride=0, fine_width=128, coarse_q_stride=1,
                  track_width=0, explore_width=0)


@pytest.fixture(scope="module")
def catalog():
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    real = [(fx[f"desc{i}"][::8], fx[f"points{i}"][::8]) for i in range(3)]
    ids, arrays = smoke_catalog([str(s) for s in fx["model_ids"]], real,
                                n_objects=8)
    return fx, ids, arrays


def _pair(catalog, cfg, empty=False):
    fx, ids, arrays = catalog
    ids, arrays = ([], []) if empty else (ids, arrays)
    jd = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                        zip(ids, arrays)], cfg, seed=SEED)
    td = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    return jd, td


@pytest.mark.parametrize("path", ["full_sweep", "coarse_fine",
                                  "empty_catalog"])
def test_detect_raw_returns_the_reference_pair(catalog, path):
    fx = catalog[0]
    cfg = _streaming_config()
    if path != "coarse_fine":
        cfg = dataclasses.replace(cfg, **FULL_SWEEP)
    jd, td = _pair(catalog, cfg, empty=path == "empty_catalog")
    td.noise = JaxReplayNoise(frame_keys(SEED, 1)[0],
                              cfg.guess.ransac.max_instances)
    kps_j, det_j = jd.detect_raw(fx["images"][0], fx["depths"][0], fx["K"])
    raw = td.detect_raw(fx["images"][0], fx["depths"][0], fx["K"])
    assert isinstance(raw, tuple) and len(raw) == 2
    kps_t, det_t = raw
    assert kps_j is None and kps_t is None
    assert type(det_t).__name__ == "ObjectDetections"
    n_obj = 0 if path == "empty_catalog" else len(td.object_ids)
    assert det_t.accepted.shape == (n_obj, cfg.guess.ransac.max_instances)
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)), name)
    # poses at the quality gate (junk accepts below it are ill-conditioned
    # refits that move by up to ~1e-2 with the summation order)
    ref = td.poses(tran.ObjectDetections(
        *(torch.from_numpy(np.array(a)) for a in det_j)))
    port = td.poses(det_t)
    key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
    assert sorted(map(key, port)) == sorted(map(key, ref))
    for r_t in port:
        r_j = next(r for r in ref if key(r) == key(r_t))
        np.testing.assert_allclose(r_t.R, r_j.R, atol=1e-5)
        np.testing.assert_allclose(r_t.T, r_j.T, atol=1e-5)
        assert r_t.quality == r_j.quality
    assert len(port) >= (0 if path == "empty_catalog" else 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_confidence_v2_takes_the_reference_arguments(seed):
    rng = np.random.default_rng(seed)
    for _ in range(16):
        args = (float(rng.integers(0, 600)), float(rng.random() * 0.02),
                int(rng.integers(0, 20)), float(rng.random() * 0.01))
        assert tfused.confidence_v2(*args) == jfused.confidence_v2(*args)
        assert tfused.confidence_v2(*args) == jfused.confidence_v2(
            args[0], 0.0, args[2], 0.0)
