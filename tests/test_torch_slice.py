"""The segmented ORB serving slice as a whole: tod_tpu_torch against tod_tpu.

Two objects are trained with the reference's TodTrainer (as test_e2e.py
does) and joined by two seeded filler objects (tod_tpu_torch.utils.
smoke_catalog), so that the prescreen and the activation cut have work.
Both FusedDetectors then see the same frame on the CPU: the port's
compaction and matcher outputs must equal the reference's, and with the
reference's RANSAC draws handed to the port both must accept the same
objects at poses within 1 cm and 2 degrees of each other and of the ground
truth.
"""

import dataclasses
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu.models.fused import bucketed_scores as jax_bucketed_scores
from tod_tpu.utils.synthetic import DEFAULT_K
from tod_tpu_torch import convert
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops.segmented import object_top1
from tod_tpu_torch.types import TodModel
from torch_parity import (WORLD_IDS as OBJECT_IDS, JaxReplayNoise,
                          build_world, frame_keys, pose_errors)

torch.set_num_threads(1)

SEED = 3


def _config():
    """A small cut of the bench's operating point (bench.py build_config):
    segmented ORB, bucketed compaction, prescreen, three instance rounds
    with lean continuations, the tight final fit and the quality gate."""
    return FusedDetectorConfig(
        n_features=1500, pipeline="segmented", q_cap=1024,
        bucket_grid=(6, 8), radius=50.0, k_matches=8,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                    prescreen=3),
        guess=GuessConfig(
            ransac=RansacConfig(n_hypotheses=256, continuation_hypotheses=64,
                                min_inliers=8, max_instances=3,
                                tight_final_fit=True),
            max_matches_per_object=256, max_active_objects=3),
        min_quality=100.0)


@pytest.fixture(scope="module")
def world():
    w = build_world("torch_slice")
    ids, arrays = w["ids"], w["arrays"]
    cfg = _config()
    jdet = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                          zip(ids, arrays)], cfg, seed=SEED)
    tdet = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    return dict(w, cfg=cfg, jdet=jdet, tdet=tdet)


def _stage1(world):
    gray, depth, K = world["jdet"].prepare_frame(world["image"],
                                                 world["depth"], DEFAULT_K)
    s1, s2, _ = world["jdet"]._stages
    ref = s1(gray, depth, K)
    tgray, tdepth, tK = world["tdet"].prepare_frame(world["image"],
                                                    world["depth"], DEFAULT_K)
    port = tfused.stage_features_compact(tgray, tdepth, tK,
                                         world["tdet"].config)
    return ref, port, s2


def test_compaction_matches(world):
    (xy, qp, dsc, ok), port, _ = _stage1(world)
    for name, a, b in (("xy", xy, port[0]), ("qp", qp, port[1]),
                       ("dsc", dsc, port[2]), ("ok", ok, port[3])):
        # equal keypoints, descriptors and back-projected points (NaN
        # where invalid, in the same slots)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert int(port[3].sum()) > 500


def test_matcher_outputs_match(world):
    (_, _, dsc, _), port, s2 = _stage1(world)
    d_j, r_j = s2(dsc, world["jdet"].sdb)
    d_t, r_t = object_top1(port[2], world["tdet"].sdb)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))


def test_bucketed_scores_match():
    rng = np.random.default_rng(9)
    n = 400
    xy = rng.integers(0, 160, (n, 2)).astype(np.float32) * 4.0
    resp = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
    finite = rng.random(n) < 0.9
    s_j = jax_bucketed_scores(jnp.asarray(xy), jnp.asarray(resp),
                              jnp.asarray(finite), (480, 640), (6, 8))
    s_t = tfused.bucketed_scores(torch.from_numpy(xy), torch.from_numpy(resp),
                                 torch.from_numpy(finite), (480, 640), (6, 8))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_detectors_accept_the_same_poses(world):
    jdet, tdet = world["jdet"], world["tdet"]
    # the port replays the reference's draws for the reference's first
    # frame key (FusedDetector(seed=SEED) splits its key once per frame)
    tdet.noise = JaxReplayNoise(frame_keys(SEED, 1)[0],
                                world["cfg"].guess.ransac.max_instances)
    jdet._key = jax.random.PRNGKey(SEED)
    ref = jdet.detect(world["image"], world["depth"], DEFAULT_K)
    port = tdet.detect(world["image"], world["depth"], DEFAULT_K)
    assert sorted(r.object_id for r in port) == \
        sorted(r.object_id for r in ref)
    assert {r.object_id for r in port} == set(OBJECT_IDS)
    for r_t in port:
        r_j = next(r for r in ref if r.object_id == r_t.object_id
                   and r.confidence == r_t.confidence)
        assert r_t.clique_size == r_j.clique_size
        dt, ang = pose_errors(r_t.R, r_t.T, r_j.R, r_j.T)
        assert dt < 0.01 and ang < 2.0, (r_t.object_id, dt, ang)
        gt_R, gt_T = world["poses"][OBJECT_IDS.index(r_t.object_id)]
        dt, ang = pose_errors(r_t.R, r_t.T, gt_R, gt_T)
        assert dt < 0.01 and ang < 2.0, (r_t.object_id, dt, ang)


def test_config_round_trip_and_unported_paths(world):
    cfg = world["cfg"]
    port_cfg = convert.config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    models = [TodModel("a", np.zeros((4, 32), np.uint8),
                       np.zeros((4, 3), np.float32))]
    # sub-pixel keypoints are ported (test_torch_subpixel.py)
    sub = tfused.FusedDetector(models, dataclasses.replace(port_cfg,
                                                           subpixel=True),
                               device="cpu")
    assert sub.detect_raw(world["image"], world["depth"],
                          DEFAULT_K)[1].accepted.shape == (
                              1, cfg.guess.ransac.max_instances)
    # the global-kNN path is ported (test_torch_global.py): it runs
    glob = tfused.FusedDetector(models, dataclasses.replace(
        port_cfg, pipeline="global"), device="cpu")
    kps, det = glob.detect_raw(world["image"], world["depth"], DEFAULT_K)
    assert kps.xy.shape == (cfg.n_features, 2)
    assert det.accepted.shape == (1, cfg.guess.ransac.max_instances)
    # SIFT is ported (test_torch_sift.py), on the segmented pipeline only,
    # as in the reference
    tfused.FusedDetector(models[:0], dataclasses.replace(
        port_cfg, feature="SIFT"), device="cpu")
    with pytest.raises(ValueError, match="segmented"):
        tfused.FusedDetector(models, dataclasses.replace(
            port_cfg, feature="SIFT", pipeline="global"), device="cpu")
    # coarse->fine is ported; reserved slots without it, or leaving no
    # coarse slot, are refused as the reference refuses them
    for change in (dict(coarse_stride=8), dict(coarse_stride=8, track_width=4,
                                               explore_width=4)):
        assert tfused.FusedDetector(models, dataclasses.replace(
            port_cfg, **change), device="cpu").cdb.rows_host == (1,)
    for change in (dict(track_width=4), dict(explore_width=4),
                   dict(coarse_stride=8, fine_width=8, track_width=4,
                        explore_width=4)):
        with pytest.raises(ValueError, match="coarse"):
            tfused.FusedDetector(models, dataclasses.replace(port_cfg,
                                                             **change),
                                 device="cpu")
    # hot catalog updates and batched detection are ported
    # (test_torch_update_models.py, test_torch_batch.py)
    det = tfused.FusedDetector(models, port_cfg, device="cpu")
    words = det.sdb.words
    det.update_models(models)
    assert det.sdb.words is words and det.object_ids == ["a"]
    frame = det.prepare_frame(world["image"], world["depth"], DEFAULT_K)
    kps, raw = det.detect_batch_raw(*(t[None] for t in frame))
    assert kps is None and raw.accepted.shape == (
        1, 1, cfg.guess.ransac.max_instances)
    assert tfused.FusedDetector([], port_cfg, device="cpu").detect(
        world["image"], world["depth"], DEFAULT_K) == []
    # catalog capacity pads with empty slots the reference packs alike
    cap = dataclasses.replace(port_cfg, catalog_capacity=3, reserve_rows=64)
    padded = tfused.FusedDetector(models, cap, device="cpu")
    assert padded.object_ids == ["a", "", ""]
    assert padded.sdb.rows_host == (4, 0, 0)
    assert padded.sdb.starts_host == (0, 4096, 8192)


def _keypoints(xy, qp, dsc, ok):
    """Multiset of a compaction's valid keypoints, each as its xy, 3D
    point and descriptor bytes."""
    return Counter(a.tobytes() + b.tobytes() + c.tobytes()
                   for a, b, c in zip(xy[ok], qp[ok], dsc[ok]))


@pytest.mark.parametrize("frame", [0, 1])
def test_fixture_compaction_at_bench_operating_point(frame):
    """The full-size frames of the smoke fixture at the bench's operating
    point (640x480, 5000 features, q_cap 2048, 6x8 buckets) against the
    compiled reference's stored compaction outputs."""
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    cfg = convert.config_from_dict(json.loads(str(fx["config_json"])))
    det = tfused.FusedDetector([], cfg, device="cpu")
    out = [t.numpy() for t in tfused.stage_features_compact(
        *det.prepare_frame(fx["images"][frame], fx["depths"][frame],
                           fx["K"]), cfg)]
    ref = [fx[k][frame] for k in ("ref_xy", "ref_qp", "ref_dsc", "ref_ok")]
    assert int(out[3].sum()) == int(ref[3].sum()) == 2048
    # Every reference keypoint reproduced bit for bit (xy, 3D point,
    # descriptor); chip_smoke.py holds the card to the same. (Before the
    # resize summed in the compiled reference's order, one level-1 pixel
    # of frame 1 rounded 1.5e-5 apart and swapped a keypoint.)
    missing = sum((_keypoints(*ref) - _keypoints(*out)).values())
    assert missing == 0
