"""The global-kNN ORB serving path as a whole: tod_tpu_torch against tod_tpu.

The world of test_torch_slice.py (two objects trained with the reference's
TodTrainer and two seeded fillers, one frame) is served by both
FusedDetectors with ``pipeline="global"`` on the CPU: all keypoints and
descriptors, the matcher's radius-cut top-k (the port's twin of kernel B5
against the reference's XLA matcher), the active set and the per-object
clusters must be equal, and with the reference's RANSAC draws handed to the
port both must accept the same objects at poses within 1e-5 of each other
and within 1 cm and 2 degrees of the ground truth. Unit tests hold
``cluster_matches`` and ``detect_frame_from_matches`` on synthetic matches
with ties, fewer flat matches than the per-object capacity and a catalog
smaller than the active set.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry import detection as jdet
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu.models import fused as jfused
from tod_tpu.utils.synthetic import DEFAULT_K
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import hamming as tham
from torch_parity import (WORLD_IDS, JaxReplayNoiseGlobal, build_world,
                          frame_keys, pose_errors)

torch.set_num_threads(1)

SEED = 4
FIELDS = ("query_pts", "train_pts", "query_idx", "query_xy", "valid")


def _config():
    """The bench's global-kNN operating point (bench.py build_config under
    BENCH_PIPELINE=global: k 8, radius 50) cut to the small world: 1500
    features, a 2048-row DB chunk, 512 hypotheses over three instance
    rounds, 512 matches an object and 3 active objects of the 4, gated at
    quality 150 (the reference's accepts of both objects here reach 224
    and 251 within 1.6 degrees; its junk stays below 130)."""
    return FusedDetectorConfig(
        n_features=1500, pipeline="global", db_chunk=2048, k_matches=8,
        radius=50.0,
        guess=jdet.GuessConfig(
            ransac=RansacConfig(n_hypotheses=512, min_inliers=8,
                                sensor_error=0.01, max_instances=3),
            max_matches_per_object=512, max_active_objects=3),
        min_quality=150.0)


@pytest.fixture(scope="module")
def world():
    w = build_world("torch_global")
    ids, arrays = w["ids"], w["arrays"]
    cfg = _config()
    jdet_ = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                           zip(ids, arrays)], cfg, seed=SEED)
    tdet_ = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    gray, depth, K = jdet_.prepare_frame(w["image"], w["depth"], DEFAULT_K)
    s1, s2, _ = jdet_._stages
    kps, desc, qp = s1(gray, depth, K)
    dist, rows = s2(desc, jdet_.db)
    port = tfused.stage_features(*tdet_.prepare_frame(
        w["image"], w["depth"], DEFAULT_K), tdet_.config)
    return dict(w, cfg=cfg, jdet=jdet_, tdet=tdet_,
                ref=(kps, desc, qp, dist, rows), port=port)


def _np(x):
    return np.asarray(x)


def test_keypoints_descriptors_and_matches(world):
    kps, desc, qp, dist, rows = world["ref"]
    t_kps, t_desc, t_qp = world["port"]
    for name, a, b in (("xy", kps.xy, t_kps.xy), ("valid", kps.valid,
                                                  t_kps.valid),
                       ("desc", desc, t_desc), ("qp", qp, t_qp)):
        np.testing.assert_array_equal(b.numpy(), _np(a), name)
    assert t_kps.xy.shape[0] == world["cfg"].n_features
    assert int(t_kps.valid.sum()) > 500
    d_t, r_t = tfused.match_against_db(t_desc, world["tdet"].db,
                                       world["tdet"].config)
    # the reference's XLA matcher after the radius cut, as B5 returns it
    within = (_np(rows) >= 0) & (_np(dist) <= world["cfg"].radius)
    np.testing.assert_array_equal(d_t.numpy(),
                                  np.where(within, _np(dist), 1e9))
    np.testing.assert_array_equal(r_t.numpy(), np.where(within, _np(rows),
                                                        -1))
    assert within.sum() > 1000


def _jax_active(obj_idx, valid, qp, n_objects, n_active):
    """The reference's active set, as detect_frame_from_matches forms it
    (tod_tpu/geometry/detection.py:162-172)."""
    if n_active >= n_objects:
        return np.arange(n_objects, dtype=np.int32)
    v = valid & jnp.isfinite(qp).all(-1)[:, None]
    counts = jnp.zeros(n_objects, jnp.int32).at[
        jnp.maximum(obj_idx, 0).reshape(-1)].add(v.reshape(-1).astype(
            jnp.int32))
    top, act = jax.lax.top_k(counts, n_active)
    return _np(jnp.where(top > 0, act, -1))


def test_active_set_and_clusters(world):
    kps, desc, qp, dist, rows = world["ref"]
    cfg, db = world["cfg"], world["jdet"].db
    m_valid = (rows >= 0) & (dist <= cfg.radius) & kps.valid[:, None]
    safe = jnp.maximum(rows, 0)
    obj = jnp.where(m_valid, db.obj_of_row[safe], -1)
    n_obj = len(world["ids"])
    active = _jax_active(obj, m_valid, qp, n_obj,
                         cfg.guess.max_active_objects)
    ref = jdet.cluster_matches(obj, dist, m_valid, db.points[safe], qp,
                               kps.xy, jnp.asarray(active),
                               cfg.guess.max_matches_per_object)
    t_kps, _, t_qp = world["port"]
    d_t, r_t = tfused.match_against_db(world["port"][1], world["tdet"].db,
                                       world["tdet"].config)
    t_obj, t_valid, t_train = tfused.flat_matches(
        t_kps.valid, d_t, r_t, tfused.geom_db(world["tdet"].db), cfg.radius)
    t_active = tdet.active_objects(t_obj, t_valid, t_qp, n_obj,
                                   cfg.guess.max_active_objects)
    np.testing.assert_array_equal(t_active.numpy(), active)
    assert sorted(active[:2].tolist()) == [0, 1]       # the trained objects
    port = tdet.cluster_matches(t_obj, d_t, t_valid, t_train, t_qp,
                                t_kps.xy, t_active,
                                cfg.guess.max_matches_per_object)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      _np(getattr(ref, name)), name)
    assert int(port.valid.sum()) > 200


def test_detectors_accept_the_same_poses(world):
    jdet_, tdet_ = world["jdet"], world["tdet"]
    tdet_.noise = JaxReplayNoiseGlobal(frame_keys(SEED, 1)[0],
                                       world["cfg"].guess.ransac.max_instances)
    jdet_._key = jax.random.PRNGKey(SEED)
    ref = jdet_.detect(world["image"], world["depth"], DEFAULT_K)
    port = tdet_.detect(world["image"], world["depth"], DEFAULT_K)
    assert sorted((r.object_id, r.confidence, r.clique_size) for r in port) \
        == sorted((r.object_id, r.confidence, r.clique_size) for r in ref)
    assert {r.object_id for r in port} == set(WORLD_IDS)
    for r_t in port:
        r_j = next(r for r in ref if r.object_id == r_t.object_id
                   and r.confidence == r_t.confidence)
        np.testing.assert_allclose(r_t.R, r_j.R, atol=1e-5)
        np.testing.assert_allclose(r_t.T, r_j.T, atol=1e-5)
        gt_R, gt_T = world["poses"][WORLD_IDS.index(r_t.object_id)]
        dt, ang = pose_errors(r_t.R, r_t.T, gt_R, gt_T)
        assert dt < 0.01 and ang < 2.0, (r_t.object_id, dt, ang)


def test_detectors_accept_the_same_poses_with_own_noise(world):
    """As above with nothing injected: the port's detector draws its own
    threefry noise from the reference's key path (utils/prng.py)."""
    from tod_tpu_torch.utils import prng

    jdet_, tdet_ = world["jdet"], world["tdet"]
    tdet_.noise = None
    tdet_._key = prng.prng_key(SEED)
    jdet_._key = jax.random.PRNGKey(SEED)
    ref = jdet_.detect(world["image"], world["depth"], DEFAULT_K)
    port = tdet_.detect(world["image"], world["depth"], DEFAULT_K)
    np.testing.assert_array_equal(tdet_._key, np.asarray(jdet_._key))
    assert sorted((r.object_id, r.confidence, r.clique_size) for r in port) \
        == sorted((r.object_id, r.confidence, r.clique_size) for r in ref)
    assert {r.object_id for r in port} == set(WORLD_IDS)
    for r_t in port:
        r_j = next(r for r in ref if r.object_id == r_t.object_id
                   and r.confidence == r_t.confidence)
        np.testing.assert_allclose(r_t.R, r_j.R, atol=1e-5)
        np.testing.assert_allclose(r_t.T, r_j.T, atol=1e-5)


def test_pack_models_and_conversion(world):
    models = convert.models_from_numpy(world["ids"],
                                       [d for d, _ in world["arrays"]],
                                       [p for _, p in world["arrays"]])
    jdb = world["jdet"].db
    tdb, ids = tfused.pack_models(models, 2048, device="cpu")
    assert ids == world["ids"] == world["jdet"].object_ids
    arrays = {name: _np(getattr(jdb, name)) for name in
              ("descriptors", "points", "obj_of_row", "n_valid", "spans")}
    for got in (tdb, convert.model_db_from_jax(arrays, device="cpu")):
        for name in ("descriptors", "points", "obj_of_row", "spans"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          arrays[name], name)
        assert got.n_valid == int(arrays["n_valid"])
        assert got.words.dtype == torch.int32 and got.words.shape[1] == 8
    empty, ids = tfused.pack_models([], 2048, device="cpu")
    jempty, _ = jfused.pack_models([], 2048)
    assert ids == [] and empty.words.shape == (0, 8) and empty.n_valid == 0
    assert tuple(jempty.descriptors.shape) == (0, 32)
    for name in ("descriptors", "points", "obj_of_row", "spans"):
        assert getattr(empty, name).shape == getattr(jempty, name).shape


def test_empty_catalog_and_refusals(world):
    cfg = world["tdet"].config
    det = tfused.FusedDetector([], cfg, device="cpu")
    kps, raw = det.detect_raw(world["image"], world["depth"], DEFAULT_K)
    assert kps.xy.shape == (cfg.n_features, 2)
    assert raw.accepted.shape == (0, cfg.guess.ransac.max_instances)
    assert det.detect(world["image"], world["depth"], DEFAULT_K) == []
    d, r = tfused.match_against_db(torch.zeros((7, 32), dtype=torch.uint8),
                                   det.db, cfg)
    assert (d == 1e9).all() and (r == -1).all() and d.shape == (7, 8)
    with pytest.raises(ValueError, match="segmented"):
        world["tdet"].update_models([])
    # batched detection of an empty catalog: batched keypoints, (B, 0, I)
    frame = det.prepare_frame(world["image"], world["depth"], DEFAULT_K)
    kps_b, raw_b = det.detect_batch_raw(*(torch.stack([t, t])
                                          for t in frame))
    assert kps_b.xy.shape == (2, cfg.n_features, 2)
    assert torch.equal(kps_b.xy[1], kps.xy)
    assert raw_b.accepted.shape == (2, 0, cfg.guess.ransac.max_instances)
    # the config round trip and the defaults: FusedDetector(models) serves
    # the global path on the card
    round_trip = convert.config_from_dict(dataclasses.asdict(world["cfg"]))
    assert dataclasses.asdict(round_trip) == dataclasses.asdict(world["cfg"])
    assert tfused.FusedDetectorConfig().pipeline == "global"
    assert inspect.signature(tfused.FusedDetector).parameters[
        "device"].default == "cuda"
    before = tham.hamming_topk_fused.launches
    for matcher in ("auto", "pallas", "xla"):   # selects nothing here
        tfused.match_against_db(torch.zeros((3, 32), dtype=torch.uint8),
                                world["tdet"].db,
                                dataclasses.replace(cfg, matcher=matcher))
    assert tham.hamming_topk_fused.launches == before


# ---- cluster_matches and detect_frame_from_matches on synthetic matches ---


def _flat(seed, n_q=120, k=3, n_obj=5):
    """Flat (Q, k) matches of a frame: integer distances (ties), object 1
    truly present at rank 0 of the first 60 queries (1 mm noise), the rest
    spread over all objects, a few invalid matches and NaN query points."""
    rng = np.random.default_rng(seed)
    dist = np.sort(rng.integers(0, 40, (n_q, k)), 1).astype(np.float32)
    obj = rng.integers(0, n_obj, (n_q, k)).astype(np.int32)
    train = rng.uniform(-0.1, 0.1, (n_q, k, 3)).astype(np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    T = np.array([0.02, -0.01, 0.8])
    qp = (T + rng.uniform(-0.12, 0.12, (n_q, 3))).astype(np.float32)
    obj[:60, 0] = 1
    dist[:60, 0] = rng.integers(0, 3, 60)
    qp[:60] = train[:60, 0] @ R.T + T + rng.normal(0, 1e-3, (60, 3))
    qp[rng.random(n_q) < 0.05] = np.nan
    valid = (dist <= 35) & (rng.random((n_q, k)) < 0.95)
    obj = np.where(valid, obj, -1).astype(np.int32)
    xy = (qp[:, :2] / qp[:, 2:] * 570.0 + [320.0, 240.0]).astype(np.float32)
    xy = np.nan_to_num(xy)
    spans = np.full(n_obj, 0.3, np.float32)
    return obj, dist, valid, train, qp.astype(np.float32), xy, spans


@pytest.mark.parametrize("n_obj, cap, ids", [
    (5, 128, [1, 3, -1, 0]),       # capacity below the flat matches; a hole
    (5, 512, [4, 1, 2, 0, 3]),     # more capacity than the 360 flat matches
    (2, 256, [0, 1])])
def test_cluster_matches_match(n_obj, cap, ids):
    obj, dist, valid, train, qp, xy, _ = _flat(n_obj, n_obj=n_obj)
    args = (obj, dist, valid, train, qp, xy, np.asarray(ids, np.int32))
    ref = jdet.cluster_matches(*(jnp.asarray(a) for a in args), cap)
    port = tdet.cluster_matches(*(torch.from_numpy(a) for a in args), cap)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      _np(getattr(ref, name)), name)
    assert port.valid.shape == (len(ids), cap)


@pytest.mark.parametrize("n_obj, n_active, cap", [
    (5, 3, 128), (5, 3, 512), (2, 3, 256), (6, 6, 256)])
def test_detect_frame_from_matches_with_injected_noise(n_obj, n_active, cap):
    """The active set by match count (ties to the lower index), clusters
    and the instance rounds on the reference's draws; a catalog smaller
    than the active set runs every object."""
    obj, dist, valid, train, qp, xy, spans = _flat(10 + n_obj, n_obj=n_obj)
    base = dict(n_hypotheses=128, min_inliers=6, sensor_error=0.01,
                max_instances=2)
    guess = dict(max_matches_per_object=cap, max_active_objects=n_active)
    key = jax.random.PRNGKey(n_obj + cap)
    args = (obj, dist, valid, train, qp, xy, spans)
    c_j, det_j = jdet.detect_frame_from_matches(
        key, *(jnp.asarray(a) for a in args),
        jdet.GuessConfig(ransac=RansacConfig(**base), **guess))
    c_t, det_t = tdet.detect_frame_from_matches(
        JaxReplayNoiseGlobal(key, base["max_instances"]),
        *(torch.from_numpy(a) for a in args),
        tdet.GuessConfig(ransac=tran.RansacConfig(**base), **guess))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(c_t, name).numpy(),
                                      _np(getattr(c_j, name)), name)
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      _np(getattr(det_j, name)), name)
    # poses of the true accepts (the planted object's 60 matches); junk
    # accepts of 6-15 inliers refit over near-degenerate sets, where the
    # two packages' f32 sums part by ~1e-3
    true = (det_t.accepted & (det_t.n_inliers >= 20)).numpy()
    np.testing.assert_allclose(det_t.R.numpy()[true], _np(det_j.R)[true],
                               atol=1e-5)
    np.testing.assert_allclose(det_t.T.numpy()[true], _np(det_j.T)[true],
                               atol=1e-5)
    assert det_t.accepted.shape == (n_obj, 2) and true[1, 0]
    act = tdet.active_objects(*(torch.from_numpy(a) for a in
                                (obj, valid, qp)), n_obj,
                              min(n_active, n_obj))
    act_j = _jax_active(jnp.asarray(obj), jnp.asarray(valid),
                        jnp.asarray(qp), n_obj, min(n_active, n_obj))
    np.testing.assert_array_equal(act.numpy(), act_j)
