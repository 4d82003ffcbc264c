"""Coarse->fine streaming serving: tod_tpu_torch against tod_tpu.

Seeded RANSAC, the gathered frame detection with forced slots and seeds,
and the streaming FusedDetector as a whole, each with the reference's own
RANSAC draws handed to the port (torch_parity): counts, accepts and clique
sizes must be equal, poses within 1e-5 (refits in f32 over the same
inliers round alike up to summation order).

The streaming run uses the smoke fixture's three trained models, every 8th
row kept so that it runs in seconds, with five seeded fillers, over four
fixture frames (0, 1, 0, 1) at the bench's feature operating point, whose
compaction outputs the port reproduces bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry import detection as jdet
from tod_tpu.geometry import ransac as jran
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import adjacency as tadj
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import segmented as tseg
from tod_tpu_torch.utils.smoke_catalog import smoke_catalog
from test_torch_geometry import (_frame_matches, _graphs, _jm, _matches,
                                 _pose_close, _ransac_cfg, _t, _tm)
from torch_parity import JaxReplayNoise, frame_keys, gumbel_batch

torch.set_num_threads(1)

SEED = 5


def _port_graphs(g):
    return tadj.AdjacencyGraphs(_t(g.physical)[None], _t(g.sample)[None],
                                _t(g.valid)[None])


def _seed(R, T, ok):
    """The same seed for both packages (output convention)."""
    R, T = np.asarray(R, np.float32), np.asarray(T, np.float32)
    return (jran.SeedPose(jnp.asarray(R), jnp.asarray(T), jnp.asarray(ok)),
            tran.SeedPose(_t(R)[None], _t(T)[None], _t(np.array([ok]))))


def _round_equal(r_t, r_j):
    assert bool(r_t.found[0]) == bool(r_j.found)
    np.testing.assert_array_equal(r_t.inliers[0].numpy(),
                                  np.asarray(r_j.inliers))
    assert int(r_t.n_unique[0]) == int(r_j.n_unique)
    assert int(r_t.clique_size[0]) == int(r_j.clique_size)
    _pose_close(r_t.R[0].numpy(), r_t.T[0].numpy(), np.asarray(r_j.R),
                np.asarray(r_j.T))


@pytest.mark.parametrize("seed_kind", ["true", "off", "wrong"])
def test_seeded_ransac_with_injected_noise(seed_kind):
    """A seed at the true pose (slightly off), a disabled seed (results
    identical to no seed, bit for bit) and a wrong seed, each through one
    round and through the three-round instance loop."""
    d, g = _graphs(2)
    rng = np.random.default_rng(3)
    _, R, T = _matches(2)
    if seed_kind == "wrong":
        R, T = np.eye(3), np.array([0.3, 0.1, 0.5])
    seed_j, seed_t = _seed(R @ _small_rotation(rng), T + 0.002,
                           seed_kind != "off")
    cfg_j, cfg_t = _ransac_cfg()
    key = jax.random.PRNGKey(31)
    tg = _port_graphs(g)
    noise = gumbel_batch([key], 256, 64)
    r_j = jran.ransac_round(key, _jm(d), g, g.valid, cfg_j, seed_j)
    r_t = tran.ransac_round(noise, _tm([d]), tg, tg.valid, cfg_t, seed_t)
    _round_equal(r_t, r_j)
    if seed_kind == "off":
        plain = tran.ransac_round(noise, _tm([d]), tg, tg.valid, cfg_t)
        for a, b in zip(r_t, plain):
            assert torch.equal(a, b)
    keys = jax.random.split(jax.random.PRNGKey(32), 3)
    det_j = jran.detect_object_instances(keys[0], _jm(d), g, cfg_j, seed_j)
    inst_keys = jax.random.split(keys[0], 3)
    gumbels = [gumbel_batch([k], cfg_t.round_hypotheses(i), 64)
               for i, k in enumerate(inst_keys)]
    det_t = tran.detect_object_instances(gumbels, _tm([d]), tg, cfg_t,
                                         seed_t)
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name)[0].numpy(),
                                      np.asarray(getattr(det_j, name)))
    _pose_close(det_t.R[0].numpy(), det_t.T[0].numpy(), np.asarray(det_j.R),
                np.asarray(det_j.T))
    assert bool(det_t.accepted[0, 0])


def _small_rotation(rng, deg=1.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.radians(deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k


def test_detect_frame_gathered_with_injected_noise():
    """A 6-slot slab over an 8-object catalog: holes, object 2 present,
    reserved slots bypassing a 2-wide prescreen (n_forced widens it), a
    tracked slot bypassing the activation cut, and seeds on the full
    object axis (one at object 2's pose, one disabled by its slot)."""
    dist, rows, q_valid, q_pts, xy, points, obj_start, spans = \
        _frame_matches(6, n_obj=8)
    sel = np.array([2, 5, -1, 0, 7, 3], np.int32)
    hole = sel < 0
    d_slab = np.where(hole[None], tseg.HOLE_DIST,
                      dist[:, np.maximum(sel, 0)]).astype(np.float32)
    r_slab = np.where(hole[None], tseg.HOLE_ROW,
                      rows[:, np.maximum(sel, 0)]).astype(np.int32)
    force = np.array([False, True, False, True, True, False])
    force_act = np.array([False, True, False, False, False, False])
    rng = np.random.default_rng(8)
    seed_R = rng.normal(size=(8, 3, 3)).astype(np.float32)
    seed_T = rng.normal(size=(8, 3)).astype(np.float32)
    seed_ok = np.array([1, 0, 1, 0, 0, 1, 0, 1], bool)
    cfg_j, cfg_t = _ransac_cfg()
    guess = dict(max_matches_per_object=128, max_active_objects=3)
    act = dict(m_cap=96, n_hypotheses=64, prescreen=2, active_reserve=1)
    key = jax.random.PRNGKey(43)
    args = (d_slab, r_slab, sel, q_valid, q_pts, xy, points, obj_start, spans)
    s_j, det_j = jdet.detect_frame_gathered(
        key, *(jnp.asarray(a) for a in args),
        jdet.GuessConfig(ransac=cfg_j, **guess),
        jdet.ActivationConfig(**act), 50.0, jnp.asarray(force), 3,
        jnp.asarray(force_act),
        jran.SeedPose(jnp.asarray(seed_R), jnp.asarray(seed_T),
                      jnp.asarray(seed_ok)))
    s_t, det_t = tdet.detect_frame_gathered(
        JaxReplayNoise(key, 3), *(_t(a) for a in args),
        tdet.GuessConfig(ransac=cfg_t, **guess),
        tdet.ActivationConfig(**act), 50.0, _t(force), 3, _t(force_act),
        tran.SeedPose(_t(seed_R), _t(seed_T), _t(seed_ok)))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)))
    _pose_close(det_t.R.numpy(), det_t.T.numpy(), np.asarray(det_j.R),
                np.asarray(det_j.T))
    assert det_t.accepted[2, 0] and not det_t.accepted[[1, 4, 6]].any()
    print("scores", s_t.tolist(), "accepted", det_t.accepted.any(1).tolist())


# ---- the streaming slice as a whole --------------------------------------

N_FRAMES = 4


def _streaming_config():
    """The frontier recipe (docs/SERVING.md) cut to a small catalog:
    coarse stride 4, a 6-slot slab of 2 coarse + 2 tracked + 2 exploration
    slots, a 1-wide prescreen (so the forced slots widen it), an activation
    cut of 3 with a reserve of 1."""
    from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
    from tod_tpu.geometry.ransac import RansacConfig
    return FusedDetectorConfig(
        n_features=5000, pipeline="segmented", q_cap=2048, bucket_grid=(6, 8),
        radius=50.0, k_matches=8, coarse_stride=4, fine_width=6,
        coarse_q_stride=2, track_width=2, explore_width=2, track_ttl=2,
        track_min_confidence=16.0,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128,
                                    prescreen=1, active_reserve=1),
        guess=GuessConfig(
            ransac=RansacConfig(n_hypotheses=256, continuation_hypotheses=64,
                                min_inliers=8, max_instances=3,
                                tight_final_fit=True),
            max_matches_per_object=256, max_active_objects=3),
        min_quality=100.0)


@pytest.fixture(scope="module")
def stream():
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    real = [(fx[f"desc{i}"][::8], fx[f"points{i}"][::8]) for i in range(3)]
    ids, arrays = smoke_catalog([str(s) for s in fx["model_ids"]], real,
                                n_objects=8)
    cfg = _streaming_config()
    jdet_ = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                           zip(ids, arrays)], cfg, seed=SEED)
    slabs = []
    c1, c2, c3 = jdet_._coarse

    def recording_c1(*a):
        out = c1(*a)
        slabs.append(out)
        return out

    jdet_._coarse = (recording_c1, c2, c3)
    tdet_ = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    frames = [(fx["images"][f % 2], fx["depths"][f % 2]) for f in
              range(N_FRAMES)]
    return dict(fx=fx, cfg=cfg, jdet=jdet_, tdet=tdet_, slabs=slabs,
                frames=frames, keys=frame_keys(SEED, N_FRAMES))


def test_streaming_detector_matches_reference(stream):
    jd, td, fx = stream["jdet"], stream["tdet"], stream["fx"]
    cfg = stream["cfg"]
    # the reference's coarse DB converts one to one into the port's
    got = convert.segmented_db_from_jax(
        {k: np.asarray(v) for k, v in jd.cdb._asdict().items()}, "cpu")
    for name in ("words", "obj_start", "n_rows"):
        assert torch.equal(getattr(got, name), getattr(td.cdb, name)), name
    confident = np.zeros(len(jd.object_ids), bool)
    n_acc = 0
    for f, (image, depth) in enumerate(stream["frames"]):
        td.noise = JaxReplayNoise(stream["keys"][f],
                                  cfg.guess.ransac.max_instances)
        _, det_j = jd.detect_raw(image, depth, fx["K"])
        _, det_t = td.detect_raw(image, depth, fx["K"])
        for name, a, b in zip(("sel", "force", "force_act"),
                              stream["slabs"][f], td.slab):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          f"frame {f} {name}")
        for name in ("accepted", "n_inliers", "clique_size"):
            np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                          np.asarray(getattr(det_j, name)),
                                          f"frame {f} {name}")
        np.testing.assert_array_equal(td._age.numpy(), np.asarray(jd._age),
                                      f"frame {f} age")
        assert td._explore_pos == jd._explore_pos
        np.testing.assert_array_equal(td._last_coarse_sel.numpy(),
                                      np.asarray(jd._last_coarse_sel))
        # the gated detections (both gated alike, on the host)
        ref = td.poses(tran.ObjectDetections(
            *(torch.from_numpy(np.array(a)) for a in det_j)))
        port = td.poses(det_t)
        key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
        assert sorted(map(key, port)) == sorted(map(key, ref)), f"frame {f}"
        for r_t in port:
            r_j = next(r for r in ref if key(r) == key(r_t))
            _pose_close(r_t.R, r_t.T, r_j.R, r_j.T)
        n_acc += len(port)
        # The last accepted poses. Those folded from a pose that passes the
        # quality gate agree within 1e-5 like the detections. Junk accepts
        # (8-16 inliers, cliques of 2-3, below the gate) are ill-conditioned
        # fits: the same inliers refit in another summation order move them
        # by up to 8.7e-3 (seen on 6 frames of this stream), so those are
        # held to be the same instance only (accepted, counts, age above).
        acc = np.asarray(det_j.accepted)
        n_in = np.asarray(det_j.n_inliers)
        best = np.argmax(np.where(acc, n_in, -1), axis=1)
        o = np.arange(len(best))
        quality = n_in[o, best] + tfused.CLIQUE_WEIGHT * np.asarray(
            det_j.clique_size)[o, best]
        confident = np.where(acc.any(1), quality >= cfg.min_quality,
                             confident)
        for name in ("_last_R", "_last_T"):
            np.testing.assert_allclose(
                getattr(td, name).numpy()[confident],
                np.asarray(getattr(jd, name))[confident], atol=1e-5)
    # the stream detects, tracks (ages 0) and explores (the cursor moved)
    assert n_acc >= N_FRAMES and confident.sum() >= 2
    assert (td._age.numpy() == 0).any()
    assert td._explore_pos == (2 * N_FRAMES) % 8
