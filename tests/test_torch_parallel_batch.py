"""The port's batched detection, sharded training, pipelined detector and
dry run (tod_tpu_torch/parallel/detect.py, train.py, pipeline.py,
dryrun.py) against the reference's (tod_tpu/parallel) on the CPU.

The detection scene: two 240 x 320 textured frames over a slanted depth
plane (the second the first shifted 9 px), and a catalog whose two objects
are the first frame's own keypoints (left and right half, their 3D points
as the model, identity pose) beside a random filler. Both packages draw
their own noise from the same keys: accepts and inlier counts exact, poses
at the accepts within 1e-5; each port result also bit for bit, every
field, against the port's single-device global path with the same key."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import GuessConfig as JGuess
from tod_tpu.geometry.ransac import RansacConfig as JRansac
from tod_tpu.models.fused import FusedDetectorConfig as JConfig
from tod_tpu.models.fused import pack_models as jpack_models
from tod_tpu.parallel import PipelinedDetector as JPipelined
from tod_tpu.parallel import detect_batch_sharded as jdetect_batch
from tod_tpu.parallel import make_mesh as jax_mesh
from tod_tpu.parallel import train_views_sharded as jtrain_sharded
from tod_tpu_torch import convert
from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.parallel import (PipelinedDetector, detect_batch_sharded,
                                    dryrun_multichip, make_mesh,
                                    train_views_sharded)
from tod_tpu_torch.parallel import train as ttrain
from tod_tpu_torch.types import TodModel, fixture_observations
from test_torch_parallel_serving import assert_same
from test_torch_train import FIXTURE, N_FEATURES, _batch, _bits

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
H, W = 240, 320
K = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
CHUNK = 256


def _configs():
    jcfg = JConfig(n_features=300, n_levels=1, db_chunk=CHUNK,
                   guess=JGuess(ransac=JRansac(n_hypotheses=64,
                                               max_instances=2),
                                max_matches_per_object=64, object_batch=2))
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def world():
    return make_world()


def make_world():
    """``(grays, depths, port models, reference models)``."""
    rng = np.random.default_rng(4)
    noise = rng.uniform(0, 255, (H // 4 + 2, W // 4 + 2)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(noise)[None, None], scale_factor=4,
        mode="bicubic")[0, 0, 4:4 + H, 4:4 + W].clamp(0, 255).round()
    grays = np.stack([tex.numpy(), np.roll(tex.numpy(), 9, axis=1)])
    yy, xx = np.mgrid[:H, :W]
    depth = (800 + 150 * np.sin(xx / 23.0) * np.cos(yy / 17.0)).astype(
        np.uint16)
    depths = np.stack([depth, depth])
    jcfg, tcfg = _configs()
    kps, desc, qp = tfused.stage_features(
        torch.from_numpy(grays[0]), torch.from_numpy(depth.astype(np.int32)),
        torch.from_numpy(K), tcfg)
    ok = torch.isfinite(qp).all(-1).numpy()
    left = ok & (kps.xy[:, 0].numpy() < W / 2)
    # model points in an object frame 0.5 m behind the camera's, with 2 mm
    # of noise (a perfect fit leaves the residual test nothing to measure)
    arrays = [(desc.numpy()[m], (qp.numpy()[m] - [0.05, 0, 0.5]
                                 + rng.normal(0, 0.002, (m.sum(), 3))
                                 ).astype(np.float32))
              for m in (left, ok & ~left)]
    arrays.append((rng.integers(0, 256, (60, 32), dtype=np.uint8),
                   rng.uniform(-0.1, 0.1, (60, 3)).astype(np.float32)))
    assert min(len(d) for d, _ in arrays[:2]) >= 20
    ids = ["left", "right", "filler"]
    return (grays, depths, [TodModel(i, d, p) for i, (d, p) in
                            zip(ids, arrays)],
            [JaxModel(i, d, p) for i, (d, p) in zip(ids, arrays)])


def _assert_like(det_t, det_j):
    for name in ("accepted", "n_inliers"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)), name)
    acc = np.asarray(det_j.accepted)
    assert acc.any()
    for name in ("R", "T"):
        np.testing.assert_allclose(getattr(det_t, name).numpy()[acc],
                                   np.asarray(getattr(det_j, name))[acc],
                                   atol=1e-5)


def _single(tcfg, models, keys, grays, depths):
    """The port's single-device global path, frame by frame."""
    db, _ = tfused.pack_models(models, CHUNK * 4, device="cpu")
    out = []
    for b in range(len(keys)):
        kps, desc, qp = tfused.stage_features(
            torch.from_numpy(grays[b]),
            torch.from_numpy(depths[b].astype(np.int32)),
            torch.from_numpy(K), tcfg)
        dist, rows = tfused.match_against_db(desc, db, tcfg)
        noise = ThreefryNoise(np.asarray(keys[b]),
                              tcfg.guess.ransac.max_instances, False, "cpu")
        out.append(tfused.stage_geometry(noise, kps.xy, kps.valid, dist,
                                         rows, qp, tfused.geom_db(db), tcfg))
    return out


def test_detect_batch_sharded_equals_reference(world):
    """(2 x 4): frames over 'data', the DB's rows (padded to 4 x 128-row
    chunks) over 'db'."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    grays, depths, tm, jm = world
    jcfg, tcfg = _configs()
    keys = jax.random.split(jax.random.PRNGKey(42), 2)
    jdb, _ = jpack_models(jm, CHUNK * 4)
    jmesh = jax_mesh(n_data=2, n_db=4)
    with jmesh:
        det_j = jdetect_batch(jmesh, keys, jnp.asarray(grays),
                              jnp.asarray(depths),
                              jnp.broadcast_to(jnp.asarray(K), (2, 3, 3)),
                              jdb, jcfg)
    tdb, _ = tfused.pack_models(tm, CHUNK * 4, device="cpu")
    det_t = detect_batch_sharded(
        make_mesh(2, 4, CPU8), np.asarray(keys), torch.from_numpy(grays),
        torch.from_numpy(depths.astype(np.int32)),
        torch.from_numpy(K).expand(2, 3, 3), tdb, tcfg)
    _assert_like(det_t, det_j)
    for b, one in enumerate(_single(tcfg, tm, keys, grays, depths)):
        assert_same(type(det_t)(*(x[b] for x in det_t)), one)


def test_pipelined_detector_equals_reference(world):
    """Three stages on three devices, two frames, against the reference's
    PipelinedDetector and the port's single-device FusedDetector."""
    grays, depths, tm, jm = world
    jcfg, tcfg = _configs()
    jpipe = JPipelined(jm, jcfg, devices=jax.devices()[:3], seed=3)
    pipe = PipelinedDetector(tm, tcfg, devices=["cpu"] * 3, seed=3)
    one = tfused.FusedDetector(tm, tcfg, seed=3, device="cpu")
    frames = [(grays[b], depths[b], K) for b in range(2)]
    dets_j = jpipe.detect_stream([jpipe.prepare_frame(*f) for f in frames])
    dets_t = pipe.detect_stream([pipe.prepare_frame(*f) for f in frames])
    assert pipe.devices == [torch.device("cpu")] * 3
    for det_t, det_j, f in zip(dets_t, dets_j, frames):
        _assert_like(det_t, det_j)
        assert_same(det_t, one.detect_raw(*f)[1])


def test_train_views_sharded_equals_reference():
    """(4 x 1): object 0's first four fixture views, one a device, equal
    the reference's batched training program's stored outputs."""
    fx = np.load(FIXTURE)
    obs = fixture_observations(fx, 0)[:4]
    fn = train_views_sharded(make_mesh(4, 1, ["cpu"] * 4),
                             n_features=N_FEATURES)
    desc, world_pts, valid = fn(*_batch(obs))
    np.testing.assert_array_equal(
        valid.numpy(), _bits(fx["views0_valid"], N_FEATURES)[:4])
    np.testing.assert_array_equal(desc.numpy(), fx["views0_desc"][:4])
    np.testing.assert_array_equal(world_pts.numpy(), fx["views0_world"][:4])


def test_train_views_sharded_small_views_equal_reference():
    """(8 x 1), eight random 240 x 320 views, against the reference's
    train_views_sharded run on its eight devices; and the port's
    unsharded step."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    rng = np.random.default_rng(1)
    v = 8
    grays = rng.uniform(0, 255, (v, H, W)).astype(np.float32)
    masks = np.ones((v, H, W), np.uint8)
    depths = np.full((v, H, W), 0.8, np.float32)
    Ks = np.broadcast_to(K, (v, 3, 3)).copy()
    Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (v, 3, 3)).copy()
    Ts = rng.uniform(-0.1, 0.1, (v, 3)).astype(np.float32)
    jmesh = jax_mesh(n_data=8, n_db=1)
    with jmesh:
        ref = jtrain_sharded(jmesh, n_features=64, n_levels=1)(
            *(jnp.asarray(x) for x in (grays, masks, depths, Ks, Rs, Ts)))
    views = [torch.from_numpy(x) for x in (grays, masks, depths, Ks, Rs, Ts)]
    got = train_views_sharded(make_mesh(8, 1, CPU8), n_features=64,
                              n_levels=1)(*views)
    whole = ttrain.train_views_step(*views, n_features=64, n_levels=1)
    for g, w, r in zip(got, whole, ref):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[2].any()


def test_dryrun_multichip_on_eight_cpu_devices():
    shapes = dryrun_multichip(8, CPU8)
    assert shapes["train"] == (4, 32, 32)
    assert shapes["detect"] == (4, 2, 1)
    assert shapes["object_top1"] == (512, 6)
    assert shapes["streaming_slots"] == (4, 6, 1)
    assert shapes["last_coarse_sel"] == (4, 4)
    assert shapes["coarse_fine_l2"] == (4, 4, 1)
