"""The port's sharded serving step (tod_tpu_torch/parallel/segmented.py
``serving_step_sharded``) against the reference's on the CPU, at (2 x 4):
the full sweep without and with the tier-1 prescreen, and coarse->fine on
the ORB (Hamming) and SIFT (L2) catalogs, ``track_width`` 0.

The scene (the reference's tests/test_parallel.py): 8 objects of 120-239
rows over 4 shards, two frames of 256 compacted queries each showing
objects 0, 3 and 5 (50 rows each) at seeded poses among random queries.
Both packages draw their own noise from the same frame keys (the port's
within 2^-22 + 2 ulp of the reference's Gumbel values): accepts, inlier
counts and clique sizes are held exactly, poses within 1e-5. The port's
step is also held bit for bit, every field, against the port's
single-device path over the same shard-major object order."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import ActivationConfig as JAct
from tod_tpu.geometry.detection import GuessConfig as JGuess
from tod_tpu.geometry.ransac import RansacConfig as JRansac
from tod_tpu.models.fused import FusedDetectorConfig as JConfig
from tod_tpu.ops.pallas.segmented import subsample_models as jsubsample
from tod_tpu.ops.pallas.segmented_l2 import quantize_descriptors
from tod_tpu.parallel import make_mesh as jax_mesh
from tod_tpu.parallel import segmented as jsharded
from tod_tpu_torch import convert
from tod_tpu_torch.geometry.detection import (detect_frame_gathered,
                                              detect_frame_segmented)
from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops.segmented import pack_segmented, subsample_models
from tod_tpu_torch.ops.segmented_l2 import pack_segmented_l2
from tod_tpu_torch.parallel import (make_mesh, pack_segmented_l2_sharded,
                                    pack_segmented_sharded,
                                    serving_step_sharded)
from tod_tpu_torch.types import TodModel

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
FIELDS = ("R", "T", "n_inliers", "accepted", "rms_residual", "clique_size")


def scene(rng, l2: bool = False):
    """``(arrays, (xy, qp, ok, dsc), poses)``: the reference test's 8
    models and two frames (``dsc`` int8-quantised for ``l2``); ``poses[(f,
    i)]`` the (R, T) object ``i`` is planted at in frame ``f``."""
    arrays = []
    for i in range(8):
        n = 120 + 17 * i
        if l2:
            d = rng.random((n, 128)).astype(np.float32)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
        else:
            d = rng.integers(0, 256, (n, 32), np.uint8)
        arrays.append((d, rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)))
    q_n = 256
    qp = np.full((2, q_n, 3), np.nan, np.float32)
    xy = np.zeros((2, q_n, 2), np.float32)
    if l2:
        dsc = rng.random((2, q_n, 128)).astype(np.float32)
        dsc /= np.linalg.norm(dsc, axis=2, keepdims=True)
    else:
        dsc = rng.integers(0, 256, (2, q_n, 32), np.uint8)
    ok = np.zeros((2, q_n), bool)
    poses = {}
    for f in range(2):
        cursor = 0
        for i in (0, 3, 5):
            desc, pts = arrays[i]
            rows = rng.choice(len(pts), 50, replace=False)
            Rg = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            if np.linalg.det(Rg) < 0:
                Rg[:, 0] *= -1
            Tg = np.array([0.1 * i - 0.3, 0.05 * f, 0.8], np.float32)
            part = slice(cursor, cursor + 50)
            qp[f, part] = pts[rows] @ Rg.T + Tg
            xy[f, part] = rng.uniform(30, 600, (50, 2))
            dsc[f, part] = desc[rows]
            ok[f, part] = True
            poses[(f, i)] = (Rg.astype(np.float32), Tg)
            cursor += 50
    if l2:
        dsc = np.array(quantize_descriptors(jnp.asarray(dsc)))
    return arrays, (xy, qp, ok, dsc), poses


def configs(**change):
    """The reference test's operating point in both packages."""
    activation = dict(m_cap=64, n_hypotheses=64, object_batch=2,
                      prescreen=change.pop("prescreen", 0))
    guess = dict(ransac=dict(n_hypotheses=128, min_inliers=8,
                             max_instances=2),
                 max_matches_per_object=64, max_active_objects=4,
                 object_batch=2)
    flat = dict(pipeline="segmented", q_cap=256,
                radius=change.pop("radius", 60.0), **change)
    jcfg = JConfig(activation=JAct(**activation),
                   guess=JGuess(ransac=JRansac(**guess["ransac"]),
                                **{k: v for k, v in guess.items()
                                   if k != "ransac"}), **flat)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, tcfg


def frame_keys():
    return jax.random.split(jax.random.PRNGKey(0), 2)


def torch_frame(frame):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in frame)


def assert_matches_reference(det_t, det_j):
    """Accepts, inlier counts and clique sizes exact; poses at the accepts
    within 1e-5."""
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)),
                                      name)
    acc = np.asarray(det_j.accepted)
    for name in ("R", "T"):
        np.testing.assert_allclose(getattr(det_t, name).numpy()[acc],
                                   np.asarray(getattr(det_j, name))[acc],
                                   atol=1e-5)
    assert acc.any()


def assert_same(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def single_device(tcfg, ordered, keys, frame, l2: bool):
    """The port's single-device path over ``ordered`` (shard-major), frame
    by frame: the full sweep, or coarse->fine without reserved slots."""
    pack = pack_segmented_l2 if l2 else pack_segmented
    db = pack(ordered, db_chunk=2048, device="cpu")
    cdb = (pack(subsample_models(ordered, tcfg.coarse_stride),
                db_chunk=2048, device="cpu")
           if tcfg.coarse_stride else None)
    xy, qp, ok, dsc = torch_frame(frame)
    dets = []
    for f in range(2):
        noise = ThreefryNoise(np.asarray(keys[f]),
                              tcfg.guess.ransac.max_instances, True, "cpu")
        if cdb is None:
            d, r = tfused.match_full(dsc[f], db)
            dets.append(detect_frame_segmented(
                noise, d, r, ok[f], qp[f], xy[f], db.points, db.obj_start,
                db.spans, tcfg.guess, tcfg.activation, tcfg.radius)[1])
        else:
            sel, _, _ = tfused.stage_coarse_select(dsc[f], ok[f], cdb, tcfg)
            d, r = tfused.match_gathered(dsc[f], db, sel)
            dets.append(detect_frame_gathered(
                noise, d, r, sel, ok[f], qp[f], xy[f], db.points,
                db.obj_start, db.spans, tcfg.guess, tcfg.activation,
                tcfg.radius)[1])
    return dets


@pytest.mark.parametrize("case", ["full", "prescreen", "coarse",
                                  "coarse_l2"])
def test_serving_step_equals_reference(rng, case):
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    l2 = case == "coarse_l2"
    arrays, frame, _ = scene(rng, l2)
    change = {"full": {}, "prescreen": {"prescreen": 4},
              "coarse": {"coarse_stride": 3, "fine_width": 4},
              "coarse_l2": {"coarse_stride": 3, "fine_width": 4,
                            "feature": "SIFT", "radius": 0.9}}[case]
    jcfg, tcfg = configs(**change)
    jm = [JaxModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    jpack = (jsharded.pack_segmented_l2_sharded if l2
             else jsharded.pack_segmented_sharded)
    tpack = pack_segmented_l2_sharded if l2 else pack_segmented_sharded
    jmesh, mesh = jax_mesh(n_data=2, n_db=4), make_mesh(2, 4, CPU8)
    jdb, ids = jpack(jm, n_shards=4, db_chunk=2048)
    tdb, tids = tpack(tm, mesh, db_chunk=2048)
    assert tids == ids
    jargs, targs = (jdb,), (tdb,)
    fine = 0
    if tcfg.coarse_stride:
        jargs += (jpack(jsubsample(jm, 3), n_shards=4, db_chunk=2048)[0],)
        targs += (tpack(subsample_models(tm, 3), mesh, db_chunk=2048)[0],)
        fine = jsharded.stacked_max_chunks(jdb)
    keys = frame_keys()
    with jmesh:
        det_j = jsharded.serving_step_sharded(jmesh, jcfg,
                                              fine_max_chunks=fine)(
            keys, *(jnp.asarray(x) for x in frame), *jargs)
    det_t = serving_step_sharded(mesh, tcfg)(np.asarray(keys),
                                             *torch_frame(frame), *targs)
    assert_matches_reference(det_t, det_j)
    by_id = {m.object_id: m for m in tm}
    ones = single_device(tcfg, [by_id[i] for i in ids], keys, frame, l2)
    for f in range(2):
        assert_same(type(det_t)(*(x[f] for x in det_t)), ones[f])
