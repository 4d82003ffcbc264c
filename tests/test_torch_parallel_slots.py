"""The port's sharded coarse->fine serving step with tracked and
exploration slab slots (tod_tpu_torch/parallel/segmented.py), and the
reference's sharded activation cut (ROADMAP queue C), on the CPU at
(2 x 4), on test_torch_parallel_serving.py's scene.

With reserved slots the port's step is held bit for bit, every field and
the slab's coarse prefix, against the port's single-device coarse->fine
path (``stage_coarse_select`` + the gathered match +
``detect_frame_gathered``). The reference's two serving paths disagree
there when ``track_width > 0``: its sharded step cuts the active set with
``where(force_act, inf, scores)``, its single-device path with
``activation_cut``'s ``active_reserve``; the port's sharded step follows
the single-device one."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry import detection as jdet
from tod_tpu.geometry.ransac import SeedPose as JSeed
from tod_tpu.ops.pallas import segmented as jseg
from tod_tpu.parallel import make_mesh as jax_mesh
from tod_tpu.parallel import segmented as jsharded
from tod_tpu_torch.geometry.detection import detect_frame_gathered
from tod_tpu_torch.geometry.ransac import SeedPose, ThreefryNoise
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops.segmented import pack_segmented, subsample_models
from tod_tpu_torch.parallel import (make_mesh, pack_segmented_sharded,
                                    serving_step_sharded)
from tod_tpu_torch.types import TodModel
from test_torch_parallel_serving import (CPU8, assert_same, configs,
                                         frame_keys, scene, torch_frame)

torch.set_num_threads(1)


def _port_single(tcfg, ordered, keys, frame, tracked, explore, seeds):
    """The port's single-device coarse->fine frames with reserved slots:
    ``(detections, coarse prefixes)``."""
    db = pack_segmented(ordered, db_chunk=2048, device="cpu")
    cdb = pack_segmented(subsample_models(ordered, tcfg.coarse_stride),
                         db_chunk=2048, device="cpu")
    xy, qp, ok, dsc = torch_frame(frame)
    n_forced = tcfg.track_width + tcfg.explore_width
    dets, prefixes = [], []
    for f in range(2):
        sel, force, force_act = tfused.stage_coarse_select(
            dsc[f], ok[f], cdb, tcfg, tracked[f],
            None if explore is None else explore[f])
        d, r = tfused.match_gathered(dsc[f], db, sel)
        noise = ThreefryNoise(np.asarray(keys[f]),
                              tcfg.guess.ransac.max_instances, True, "cpu")
        dets.append(detect_frame_gathered(
            noise, d, r, sel, ok[f], qp[f], xy[f], db.points, db.obj_start,
            db.spans, tcfg.guess, tcfg.activation, tcfg.radius, force,
            n_forced, force_act, SeedPose(*(x[f] for x in seeds)))[1])
        prefixes.append(sel[:sel.shape[0] - n_forced])
    return dets, prefixes


def _sharded(tcfg, tm, keys, frame, tracked, explore, seeds):
    mesh = make_mesh(2, 4, CPU8)
    tdb, ids = pack_segmented_sharded(tm, mesh, db_chunk=2048)
    tcdb, _ = pack_segmented_sharded(subsample_models(tm, 3), mesh,
                                     db_chunk=2048)
    det, last_sel = serving_step_sharded(mesh, tcfg)(
        np.asarray(keys), *torch_frame(frame), tdb, tcdb, tracked, explore,
        seeds)
    return det, last_sel, ids


@pytest.mark.parametrize("prescreen,fine_width", [(0, 12), (4, 12),
                                                  (0, 16)])
def test_slots_equal_single_device(rng, prescreen, fine_width):
    """One tracked slot (frame 0: object 5, also ranked by the coarse
    screen, seeded with its true pose; frame 1: empty) and three
    exploration slots (one repeating the tracked id). ``prescreen`` 4
    widens tier 1 by the reserved slots (8 of 12); ``fine_width`` 16 over
    8 objects clamps the coarse part of the slab."""
    arrays, frame, poses = scene(rng)
    _, tcfg = configs(prescreen=prescreen, coarse_stride=3,
                      fine_width=fine_width, track_width=1, explore_width=3)
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    keys = frame_keys()
    tracked = torch.tensor([[5], [-1]], dtype=torch.int32)
    explore = torch.tensor([[2, 5, 7], [3, 4, 6]], dtype=torch.int32)
    mesh_ids = pack_segmented_sharded(tm, make_mesh(2, 4, CPU8),
                                      db_chunk=2048)[1]
    o5 = mesh_ids.index("o5")
    seeds = SeedPose(R=torch.eye(3).repeat(2, 8, 1, 1),
                     T=torch.zeros((2, 8, 3)),
                     ok=torch.zeros((2, 8), dtype=torch.bool))
    seeds.R[0, o5] = torch.from_numpy(poses[(0, 5)][0])
    seeds.T[0, o5] = torch.from_numpy(poses[(0, 5)][1])
    seeds.ok[0, o5] = True
    # the slots hold shard-major ids
    tracked_sm = torch.where(tracked >= 0, torch.tensor(
        [mesh_ids.index(f"o{int(i)}") if i >= 0 else -1
         for i in tracked.flatten()]).reshape(2, 1).int(), -1)
    explore_sm = torch.tensor([[mesh_ids.index(f"o{int(i)}") for i in row]
                               for row in explore], dtype=torch.int32)
    det, last_sel, ids = _sharded(tcfg, tm, keys, frame, tracked_sm,
                                  explore_sm, seeds)
    by_id = {m.object_id: m for m in tm}
    ones, prefixes = _port_single(tcfg, [by_id[i] for i in ids], keys,
                                  frame, tracked_sm, explore_sm, seeds)
    assert last_sel.shape == (2, min(fine_width - 4, 8))
    for f in range(2):
        assert_same(type(det)(*(x[f] for x in det)), ones[f])
        assert torch.equal(last_sel[f], prefixes[f])
    assert det.accepted.any()


def test_sharded_activation_cut_follows_single_device(rng):
    """Four tracked slots hold objects absent from both frames (1, 2, 4,
    6), the active set is 4 wide, and objects 0, 3 and 5 are present but
    untracked. The reference's sharded step activates the four tracked
    objects only, its single-device path (``active_reserve`` 4) the
    present ones first: their accepts differ. The port's sharded step
    gives the port's single-device detections bit for bit, whose accepts
    are the reference single-device path's."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    arrays, frame, _ = scene(rng)
    jcfg, tcfg = configs(coarse_stride=3, fine_width=12, track_width=4)
    assert tcfg.activation.active_reserve == 4
    jm = [JaxModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    keys = frame_keys()
    jmesh = jax_mesh(n_data=2, n_db=4)
    jdb, ids = jsharded.pack_segmented_sharded(jm, 4, db_chunk=2048)
    jcdb, _ = jsharded.pack_segmented_sharded(jseg.subsample_models(jm, 3),
                                              4, db_chunk=2048)
    absent = [ids.index(f"o{i}") for i in (1, 2, 4, 6)]
    tracked = np.asarray([absent, absent], np.int32)
    n = len(ids)
    seed_r = np.broadcast_to(np.eye(3, dtype=np.float32), (2, n, 3, 3))
    seed_t = np.zeros((2, n, 3), np.float32)
    seed_ok = np.zeros((2, n), bool)
    with jmesh:
        det_js, _ = jsharded.serving_step_sharded(
            jmesh, jcfg, fine_max_chunks=jsharded.stacked_max_chunks(jdb))(
            keys, *(jnp.asarray(x) for x in frame), jdb, jcdb,
            jnp.asarray(tracked), jnp.asarray(seed_r), jnp.asarray(seed_t),
            jnp.asarray(seed_ok))
    # the reference's single-device path over the same shard-major order
    by_id = {m.object_id: m for m in jm}
    db1 = jseg.pack_segmented([by_id[i] for i in ids], db_chunk=2048)
    cdb1 = jseg.pack_segmented(jseg.subsample_models(
        [by_id[i] for i in ids], 3), db_chunk=2048)
    xy, qp, ok, dsc = (jnp.asarray(x) for x in frame)
    single_j = []
    for f in range(2):
        dc, _ = jseg.object_top1(dsc[f], cdb1, db_chunk=2048)
        sel = jdet.coarse_select(dc, ok[f], jcfg.radius,
                                 jcfg.resolved_coarse_slack,
                                 jcfg.fine_width - jcfg.track_width,
                                 jcfg.activation.prescreen_top)
        sel = jdet.merge_tracked(sel, jnp.asarray(tracked[f]))
        force = jdet.reserved_force_mask(sel, jnp.asarray(tracked[f]))
        df, rf = jseg.object_top1_gathered_xla(dsc[f], db1, sel,
                                               db_chunk=2048)
        single_j.append(jax.jit(jdet.detect_frame_gathered,
                                static_argnums=(10, 11, 12, 14))(
            keys[f], df, rf, sel, ok[f], qp[f], xy[f], db1.points,
            db1.obj_start, db1.spans, jcfg.guess, jcfg.activation,
            jcfg.radius, force, jcfg.track_width, force,
            JSeed(jnp.asarray(seed_r[f]), jnp.asarray(seed_t[f]),
                  jnp.asarray(seed_ok[f])))[1])
    acc_single = np.stack([np.asarray(d.accepted) for d in single_j])
    present = [ids.index(f"o{i}") for i in (0, 3, 5)]
    assert acc_single[:, present].any()
    assert not np.asarray(det_js.accepted)[:, present].any()
    assert not np.array_equal(np.asarray(det_js.accepted), acc_single)

    seeds = SeedPose(*(torch.from_numpy(np.ascontiguousarray(x))
                       for x in (seed_r, seed_t, seed_ok)))
    tracked_t = torch.from_numpy(tracked)
    det, _, tids = _sharded(tcfg, tm, keys, frame, tracked_t, None, seeds)
    assert tids == ids
    by_id_t = {m.object_id: m for m in tm}
    ones, _ = _port_single(tcfg, [by_id_t[i] for i in ids], keys, frame,
                           tracked_t, None, seeds)
    for f in range(2):
        assert_same(type(det)(*(x[f] for x in det)), ones[f])
    np.testing.assert_array_equal(det.accepted.numpy(), acc_single)


@pytest.mark.parametrize("n", [8, 4, 1])
def test_fits_do_not_depend_on_the_batch(n):
    """Each object's refit, 3-path log-weights (exact counts, past 2^24 in
    a dense graph of 384 matches) and RANSAC round are the same in a batch
    of 16 objects and of ``n``, as the sharded step needs (the card's
    counterpart is in test_torch_cuda.py)."""
    from tod_tpu_torch.geometry import adjacency as tadj
    from tod_tpu_torch.geometry import ransac as tran
    from tod_tpu_torch.geometry.transforms import kabsch
    from test_torch_cuda import _batch_scene

    m, gum = _batch_scene(torch.device("cpu"))
    spans = torch.full((16,), 0.5)
    dense = torch.ones((16, 384, 384), dtype=torch.bool)
    counts = (dense & m.valid[:, :, None] & m.valid[:, None, :]).to(
        torch.int64)
    paths = counts @ (counts @ (counts @ m.valid.to(torch.int64)[..., None]))
    assert paths.max() > 2 ** 24
    assert torch.equal(tran.consistency_log_weights(dense, m.valid),
                       torch.log1p(paths[..., 0].to(torch.float32)))

    def run(k):
        part = type(m)(*(x[:k] for x in m))
        graphs = tadj.fill_adjacency(part, spans[:k], 0.01)
        fit = kabsch(part.query_pts, part.train_pts, part.valid.float())
        rnd = tran.ransac_round(gum[:k], part, graphs, graphs.valid,
                                tran.RansacConfig(n_hypotheses=128))
        return (fit.R, fit.T, tran.consistency_log_weights(dense[:k],
                                                           part.valid),
                *rnd)

    for a, b in zip(run(16), run(n)):
        assert torch.equal(a[:n], b)
