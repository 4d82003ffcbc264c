"""Parity of the port's coarse->fine pieces with the JAX reference: the
gathered matcher's twin (kernel B2's plain version), the coarse DB, and the
slab selection and streaming-state functions of geometry/detection.py.

On the CPU the gathered wrapper runs its twin; it must equal, bit for bit,
the reference's XLA twin and its Pallas kernel run in interpret mode. The
CUDA kernel itself is compared with the twin in test_torch_cuda.py and by
chip_smoke.py, which need a card. The selection and state functions are
integer or boolean valued (poses are copied, not computed), so they are
held exactly, on inputs full of ties.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tod_tpu.geometry import detection as jdet
from tod_tpu.geometry import ransac as jran
from tod_tpu.ops.pallas import segmented as jseg
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.ops import segmented as tseg
from test_torch_segmented import _both, _edge_case_models, _queries

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gathered_twin_matches_reference_twin_and_interpret_kernel(rng):
    arrays = _edge_case_models(rng)       # empty, multi-chunk, duplicates
    jm, tm = _both(arrays)
    jdb = jseg.pack_segmented(jm, db_chunk=2048)
    tdb = tseg.pack_segmented(tm, db_chunk=2048, device="cpu")
    q = _queries(rng, arrays, n=256)
    # holes, a repeated id, out-of-order ids, the empty and multi-chunk ones
    sel = np.array([4, -1, 2, 1, 4, 0, -1, 5, 3], np.int32)
    d_x, r_x = jseg.object_top1_gathered_xla(jnp.asarray(q), jdb,
                                             jnp.asarray(sel), db_chunk=2048)
    d_f, r_f = jseg.object_top1_gathered_fused(
        jnp.asarray(q), jdb, jnp.asarray(sel),
        jseg.max_chunks_per_object(jdb), q_tile=256)     # interpret mode
    d_t, r_t = tseg.object_top1_gathered(torch.from_numpy(q), tdb,
                                         torch.from_numpy(sel))
    assert d_t.dtype == torch.float32 and r_t.dtype == torch.int32
    for d_ref, r_ref in ((d_x, r_x), (d_f, r_f)):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_ref))
    d, r = d_t.numpy(), r_t.numpy()
    assert (tseg.HOLE_DIST, tseg.HOLE_ROW) == (8191.0, 262143)
    assert (d[:, sel < 0] == tseg.HOLE_DIST).all()
    assert (r[:, sel < 0] == tseg.HOLE_ROW).all()
    assert (d[:, 3] == tseg.DIST_CLAMP).all() and (r[:, 3] == 0).all()
    assert (d[0, 0], r[0, 0]) == (0, 123)       # object 4, row 123
    assert (d[2, 8], r[2, 8]) == (0, 5)         # lowest of 11 equal rows
    assert (d[1, 7], r[1, 7]) == (256, 0)
    # each slot's column is B1's twin's column for its object
    d_b1, r_b1 = tseg.object_top1_torch(torch.from_numpy(q), tdb)
    real = np.nonzero(sel >= 0)[0]
    assert torch.equal(d_t[:, real], d_b1[:, sel[real]])
    assert torch.equal(r_t[:, real], r_b1[:, sel[real]])


def test_gathered_wrapper_counts_no_launch_on_cpu(rng):
    _, tm = _both([(rng.integers(0, 256, (40, 32), dtype=np.uint8),
                    np.zeros((40, 3), np.float32))])
    tdb = tseg.pack_segmented(tm, db_chunk=256, device="cpu")
    q = torch.from_numpy(rng.integers(0, 256, (5, 32), dtype=np.uint8))
    before = tseg.object_top1_gathered.launches
    d, r = tseg.object_top1_gathered(q, tdb, _t(np.array([0, -1, 1, 7],
                                                         np.int32)))
    assert tseg.object_top1_gathered.launches == before
    # ids outside [0, O) are holes, as -1 is
    assert (d[:, 1:] == tseg.HOLE_DIST).all()
    assert (r[:, 1:] == tseg.HOLE_ROW).all()
    with pytest.raises(ValueError):
        tseg.object_top1_gathered(q.to("meta"), tdb, _t(np.zeros(1, np.int32)))


def test_subsampled_coarse_db_matches(rng):
    arrays = _edge_case_models(rng)
    jm, tm = _both(arrays)
    j_sub = jseg.subsample_models(jm, 16)
    t_sub = tseg.subsample_models(tm, 16)
    for a, b in zip(j_sub, t_sub):
        assert a.object_id == b.object_id
        np.testing.assert_array_equal(b.descriptors, a.descriptors)
        np.testing.assert_array_equal(b.points, a.points)
        assert b.span == a.span
    assert [m.n_points for m in t_sub] == [19, 0, 282, 4, 44, 1]
    # the reference's coarse DB converts one to one into the port's
    jdb = jseg.pack_segmented(j_sub, db_chunk=512, reserve_rows=2)
    got = convert.segmented_db_from_jax(
        {k: np.asarray(v) for k, v in jdb._asdict().items()}, "cpu")
    want = tseg.pack_segmented(t_sub, db_chunk=512, reserve_rows=2,
                               device="cpu")
    for name in ("words", "points", "obj_start", "n_rows", "spans"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ---- selection and streaming state, held exactly -------------------------

AGE = np.array([0, 3, 1, jdet.AGE_NEVER, 0, 2, 1, 0, jdet.AGE_NEVER + 1, 2],
               np.int32)


def _detections(rng, n_obj=6, n_inst=3):
    acc = rng.random((n_obj, n_inst)) < 0.4
    acc[0] = False
    acc[1] = [True, False, True]                    # equal inliers: first
    n_in = rng.integers(8, 30, (n_obj, n_inst)).astype(np.int32)
    n_in[1] = [20, 25, 20]
    n_in[2] = [15, 12, 17]                          # below a 16 latch gate
    acc[2] = [True, True, False]
    R = rng.normal(size=(n_obj, n_inst, 3, 3)).astype(np.float32)
    T = rng.normal(size=(n_obj, n_inst, 3)).astype(np.float32)
    zero = np.zeros((n_obj, n_inst), np.float32)
    arrays = (R, T, n_in, acc, zero, np.zeros((n_obj, n_inst), np.int32))
    return (jran.ObjectDetections(*(jnp.asarray(a) for a in arrays)),
            tran.ObjectDetections(*(_t(a) for a in arrays)))


def _case(name, rng):
    """(reference outputs, port outputs) of one selection/state case."""
    j, t = jnp.asarray, _t
    if name == "coarse_select":
        dist = rng.integers(20, 80, (200, 12)).astype(np.float32)
        dist[:60, 3] = rng.integers(2, 20, 60)
        dist[:60, 7] = dist[:60, 3]                  # an exact tie
        ok = rng.random(200) < 0.9
        args = (50.0, 16.0, 5, 32)
        return (jdet.coarse_select(j(dist), j(ok), *args),
                tdet.coarse_select(t(dist), t(ok), *args))
    if name.startswith("tracked_from_age"):
        needy = None if name.endswith("plain") else rng.random(10) < 0.5
        width = 3 if name.endswith("narrow") else 8
        return (jdet.tracked_from_age(j(AGE), width, 2, None if needy is None
                                      else j(needy)),
                tdet.tracked_from_age(t(AGE), width, 2, None if needy is None
                                      else t(needy)))
    if name == "tracked_needy":
        last = np.array([4, -1, 0, 9, 7], np.int32)
        return (jdet.tracked_needy(j(AGE), j(last), 4, 2),
                tdet.tracked_needy(t(AGE), t(last), 4, 2))
    if name == "merge_tracked":
        main = np.array([5, 2, 9, 0], np.int32)
        tracked = np.array([2, -1, 7, 0, 3], np.int32)
        return (jdet.merge_tracked(j(main), j(tracked)),
                tdet.merge_tracked(t(main), t(tracked)))
    if name == "reserved_force_mask":
        sel = np.array([5, 2, -1, 0, 7, -1, 3, 8], np.int32)
        tracked = np.array([2, -1, 7], np.int32)
        explore = np.array([3, 9, -1], np.int32)
        return ([jdet.reserved_force_mask(j(sel), j(tracked), None,
                                          j(explore)),
                 jdet.reserved_force_mask(j(sel), j(tracked))],
                [tdet.reserved_force_mask(t(sel), t(tracked), None,
                                          t(explore)),
                 tdet.reserved_force_mask(t(sel), t(tracked))])
    if name.startswith("update_age"):
        gate = 16.0 if name.endswith("gated") else 0.0
        d_j, d_t = _detections(rng)
        return (jdet.update_age(j(AGE[:6]), d_j, gate),
                tdet.update_age(t(AGE[:6]), d_t, gate))
    if name == "seeds_from_state":
        r = rng.normal(size=(10, 3, 3)).astype(np.float32)
        tt = rng.normal(size=(10, 3)).astype(np.float32)
        return (list(jdet.seeds_from_state(j(AGE), j(r), j(tt), 1)),
                list(tdet.seeds_from_state(t(AGE), t(r), t(tt), 1)))
    if name == "fold_best_pose":
        d_j, d_t = _detections(rng)
        r = rng.normal(size=(6, 3, 3)).astype(np.float32)
        tt = rng.normal(size=(6, 3)).astype(np.float32)
        return (list(jdet.fold_best_pose(j(r), j(tt), d_j)),
                list(tdet.fold_best_pose(t(r), t(tt), d_t)))
    # activation_cut with forced slots and the reserve: scores tied, forced
    # slots weaker and stronger than unforced ones, an all-forced slab
    scores = np.array([9, 4, 30, 9, 3, 9, 0, 12, 9, 5], np.int32)
    force = np.zeros(10, bool)
    force[[1, 3, 6, 7]] = True
    n_active, reserve = {"cut_forced": (4, 4), "cut_forced_r2": (6, 2),
                         "cut_forced_r0": (4, 0), "cut_all_forced": (4, 3),
                         "cut_unforced": (5, 4)}[name]
    if name == "cut_all_forced":
        force[:] = True
    if name == "cut_unforced":
        force = None
    act = dict(min_score=4, active_reserve=reserve)
    return (jdet.activation_cut(j(scores), None if force is None
                                else j(force), n_active,
                                jdet.ActivationConfig(**act)),
            tdet.activation_cut(t(scores), n_active,
                                tdet.ActivationConfig(**act),
                                None if force is None else t(force)))


@pytest.mark.parametrize("name", [
    "coarse_select", "tracked_from_age_plain", "tracked_from_age_needy",
    "tracked_from_age_needy_narrow", "tracked_needy", "merge_tracked",
    "reserved_force_mask", "update_age", "update_age_gated",
    "seeds_from_state", "fold_best_pose", "cut_forced", "cut_forced_r2",
    "cut_forced_r0", "cut_all_forced", "cut_unforced"])
def test_selection_and_state_match(name):
    ref, port = _case(name, np.random.default_rng(zlib.crc32(name.encode())))
    if not isinstance(ref, list):
        ref, port = [ref], [port]
    for a, b in zip(ref, port, strict=True):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
