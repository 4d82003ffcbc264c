"""The port's ShardedServingDetector (tod_tpu_torch/parallel/serving.py)
against the reference's single-device streaming loop, stream by stream, on
the CPU at (2 x 4).

test_torch_parallel_serving.py's scene: both streams see their frame's
compacted queries four times over (frame 0 stream 0, frame 1 stream 1),
at coarse->fine with two tracked and two exploration slots, ttl 2 and the
prescreen. Stream ``b`` against the reference's ``FusedDetector``
streaming loop keyed ``PRNGKey(b)`` (its stage functions and state
updates, as the reference's tests/test_parallel.py drives it): accepts,
inlier counts and clique sizes exact, poses within 1e-5; and against the
port's ``FusedDetector(seed=b).detect_compacted`` on the same queries:
every field bit for bit, every frame."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import AGE_NEVER
from tod_tpu.models import fused as jfused
from tod_tpu.ops.pallas.segmented import (object_top1_gathered_xla,
                                          pack_segmented, subsample_models)
from tod_tpu_torch.models.fused import FusedDetector
from tod_tpu_torch.parallel import ShardedServingDetector, make_mesh
from tod_tpu_torch.types import TodModel
from test_torch_parallel_serving import (CPU8, assert_same, configs, scene,
                                         torch_frame)

torch.set_num_threads(1)

N_FRAMES = 4


def _reference_stream(jcfg, ordered, frame, b: int):
    """The reference's streaming loop for stream ``b``: its detections,
    frame by frame."""
    xy, qp, ok, dsc = (jnp.asarray(x[b]) for x in frame)
    db1 = pack_segmented(ordered, db_chunk=4096)
    cdb1 = pack_segmented(subsample_models(ordered, jcfg.coarse_stride),
                          db_chunk=4096)
    c1 = jax.jit(functools.partial(jfused._stage_coarse_select, cfg=jcfg))
    c3 = jax.jit(functools.partial(jfused._stage_geometry_gathered,
                                   cfg=jcfg))
    n_coarse = jcfg.fine_width - jcfg.track_width - jcfg.explore_width
    n_obj = len(ordered)
    key = jax.random.PRNGKey(b)
    age = jnp.full(n_obj, AGE_NEVER, jnp.int32)
    last_r = jnp.zeros((n_obj, 3, 3), jnp.float32)
    last_t = jnp.zeros((n_obj, 3), jnp.float32)
    last_sel, epos, out = None, 0, []
    for _ in range(N_FRAMES):
        key, sub = jax.random.split(key)
        tracked = (jfused._jit_tracked_needy(age, last_sel, jcfg.track_width,
                                             jcfg.track_ttl)
                   if last_sel is not None else
                   jfused._jit_tracked(age, jcfg.track_width, jcfg.track_ttl))
        e_ids = jnp.asarray((epos + np.arange(jcfg.explore_width)) % n_obj,
                            jnp.int32)
        epos = (epos + jcfg.explore_width) % n_obj
        seeds = jfused._jit_seeds(age, last_r, last_t, jcfg.track_ttl)
        sel, force, force_act = c1(dsc, ok, cdb1, tracked, e_ids)
        last_sel = sel[:n_coarse]
        df, rf = object_top1_gathered_xla(dsc, db1, sel, db_chunk=4096)
        det = c3(sub, xy, qp, ok, df, rf, sel, db1.points, db1.obj_start,
                 db1.spans, force, force_act, seeds)
        age = jfused._jit_age(age, det)
        last_r, last_t = jfused._jit_update_pose(last_r, last_t, det)
        out.append(det)
    return out


@pytest.fixture(scope="module")
def served():
    """The scene served four frames by a (2 x 4) ShardedServingDetector."""
    arrays, frame, _ = scene(np.random.default_rng(0))
    jcfg, tcfg = configs(prescreen=4, coarse_stride=3, fine_width=12,
                         track_width=2, explore_width=2, track_ttl=2)
    tm = [TodModel(f"o{i}", d, p) for i, (d, p) in enumerate(arrays)]
    drv = ShardedServingDetector(make_mesh(2, 4, CPU8), tm, tcfg, seed=0)
    got = [drv.step(*torch_frame(frame)) for _ in range(N_FRAMES)]
    return arrays, frame, jcfg, tcfg, drv, got


@pytest.mark.parametrize("b", [0, 1])
def test_sharded_detector_equals_streaming_loops(served, b):
    arrays, frame, jcfg, tcfg, drv, got = served
    assert drv.object_ids.count(None) == 0
    by_id = {f"o{i}": (d, p) for i, (d, p) in enumerate(arrays)}
    ref = _reference_stream(
        jcfg, [JaxModel(i, *by_id[i]) for i in drv.object_ids], frame, b)
    port = FusedDetector([TodModel(i, *by_id[i]) for i in drv.object_ids],
                         tcfg, seed=b, device="cpu")
    xy, qp, ok, dsc = torch_frame(frame)
    n_acc = 0
    for t in range(N_FRAMES):
        one = type(got[t])(*(x[b] for x in got[t]))
        for name in ("accepted", "n_inliers", "clique_size"):
            np.testing.assert_array_equal(
                getattr(one, name).numpy(),
                np.asarray(getattr(ref[t], name)), f"frame {t} {name}")
        acc = np.asarray(ref[t].accepted)
        for name in ("R", "T"):
            np.testing.assert_allclose(getattr(one, name).numpy()[acc],
                                       np.asarray(getattr(ref[t], name))[acc],
                                       atol=1e-5)
        assert_same(one, port.detect_compacted(xy[b], qp[b], dsc[b], ok[b]))
        assert [(r.object_id, r.confidence) for r in drv.results(got[t], b)] \
            == [(r.object_id, r.confidence) for r in port.poses(one)]
        n_acc += int(acc.sum())
    assert n_acc > 0
