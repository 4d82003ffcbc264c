"""Hot catalog updates (``FusedDetector.update_models``) on the segmented
path: tod_tpu_torch against a freshly built detector and against tod_tpu.

The reference's scenario (tests/test_e2e.py test_update_models_hot_swap):
a detector built with ``catalog_capacity`` and ``reserve_rows`` serves one
object, gets the others added into its spare slots, then one dropped. On
each fitting update the DB's tensors keep their shapes, dtypes and storage
(``data_ptr``: the swap is one upload into them), the streaming state is
reset, and every detection then equals, bit for bit, that of a detector
built fresh on the new catalog with the same key. A catalog that outgrows
the reservation gets new tensors and the same equality. The reference
detector run through the same updates on the same key accepts the same
objects, poses within ``POSE_ATOL`` at the gate. The smoke fixture's three
models with every 4th row kept, over its two frames.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.geometry.detection import ActivationConfig, GuessConfig
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetector, FusedDetectorConfig
from tod_tpu_torch import convert
from tod_tpu_torch.models import fused as tfused

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SEED = 9
POSE_ATOL = 1e-5
RESERVE = 8192        # every model of 4,703-6,216 rows fits
STREAM = dict(coarse_stride=4, fine_width=3, coarse_q_stride=2,
              track_width=1, explore_width=1, track_ttl=2,
              track_min_confidence=16.0)


def _config(**change):
    return FusedDetectorConfig(**{**dict(
        n_features=1500, pipeline="segmented", q_cap=1024,
        bucket_grid=(6, 8), radius=50.0, catalog_capacity=3,
        reserve_rows=RESERVE,
        activation=ActivationConfig(m_cap=128, n_hypotheses=128),
        guess=GuessConfig(ransac=RansacConfig(
            n_hypotheses=256, continuation_hypotheses=64, min_inliers=8,
            max_instances=2, tight_final_fit=True),
            max_matches_per_object=256, max_active_objects=2),
        min_quality=100.0), **change})


@pytest.fixture(scope="module")
def smoke():
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    ids = [str(s) for s in fx["model_ids"]]
    arrays = [(fx[f"desc{i}"][::4], fx[f"points{i}"][::4])
              for i in range(3)]
    assert max(len(d) for d, _ in arrays) <= RESERVE
    return dict(fx=fx, ids=ids, jmodels=[JaxModel(i, d, p) for i, (d, p)
                                         in zip(ids, arrays)],
                tmodels=convert.models_from_numpy(
                    ids, [d for d, _ in arrays], [p for _, p in arrays]))


def _tensors(det):
    return {f"{which}.{f.name}": getattr(db, f.name)
            for which, db in (("sdb", det.sdb), ("cdb", det.cdb))
            if db is not None for f in dataclasses.fields(db)
            if isinstance(getattr(db, f.name), torch.Tensor)}


def _layout(det):
    return {name: (tuple(t.shape), t.dtype, t.data_ptr())
            for name, t in _tensors(det).items()}


def _frames(det, fx):
    return [det.prepare_frame(fx["images"][f], fx["depths"][f], fx["K"])
            for f in range(len(fx["images"]))]


def _assert_equal_run(det, models, cfg, fx, n_frames=2):
    """``det`` and a detector built fresh on ``models`` with det's key: the
    same detections, bit for bit, and the same slabs, frame by frame."""
    fresh = tfused.FusedDetector(models, cfg, seed=0, device="cpu")
    fresh._key = det._key.copy()
    assert fresh.object_ids == det.object_ids
    for name, t in _tensors(fresh).items():
        assert torch.equal(t, _tensors(det)[name]), name
    frames = _frames(det, fx)
    found = []
    for f in range(n_frames):
        _, a = det.detect_raw(*frames[f % len(frames)])
        _, b = fresh.detect_raw(*frames[f % len(frames)])
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), (f, name)
        if det.slab is not None:
            for x, y in zip(det.slab, fresh.slab):
                assert torch.equal(x, y), f
        found.append({r.object_id for r in det.poses(a)})
    return found


@pytest.mark.parametrize("stream", [False, True], ids=["sweep", "stream"])
def test_update_models_in_place_equals_a_fresh_detector(smoke, stream):
    """Add two objects into spare slots, then drop the first: the storage
    stays, the state resets, the detections equal a fresh detector's; then
    a catalog past the reservation moves to new tensors."""
    cfg = convert.config_from_dict(dataclasses.asdict(
        _config(**(STREAM if stream else {}))))
    m0, m1, m2 = smoke["tmodels"]
    fx = smoke["fx"]
    det = tfused.FusedDetector([m0], cfg, seed=SEED, device="cpu")
    layout = _layout(det)
    assert det.object_ids == [m0.object_id, "", ""]
    assert (det.cdb is not None) == stream
    for frame in _frames(det, fx):          # state to reset
        det.detect_raw(*frame)
    det.update_models([m0, m1, m2])         # into the spare slots
    assert _layout(det) == layout
    if stream:
        assert (det._age == tfused.AGE_NEVER).all()
        assert det._last_coarse_sel is None and det._explore_pos == 0
    # three frames: the stream latches an added object within them
    found = _assert_equal_run(det, [m0, m1, m2], cfg, fx, n_frames=3)
    assert {m1.object_id, m2.object_id} <= set().union(*found)
    det.update_models([m1, m2])             # drop the first
    assert _layout(det) == layout
    found = _assert_equal_run(det, [m1, m2], cfg, fx)
    assert m0.object_id not in set().union(*found)
    big = dataclasses.replace(m1, descriptors=np.concatenate(
        [m1.descriptors] * 2), points=np.concatenate([m1.points] * 2))
    det.update_models([big, m2])            # outgrows the reservation
    assert _layout(det)["sdb.words"][:2] != layout["sdb.words"][:2]
    _assert_equal_run(det, [big, m2], cfg, fx, n_frames=1)


def test_hot_swap_matches_reference(smoke):
    """The reference's scenario on the full sweep, both packages on the
    same key through the same updates: the same accepted objects,
    instances and inlier counts, poses within POSE_ATOL at the gate."""
    cfg = _config()
    fx = smoke["fx"]
    jd = FusedDetector(smoke["jmodels"][:1], cfg, seed=SEED)
    td = tfused.FusedDetector(smoke["tmodels"][:1], convert.config_from_dict(
        dataclasses.asdict(cfg)), seed=SEED, device="cpu")
    seen = set()
    for catalog in ([0], [0, 1, 2], [1, 2]):
        jd.update_models([smoke["jmodels"][i] for i in catalog])
        td.update_models([smoke["tmodels"][i] for i in catalog])
        for f in range(len(fx["images"])):
            frame = (fx["images"][f], fx["depths"][f], fx["K"])
            ref, port = jd.detect(*frame), td.detect(*frame)
            key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
            assert sorted(map(key, port)) == sorted(map(key, ref)), (catalog,
                                                                     f)
            for r in port:
                r_j = next(x for x in ref if key(x) == key(r))
                gap = max(np.abs(r.R - r_j.R).max(),
                          np.abs(r.T - r_j.T).max())
                assert gap < POSE_ATOL, (r.object_id, gap)
            ids = {r.object_id for r in port}
            assert ids <= {smoke["ids"][i] for i in catalog}
            seen |= ids
    assert seen == set(smoke["ids"])
