"""conf/detection.ork with SIFT features (the global-kNN cell graph on the
L2 matcher, ``ops/matching.py l2_topk``) through both packages on the CPU,
over the SIFT smoke models (tests/data/torch_sift_fixture.npz, served as
``q / 256`` as the serving graphs serve them) and the smoke fixture's
frame 0, at 3000 features and 256 RANSAC iterations (the CPU's cut of the
graph's 5000 and 2500, which chip_smoke.py runs).

The MatchSet must be equal in every field, its distances bit for bit: the
port sums ``|q|^2 + |r|^2 - 2 q.r`` in the compiled reference's order
(``ops/matching.py l2_topk``, read off by tools/fit_l2_order.py).
The accepts must be the same objects and instances with the same
unique-inlier counts, poses within ``POSE_TOL``. chip_smoke.py phase 7e
holds the port's graph on the card to the reference's rows and accepts
stored by tools/make_torch_jpeg_fixture.py."""

import os

import numpy as np
import pytest
import torch

import tod_tpu.db as rdb
from tod_tpu.pipeline import Scheduler as RefScheduler
from tod_tpu.pipeline import build_pipeline_from_ork as ref_build
import tod_tpu_torch.db as tdb
from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
from test_torch_cells import POSE_TOL, pose_gap
from torch_parity import native_library

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORK = os.path.join(ROOT, "conf", "detection.ork")
# conf/detection.ork's own settings with the feature switched to SIFT and
# the SIFT serving graph's radius (conf/detection.sift.serving.ork)
SIFT_GRAPH = {
    "feature": {"type": "SIFT", "n_features": 5000, "n_levels": 3,
                "scale_factor": 1.2},
    "descriptor": {"type": "SIFT"},
    "search": {"type": "LSH", "key_size": 16, "multi_probe_level": 1,
               "n_tables": 10, "radius": 0.9, "ratio": 0.8},
}
CPU_CUT = {"feature": {**SIFT_GRAPH["feature"], "n_features": 3000},
           "n_ransac_iterations": 256}


@pytest.fixture(scope="module", autouse=True)
def _native_library():
    native_library()


@pytest.fixture(scope="module")
def sift_inputs(tmp_path_factory):
    """The three SIFT models in a FilesystemDb written by the reference,
    and frame 0 as an .npz frame directory."""
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    root = str(tmp_path_factory.mktemp("sift_graph_db"))
    db = rdb.FilesystemDb(root)
    for i, oid in enumerate(sx["model_ids"]):
        rdb.write_model(db, str(oid), sx[f"desc{i}"].astype(np.float32)
                        / 256.0, sx[f"points{i}"])
    frames = tmp_path_factory.mktemp("sift_graph_frames")
    np.savez(frames / "frame0.npz", image=fx["images"][0],
             depth=fx["depths"][0], K=fx["K"])
    return {"type": "filesystem", "root": root}, str(frames)


def run_sift_graph(build, sched, db, frames, **extra):
    pipeline = build(ORK, {"source1": {"path": frames, "loop": False},
                           "pipeline1": {"db": db, **SIFT_GRAPH, **CPU_CUT,
                                         **extra}})
    sched(pipeline.plasm).execute_iteration()
    det = pipeline.cells["pipeline1"]
    return (det.descriptor_matcher.outputs["matches"],
            list(det.outputs["pose_results"]))


def test_sift_global_graph_matches_reference(sift_inputs):
    db, frames = sift_inputs
    tdb.InMemoryDb.reset_shared()
    ref_m, ref_found = run_sift_graph(ref_build, RefScheduler, db, frames)
    m, found = run_sift_graph(build_pipeline_from_ork, Scheduler, db,
                              frames, device="cpu")
    rows = (m.train_idx != ref_m.train_idx).any(axis=1)
    assert int(rows.sum()) == 0, f"{int(rows.sum())} query rows differ"
    for name in ("dist", "train_idx", "obj_idx", "local_idx", "valid"):
        a, b = getattr(m, name), getattr(ref_m, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    assert int(ref_m.valid.sum()) > 1000
    assert [(r.object_id, r.confidence) for r in found] == \
        [(r.object_id, r.confidence) for r in ref_found]
    for a, b in zip(found, ref_found):
        dt, ang = pose_gap(a, b)
        assert dt < POSE_TOL[0] and ang < POSE_TOL[1], (a.object_id, dt, ang)
    assert {"obj000", "obj001", "obj002"} <= {r.object_id for r in found}
