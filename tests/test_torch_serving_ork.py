"""The SIFT serving graph (``conf/detection.sift.serving.ork``'s schema:
TodDetector with ``pipeline: segmented`` and SIFT features) through each
package's ``build_pipeline_from_ork`` and ``Scheduler`` on the CPU.

The SIFT fixture's three models (every 4th row kept) and seeded fillers, six
objects, served as ``q / 256`` from one FilesystemDb that both packages
read, over the smoke fixture's two frames. The file's own parameters, cut
to the small catalog. The port's SIFT descriptors differ from the
reference's in the last bits (ROADMAP queue C; quantised entries off by one
in under 2e-4 of them), so its compaction may differ by a query or two:
held to the same accepted objects, instances and inlier counts, and poses
within ``POSE_TOL`` of the reference graph's at the gate.
"""

import os

import numpy as np
import pytest
import torch

import tod_tpu.db as rdb
from tod_tpu.pipeline import Scheduler as RefScheduler
from tod_tpu.pipeline import build_pipeline_from_ork as ref_build
import tod_tpu_torch.db as tdb
from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
from tod_tpu_torch.utils.smoke_catalog import smoke_catalog
from test_torch_cells import pose_gap
from torch_parity import native_library

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
POSE_TOL = (1e-4, 0.05)     # meters, degrees: the graphs' depth cells
CUTS = {"n_features: 5000": "n_features: 2000",
        "q_cap: 2048": "q_cap: 1024",
        "n_ransac_iterations: 768": "n_ransac_iterations: 256",
        "max_matches_per_object: 384": "max_matches_per_object: 192",
        "activation_m_cap: 192": "activation_m_cap: 96",
        "activation_hypotheses: 192": "activation_hypotheses: 128",
        "activation_prescreen: 32": "activation_prescreen: 3",
        "max_active_objects: 16": "max_active_objects: 3"}


@pytest.fixture(scope="session", autouse=True)
def _native_library():
    """The reference's Plasm sorts through tod_tpu.native: build it
    safely."""
    native_library()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    sx = np.load(os.path.join(DATA, "torch_sift_fixture.npz"))
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    root = tmp_path_factory.mktemp("sift_serving")
    ids, arrays = smoke_catalog(
        [str(s) for s in sx["model_ids"]],
        [(sx[f"desc{i}"][::4], sx[f"points{i}"][::4]) for i in range(3)],
        n_objects=6)
    db = rdb.FilesystemDb(str(root / "db"))
    for oid, (desc, pts) in zip(ids, arrays):
        rdb.write_model(db, oid, desc.astype(np.float32) / 256.0, pts)
    frames = root / "frames"
    frames.mkdir()
    for f in range(2):
        np.savez(frames / f"frame{f}.npz", image=fx["images"][f],
                 depth=fx["depths"][f], K=fx["K"])
    text = open(os.path.join(ROOT, "conf", "detection.sift.serving.ork")
                ).read()
    for old, new in CUTS.items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    ork = root / "detection.sift.serving.ork"
    ork.write_text(text)
    return dict(ork=str(ork), over={
        "source1": {"path": str(frames), "loop": False},
        "pipeline1": {"db": {"type": "filesystem", "root": str(root / "db")}}})


def test_sift_serving_graph_matches_reference(inputs):
    results = []
    for build, sched, extra in ((ref_build, RefScheduler, {}),
                                (build_pipeline_from_ork, Scheduler,
                                 {"device": "cpu"})):
        tdb.InMemoryDb.reset_shared()
        pipeline = build(inputs["ork"], {**inputs["over"], "pipeline1": {
            **inputs["over"]["pipeline1"], **extra}})
        s = sched(pipeline.plasm)
        frames = []
        for _ in range(2):
            s.execute_iteration()
            frames.append(list(pipeline.cells["pipeline1"].outputs[
                "pose_results"]))
        results.append(frames)
    port = pipeline.cells["pipeline1"].serving._detector
    assert port.config.feature == "SIFT" and port.config.min_quality == 156
    found = []
    for f, (got, want) in enumerate(zip(results[1], results[0])):
        key = lambda r: (r.object_id, r.confidence, r.clique_size)  # noqa
        assert sorted(map(key, got)) == sorted(map(key, want)), f
        for r in got:
            dt, ang = pose_gap(r, next(w for w in want if key(w) == key(r)))
            assert dt < POSE_TOL[0] and ang < POSE_TOL[1], (r.object_id, dt,
                                                            ang)
        found += [r.object_id for r in got]
    assert len(set(found)) >= 2, found
