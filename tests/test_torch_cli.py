"""The port's CLI (ROADMAP A12b): ``python -m tod_tpu_torch.cli``, the
counterpart of apps/tod, on the CPU.

Its help, and a training then detection round trip in a temporary
directory as tests/test_apps.py runs apps/tod: observations of object 0
(tests/data/torch_train_fixture.npz) in a FilesystemDb, a training .ork and
a detection .ork written there, ``--device cpu``. The model document the
CLI writes equals ``train_object``'s on the same views, bit for bit, and
detection on the smoke fixture's frames prints the poses of the port's
TodDetector built in process from the same .ork.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tod_tpu_torch.cells.trainer import train_object
from tod_tpu_torch.db import (FilesystemDb, insert_observation,
                              load_models_for_objects)
from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
from tod_tpu_torch.types import fixture_observations

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ENV = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
       + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
FEATURES = {"type": "ORB", "n_features": 400, "n_levels": 3,
            "scale_factor": 1.2}


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "tod_tpu_torch.cli", *args],
                          capture_output=True, text=True, env=ENV, cwd=ROOT,
                          timeout=600)


def test_cli_help():
    r = _cli("--help")
    assert r.returncode == 0, r.stderr
    assert "training" in r.stdout and "detection" in r.stdout
    for command in ("training", "detection"):
        r = _cli(command, "--help")
        assert r.returncode == 0 and "--device" in r.stdout


def test_cli_profile_is_not_ported(tmp_path):
    """``--profile DIR`` (ported since: the name is kept) runs the detection
    loop inside a torch.profiler trace and writes it into DIR; here a graph
    of the frame source alone over one frame."""
    frames = tmp_path / "frames"
    frames.mkdir()
    np.savez(frames / "frame0.npz", image=np.zeros((4, 4, 3), np.uint8),
             depth=np.zeros((0, 0)), K=np.eye(3))
    conf = tmp_path / "d.ork"
    conf.write_text("source1:\n  type: OpenNI\n")
    trace_dir = tmp_path / "trace"
    r = _cli("detection", "-c", str(conf), "--frames", str(frames),
             "--profile", str(trace_dir))
    assert r.returncode == 0, r.stderr
    assert "frame 0: 0 poses" in r.stdout
    assert list(trace_dir.glob("*.pt.trace.json"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Object 0's views (every sixth of 60) in a FilesystemDb, trained
    through the CLI: (db root, views)."""
    root = str(tmp_path_factory.mktemp("cli") / "db")
    views = fixture_observations(np.load(os.path.join(
        DATA, "torch_train_fixture.npz")), 0)[::6]
    db = FilesystemDb(root)
    for o in views:
        insert_observation(db, "obj000", o.frame_number, o.image, o.depth,
                           o.mask, o.K, o.R, o.T)
    conf = os.path.join(os.path.dirname(root), "training.ork")
    with open(conf, "w") as f:
        f.write(f"""
pipeline1:
  type: TodTrainer
  module: object_recognition_tod
  parameters:
    feature: {json.dumps(FEATURES).replace('"', '')}
    descriptor: {{type: ORB}}
    db: {{type: filesystem, root: '{root}'}}
    object_ids: "all"
""")
    r = _cli("training", "-c", conf, "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "training object obj000" in r.stdout
    return root, views


def test_cli_training_writes_the_trained_model(trained):
    root, views = trained
    (model,) = load_models_for_objects(FilesystemDb(root), "all")
    desc, pts = train_object(views, FEATURES, device="cpu")
    assert model.object_id == "obj000" and len(desc) > 500
    np.testing.assert_array_equal(model.descriptors, desc)
    np.testing.assert_array_equal(model.points, pts.reshape(-1, 3))


def test_cli_detection_round_trip(trained, tmp_path):
    root, _ = trained
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    frames = tmp_path / "frames"
    frames.mkdir()
    for f in range(len(fx["images"])):
        np.savez(frames / f"frame{f}.npz", image=fx["images"][f],
                 depth=fx["depths"][f], K=fx["K"])
    conf = tmp_path / "detection.ork"
    conf.write_text(f"""
source1:
  type: OpenNI
  module: object_recognition_core.io.source
pipeline1:
  type: TodDetector
  module: object_recognition_tod
  inputs: [source1]
  parameters:
    object_ids: "all"
    feature: {{type: ORB, n_features: 1000, n_levels: 3, scale_factor: 1.2}}
    descriptor: {{type: ORB}}
    search: {{type: LSH, radius: 35, ratio: 0.8}}
    n_ransac_iterations: 256
    min_inliers: 8
    sensor_error: 0.01
    db: {{type: filesystem, root: '{root}'}}
""")
    r = _cli("detection", "-c", str(conf), "--frames", str(frames),
             "--timing", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "scheduler: 2 iterations" in r.stderr
    # the same .ork in process, on the CPU: the lines the CLI prints
    pipeline = build_pipeline_from_ork(str(conf), {
        "source1": {"path": str(frames), "loop": False},
        "pipeline1": {"device": "cpu"}})
    sched = Scheduler(pipeline.plasm)
    want = []
    for it in range(2):
        sched.execute_iteration()
        results = pipeline.cells["pipeline1"].outputs["pose_results"]
        want.append(f"frame {it}: {len(results)} poses")
        want += [f"  {p.object_id}: T={[round(float(x), 4) for x in p.T]} "
                 f"inliers={int(p.confidence)}" for p in results]
    assert r.stdout.splitlines() == want
    assert "obj000" in r.stdout
