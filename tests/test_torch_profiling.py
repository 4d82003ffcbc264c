"""The port's profiling API (tod_tpu_torch/utils/profiling.py, the
counterpart of tod_tpu/utils/profiling.py) on the CPU: ``trace`` writes a
``torch.profiler`` Chrome trace, ``timed`` returns seconds per call,
``StageTimer`` accumulates host-clock stages on the CPU and reports them in
the reference's format; and ``python -m tod_tpu_torch.cli detection
--profile DIR`` over depthless frames (the 2D-only path) writes a trace
holding the detection's operators. The card's side (CUDA-event stages, the
kernels in the trace) is in test_torch_cuda.py and chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from tod_tpu.utils import profiling as rprof
from tod_tpu_torch.db import FilesystemDb, write_model
from tod_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
ENV = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
       + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}


def _trace_events(log_dir):
    (path,) = list(log_dir.glob("*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones((64, 64))
    with tprof.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    names = {e.get("name") for e in _trace_events(tmp_path)}
    assert "aten::mm" in names
    assert prof.key_averages()


def test_timed_counts_the_calls_and_returns_seconds():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2, {"unused": x})

    secs = tprof.timed(fn, torch.ones(8), n=5, warmup=2)
    assert len(calls) == 7 and 0 < secs < 1
    assert tprof.timed(lambda: None, n=2, warmup=0) >= 0


def test_stage_timer_on_the_cpu_and_the_reference_report():
    timer = tprof.StageTimer("cpu")
    for _ in range(2):
        with timer.stage("a"):
            torch.ones(1000).sum()
        with timer.stage("b"):
            pass
    assert set(timer.times) == {"a", "b"} and timer.times["a"] > 0
    ref = rprof.StageTimer()
    ref.times = dict(timer.times)
    assert timer.report() == ref.report()
    assert timer.report().splitlines()[0].lstrip().startswith("a ")


def test_cli_detection_profile_writes_a_trace_of_a_depthless_frame(tmp_path):
    """The 2D-only path through the CLI: conf-like TodDetector .ork over
    the smoke fixture's first frame with its depth removed, on the CPU."""
    fx = np.load(os.path.join(DATA, "torch_smoke_fixture.npz"))
    root = str(tmp_path / "db")
    db = FilesystemDb(root)
    for i, oid in enumerate(fx["model_ids"]):
        write_model(db, str(oid), fx[f"desc{i}"], fx[f"points{i}"])
    frames = tmp_path / "frames"
    frames.mkdir()
    np.savez(frames / "frame0.npz", image=fx["images"][0],
             depth=np.zeros((0, 0)), K=fx["K"])
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
    feature: {{type: ORB, n_features: 800, n_levels: 3, scale_factor: 1.2}}
    descriptor: {{type: ORB}}
    search: {{type: LSH, radius: 35, ratio: 0.8}}
    n_ransac_iterations: 128
    min_inliers: 8
    sensor_error: 0.01
    db: {{type: filesystem, root: '{root}'}}
""")
    trace_dir = tmp_path / "trace"
    r = subprocess.run(
        [sys.executable, "-m", "tod_tpu_torch.cli", "detection", "-c",
         str(conf), "--frames", str(frames), "--device", "cpu",
         "--profile", str(trace_dir)],
        capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "frame 0:" in r.stdout and "obj001" in r.stdout
    names = {e.get("name") for e in _trace_events(trace_dir)}
    assert {"aten::bmm", "aten::scatter_add_"} <= names
