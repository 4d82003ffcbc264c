"""tod_tpu_torch stands alone: importing it and every submodule pulls in
neither JAX, cv2, yaml nor the JAX package (none of them is installed on
the machine with the GPU), nor matplotlib (only ``view --png`` imports
it), and builds no kernel."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import tod_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tod_tpu_torch.__path__,
                                               "tod_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from tod_tpu_torch import kernels
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml",
                                       "tod_tpu", "triton", "matplotlib"))
print(json.dumps({"modules": names, "banned": banned,
                  "loaded": sorted(kernels._loaded)}))
"""


def test_port_imports_no_jax_cv2_yaml_or_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("models.fused", "ops.sift", "ops.segmented_l2",
                 "ops.hamming", "ops.matching", "geometry.detection",
                 "ops.morphology", "ops.compress", "parallel.train",
                 "cells.trainer", "utils.config", "pipeline.tendril",
                 "pipeline.cell", "pipeline.plasm", "pipeline.scheduler",
                 "pipeline.blackbox", "pipeline.ork_yaml", "pipeline.ork",
                 "db.document", "db.backends", "db.views", "db.models",
                 "cells.types", "cells.io", "cells.readers",
                 "cells.features", "cells.matcher", "cells.guess",
                 "cells.serving", "models.detector", "models.trainer",
                 "cli", "geometry.pnp", "geometry.detection2d",
                 "utils.profiling", "parallel", "parallel.mesh",
                 "parallel.matching", "parallel.segmented",
                 "parallel.serving", "parallel.detect", "parallel.pipeline",
                 "parallel.dryrun", "utils.png", "utils.visualize",
                 "utils.ingest", "db.legacy", "db.migrate", "cells.viz",
                 "utils.exif", "utils.jpeg", "utils.raster",
                 "utils.synthetic"):
        assert f"tod_tpu_torch.{name}" in got["modules"]
    assert len(got["modules"]) >= 73
    assert got["banned"] == [] and got["loaded"] == []


CLI_PROBE = r"""
import runpy, sys
sys.argv = ["tod_tpu_torch.cli", "--help"]
try:
    runpy.run_module("tod_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml",
                                       "tod_tpu", "triton", "matplotlib"))
print("BANNED", banned)
"""


def test_cli_help_imports_no_jax_cv2_yaml_or_reference():
    """``python -m tod_tpu_torch.cli --help`` on a fresh interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", CLI_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "training" in out.stdout and "detection" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BANNED []"


INGEST_PROBE = r"""
import json, os, sys, tempfile
import numpy as np
from tod_tpu_torch import cli
from tod_tpu_torch.utils import png, synthetic
# a "pairs" recording of one rendered frame: JPEG colour, PNG depth
JPEG = bytes.fromhex(sys.argv[1])
src = tempfile.mkdtemp()
with open(os.path.join(src, "color_0000.jpg"), "wb") as f:
    f.write(JPEG)
png.write_png(os.path.join(src, "depth_0000.png"),
              np.full((16, 24), 800, np.uint16))
cli.main(["ingest", "--format", "pairs", "--rgb-glob", "color_*.jpg",
          src, os.path.join(src, "out")])
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml",
                                       "tod_tpu", "triton", "matplotlib"))
print("BANNED", json.dumps(banned))
"""


def test_ingest_of_a_jpeg_imports_no_jax_cv2_yaml_or_reference():
    """``cli ingest`` of a JPEG recording, and the renderer, import none
    of them."""
    import cv2
    import numpy as np

    img = np.random.default_rng(0).integers(0, 255, (16, 24, 3), np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", INGEST_PROBE, jpg.hex()],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "wrote 1 frames" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BANNED []"
