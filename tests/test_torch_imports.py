"""tod_tpu_torch stands alone: importing it and every submodule pulls in
neither JAX, cv2, yaml nor the JAX package (none of them is installed on
the machine with the GPU), and builds no kernel."""

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
                                       "tod_tpu", "triton"))
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
                 "cells.trainer"):
        assert f"tod_tpu_torch.{name}" in got["modules"]
    assert len(got["modules"]) >= 28
    assert got["banned"] == [] and got["loaded"] == []
