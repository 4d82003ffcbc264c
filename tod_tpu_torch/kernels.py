"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled at
first use with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so``
(the hash is of the source, so an edited kernel is rebuilt), then loaded
with ``ctypes``. ``ptxas``'s report of each kernel's registers, shared
memory and spills is kept in :data:`build_log`. Nothing here runs at
import time; on a machine without a CUDA toolkit only :func:`load` fails,
and only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("segmented_top1", "segmented_l2_top1",   # csrc/, by file stem
           "hamming_topk", "threefry_gumbel", "libm_f32", "sift_descriptor")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}     # nvcc's (ptxas -v) report of each build


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of tod_tpu_torch "
                       "need the CUDA toolkit (set NVCC or add it to PATH)")


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib_path = BUILD / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builds agree
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def build_all() -> None:
    """Build every kernel of ``SOURCES`` that is not built yet, one ``nvcc``
    per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(load, SOURCES))


def call(name: str, entry: str, pointers: Sequence[int],
         ints: Sequence[int], stream: int) -> None:
    """Call the C entry point ``entry(pointers..., ints..., stream)`` of
    ``csrc/<name>.cu``; raise on the ``cudaError_t`` it returns."""
    fn = getattr(load(name), entry)
    fn.argtypes = [ctypes.c_void_p] * len(pointers) \
        + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(*pointers, *ints, stream)
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError "
                           f"{status}")
