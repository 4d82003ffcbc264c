"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled at
first use with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so``
(the hash is of the source and of the local headers it includes, so an
edited kernel or header is rebuilt), then loaded with ``ctypes``.
``ptxas``'s report of each kernel's registers, shared memory and spills
is kept in :data:`build_log`. Nothing here runs at
import time; on a machine without a CUDA toolkit only :func:`load` fails,
and only when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("segmented_top1", "segmented_l2_top1",   # csrc/, by file stem
           "hamming_topk", "threefry_gumbel", "libm_f32", "sift_descriptor",
           "l2_distances", "p3p", "gauss_newton", "orientation",
           "mirror", "consensus")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}     # entry points, typed once
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


def local_includes(src: Path) -> list:
    """The headers of ``src``'s directory that it includes with quotes,
    directly or through another such header, in the order first met."""
    found: list = []
    todo = [src]
    while todo:
        text = todo.pop(0).read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            header = src.parent / name
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def digest(src: Path) -> str:
    """12 hex digits of the SHA-1 of ``src`` and its local headers."""
    h = hashlib.sha1(src.read_bytes())
    for header in local_includes(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    return h.hexdigest()[:12]


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, building it if needed."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    lib_path = BUILD / f"lib{name}-{digest(src)}.so"
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
    key = (name, entry, len(pointers), len(ints))
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(name), entry)
        fn.argtypes = [ctypes.c_void_p] * len(pointers) \
            + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[key] = fn
    status = fn(*pointers, *ints, stream)
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError "
                           f"{status}")
