#!/usr/bin/env python3
"""Measured throughput of ``__popc`` and ``__dp4a`` on the GPU, the
operations that bound the matcher kernels on the CUDA cores.

    python3 tools/bench_int_rate.py

Builds tools/bench_int_rate.cu with nvcc for sm_90a into a temporary
directory, runs each operation as 8 independent chains a thread on every
SM, and prints operations per second, per clock and SM at the card's
maximum clock and at the clock nvidia-smi reads just after the run, and the
descriptor pairs per second they allow (8 ``__popc`` a Hamming pair, 32
``__dp4a`` an int8 L2 pair), beside the card's name and power limit. Needs
only the CUDA toolkit and a card (no torch).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 1 << 16
PER_PAIR = {"__popc": 8, "__dp4a": 32}


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0].strip()


def main() -> int:
    from tod_tpu_torch.kernels import NVCC_FLAGS, _nvcc

    card = smi("name,power.limit")
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libbench_int_rate.so")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path,
                        os.path.join(ROOT, "tools", "bench_int_rate.cu")],
                       check=True)
        lib = ctypes.CDLL(lib_path)
        lib.bench_int_rate.restype = ctypes.c_int
        for op, name in enumerate(PER_PAIR):
            ms, count = ctypes.c_float(), ctypes.c_double()
            n_sm, khz = ctypes.c_int(), ctypes.c_int()
            status = lib.bench_int_rate(
                op, ITERS, ctypes.byref(ms), ctypes.byref(count),
                ctypes.byref(n_sm), ctypes.byref(khz))
            if status != 0:
                raise RuntimeError(f"{name}: cudaError {status}")
            now_mhz = float(smi("clocks.sm").split()[0])
            rate = count.value / (ms.value * 1e-3)
            per_sm = rate / n_sm.value
            print(f"{name}: {count.value:.4g} operations in {ms.value:.3f} "
                  f"ms = {rate:.4g} /s; {per_sm / (khz.value * 1e3):.2f} per "
                  f"clock and SM at the maximum {khz.value / 1e3:.0f} MHz x "
                  f"{n_sm.value} SMs, {per_sm / (now_mhz * 1e6):.2f} at the "
                  f"{now_mhz:.0f} MHz read after the run; "
                  f"{rate / PER_PAIR[name]:.4g} pairs/s at "
                  f"{PER_PAIR[name]} a pair; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
