#!/usr/bin/env python3
"""Measured throughput of ``__popc`` and ``__dp4a`` on the GPU, the
operations that bound the matcher kernels on the CUDA cores, of the two
``mma.sync`` products that the tensor-core kernels use (int8 m16n8k32 and
1-bit m16n8k256 ``.and.popc``, whose rate on the H100 no data sheet gives),
and of the warpgroup products ``wgmma`` m64n256k32 int8 and m64n256k256
1-bit ``.and.popc`` (A from shared memory, and the 1-bit one with A in
registers too), the way to the full tensor-core rate.

    python3 tools/bench_int_rate.py

Builds tools/bench_int_rate.cu with nvcc for sm_90a into
tod_tpu_torch/build/ (removed after the run), runs each operation as 8 independent chains a thread on every
SM (``wgmma``: one warpgroup a block, two blocks an SM, a group of four
products kept in flight), and prints operations per second, per clock and SM at the card's
maximum clock and at the clock nvidia-smi reads just after the run, and the
descriptor pairs per second they allow (8 ``__popc`` a Hamming pair, 32
``__dp4a`` an int8 L2 pair; 512 int8 operations a Hamming pair on unpacked
bits, or 512 bit operations on packed bits), beside the card's name and
power limit. Needs only the CUDA toolkit and a card (no torch).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 1 << 16
MMA_ITERS = 1 << 12
# op id of tools/bench_int_rate.cu -> (name, operations a descriptor pair)
OPS = {"popc": (0, 8), "dp4a": (1, 32), "mma_s8": (2, 512),
       "mma_b1": (3, 512), "wgmma_b1": (4, 512), "wgmma_s8": (5, 512),
       "wgmma_b1_rega": (6, 512)}
UNITS = {"popc": "__popc", "dp4a": "__dp4a",
         "mma_s8": "int8 operations of mma s8",
         "mma_b1": "bit operations of mma b1",
         "wgmma_b1": "bit operations of wgmma b1",
         "wgmma_s8": "int8 operations of wgmma s8",
         "wgmma_b1_rega": "bit operations of wgmma b1 (A in registers)"}
B1_OPS = ("mma_b1", "wgmma_b1", "wgmma_b1_rega")   # the 1-bit products


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0].strip()


def measure_rates() -> Dict[str, dict]:
    """Build the bench (into tod_tpu_torch/build/) and run each operation
    once on the current card: ``{name: {"rate": operations/s,
    "per_clock_sm": at the maximum clock, "ms", "operations", "n_sm",
    "max_mhz"}}``. Raises if ptxas warns (a serialised ``wgmma`` would
    understate its rate)."""
    from tod_tpu_torch.kernels import BUILD, NVCC_FLAGS, _nvcc

    out = {}
    BUILD.mkdir(parents=True, exist_ok=True)
    lib_path = str(BUILD / f"libbench_int_rate.{os.getpid()}.so")
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", lib_path,
             os.path.join(ROOT, "tools", "bench_int_rate.cu")],
            capture_output=True, text=True)
        warnings = [ln for ln in proc.stderr.splitlines()
                    if "warning" in ln.lower() or "error" in ln.lower()]
        if proc.returncode != 0 or warnings:
            raise RuntimeError("nvcc for bench_int_rate.cu:\n"
                               + "\n".join(warnings or [proc.stderr]))
        lib = ctypes.CDLL(lib_path)
        lib.bench_int_rate.restype = ctypes.c_int
        for name, (op, _) in OPS.items():
            ms, count = ctypes.c_float(), ctypes.c_double()
            n_sm, khz = ctypes.c_int(), ctypes.c_int()
            status = lib.bench_int_rate(
                op, ITERS if op < 2 else MMA_ITERS, ctypes.byref(ms),
                ctypes.byref(count), ctypes.byref(n_sm), ctypes.byref(khz))
            if status != 0:
                raise RuntimeError(f"{name}: cudaError {status}")
            rate = count.value / (ms.value * 1e-3)
            out[name] = dict(rate=rate, ms=float(ms.value),
                             operations=count.value, n_sm=n_sm.value,
                             max_mhz=khz.value / 1e3,
                             per_clock_sm=rate / n_sm.value
                             / (khz.value * 1e3))
    finally:
        if os.path.exists(lib_path):
            os.remove(lib_path)
    return out


def b1_rate(rates: Dict[str, dict]) -> float:
    """The highest measured 1-bit rate (bit operations/s) of ``B1_OPS``:
    the card's 1-bit tensor rate as far as this bench can show it."""
    return max(rates[name]["rate"] for name in B1_OPS)


def main() -> int:
    card = smi("name,power.limit")
    for name, r in measure_rates().items():
        now_mhz = float(smi("clocks.sm").split()[0])
        per_pair = OPS[name][1]
        print(f"{name}: {r['operations']:.4g} {UNITS[name]} in "
              f"{r['ms']:.3f} ms = {r['rate']:.4g} /s; "
              f"{r['per_clock_sm']:.2f} per clock and SM at the maximum "
              f"{r['max_mhz']:.0f} MHz x {r['n_sm']} SMs, "
              f"{r['rate'] / r['n_sm'] / (now_mhz * 1e6):.2f} at the "
              f"{now_mhz:.0f} MHz read after the run; "
              f"{r['rate'] / per_pair:.4g} pairs/s at {per_pair} a pair; "
              f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
