"""Profiling helpers (tod_tpu/utils/profiling.py).

A ``torch.profiler`` trace around any region, written as a Chrome trace
(open it in Perfetto, chrome://tracing or TensorBoard's profiler plugin); a
pipelined wall-clock timer that waits for the device the way the reference
waits for its own (a scalar reduction of the output read back to the host);
and a stage timer that times a stage on a card by CUDA events on the
current stream and on the CPU by the host clock. The per-cell scheduler
timing lives in ``pipeline.scheduler.timing_report``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the region into ``log_dir``
    (one ``*.pt.trace.json`` Chrome trace): CPU activity, and the card's
    kernels and copies when CUDA is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof


def _first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor of a (nested) tuple, list or dict output."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _sync(out) -> float:
    """Wait for ``out``: a scalar reduction of its first tensor, read back
    to the host (the reference's hard sync)."""
    t = _first_tensor(out)
    return 0.0 if t is None else float(t.double().sum())


def timed(fn, *args, n: int = 20, warmup: int = 1) -> float:
    """Average seconds per call of ``fn(*args)`` over ``n`` calls issued
    back to back, after ``warmup`` calls, each side ended by reading the
    last output back to the host."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / n


class StageTimer:
    """Accumulate named stages. On a CUDA ``device`` a stage is the device
    time between two CUDA events recorded on the current stream (the
    events are read, waiting for the card, in :meth:`report`); on the CPU
    it is the host clock. For pipeline cells use
    ``Scheduler.timing_report``."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self._pending: List[Tuple[str, torch.cuda.Event,
                                  torch.cuda.Event]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield
            finally:
                end.record(stream)
                self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds

    def _collect(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3)
        self._pending.clear()

    def report(self) -> str:
        self._collect()
        total = sum(self.times.values()) or 1.0
        lines = [f"  {k:<24} {v*1e3:8.2f} ms ({100*v/total:4.1f}%)"
                 for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)


__all__ = ["StageTimer", "timed", "trace"]
