"""Scheduler: executes a plasm's cells in dataflow order (a copy of
tod_tpu/pipeline/scheduler.py).

The ecto-scheduler analog (the reference runs everything through ecto's
single-process scheduler, SURVEY.md L1). Topological order and cycle
detection come from :func:`tod_tpu_torch.pipeline.plasm.toposort`; per-cell
wall times are recorded for observability. Each computing cell reads its
device results back to the host before it returns, so a cell's wall time
includes its device work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

from tod_tpu_torch.pipeline.plasm import Plasm


class Scheduler:
    def __init__(self, plasm: Plasm):
        self.plasm = plasm
        self.cell_times: Dict[str, float] = defaultdict(float)
        self.n_iterations = 0
        self._order = None

    def prepare(self) -> None:
        if self._order is None:
            self._order = self.plasm.toposorted()
            for cell in self._order:
                cell.ensure_configured()
        # incoming connections per cell, in insertion order
        self._incoming = defaultdict(list)
        for conn in self.plasm.connections:
            self._incoming[id(conn.dst)].append(conn)

    def execute_iteration(self) -> None:
        self.prepare()
        for cell in self._order:
            for conn in self._incoming[id(cell)]:
                conn.propagate()
            t0 = time.perf_counter()
            cell.process()
            self.cell_times[cell.name] += time.perf_counter() - t0
        self.n_iterations += 1

    def execute(self, niter: int = 1) -> None:
        for _ in range(niter):
            self.execute_iteration()

    def timing_report(self) -> str:
        lines = [f"scheduler: {self.n_iterations} iterations"]
        for name, t in sorted(self.cell_times.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<24} {1e3 * t / max(self.n_iterations, 1):8.2f} ms/iter")
        return "\n".join(lines)


class ThreadedScheduler(Scheduler):
    """Executes independent cells of each dataflow level concurrently.

    The ecto multithreaded-scheduler analog (the reference exposes scheduler
    options through ecto, apps/feature_viewer:18-19). Python threads release
    the GIL inside torch/numpy compute, so IO-bound and host-compute cells
    overlap; cells within one topological level never share data edges.
    """

    def __init__(self, plasm: Plasm, max_workers: int = 4):
        super().__init__(plasm)
        self.max_workers = max_workers
        self._levels = None

    def prepare(self) -> None:
        super().prepare()
        if self._levels is not None:
            return
        # group the topological order into dependency levels
        level_of: Dict[int, int] = {}
        deps = defaultdict(set)
        for conn in self.plasm.connections:
            deps[id(conn.dst)].add(id(conn.src))
        levels: List[List] = []
        for cell in self._order:
            lvl = 1 + max((level_of[d] for d in deps[id(cell)]), default=-1)
            level_of[id(cell)] = lvl
            while len(levels) <= lvl:
                levels.append([])
            levels[lvl].append(cell)
        self._levels = levels

    def execute_iteration(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self.prepare()

        def run_cell(cell):
            for conn in self._incoming[id(cell)]:
                conn.propagate()
            t0 = time.perf_counter()
            cell.process()
            self.cell_times[cell.name] += time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            for level in self._levels:
                if len(level) == 1:
                    run_cell(level[0])
                else:
                    list(pool.map(run_cell, level))
        self.n_iterations += 1
