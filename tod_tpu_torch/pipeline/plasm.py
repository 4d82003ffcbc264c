"""Plasm: the dataflow graph of cells + connections (tod_tpu/pipeline/
plasm.py).

The ecto ``Plasm`` analog (reference usage: apps/feature_viewer:43-50). The
topological order is :func:`toposort`, the algorithm of the reference's
native core (tod_tpu/native/src/tod_native.cc tod_toposort) in Python.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple, Union

from tod_tpu_torch.pipeline.cell import Cell


def toposort(n_nodes: int, edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Kahn's algorithm with the ready nodes popped lowest index first (the
    reference's ``tod_toposort``, tod_native.cc:331-351): a deterministic
    topological order of nodes ``0 .. n_nodes - 1``; raises ``ValueError``
    on a cycle."""
    out_adj: List[List[int]] = [[] for _ in range(n_nodes)]
    indeg = [0] * n_nodes
    for src, dst in edges:
        out_adj[src].append(dst)
        indeg[dst] += 1
    ready = [v for v in range(n_nodes) if indeg[v] == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        v = heapq.heappop(ready)
        order.append(v)
        for u in out_adj[v]:
            indeg[u] -= 1
            if indeg[u] == 0:
                heapq.heappush(ready, u)
    if len(order) != n_nodes:
        raise ValueError("plasm graph has a cycle")
    return order


@dataclass(frozen=True)
class Connection:
    src: Cell
    src_port: str
    dst: Cell
    dst_port: str

    def propagate(self) -> None:
        self.dst.inputs[self.dst_port] = self.src.outputs[self.src_port]


class Plasm:
    def __init__(self):
        self.cells: List[Cell] = []
        self.connections: List[Connection] = []

    def insert(self, cell: Cell) -> None:
        if cell not in self.cells:
            self.cells.append(cell)

    def connect(self, *connections: Union[Connection, Iterable[Connection]]) -> None:
        for item in connections:
            conns = [item] if isinstance(item, Connection) else list(item)
            for c in conns:
                if c.src_port not in c.src.outputs:
                    raise KeyError(
                        f"{c.src.name} has no output {c.src_port!r}")
                if c.dst_port not in c.dst.inputs:
                    raise KeyError(
                        f"{c.dst.name} has no input {c.dst_port!r}")
                self.insert(c.src)
                self.insert(c.dst)
                self.connections.append(c)

    def toposorted(self) -> List[Cell]:
        index = {id(c): i for i, c in enumerate(self.cells)}
        edges = [(index[id(c.src)], index[id(c.dst)])
                 for c in self.connections]
        order = toposort(len(self.cells), edges)
        return [self.cells[i] for i in order]

    def execute(self, niter: int = 1) -> None:
        from tod_tpu_torch.pipeline.scheduler import Scheduler
        Scheduler(self).execute(niter)
