"""The ('data', 'db') device mesh (tod_tpu/parallel/mesh.py), for one
controlling process.

The reference runs its sharded programs under ``shard_map`` over a mesh of
devices in one process. Here a mesh is a frozen (n_data, n_db) grid of
``torch.device``s: ``'data'`` splits independent frames, views or query
blocks, ``'db'`` splits the model DB. The same process launches every
tile's work on its device (launches on distinct cards run concurrently);
the reference's collectives become the explicit copies and merges below.
A grid may name one device several times, as ``[cuda:0] * 4`` does: then
each shard still runs at its own offsets, with its own launches, and every
shard boundary of a sharded path is exercised on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "db")


@dataclass(frozen=True)
class Mesh:
    """``devices[i][s]``: the device of tile (data ``i``, db ``s``)."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "db": len(self.devices[0])}

    def device(self, i: int, s: int) -> torch.device:
        return self.devices[i][s]

    @property
    def first(self) -> torch.device:
        """Where the sharded entry points leave their results."""
        return self.devices[0][0]


def make_mesh(n_data: Optional[int] = None, n_db: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """An (n_data, n_db) mesh over ``devices`` in order, row by row; by
    default every CUDA device, each once, on the data axis. A device
    repeats only where the caller's list repeats it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_db
    n = n_data * n_db
    if n > len(devices) or n < 1:
        raise ValueError(f"need {max(n, 1)} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[i * n_db:(i + 1) * n_db])
                      for i in range(n_data)))


def split_even(n: int, parts: int, what: str) -> int:
    """``n // parts``, or raise when ``parts`` does not divide ``n``."""
    if n % parts:
        raise ValueError(f"{what} ({n}) must divide by {parts}")
    return n // parts


def all_gather(parts: Sequence[torch.Tensor], device: torch.device,
               dim: int = 0) -> torch.Tensor:
    """The shards' tensors, in shard order, concatenated along ``dim`` on
    ``device`` (each copied there without waiting on the host)."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim)


def ring_rotate(shards: Sequence) -> List:
    """One step of the ring: position ``j`` takes what ``j + 1`` held."""
    return list(shards[1:]) + list(shards[:1])


def min_over(parts: Sequence[torch.Tensor],
             device: torch.device) -> torch.Tensor:
    """The elementwise minimum of the shards' packed keys, on ``device``."""
    out = parts[0].to(device, non_blocking=True)
    for p in parts[1:]:
        out = torch.minimum(out, p.to(device, non_blocking=True))
    return out
