"""DB-sharded global matching (tod_tpu/parallel/matching.py): kernel B5 on
each shard of the DB's rows.

The DB's rows split evenly over the mesh's ``'db'`` axis and the queries
over ``'data'``; tile (i, s) runs B5 (``ops/hamming.py
hamming_topk_fused``) for query block ``i`` against shard ``s``, with the
shard's own count of valid rows, and moves its rows to global indices.
The top k of the per-shard top k's is the global top k, so both merges are
exact: :func:`sharded_hamming_topk` gathers the per-shard lists and keeps
the k nearest (ties to the lower shard, hence the lower global row, as the
single-device kernel orders them); :func:`ring_hamming_topk` passes the
shards round the ring and folds each into a running top k by the packed
key ``min(dist, 510) << 22 | row``. Results land on the mesh's first
device. The reference's ``_replicate_over_db`` existed only for
``shard_map``'s types and has no counterpart.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from tod_tpu_torch.ops.hamming import hamming_topk_fused, pack_db_bits
from tod_tpu_torch.ops.matching import BIG_DIST
from tod_tpu_torch.parallel.mesh import (Mesh, all_gather, ring_rotate,
                                         split_even)

RING_ROW_BITS = 22
RING_INVALID = 0x7FFFFFFF   # above every packable key (510 << 22 | 2^22-1)


def _shard_rows(mesh: Mesh, words: torch.Tensor, chunk: int) -> int:
    """Rows a shard, or the reference's error when the DB does not split
    into ``'db'`` shards of whole chunks."""
    n_rows, n_db = words.shape[0], mesh.shape["db"]
    shard_rows = n_rows // n_db
    if shard_rows * n_db != n_rows or shard_rows % chunk != 0:
        raise ValueError(
            f"db rows {n_rows} must divide into {n_db} shards of "
            f"chunk-multiple size (chunk={chunk})")
    return shard_rows


def _words(db: torch.Tensor) -> torch.Tensor:
    """B5's DB operand: (N, 8) int32 words, from (N, 32) uint8 rows too."""
    return pack_db_bits(db) if db.dtype == torch.uint8 else db


def _query_blocks(mesh: Mesh, query_u8: torch.Tensor) -> List[torch.Tensor]:
    n_data = mesh.shape["data"]
    per = split_even(query_u8.shape[0], n_data, "queries over 'data'")
    return [query_u8[i * per:(i + 1) * per] for i in range(n_data)]


def _shard_topk(mesh: Mesh, i: int, s: int, q: torch.Tensor,
                shard: torch.Tensor, src: int, shard_rows: int,
                n_valid: int, k: int, radius: Optional[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 on tile (i, s) against the shard that ``src`` owns, its rows
    moved to global indices."""
    dev = mesh.device(i, s)
    offset = src * shard_rows
    local_valid = min(max(n_valid - offset, 0), shard_rows)
    dist, idx = hamming_topk_fused(q.to(dev, non_blocking=True),
                                   shard.to(dev, non_blocking=True),
                                   local_valid, k=k, radius=radius)
    return dist, torch.where(idx >= 0, idx + offset, -1)


def sharded_hamming_topk(mesh: Mesh, query_u8: torch.Tensor,
                         db: torch.Tensor, n_db_valid: int, k: int = 5,
                         chunk: int = 16384, radius: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN with the DB's rows sharded over ``'db'`` and the queries
    over ``'data'``: ``query_u8`` (Q, 32) uint8 (Q divisible by the data
    axis), ``db`` (N, 32) uint8 or (N, 8) int32 words, N divisible into
    ``'db'`` shards of whole ``chunk``s, rows from ``n_db_valid`` on never
    matched; ``radius`` as B5 takes it (None: every row). Returns the
    single-device kernel's ``(dist (Q, k), idx (Q, k))`` with global rows,
    on the mesh's first device."""
    words = _words(db)
    shard_rows = _shard_rows(mesh, words, chunk)
    n_valid = int(n_db_valid)
    out_d, out_i = [], []
    for i, q in enumerate(_query_blocks(mesh, query_u8)):
        parts = [_shard_topk(mesh, i, s, q,
                             words[s * shard_rows:(s + 1) * shard_rows], s,
                             shard_rows, n_valid, k, radius)
                 for s in range(mesh.shape["db"])]
        home = mesh.device(i, 0)
        d = all_gather([p[0] for p in parts], home, dim=1)
        idx = all_gather([p[1] for p in parts], home, dim=1)
        # each list ascends by (dist, row) and the shards ascend by row: a
        # stable sort on dist keeps the lower row first among equals
        pos = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out_d.append(d.gather(1, pos))
        out_i.append(idx.gather(1, pos))
    return all_gather(out_d, mesh.first), all_gather(out_i, mesh.first)


def _merge_topk_by_index(best_d: torch.Tensor, best_i: torch.Tensor,
                         new_d: torch.Tensor, new_i: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k least of two top-k lists by ``min(dist, 510) << 22 | row``:
    independent of the fold's order, so every ring position ends with the
    same list. Rows must be < 2^22; distances past 510 share one bucket,
    behind every nearer match and ahead of the empty slots (-1), whose key
    ``RING_INVALID`` lies above every packable key."""
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    d_int = torch.clamp_max(d, 510.0).to(torch.int32)
    keys = torch.where(i >= 0, (d_int << RING_ROW_BITS) | i, RING_INVALID)
    pos = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    return d.gather(1, pos), i.gather(1, pos)


def ring_hamming_topk(mesh: Mesh, query_u8: torch.Tensor, db: torch.Tensor,
                      n_db_valid: int, k: int = 5, chunk: int = 16384,
                      radius: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_hamming_topk` by passing the shards round the
    ``'db'`` ring: at each of ``n_db`` steps, ring position ``j`` runs B5
    on the shard it holds and folds the result into its running top k
    (:func:`_merge_topk_by_index`), then the shards rotate
    (``mesh.ring_rotate``). After the last step every position holds the
    global top k; position 0's is returned, on the mesh's first device.
    The DB must hold fewer than 2^22 rows (the packed key)."""
    words = _words(db)
    shard_rows = _shard_rows(mesh, words, chunk)
    if words.shape[0] >= (1 << RING_ROW_BITS):
        raise ValueError("ring merge packs (dist, idx) into int32: "
                         f"db rows must be < 2^22, got {words.shape[0]}")
    n_db, n_valid = mesh.shape["db"], int(n_db_valid)
    out_d, out_i = [], []
    for i, q in enumerate(_query_blocks(mesh, query_u8)):
        held = [(s, words[s * shard_rows:(s + 1) * shard_rows])
                for s in range(n_db)]
        best = []
        for j in range(n_db):
            dev = mesh.device(i, j)
            best.append((torch.full((q.shape[0], k), BIG_DIST,
                                    dtype=torch.float32, device=dev),
                         torch.full((q.shape[0], k), -1, dtype=torch.int32,
                                    device=dev)))
        for _ in range(n_db):
            for j, (src, shard) in enumerate(held):
                d, idx = _shard_topk(mesh, i, j, q, shard, src, shard_rows,
                                     n_valid, k, radius)
                best[j] = _merge_topk_by_index(*best[j], d, idx, k)
            held = ring_rotate(held)
        out_d.append(best[0][0])
        out_i.append(best[0][1])
    return all_gather(out_d, mesh.first), all_gather(out_i, mesh.first)
