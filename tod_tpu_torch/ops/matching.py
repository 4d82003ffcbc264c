"""Bit helpers for 256-bit binary descriptors and the streaming exact k-NN
matcher (tod_tpu/ops/matching.py).

:func:`hamming_topk` is the reference's XLA matcher as plain PyTorch: the
exact Hamming distance of every (query, row) pair as ``popcount(q) +
popcount(r) - 2 q.r`` on unpacked bits (integers below 2^24 are exact in an
f32 product), streamed over row chunks with a running top-k, so the Q x N
distance matrix never materialises. :func:`l2_topk` is its counterpart by
squared L2 distance for float (SIFT) descriptors, which the cell graph's
DescriptorMatcher runs; the reference computes it in XLA, outside any
Pallas kernel, and so does this port (a plain f32 product).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.fast import stable_topk

BIG_DIST = 1e9


def unpack_bits(desc_u8: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, B) uint8 -> (N, 8*B) 0/1 values, LSB-first per byte (the cv::ORB /
    np.unpackbits(bitorder='little') convention)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[:, :, None] >> shifts) & 1
    return bits.reshape(desc_u8.shape[0], -1).to(dtype)


def popcount_rows(desc_u8: torch.Tensor) -> torch.Tensor:
    """(N, B) uint8 -> (N,) float32 popcounts."""
    return unpack_bits(desc_u8, torch.float32).sum(dim=1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 8*B) 0/1 -> (N, B) uint8, LSB-first per byte (inverse of
    :func:`unpack_bits`)."""
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    grouped = bits.to(torch.uint8).reshape(bits.shape[0], -1, 8)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)


class Matches(NamedTuple):
    """Top-k matches per query descriptor (padded, masked)."""

    dist: torch.Tensor   # (Q, k) float32 Hamming distance
    idx: torch.Tensor    # (Q, k) int32 global DB row
    valid: torch.Tensor  # (Q, k) bool: within radius, real row, valid query


def _merge_topk(best_d, best_i, new_d, new_i, k: int):
    """The ``k`` smallest of the running best and a chunk's candidates; on a
    tie the running best (the earlier chunk) comes first."""
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    nd, pos = stable_topk(-d, k)
    return -nd, torch.gather(i, 1, pos)


def hamming_topk(query_u8: torch.Tensor, db_u8: torch.Tensor, n_db_valid: int,
                 k: int = 5, chunk: int = 16384
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by Hamming distance: ``(dist (Q, k) f32, idx (Q, k) i32)``
    ascending, ties to the lower row. ``db_u8`` (N, 32) uint8 with N a
    multiple of ``chunk``; rows from ``n_db_valid`` on are padding at
    distance ``BIG_DIST`` (and may fill the tail when fewer than k rows
    are valid)."""
    n = db_u8.shape[0]
    if n % chunk != 0:
        raise ValueError(f"db rows {n} not a multiple of chunk {chunk}")
    dev = query_u8.device
    q_bits = unpack_bits(query_u8)                          # (Q, 256)
    q_pop = q_bits.sum(dim=1, keepdim=True)
    q = query_u8.shape[0]
    best_d = torch.full((q, k), BIG_DIST, dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    big = torch.full((), BIG_DIST, dtype=torch.float32, device=dev)
    for base in range(0, n, chunk):
        db_bits = unpack_bits(db_u8[base:base + chunk])     # (chunk, 256)
        dist = q_pop + db_bits.sum(dim=1)[None, :] - 2.0 * (q_bits @ db_bits.T)
        gidx = torch.arange(base, base + chunk, dtype=torch.int32,
                            device=dev)
        dist = torch.where(gidx[None, :] < n_db_valid, dist, big)
        nd, pos = stable_topk(-dist, k)
        best_d, best_i = _merge_topk(best_d, best_i, -nd, gidx[pos], k)
    return best_d, best_i


def l2_topk(query: torch.Tensor, db: torch.Tensor, n_db_valid: int,
            k: int = 5, chunk: int = 4096
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2 distance (tod_tpu/ops/matching.py:107):
    ``(d_sq (Q, k) f32, idx (Q, k) i32)`` ascending, ties to the lower row,
    with :func:`hamming_topk`'s contract for ``db`` (N a multiple of
    ``chunk``) and its padding rows. ``max(|q|^2 + |r|^2 - 2 q.r, 0)`` from
    an f32 product."""
    n = db.shape[0]
    if n % chunk != 0:
        raise ValueError(f"db rows {n} not a multiple of chunk {chunk}")
    dev = query.device
    q32 = query.to(torch.float32)
    q_sq = (q32 * q32).sum(dim=1, keepdim=True)
    qn = query.shape[0]
    best_d = torch.full((qn, k), BIG_DIST, dtype=torch.float32, device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    big = torch.full((), BIG_DIST, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for base in range(0, n, chunk):
        db_c = db[base:base + chunk].to(torch.float32)
        d_sq = (db_c * db_c).sum(dim=1)[None, :]
        dist = torch.maximum(q_sq + d_sq - 2.0 * (q32 @ db_c.T), zero)
        gidx = torch.arange(base, base + chunk, dtype=torch.int32,
                            device=dev)
        dist = torch.where(gidx[None, :] < n_db_valid, dist, big)
        nd, pos = stable_topk(-dist, k)
        best_d, best_i = _merge_topk(best_d, best_i, -nd, gidx[pos], k)
    return best_d, best_i


def radius_truncate(dist: torch.Tensor, idx: torch.Tensor, radius: float,
                    query_valid: torch.Tensor) -> Matches:
    """The reference's radius cut: keep matches up to (not including) the
    first one farther than ``radius``; distances ascend, so that equals
    ``dist <= radius``."""
    within = dist <= radius
    valid = within & (idx >= 0) & query_valid[:, None]
    return Matches(dist=dist, idx=idx, valid=valid)


# copied from tod_tpu/ops/matching.py pad_db (numpy only)
def pad_db(desc_u8: np.ndarray, chunk: int) -> Tuple[np.ndarray, int]:
    """Pad a DB descriptor matrix up to a chunk multiple; returns (padded, n)."""
    n = desc_u8.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        desc_u8 = np.concatenate(
            [desc_u8, np.zeros((n_pad,) + desc_u8.shape[1:], desc_u8.dtype)])
    return desc_u8, n
