"""Exact radius k-NN by Hamming distance over a whole DB (kernel B5), and the
isolation probes of its inner loop (T1).

Port of tod_tpu/ops/pallas/hamming.py (``KEY_INVALID``, ``pack_db_bits``,
``pad_queries``, ``hamming_topk_fused``). The DB stays packed, (N, 8) int32
words a row as ``SegmentedDb.words`` holds them: the (256, N) unpacked
transpose and its popcounts existed only to feed the TPU's matrix unit.
The TPU's tile sizes, key shift, VMEM limit, one-hot gather and chunk
fallbacks are not ported: the kernel takes any Q and any N.

:func:`hamming_topk_fused` launches ``csrc/hamming_topk.cu`` on a CUDA tensor
and runs the plain PyTorch twin :func:`hamming_topk_fused_torch` on a CPU
tensor. Both return, per query, the <= k nearest rows among rows <
``n_valid`` within ``radius`` (all of them for ``radius=None``), ascending by
(dist, row); a missing slot is (1e9, -1), after every real match.

:func:`hamming_probe` (T1, a second entry point of the same file; twin
:func:`hamming_probe_torch`) runs the sweep with the extraction replaced by
a per-query distance sum, a per-query minimum or one minimum over all
pairs: what the card spends on distances alone. It runs on three routes
(``PROBE_ROUTES``): the CUDA-core popcount sweep (B5's earlier design) and
the two tensor-core products, int8 ``mma`` on unpacked bits and 1-bit
``mma`` on packed words. B5 is compiled with one of them, fixed in the
source; :func:`b5_route` reads which from the built library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.matching import BIG_DIST, unpack_bits
from tod_tpu_torch.ops.segmented import TWIN_ROWS, checked_query

KEY_INVALID = 2 ** 30      # the reference's invalid sort key (never output)
MAX_K = 8
BLOCK_QUERIES = 256        # queries a block of the tensor-core sweep
POPC_BLOCK_QUERIES = 128   # queries a block of the popcount sweep (T1)
ROW_TILE = 128             # rows a split is rounded to (the staged tile)
MIN_SPLIT_ROWS = 4096      # fewer rows a block would be mostly overhead
MAX_SPLIT_ROWS = 1 << 23   # a split's rows fit the kernel's 23-bit keys
BLOCKS_PER_SM = 16         # blocks the splits aim at: several waves
MAX_SPLITS = 65535         # the grid's y extent
TWIN_SMS = 132             # the H100's SMs: the twin's split plan
PROBE_MODES = {"dist_sum": 1, "row_min": 2, "block_min": 3}
PROBE_ROUTES = {"popc": 0, "s8": 1, "b1": 2}
_NO_ROW = (1 << 63) - 1    # the twin's empty key


def pack_db_bits(db_u8: torch.Tensor) -> torch.Tensor:
    """The kernel's DB operand, once at index-build time: (N, 32) uint8 rows
    as (N, 8) int32 words (little-endian bytes, the same bits)."""
    if db_u8.dtype != torch.uint8 or db_u8.dim() != 2 or db_u8.shape[1] != 32:
        raise ValueError(f"db must be (N, 32) uint8, got "
                         f"{tuple(db_u8.shape)} {db_u8.dtype}")
    if db_u8.shape[0] == 0:     # an empty view has no stride to reuse
        return torch.zeros((0, 8), dtype=torch.int32, device=db_u8.device)
    return db_u8.contiguous().view(torch.int32)


def pad_queries(query_u8: np.ndarray,
                q_tile: int = 512) -> Tuple[np.ndarray, int]:
    """Pad queries with zero rows up to a multiple of ``q_tile`` (the
    reference's default tile); returns (padded, n). The port's kernel needs
    no padding: this is for callers written against the reference."""
    qn = query_u8.shape[0]
    pad = (-qn) % q_tile
    if pad:
        query_u8 = np.concatenate(
            [query_u8, np.zeros((pad, 32), query_u8.dtype)])
    return query_u8, qn


def radius_int(radius: Optional[float]) -> int:
    """The kernel's integer radius: ``int(radius)``, 256 (every distance)
    for None; clamped to [-1, 256], which keeps the same rows."""
    return 256 if radius is None else max(-1, min(256, int(radius)))


def split_plan(n_q: int, n_valid: int, n_sm: int,
               q_block: int = BLOCK_QUERIES) -> Tuple[int, int]:
    """``(n_split, rows_per_split)``: how the kernel's grid splits the rows
    so that ``ceil(n_q / q_block) x n_split`` blocks fill ``n_sm`` SMs
    several times over, each split a multiple of ROW_TILE rows, at least
    MIN_SPLIT_ROWS and at most MAX_SPLIT_ROWS; every split holds rows."""
    if n_valid <= 0:
        return 1, 0
    tiles = -(-n_q // q_block)
    want = min(-(-n_valid // MIN_SPLIT_ROWS),
               -(-BLOCKS_PER_SM * n_sm // tiles), MAX_SPLITS)
    want = max(want, -(-n_valid // MAX_SPLIT_ROWS))
    per = -(-n_valid // max(want, 1))
    per = -(-per // ROW_TILE) * ROW_TILE
    return -(-n_valid // per), per


def _checked(query_u8: torch.Tensor, words: torch.Tensor, n_valid: int
             ) -> torch.Tensor:
    q = checked_query(query_u8, words, torch.uint8, 32)
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 8:
        raise ValueError(f"db must be (N, 8) int32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not 0 <= n_valid <= words.shape[0]:
        raise ValueError(f"n_valid {n_valid} outside [0, {words.shape[0]}]")
    return q


def _plan(q: torch.Tensor, n_valid: int,
          q_block: int = BLOCK_QUERIES) -> Tuple[int, int]:
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return split_plan(q.shape[0], n_valid, n_sm, q_block)


def twin_schedule(n_q: int, n_valid: int):
    """The twin's ``(first, end)`` row blocks: the kernel's splits on the
    H100 (:func:`split_plan` at TWIN_SMS), each cut into blocks of at most
    TWIN_ROWS rows, in ascending order."""
    n_split, per = split_plan(n_q, n_valid, TWIN_SMS)
    for s in range(n_split):
        split_end = min((s + 1) * per, n_valid)
        for base in range(s * per, split_end, TWIN_ROWS):
            yield base, min(base + TWIN_ROWS, split_end)


def _twin_blocks(query_u8: torch.Tensor, words: torch.Tensor, n_valid: int):
    """``(base, dist (Q, cnt) int64)`` per block of :func:`twin_schedule`:
    an exact f32 product of unpacked bits (integers below 2^24 are exact),
    ``|q| + |r| - 2 popc(q & r)`` as the kernel forms it."""
    qb = unpack_bits(query_u8, torch.float32)                     # (Q, 256)
    q_pop = qb.sum(dim=1, keepdim=True)
    db_u8 = words.view(torch.uint8)
    for base, end in twin_schedule(query_u8.shape[0], n_valid):
        rb = unpack_bits(db_u8[base:end], torch.float32)
        yield base, (q_pop + rb.sum(dim=1)[None, :]
                     - 2.0 * (qb @ rb.T)).to(torch.int64)


def hamming_topk_fused_torch(query_u8: torch.Tensor, words: torch.Tensor,
                             n_valid: int, k: int = 5,
                             radius: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B5: the radius-cut streaming top-k over
    the kernel's row splits, merged on the key ``dist << 32 | row`` (unique
    per row, so the order is exactly (dist, row), whatever the schedule)."""
    r = radius_int(radius)
    dev = query_u8.device
    best = torch.full((query_u8.shape[0], k), _NO_ROW, dtype=torch.int64,
                      device=dev)
    no_row = torch.full((), _NO_ROW, dtype=torch.int64, device=dev)
    for base, dist in _twin_blocks(query_u8, words, n_valid):
        row = torch.arange(base, base + dist.shape[1], dtype=torch.int64,
                           device=dev)
        keys = torch.where(dist <= r, (dist << 32) | row, no_row)
        best = torch.topk(torch.cat([best, keys], dim=1), k, dim=1,
                          largest=False, sorted=True).values
    hole = best == _NO_ROW
    dist = torch.where(hole, BIG_DIST, (best >> 32).to(torch.float32))
    idx = torch.where(hole, -1, best & 0xFFFFFFFF).to(torch.int32)
    return dist.to(torch.float32), idx


def _launch(query_u8: torch.Tensor, words: torch.Tensor, n_valid: int,
            k: int, radius: Optional[float]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = _checked(query_u8, words, n_valid)
    n_q = q.shape[0]
    dist = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if n_q == 0:
        return dist, idx
    n_split, per = _plan(q, n_valid)
    part = torch.empty((n_split, n_q, k), dtype=torch.int64, device=q.device)
    kernels.call("hamming_topk", "tod_hamming_topk",
                 (q.data_ptr(), words.data_ptr(), part.data_ptr(),
                  dist.data_ptr(), idx.data_ptr()),
                 (n_q, n_valid, k, radius_int(radius), n_split, per),
                 torch.cuda.current_stream(q.device).cuda_stream)
    hamming_topk_fused.launches += 1
    return dist, idx


def hamming_topk_fused(query_u8: torch.Tensor, db: torch.Tensor,
                       n_valid: int, k: int = 5,
                       radius: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact radius k-NN by Hamming distance: ``query_u8`` (Q, 32) uint8,
    ``db`` (N, 8) int32 words (:func:`pack_db_bits`), rows from ``n_valid``
    on never matched; ``1 <= k <= 8``; ``radius`` keeps ``dist <=
    int(radius)`` (None: every row). Returns ``(dist (Q, k) f32, idx (Q, k)
    i32)`` ascending by (dist, row), (1e9, -1) where a slot is missing.
    CUDA tensors go through kernel B5 (or raise); CPU tensors through
    :func:`hamming_topk_fused_torch`."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if query_u8.is_cuda:
        return _launch(query_u8, db, int(n_valid), k, radius)
    if query_u8.device.type != "cpu":
        raise ValueError(f"hamming_topk_fused has no path for "
                         f"{query_u8.device}")
    _checked(query_u8, db, int(n_valid))
    return hamming_topk_fused_torch(query_u8, db, int(n_valid), k, radius)


hamming_topk_fused.launches = 0


def hamming_probe_torch(query_u8: torch.Tensor, words: torch.Tensor,
                        n_valid: int, mode: str) -> torch.Tensor:
    """Plain PyTorch twin of T1: ``dist_sum`` (Q,) int64, ``row_min`` (Q,)
    int32 or ``block_min`` (1,) int32 over rows < ``n_valid``."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {sorted(PROBE_MODES)}")
    parts = []
    for _, dist in _twin_blocks(query_u8, words, n_valid):
        parts.append(dist.sum(1) if mode == "dist_sum"
                     else dist.min(1).values)
    stacked = torch.stack(parts, 1)
    if mode == "dist_sum":
        return stacked.sum(1)
    m = stacked.min(1).values.to(torch.int32)
    return m if mode == "row_min" else m.min().reshape(1)


def hamming_probe(query_u8: torch.Tensor, db: torch.Tensor, n_valid: int,
                  mode: str, route: str = "popc") -> torch.Tensor:
    """T1: the sweep on ``route`` (``PROBE_ROUTES``) with the extraction
    replaced by ``mode`` (see :func:`hamming_probe_torch`, the plain
    version of every route). CUDA tensors go through the kernel (or raise);
    CPU tensors through the twin. Needs ``n_valid > 0``."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {sorted(PROBE_MODES)}")
    if route not in PROBE_ROUTES:
        raise ValueError(f"route must be one of {sorted(PROBE_ROUTES)}")
    n_valid = int(n_valid)
    if n_valid <= 0:
        raise ValueError("hamming_probe needs at least one valid row")
    q = _checked(query_u8, db, n_valid)
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"hamming_probe has no path for {q.device}")
        return hamming_probe_torch(q, db, n_valid, mode)
    n_q = q.shape[0]
    if mode == "dist_sum":
        out = torch.zeros(n_q, dtype=torch.int64, device=q.device)
        ptrs = (out.data_ptr(), 0)
    else:
        out = torch.full((n_q if mode == "row_min" else 1,), 2 ** 31 - 1,
                         dtype=torch.int32, device=q.device)
        ptrs = (0, out.data_ptr())
    if n_q == 0:
        return out
    n_split, per = _plan(q, n_valid, POPC_BLOCK_QUERIES if route == "popc"
                         else BLOCK_QUERIES)
    kernels.call("hamming_topk", "tod_hamming_probe",
                 (q.data_ptr(), db.data_ptr(), *ptrs),
                 (n_q, n_valid, PROBE_MODES[mode], PROBE_ROUTES[route],
                  n_split, per),
                 torch.cuda.current_stream(q.device).cuda_stream)
    hamming_probe.launches += 1
    return out


hamming_probe.launches = 0


def b5_route() -> str:
    """The route (a key of ``PROBE_ROUTES``) that B5 is compiled with, as
    the built library reports it (``tod_hamming_b5_route``)."""
    code = kernels.load("hamming_topk").tod_hamming_b5_route()
    return next(r for r, c in PROBE_ROUTES.items() if c == code)

