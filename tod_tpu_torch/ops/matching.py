"""Bit helpers for 256-bit binary descriptors and the streaming exact k-NN
matcher (tod_tpu/ops/matching.py).

:func:`hamming_topk` is the reference's XLA matcher as plain PyTorch: the
exact Hamming distance of every (query, row) pair as ``popcount(q) +
popcount(r) - 2 q.r`` on unpacked bits (integers below 2^24 are exact in an
f32 product), streamed over row chunks with a running top-k, so the Q x N
distance matrix never materialises. :func:`l2_topk` is its counterpart by
squared L2 distance for float (SIFT) descriptors, which the cell graph's
DescriptorMatcher runs. The reference computes it in XLA, outside any
Pallas kernel; the port rounds every step as the compiled reference does
(:func:`l2_distances_torch`), through kernel L3
(``csrc/l2_distances.cu``) on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.image import fma_f32, gemm_order
from tod_tpu_torch.ops.reduce import square_norms

BIG_DIST = 1e9
L2_DIM = 128            # float descriptor width


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


# How the compiled reference rounds l2_topk (tod_tpu/ops/matching.py:107,
# under jax.jit, as tod_tpu/cells/matcher.py runs it), read off jax 0.9.0's
# CPU backend on x86-64 with AVX-512 and FMA (tools/fit_l2_order.py); the
# premise of ops/image.py's product rules, whose column rule this dot
# follows. Another CPU or jax may move any of it; rerun the tool.
# - The norms |q|^2 and |r|^2: the squares rounded (a fusion of their own),
#   added in order within each 32-wide window from +0 (reduce-window), the
#   four windows added in order (square_norms).
# - The dot q.r at Precision.HIGHEST, one f32 fused multiply-add a term:
#   more than one query is a DotThunk, whose oneDNN kernel follows the
#   chunk's width as a resize's column product follows its columns
#   (ops/image.py gemm_order; at the matcher's 4,096 one chain over the
#   128 depths; every width from 8 to 8,192 surveyed): "chain", "parity"
#   (even and odd chains, added) or "lanes" (four chains over depth mod 4,
#   (p0 + p1) + (p2 + p3)). One query is a loop fusion whose reassociated
#   reduction LLVM compiles to eight 8-lane chains over the 8-float blocks
#   of VECTOR_BLOCKS in that order (lane 0 from +0, the others from -0),
#   then lanes (l, l + 4) added, then (0, 2) and (1, 3), then the two
#   ("vector"; its object code, tools/fit_l2_order.py --asm).
# - max((|q|^2 + |r|^2) - 2 q.r, 0): 2 q.r is exact, so whether XLA fuses
#   the subtraction into a multiply-add does not matter.
VECTOR_BLOCKS = (0, 4, 8, 12, 5, 1, 9, 13, 6, 2, 10, 14, 7, 3, 11, 15)
L2_KINDS = ("chain", "parity", "lanes", "vector")   # L3's kind argument
# The CPU path's screen: the reference's distance of any pair lies within
# SCREEN_BOUND x (|q|^2 + |r|^2) of the f64 one. Each of its at most 131
# roundings (the dot's 128, the sum, the difference; the norms' error is
# below the dot's) moves it by at most 2^-24 of |q|^2 + |r|^2 >= 2 |q.r|
# (Cauchy-Schwarz), 131 x 2^-24 < 2^-17: 2^-14 leaves a factor 8.
SCREEN_BOUND = 2.0 ** -14


def l2_order(n_query: int, chunk: int) -> str:
    """The kind of the reference's dot of ``n_query`` queries by a chunk of
    ``chunk`` rows (see above): "vector" for one query, else the column
    rule's kind at the chunk's width (a chain block of 512 or a parity
    block of 1,024 holds all 128 depths)."""
    if n_query == 1:
        return "vector"
    return gemm_order(L2_DIM, chunk, False)[0]


def ordered_dot(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """f32 ``a . b`` over the last axis (128) of broadcastable ``a`` and
    ``b``, summed in the reference's order ``kind`` (:func:`l2_order`), one
    rounding a fused multiply-add (``fma_f32``)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])

    def chain(depths, init: float = 0.0) -> torch.Tensor:
        acc = torch.full(shape, init, dtype=torch.float32, device=a.device)
        for k in depths:
            acc = fma_f32(a[..., k], b[..., k], acc)
        return acc

    if kind == "chain":
        return chain(range(L2_DIM))
    if kind == "parity":
        return chain(range(0, L2_DIM, 2)) + chain(range(1, L2_DIM, 2))
    if kind == "lanes":
        p = [chain(range(g, L2_DIM, 4)) for g in range(4)]
        return (p[0] + p[1]) + (p[2] + p[3])
    if kind != "vector":
        raise ValueError(f"unknown L2 summation order {kind!r}")
    lanes = [chain([8 * blk + lane for blk in VECTOR_BLOCKS],
                   0.0 if lane == 0 else -0.0) for lane in range(8)]
    v = [lanes[i] + lanes[i + 4] for i in range(4)]
    return (v[0] + v[2]) + (v[1] + v[3])


def _distance(q_sq: torch.Tensor, r_sq: torch.Tensor,
              dot: torch.Tensor) -> torch.Tensor:
    """``max((|q|^2 + |r|^2) - 2 q.r, 0)``, each step rounded once."""
    return torch.clamp_min((q_sq + r_sq) - 2.0 * dot, 0.0)


def l2_distances_torch(query: torch.Tensor, rows: torch.Tensor,
                       n_valid: int, kind: str) -> torch.Tensor:
    """(Q, C) float32 squared L2 distances of (Q, 128) ``query`` to (C,
    128) ``rows``, every bit the compiled reference's at the order
    ``kind`` (:func:`l2_order`); ``BIG_DIST`` in the columns from
    ``n_valid`` on (the chunk's padding rows). The plain version of kernel
    L3."""
    dist = _distance(square_norms(query)[:, None], square_norms(rows)[None],
                     ordered_dot(query[:, None, :], rows[None], kind))
    big = torch.full((), BIG_DIST, dtype=torch.float32, device=dist.device)
    valid = torch.arange(rows.shape[0], device=dist.device) < n_valid
    return torch.where(valid[None, :], dist, big)


def l2_distances(query: torch.Tensor, rows: torch.Tensor, n_valid: int,
                 kind: str) -> torch.Tensor:
    """:func:`l2_distances_torch`'s tile: kernel L3 on a CUDA tensor (one
    launch, counted in ``l2_distances.launches``; a failed launch raises),
    the plain version on a CPU tensor. ``query`` and ``rows`` are float32,
    128 wide."""
    if query.dtype != torch.float32 or rows.dtype != torch.float32 \
            or query.dim() != 2 or rows.dim() != 2 \
            or query.shape[1] != L2_DIM or rows.shape[1] != L2_DIM \
            or query.device != rows.device:
        raise ValueError(f"l2_distances: query {tuple(query.shape)} "
                         f"{query.dtype} on {query.device}, rows "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")
    if query.device.type == "cpu":
        return l2_distances_torch(query, rows, n_valid, kind)
    if query.device.type != "cuda":
        raise ValueError(f"no L2 distance path for {query.device}")
    n_q, n_rows = query.shape[0], rows.shape[0]
    out = torch.empty((n_q, n_rows), dtype=torch.float32,
                      device=query.device)
    if out.numel():
        query, rows = query.contiguous(), rows.contiguous()
        kernels.call("l2_distances", "tod_l2_distances",
                     [query.data_ptr(), rows.data_ptr(), out.data_ptr()],
                     [n_q, n_rows, max(0, min(n_valid, n_rows)),
                      L2_KINDS.index(kind)],
                     torch.cuda.current_stream(query.device).cuda_stream)
        l2_distances.launches += 1
    return out


l2_distances.launches = 0


L2_TOPK_MAX_K = 8        # the fused matcher's lists
FUSED_SPLIT_BLOCKS = 8 * 132   # the sweep's target grid: ~8 blocks an SM


def fused_splits(n_q: int, n_valid: int) -> Tuple[int, int]:
    """``(n_split, tiles_per_split)`` of the fused matcher's sweep: the
    valid rows' 128-row tiles cut into contiguous splits, so that query
    tiles x splits is about :data:`FUSED_SPLIT_BLOCKS` (several waves of
    one block an SM, a short tail)."""
    tiles = max(1, -(-n_valid // 128))
    q_tiles = max(1, -(-n_q // 128))
    want = max(1, min(tiles, -(-FUSED_SPLIT_BLOCKS // q_tiles)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def l2_topk_fused(query: torch.Tensor, db: torch.Tensor, n_valid: int,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`l2_topk` in the "chain" order over the whole DB at once:
    kernel L3's fused matcher (``tod_l2_topk``: norms, split sweep, merge;
    one call, counted in ``l2_topk_fused.launches``; a failed launch
    raises) on CUDA tensors, its plain version :func:`_l2_topk_screened`
    on CPU tensors. ``query`` (Q, 128) and ``db`` (N, 128) float32; rows
    from ``n_valid`` on are padding; ``k`` at most 8."""
    if query.dtype != torch.float32 or db.dtype != torch.float32 \
            or query.dim() != 2 or db.dim() != 2 \
            or query.shape[1] != L2_DIM or db.shape[1] != L2_DIM \
            or query.device != db.device or not 1 <= k <= L2_TOPK_MAX_K:
        raise ValueError(f"l2_topk_fused: query {tuple(query.shape)} "
                         f"{query.dtype} on {query.device}, db "
                         f"{tuple(db.shape)} {db.dtype} on {db.device}, k {k}")
    n_valid = max(0, min(n_valid, db.shape[0]))
    qn, dev = query.shape[0], query.device
    if dev.type == "cpu":
        return _l2_topk_screened(query, db, n_valid, k, "chain")
    if dev.type != "cuda":
        raise ValueError(f"no L2 matcher path for {dev}")
    out_d = torch.full((qn, k), BIG_DIST, dtype=torch.float32, device=dev)
    out_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    if qn == 0 or n_valid == 0:
        return out_d, out_i
    query, db = query.contiguous(), db.contiguous()
    n_split, per = fused_splits(qn, n_valid)
    norms = torch.empty(qn + db.shape[0], dtype=torch.float32, device=dev)
    part_d = torch.empty((2 * n_split, qn, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((2 * n_split, qn, k), dtype=torch.int32, device=dev)
    kernels.call("l2_distances", "tod_l2_topk",
                 [query.data_ptr(), db.data_ptr(), norms.data_ptr(),
                  part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                  out_i.data_ptr()],
                 [qn, db.shape[0], n_valid, k, n_split, per],
                 torch.cuda.current_stream(dev).cuda_stream)
    l2_topk_fused.launches += 1
    return out_d, out_i


l2_topk_fused.launches = 0


def l2_topk(query: torch.Tensor, db: torch.Tensor, n_db_valid: int,
            k: int = 5, chunk: int = 4096
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by squared L2 distance (tod_tpu/ops/matching.py:107):
    ``(d_sq (Q, k) f32, idx (Q, k) i32)`` ascending, ties to the lower row,
    with :func:`hamming_topk`'s contract for ``db`` (N a multiple of
    ``chunk``) and its padding rows; every distance the compiled
    reference's, bit for bit (:func:`l2_distances_torch`). On the card the
    "chain" order (more than one query at a chunk of 4,096, the SIFT
    graph's case) is :func:`l2_topk_fused`; the other orders scan the
    chunks with one L3 tile a chunk (:func:`l2_topk_chunked`). On the CPU
    :func:`_l2_topk_screened`."""
    n = db.shape[0]
    if n % chunk != 0:
        raise ValueError(f"db rows {n} not a multiple of chunk {chunk}")
    dev = query.device
    q32 = query.to(torch.float32)
    kind = l2_order(query.shape[0], chunk)
    if dev.type == "cpu":
        return _l2_topk_screened(q32, db, min(n_db_valid, n), k, kind)
    if kind == "chain" and k <= L2_TOPK_MAX_K:
        return l2_topk_fused(q32, db.to(torch.float32), n_db_valid, k)
    return l2_topk_chunked(q32, db, n_db_valid, k, chunk, kind)


def l2_topk_chunked(q32: torch.Tensor, db: torch.Tensor, n_db_valid: int,
                    k: int, chunk: int, kind: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`l2_topk` as a scan of the chunks: one :func:`l2_distances`
    tile a chunk, :func:`stable_topk` of it, :func:`_merge_topk` into the
    running best (the parent design of the fused matcher, and the path of
    the orders it does not take)."""
    n, qn, dev = db.shape[0], q32.shape[0], q32.device
    best_d = torch.full((qn, k), BIG_DIST, dtype=torch.float32, device=dev)
    best_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        dist = l2_distances(q32, db[base:base + chunk].to(torch.float32),
                            n_db_valid - base, kind)
        gidx = torch.arange(base, base + chunk, dtype=torch.int32,
                            device=dev)
        nd, pos = stable_topk(-dist, k)
        best_d, best_i = _merge_topk(best_d, best_i, -nd, gidx[pos], k)
    return best_d, best_i


def _l2_topk_screened(q32: torch.Tensor, db: torch.Tensor, n_valid: int,
                      k: int, kind: str
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`l2_topk` on the CPU, where the 128-step emulated chain over
    every pair would take minutes at the graph's size: f64 distances
    screen the rows (the reference's lies within ``SCREEN_BOUND x (|q|^2
    + max |r|^2)`` of each, so every row of its top k is within twice
    that of the k-th smallest f64 one), then the pairs that pass take the
    reference's arithmetic (:func:`ordered_dot`). The result is the
    chunked scan's: by distance, the start's ``(BIG_DIST, -1)`` slots
    before any row at or past ``BIG_DIST``, then the lower row."""
    qn = q32.shape[0]
    best_d = torch.full((qn, k), BIG_DIST, dtype=torch.float32)
    best_i = torch.full((qn, k), -1, dtype=torch.int32)
    if qn == 0 or n_valid <= 0:
        return best_d, best_i
    rows = db[:n_valid].to(torch.float32)
    q_sq, r_sq = square_norms(q32), square_norms(rows)
    q64, q_sq64 = q32.double(), q_sq.double()
    err = SCREEN_BOUND * (q_sq64 + r_sq.double().max())
    kk = min(k, n_valid)
    run = torch.full((qn, kk), float("inf"), dtype=torch.float64)
    pairs = []
    for base in range(0, n_valid, 4096):
        r = rows[base:base + 4096]
        approx = (q_sq64[:, None] + r_sq[base:base + 4096].double()[None]) \
            - 2.0 * (q64 @ r.double().T)
        run = torch.cat([run, approx], 1).topk(kk, 1, largest=False).values
        qi, ri = (approx <= (run[:, -1] + 2.0 * err)[:, None]).nonzero(
            as_tuple=True)
        pairs.append(qi * n_valid + ri + base)
    key = torch.sort(torch.cat(pairs)).values       # by query, then row
    qi, ri = key // n_valid, key % n_valid
    dist = _distance(q_sq[qi], r_sq[ri], ordered_dot(q32[qi], rows[ri], kind))
    counts = torch.bincount(qi, minlength=qn)
    pos = torch.arange(len(key)) - (torch.cumsum(counts, 0) - counts)[qi]
    dense_d = torch.full((qn, k + int(counts.max())), float("inf"))
    dense_i = torch.full(dense_d.shape, -1, dtype=torch.int32)
    dense_d[:, :k] = BIG_DIST
    dense_d[qi, k + pos] = dist
    dense_i[qi, k + pos] = ri.to(torch.int32)
    nd, at = stable_topk(-dense_d, k)
    return -nd, torch.gather(dense_i, 1, at)


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
