"""Per-(query, object) nearest-row matching over an object-segmented DB of
int8-quantised float (SIFT) descriptors, by squared L2 distance.

Port of tod_tpu/ops/pallas/segmented_l2.py (``SegmentedDbF``,
``quantize_descriptors``, ``pack_segmented_l2``, ``_to_l2``,
``object_top1_l2``, ``object_top1_l2_gathered``). Unit-norm descriptors are
quantised as ``clip(round(d * 256), 0, 127)``; the squared distance
``|q|^2 + |r|^2 - 2 q.r`` is then exact in int32 and the result is reported
as ``sqrt(d) / 256`` in descriptor units. The DB keeps the reference's
object-contiguous layout with chunk-aligned segments (``obj_start``,
``points`` and ``norm_sq`` are the reference's arrays) but stores rows
row-major, (N, 128) int8, 128 contiguous bytes a row: the reference's
(128, N) transpose fed the TPU's matrix unit.

:func:`object_top1_l2` (kernel B3) launches ``csrc/segmented_l2_top1.cu`` on
a CUDA tensor and runs the plain PyTorch twin :func:`object_top1_l2_torch`
on a CPU tensor. Per (query, object) both return the smallest distance over
the object's real rows and the lowest row that attains it. An object with
no real rows reports what the reference's padding rows give it: the squared
distance ``|q|^2 + PAD_NORM`` and row 0.

:func:`object_top1_l2_gathered` (kernel B4, the second entry point of the
same file; twin :func:`object_top1_l2_gathered_torch`) is the fine pass of
coarse->fine matching: the same columns for the selected objects ``sel``
(C,) only; a slot outside [0, O) (``-1`` = empty) reports
``to_l2(DIST_INVALID)`` and row ``HOLE_ROW_L2`` = 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.segmented import (MAX_GRID_Y, ROW_BITS, ROW_MASK,
                                         TWIN_ROWS, checked_query,
                                         checked_sel)

DB_CHUNK = 4096
DESC_DIM = 128
QUANT_SCALE = 256.0     # descriptor quantization: round(d * 256) in [0, 127]
DIST_INVALID = 0x7FFFFFFF
PAD_NORM = 1 << 28      # padding-row |r|^2: beyond any real distance
HOLE_ROW_L2 = 0
NORM_ROWS = 1 << 20     # rows per step when the norms are computed


def quantize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Unit-norm float descriptors -> int8 (round(d * 256), clip [0, 127])."""
    return torch.clamp(torch.round(desc * QUANT_SCALE), 0, 127).to(torch.int8)


def quantize_numpy(desc: np.ndarray) -> np.ndarray:
    """:func:`quantize_descriptors` on the host; int8 input is taken as
    quantised already."""
    desc = np.asarray(desc)
    if desc.dtype == np.int8:
        return desc
    return quantize_descriptors(
        torch.from_numpy(np.ascontiguousarray(desc, np.float32))).numpy()


def to_l2(d_sq_int: torch.Tensor) -> torch.Tensor:
    """Scaled-int squared distance -> plain L2 in descriptor units (the
    reference's ``_to_l2``, bit for bit). The reference's float32 square
    root is correctly rounded; PyTorch's vectorised float32 ``sqrt`` on a
    CPU is not (about 0.7 % of the integers below 3e6 come out one ulp
    low), so the root of the float32 value is taken in float64 and rounded
    once. 1/256 is a power of two."""
    d = torch.clamp(d_sq_int, min=0).to(torch.float32)
    return torch.sqrt(d.to(torch.float64)).to(torch.float32) \
        * (1.0 / QUANT_SCALE)


HOLE_DIST_L2 = float(np.sqrt(np.float32(DIST_INVALID)) * np.float32(1 / 256))


@dataclass
class SegmentedDbF:
    """Object-contiguous int8 descriptor DB with chunk-aligned segments.

    Rows of object ``o`` occupy [obj_start[o], obj_start[o] + n_rows[o]);
    rows past ``n_rows`` inside a segment are zero padding with ``norm_sq``
    = ``PAD_NORM`` that no matcher visits. Rows are row-major, 128
    contiguous bytes each; ``points`` rows align with descriptor rows."""

    rows: torch.Tensor       # (N_pad, 128) int8 quantised descriptors
    norm_sq: torch.Tensor    # (N_pad,) int32 |r|^2 (PAD_NORM on padding)
    points: torch.Tensor     # (N_pad, 3) f32 model points (0 on padding)
    obj_start: torch.Tensor  # (O,) int32 first global row of each object
    n_rows: torch.Tensor     # (O,) int32 real row count of each object
    spans: torch.Tensor      # (O,) f32 model AABB diagonals
    db_chunk: int
    starts_host: Tuple[int, ...]   # obj_start / n_rows as host integers
    rows_host: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def n_objects(self) -> int:
        return len(self.rows_host)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.rows, self.norm_sq, self.points, self.obj_start,
                    self.n_rows, self.spans))


def db_f_from_arrays(desc_i8: np.ndarray, points: np.ndarray,
                     obj_start: np.ndarray, n_rows: np.ndarray,
                     spans: np.ndarray, db_chunk: int,
                     device: torch.device | str) -> SegmentedDbF:
    """Upload host arrays in the segmented layout (desc (N_pad, 128) int8,
    zero on padding); the norms are computed on ``device``."""
    starts = np.array(obj_start, np.int32)
    counts = np.array(n_rows, np.int32)
    rows = torch.from_numpy(np.ascontiguousarray(desc_i8, np.int8)).to(device)
    obj_start_t = torch.from_numpy(starts).to(device)
    n_rows_t = torch.from_numpy(counts).to(device)
    norm_sq = torch.full((rows.shape[0],), PAD_NORM, dtype=torch.int32,
                         device=rows.device)
    index = torch.arange(rows.shape[0], device=rows.device)
    for base in range(0, rows.shape[0] if len(starts) else 0, NORM_ROWS):
        part = slice(base, base + NORM_ROWS)
        # the object of each row: the last segment starting at or before it
        obj = torch.searchsorted(obj_start_t, index[part].to(torch.int32),
                                 right=True) - 1
        real = index[part] - obj_start_t[obj] < n_rows_t[obj]
        norm = (rows[part].to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
        norm_sq[part] = torch.where(real, norm, norm_sq[part])
    return SegmentedDbF(
        rows=rows, norm_sq=norm_sq,
        points=torch.from_numpy(np.array(points, np.float32)).to(device),
        obj_start=obj_start_t, n_rows=n_rows_t,
        spans=torch.from_numpy(np.array(spans, np.float32)).to(device),
        db_chunk=int(db_chunk),
        starts_host=tuple(int(s) for s in starts),
        rows_host=tuple(int(n) for n in counts))


def pack_segmented_l2(models: Sequence, db_chunk: int = DB_CHUNK,
                      reserve_rows: int = 0,
                      device: torch.device | str = "cuda") -> SegmentedDbF:
    """Pack float-descriptor models into the segmented layout (host-side, at
    load time), with the reference's segment layout: every object's segment
    is padded to a multiple of ``db_chunk`` rows, and to at least
    ``reserve_rows``. Descriptors are (N, 128) float32, quantised here, or
    (N, 128) int8, taken as quantised already."""
    descs, pts, starts, nrows, spans = [], [], [], [], []
    cursor = 0
    for o, m in enumerate(models):
        n = m.n_points
        if n > (1 << ROW_BITS):
            raise ValueError(
                f"object {o} has {n} rows > 2^{ROW_BITS}: row indices "
                "would alias; split the model")
        n_pad = -(-max(n, 1, reserve_rows) // db_chunk) * db_chunk
        d = np.zeros((n_pad, DESC_DIM), np.int8)
        d[:n] = quantize_numpy(m.descriptors)
        p = np.zeros((n_pad, 3), np.float32)
        p[:n] = m.points
        descs.append(d)
        pts.append(p)
        starts.append(cursor)
        nrows.append(n)
        spans.append(m.span)
        cursor += n_pad
    if not models:
        descs = [np.zeros((db_chunk, DESC_DIM), np.int8)]
        pts = [np.zeros((db_chunk, 3), np.float32)]
    return db_f_from_arrays(np.concatenate(descs), np.concatenate(pts),
                            np.asarray(starts, np.int32),
                            np.asarray(nrows, np.int32),
                            np.asarray(spans, np.float32), db_chunk, device)


def _query_terms(query_i8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query as float32 (exact) and the int64 keys of an object with no
    rows, ``(|q|^2 + PAD_NORM) << ROW_BITS | 0``."""
    q_norm = (query_i8.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
    return query_i8.to(torch.float32), \
        (q_norm.to(torch.int64) + PAD_NORM) << ROW_BITS


def _object_keys(qf: torch.Tensor, empty: torch.Tensor, db: SegmentedDbF,
                 start: int, n: int) -> torch.Tensor:
    """(Q,) int64 min over one object's ``n`` real rows of ``dist << 18 |
    row``: the smallest distance, then the lowest row. The product runs in
    float32, exact for int8 operands (|q.r| < 2^24); the norms are added in
    int64 (``PAD_NORM`` plus a small integer is no float32)."""
    q_norm = (empty >> ROW_BITS) - PAD_NORM
    best = empty
    for base in range(0, n, TWIN_ROWS):
        part = slice(start + base, start + min(base + TWIN_ROWS, n))
        dot = (qf @ db.rows[part].to(torch.float32).T).to(torch.int64)
        dist = q_norm[:, None] + db.norm_sq[part][None, :] - 2 * dot
        col = torch.arange(base, base + dist.shape[1], device=qf.device)
        keys = (dist << ROW_BITS) | col
        best = torch.minimum(best, keys.min(dim=1).values)
    return best


def _split_keys(best: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 keys -> (squared distance int32, row int32)."""
    return (best >> ROW_BITS).to(torch.int32), \
        (best & ROW_MASK).to(torch.int32)


def object_top1_l2_sq_torch(query_i8: torch.Tensor, db: SegmentedDbF
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B3, one object at a time: the int32
    squared distances and rows the kernel writes."""
    qf, empty = _query_terms(query_i8)
    best = empty[:, None].repeat(1, db.n_objects)
    for o, (start, n) in enumerate(zip(db.starts_host, db.rows_host)):
        best[:, o] = _object_keys(qf, empty, db, start, n)
    return _split_keys(best)


def object_top1_l2_gathered_sq_torch(query_i8: torch.Tensor, db: SegmentedDbF,
                                     sel: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B4: B3's twin visiting only the objects
    of ``sel``; a slot outside [0, O) reports (DIST_INVALID, 0)."""
    qf, empty = _query_terms(query_i8)
    ids = [int(o) for o in sel.tolist()]
    best = torch.full((query_i8.shape[0], len(ids)), DIST_INVALID << ROW_BITS,
                      dtype=torch.int64, device=query_i8.device)
    for c, o in enumerate(ids):
        if 0 <= o < db.n_objects:
            best[:, c] = _object_keys(qf, empty, db, db.starts_host[o],
                                      db.rows_host[o])
    return _split_keys(best)


def object_top1_l2_torch(query_i8: torch.Tensor, db: SegmentedDbF
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of :func:`object_top1_l2`: ``(dist f32 L2, row i32)``."""
    d_sq, row = object_top1_l2_sq_torch(query_i8, db)
    return to_l2(d_sq), row


def object_top1_l2_gathered_torch(query_i8: torch.Tensor, db: SegmentedDbF,
                                  sel: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of :func:`object_top1_l2_gathered`."""
    d_sq, row = object_top1_l2_gathered_sq_torch(query_i8, db, sel)
    return to_l2(d_sq), row


def _call(entry: str, q: torch.Tensor, db: SegmentedDbF, n_cols: int,
          ptrs: tuple = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the (Q, n_cols) int32 outputs and launch ``entry`` of
    csrc/segmented_l2_top1.cu on the current stream; raise on a launch
    error. Every entry takes (query, rows, norm_sq, obj_start, n_rows,
    *ptrs, dist, row, n_q, n_cols, n_obj, stream)."""
    d_sq = torch.empty((q.shape[0], n_cols), dtype=torch.int32,
                       device=q.device)
    row = torch.empty((q.shape[0], n_cols), dtype=torch.int32,
                      device=q.device)
    kernels.call("segmented_l2_top1", entry,
                 (q.data_ptr(), db.rows.data_ptr(), db.norm_sq.data_ptr(),
                  db.obj_start.data_ptr(), db.n_rows.data_ptr(), *ptrs,
                  d_sq.data_ptr(), row.data_ptr()),
                 (q.shape[0], n_cols, db.n_objects),
                 torch.cuda.current_stream(q.device).cuda_stream)
    return d_sq, row


def object_top1_l2_sq(query_i8: torch.Tensor, db: SegmentedDbF
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3's own outputs: ``(squared distance (Q, O) i32, row (Q, O)
    i32)``. CUDA tensors go through the kernel (or raise); CPU tensors
    through :func:`object_top1_l2_sq_torch`."""
    if query_i8.is_cuda:
        q = checked_query(query_i8, db.rows, torch.int8, DESC_DIM)
        if db.n_objects > MAX_GRID_Y:
            raise ValueError(
                f"{db.n_objects} objects exceed the grid's y limit")
        out = _call("tod_object_top1_l2", q, db, db.n_objects)
        object_top1_l2.launches += 1
        return out
    if query_i8.device.type != "cpu":
        raise ValueError(f"object_top1_l2 has no path for {query_i8.device}")
    return object_top1_l2_sq_torch(query_i8, db)


def object_top1_l2_gathered_sq(query_i8: torch.Tensor, db: SegmentedDbF,
                               sel: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4's own outputs, ``(Q, C)`` int32 each. CUDA tensors go
    through the kernel (or raise); CPU tensors through
    :func:`object_top1_l2_gathered_sq_torch`."""
    if query_i8.is_cuda:
        q = checked_query(query_i8, db.rows, torch.int8, DESC_DIM)
        sel = checked_sel(sel, q)
        out = _call("tod_object_top1_l2_gathered", q, db, sel.shape[0],
                    (sel.data_ptr(),))
        object_top1_l2_gathered.launches += 1
        return out
    if query_i8.device.type != "cpu":
        raise ValueError(
            f"object_top1_l2_gathered has no path for {query_i8.device}")
    return object_top1_l2_gathered_sq_torch(query_i8, db, sel)


def object_top1_l2(query_i8: torch.Tensor, db: SegmentedDbF
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, object) nearest row over int8-quantised descriptors:
    ``(dist (Q, O) f32 plain L2, row (Q, O) i32 row-within-object)``."""
    d_sq, row = object_top1_l2_sq(query_i8, db)
    return to_l2(d_sq), row


object_top1_l2.launches = 0


def object_top1_l2_gathered(query_i8: torch.Tensor, db: SegmentedDbF,
                            sel: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, selected object) nearest row: ``(dist (Q, C) f32, row
    (Q, C) i32)``, each column bitwise equal to :func:`object_top1_l2`'s
    column ``sel[c]``; slots outside [0, O) report (``HOLE_DIST_L2``,
    ``HOLE_ROW_L2``)."""
    d_sq, row = object_top1_l2_gathered_sq(query_i8, db, sel)
    return to_l2(d_sq), row


object_top1_l2_gathered.launches = 0
