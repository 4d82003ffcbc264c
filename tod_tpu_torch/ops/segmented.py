"""Per-(query, object) nearest-row matching over an object-segmented DB.

Port of tod_tpu/ops/pallas/segmented.py (``SegmentedDb``, ``pack_segmented``,
``object_top1``, ``subsample_models``, ``object_top1_gathered``). The DB
keeps the reference's object-contiguous layout with
chunk-aligned segments (so ``obj_start`` and ``points`` are the reference's
arrays), but each row is stored as its packed 256 bits, (N, 8) int32 words:
the (256, N) unpacked transpose existed only to feed the TPU's matrix unit.

:func:`object_top1` launches the CUDA kernel ``csrc/segmented_top1.cu`` on a
CUDA tensor and runs the plain PyTorch twin :func:`object_top1_torch` on a CPU
tensor. Both return, per (query, object), the key
``min(dist, 511) << 18 | row_within_object`` minimised over the object's real
rows, split into ``(dist f32, row i32)``: ties go to the lowest row and an
object with no real rows reports (511, 0).

:func:`object_top1_gathered` (kernel B2, a second entry point of the same
CUDA file; twin :func:`object_top1_gathered_torch`) is the fine pass of
coarse->fine matching: the same columns, but only for the selected objects
``sel`` (C,), with ``-1`` slots reported as (``HOLE_DIST``, ``HOLE_ROW``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.ops.matching import unpack_bits

DB_CHUNK = 4096
ROW_BITS = 18
ROW_MASK = (1 << ROW_BITS) - 1
DIST_CLAMP = 511
KEY_INVALID = 0x7FFFFFFF
HOLE_DIST = float(KEY_INVALID >> ROW_BITS)   # 8191.0: an empty sel slot
HOLE_ROW = KEY_INVALID & ROW_MASK            # 262143
MAX_GRID_Y = 65535      # objects (B1) or slots (B2): the grid's y extent
TWIN_ROWS = 8192        # rows per product in the plain twin (bounds memory)


@dataclass
class SegmentedDb:
    """Object-contiguous packed model DB with chunk-aligned object segments.

    Rows of object ``o`` occupy [obj_start[o], obj_start[o] + n_rows[o]);
    rows past ``n_rows`` inside a segment are zero padding that no matcher
    visits. ``points`` rows align with descriptor rows."""

    words: torch.Tensor      # (N_pad, 8) int32 packed descriptor bits
    points: torch.Tensor     # (N_pad, 3) f32 model points (0 on padding)
    obj_start: torch.Tensor  # (O,) int32 first global row of each object
    n_rows: torch.Tensor     # (O,) int32 real row count of each object
    spans: torch.Tensor      # (O,) f32 model AABB diagonals
    db_chunk: int
    starts_host: Tuple[int, ...]   # obj_start / n_rows as host integers
    rows_host: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def n_objects(self) -> int:
        return len(self.rows_host)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.words, self.points, self.obj_start, self.n_rows,
                    self.spans))


def db_from_arrays(desc_u8: np.ndarray, points: np.ndarray,
                   obj_start: np.ndarray, n_rows: np.ndarray,
                   spans: np.ndarray, db_chunk: int,
                   device: torch.device | str) -> SegmentedDb:
    """Upload host arrays in the segmented layout (desc (N_pad, 32) u8)."""
    words = np.array(desc_u8, np.uint8, order="C").view("<i4")
    starts = np.array(obj_start, np.int32)
    rows = np.array(n_rows, np.int32)
    return SegmentedDb(
        words=torch.from_numpy(words).to(device),
        points=torch.from_numpy(np.array(points, np.float32)).to(device),
        obj_start=torch.from_numpy(starts).to(device),
        n_rows=torch.from_numpy(rows).to(device),
        spans=torch.from_numpy(np.array(spans, np.float32)).to(device),
        db_chunk=int(db_chunk),
        starts_host=tuple(int(s) for s in starts),
        rows_host=tuple(int(n) for n in rows))


def pack_segmented(models: Sequence, db_chunk: int = DB_CHUNK,
                   reserve_rows: int = 0,
                   device: torch.device | str = "cuda") -> SegmentedDb:
    """Pack models into the segmented layout (host-side, at load time).

    Same segment layout as the reference: every object's segment is padded
    to a multiple of ``db_chunk`` rows, and to at least ``reserve_rows``."""
    descs, pts, starts, nrows, spans = [], [], [], [], []
    cursor = 0
    for o, m in enumerate(models):
        n = m.n_points
        if n > (1 << ROW_BITS):
            raise ValueError(
                f"object {o} has {n} rows > 2^{ROW_BITS}: the key packing "
                "(dist << 18 | row) would corrupt results; split the model")
        n_pad = -(-max(n, 1, reserve_rows) // db_chunk) * db_chunk
        d = np.zeros((n_pad, 32), np.uint8)
        d[:n] = m.descriptors
        p = np.zeros((n_pad, 3), np.float32)
        p[:n] = m.points
        descs.append(d)
        pts.append(p)
        starts.append(cursor)
        nrows.append(n)
        spans.append(m.span)
        cursor += n_pad
    if not models:
        descs = [np.zeros((db_chunk, 32), np.uint8)]
        pts = [np.zeros((db_chunk, 3), np.float32)]
    return db_from_arrays(np.concatenate(descs), np.concatenate(pts),
                          np.asarray(starts, np.int32),
                          np.asarray(nrows, np.int32),
                          np.asarray(spans, np.float32), db_chunk, device)


def subsample_models(models: Sequence, stride: int) -> list:
    """Stride-subsampled copies of the models (the coarse companion DB of
    coarse->fine matching): every ``stride``-th row from the first, so every
    non-empty object keeps at least one row."""
    return [type(m)(object_id=m.object_id,
                    descriptors=np.ascontiguousarray(m.descriptors[::stride]),
                    points=np.ascontiguousarray(m.points[::stride]))
            for m in models]


def _object_keys(qb: torch.Tensor, q_pop: torch.Tensor, db_u8: torch.Tensor,
                 start: int, n: int) -> torch.Tensor:
    """(Q,) min key over one object's ``n`` real rows: an exact f32 product
    of unpacked bits (integers below 2^24 are exact), then a min over
    ``dist << 18 | row``; (511, 0) for an object with no rows."""
    best = torch.full((qb.shape[0],), DIST_CLAMP << ROW_BITS,
                      dtype=torch.int32, device=qb.device)
    for base in range(0, n, TWIN_ROWS):
        cnt = min(TWIN_ROWS, n - base)
        rb = unpack_bits(db_u8[start + base:start + base + cnt],
                         torch.float32)                           # (cnt, 256)
        dot = qb @ rb.T
        dist = (q_pop + rb.sum(dim=1)[None, :] - 2.0 * dot).to(torch.int32)
        col = torch.arange(base, base + cnt, dtype=torch.int32,
                           device=qb.device)
        best = torch.minimum(best, ((dist << ROW_BITS) | col).min(dim=1).values)
    return best


def _split_keys(best: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (best >> ROW_BITS).to(torch.float32), best & ROW_MASK


def object_top1_torch(query_u8: torch.Tensor, db: SegmentedDb
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B1, one object at a time."""
    qb = unpack_bits(query_u8, torch.float32)                     # (Q, 256)
    q_pop = qb.sum(dim=1, keepdim=True)
    db_u8 = db.words.view(torch.uint8)                            # (N, 32)
    best = torch.full((query_u8.shape[0], db.n_objects),
                      DIST_CLAMP << ROW_BITS, dtype=torch.int32,
                      device=query_u8.device)
    for o, (start, n) in enumerate(zip(db.starts_host, db.rows_host)):
        best[:, o] = _object_keys(qb, q_pop, db_u8, start, n)
    return _split_keys(best)


def object_top1_gathered_torch(query_u8: torch.Tensor, db: SegmentedDb,
                               sel: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of kernel B2: B1's twin visiting only the objects
    of ``sel``; a slot outside [0, O) (``-1`` = empty) reports
    (HOLE_DIST, HOLE_ROW)."""
    qb = unpack_bits(query_u8, torch.float32)
    q_pop = qb.sum(dim=1, keepdim=True)
    db_u8 = db.words.view(torch.uint8)
    ids = [int(o) for o in sel.tolist()]
    best = torch.full((query_u8.shape[0], len(ids)), KEY_INVALID,
                      dtype=torch.int32, device=query_u8.device)
    for c, o in enumerate(ids):
        if 0 <= o < db.n_objects:
            best[:, c] = _object_keys(qb, q_pop, db_u8, db.starts_host[o],
                                      db.rows_host[o])
    return _split_keys(best)


def checked_query(query: torch.Tensor, rows: torch.Tensor,
                  dtype: torch.dtype, width: int) -> torch.Tensor:
    """The query as the kernels take it, or raise: (Q, ``width``) of
    ``dtype`` on the device of the DB's ``rows``, contiguous and 16-byte
    aligned like them."""
    if query.dtype != dtype or query.dim() != 2 or query.shape[1] != width:
        raise ValueError(f"query must be (Q, {width}) {dtype}, got "
                         f"{tuple(query.shape)} {query.dtype}")
    if rows.device != query.device:
        raise ValueError(f"query on {query.device}, DB on {rows.device}")
    q = query.contiguous()
    for name, t in (("query", q), ("DB rows", rows)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return q


def checked_sel(sel: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The selection as the gathered kernels take it, or raise."""
    if sel.dtype != torch.int32 or sel.dim() != 1:
        raise ValueError(f"sel must be (C,) int32, got {tuple(sel.shape)} "
                         f"{sel.dtype}")
    if sel.device != q.device:
        raise ValueError(f"sel on {sel.device}, query on {q.device}")
    if sel.shape[0] > MAX_GRID_Y:
        raise ValueError(f"{sel.shape[0]} slots exceed the grid's y limit")
    return sel.contiguous()


def _call(entry: str, q: torch.Tensor, db: SegmentedDb, n_cols: int,
          ptrs: tuple = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate the (Q, n_cols) outputs and launch ``entry`` of
    csrc/segmented_top1.cu on the current stream; raise on a launch error.
    Every entry takes (query, rows, obj_start, n_rows, *ptrs, dist, row,
    n_q, n_cols, n_obj, stream)."""
    dist = torch.empty((q.shape[0], n_cols), dtype=torch.float32,
                       device=q.device)
    row = torch.empty((q.shape[0], n_cols), dtype=torch.int32,
                      device=q.device)
    kernels.call("segmented_top1", entry,
                 (q.data_ptr(), db.words.data_ptr(), db.obj_start.data_ptr(),
                  db.n_rows.data_ptr(), *ptrs, dist.data_ptr(),
                  row.data_ptr()),
                 (q.shape[0], n_cols, db.n_objects),
                 torch.cuda.current_stream(q.device).cuda_stream)
    return dist, row


def _launch(query_u8: torch.Tensor, db: SegmentedDb
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = checked_query(query_u8, db.words, torch.uint8, 32)
    if db.n_objects > MAX_GRID_Y:
        raise ValueError(f"{db.n_objects} objects exceed the grid's y limit")
    out = _call("tod_object_top1", q, db, db.n_objects)
    object_top1.launches += 1
    return out


def _launch_gathered(query_u8: torch.Tensor, db: SegmentedDb,
                     sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    q = checked_query(query_u8, db.words, torch.uint8, 32)
    sel = checked_sel(sel, q)
    out = _call("tod_object_top1_gathered", q, db, sel.shape[0],
                (sel.data_ptr(),))
    object_top1_gathered.launches += 1
    return out


def object_top1(query_u8: torch.Tensor, db: SegmentedDb
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, object) nearest row: ``(dist (Q, O) f32, row (Q, O) i32
    row-within-object)``. CUDA tensors go through the kernel (or raise);
    CPU tensors through :func:`object_top1_torch`."""
    if query_u8.is_cuda:
        return _launch(query_u8, db)
    if query_u8.device.type != "cpu":
        raise ValueError(f"object_top1 has no path for {query_u8.device}")
    return object_top1_torch(query_u8, db)


object_top1.launches = 0


def object_top1_gathered(query_u8: torch.Tensor, db: SegmentedDb,
                         sel: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, selected object) nearest row: ``(dist (Q, C) f32, row
    (Q, C) i32)``, each column bitwise equal to :func:`object_top1`'s
    column ``sel[c]``; slots outside [0, O) report (HOLE_DIST, HOLE_ROW).
    CUDA tensors go through kernel B2 (or raise); CPU tensors through
    :func:`object_top1_gathered_torch`."""
    if query_u8.is_cuda:
        return _launch_gathered(query_u8, db, sel)
    if query_u8.device.type != "cpu":
        raise ValueError(
            f"object_top1_gathered has no path for {query_u8.device}")
    return object_top1_gathered_torch(query_u8, db, sel)


object_top1_gathered.launches = 0
