"""Per-(query, object) nearest-row matching over an object-segmented DB.

Port of tod_tpu/ops/pallas/segmented.py (``SegmentedDb``, ``pack_segmented``,
``object_top1``). The DB keeps the reference's object-contiguous layout with
chunk-aligned segments (so ``obj_start`` and ``points`` are the reference's
arrays), but each row is stored as its packed 256 bits, (N, 8) int32 words:
the (256, N) unpacked transpose existed only to feed the TPU's matrix unit.

:func:`object_top1` launches the CUDA kernel ``csrc/segmented_top1.cu`` on a
CUDA tensor and runs the plain PyTorch twin :func:`object_top1_torch` on a CPU
tensor. Both return, per (query, object), the key
``min(dist, 511) << 18 | row_within_object`` minimised over the object's real
rows, split into ``(dist f32, row i32)``: ties go to the lowest row and an
object with no real rows reports (511, 0).
"""

from __future__ import annotations

import ctypes
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
                   device: torch.device | str = "cpu") -> SegmentedDb:
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


def object_top1_torch(query_u8: torch.Tensor, db: SegmentedDb
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: an exact f32 product of unpacked
    bits per object (integers below 2^24 are exact), then a min over keys."""
    q = query_u8.shape[0]
    dev = query_u8.device
    qb = unpack_bits(query_u8, torch.float32)                     # (Q, 256)
    q_pop = qb.sum(dim=1, keepdim=True)
    db_u8 = db.words.view(torch.uint8)                            # (N, 32)
    best = torch.full((q, max(db.n_objects, 1)), DIST_CLAMP << ROW_BITS,
                      dtype=torch.int32, device=dev)
    for o, (start, n) in enumerate(zip(db.starts_host, db.rows_host)):
        for base in range(0, n, TWIN_ROWS):
            cnt = min(TWIN_ROWS, n - base)
            rb = unpack_bits(db_u8[start + base:start + base + cnt],
                             torch.float32)                       # (cnt, 256)
            dot = qb @ rb.T
            dist = (q_pop + rb.sum(dim=1)[None, :] - 2.0 * dot).to(torch.int32)
            col = torch.arange(base, base + cnt, dtype=torch.int32,
                               device=dev)
            keys = (dist << ROW_BITS) | col
            best[:, o] = torch.minimum(best[:, o], keys.min(dim=1).values)
    best = best[:, :db.n_objects]
    return (best >> ROW_BITS).to(torch.float32), best & ROW_MASK


def _launch(query_u8: torch.Tensor, db: SegmentedDb
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if query_u8.dtype != torch.uint8 or query_u8.dim() != 2 \
            or query_u8.shape[1] != 32:
        raise ValueError(f"query must be (Q, 32) uint8, got "
                         f"{tuple(query_u8.shape)} {query_u8.dtype}")
    if db.words.device != query_u8.device:
        raise ValueError(f"query on {query_u8.device}, DB on "
                         f"{db.words.device}")
    if db.n_objects > 65535:
        raise ValueError(f"{db.n_objects} objects exceed the grid's y limit")
    q = query_u8.contiguous()
    for name, t in (("query", q), ("words", db.words)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n_q, n_obj = q.shape[0], db.n_objects
    dist = torch.empty((n_q, n_obj), dtype=torch.float32, device=q.device)
    row = torch.empty((n_q, n_obj), dtype=torch.int32, device=q.device)
    lib = kernels.load("segmented_top1")
    fn = lib.tod_object_top1
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), db.words.data_ptr(), db.obj_start.data_ptr(),
                db.n_rows.data_ptr(), dist.data_ptr(), row.data_ptr(),
                n_q, n_obj, stream)
    kernels.check(status, "tod_object_top1")
    object_top1.launches += 1
    return dist, row


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
