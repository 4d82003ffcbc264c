"""The smoke catalog: a few trained models plus seeded filler objects.

A 100-object catalog trained like the bench's is ~2.2M rows, too large to
ship. The smoke catalog keeps the bench's rows per object instead: filler
object ``j`` is a copy of trained model ``j % n_real`` with every descriptor
bit flipped with probability ``flip_p`` and its points redrawn uniformly in
a cube of ``cube_m``. The matcher then meets real in-radius junk, but the
fillers carry no geometric consistency. Numpy only, so the fixture generator
(with the reference) and the smoke run (with the port) build the same
catalog from the same seed.

SIFT models travel quantised, as (N, 128) int8 (``round(d * 256)`` clipped
to [0, 127]; ``q / 256`` is exact in float32 and quantises back to ``q``).
Their fillers add seeded integer noise, uniform in [-``L2_NOISE``,
``L2_NOISE``], to every entry and clip back to [0, 127]. At 16 a filler row
lies 0.36 +- 0.02 L2 units from its source row (measured on the three
trained models by tools/make_torch_sift_fixture.py; entries that clip at 0
move less), inside the serving radius of 0.9 and about as far, relative to
the radius, as an ORB filler's 25 bits of 50: a query that matches a
trained row at distance d meets its fillers' copies near
sqrt(d^2 + 0.36^2), in radius but ranked below the source.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SEED = 20260
FLIP_P = 0.1
CUBE_M = 0.25
L2_NOISE = 16


def filler_arrays(real: Sequence[Tuple[np.ndarray, np.ndarray]],
                  n_filler: int, seed: int = SEED, flip_p: float = FLIP_P,
                  cube_m: float = CUBE_M
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_filler`` (descriptors u8, points f32) pairs made from the
    ``real`` (descriptors, points) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_filler):
        desc, _ = real[j % len(real)]
        n = desc.shape[0]
        flips = rng.random((n, 256)) < flip_p
        mask = np.packbits(flips, axis=1, bitorder="little")
        pts = rng.uniform(-cube_m / 2, cube_m / 2, (n, 3)).astype(np.float32)
        out.append((np.bitwise_xor(desc, mask), pts))
    return out


def filler_arrays_on(device, real: Sequence[Tuple[np.ndarray, np.ndarray]],
                     first: int, n_filler: int, seed: int = SEED,
                     flip_p: float = FLIP_P, cube_m: float = CUBE_M
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Fillers ``first .. first + n_filler - 1`` made as
    :func:`filler_arrays` makes them, but drawn on ``device`` from a seeded
    ``torch.Generator``: the same distribution, other draws. A 1000-object
    catalog needs ~5.4e9 bit draws, too many for the host."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + first)
    weights = (1 << torch.arange(8, device=device)).to(torch.uint8)
    out = []
    for j in range(first, first + n_filler):
        desc, _ = real[j % len(real)]
        n = desc.shape[0]
        flips = torch.rand((n, 32, 8), generator=gen, device=device) < flip_p
        mask = (flips.to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)
        pts = (torch.rand((n, 3), generator=gen, device=device) - 0.5) * cube_m
        out.append((np.bitwise_xor(desc, mask.cpu().numpy()),
                    pts.cpu().numpy().astype(np.float32)))
    return out


def filler_arrays_l2(real: Sequence[Tuple[np.ndarray, np.ndarray]],
                     n_filler: int, seed: int = SEED, noise: int = L2_NOISE,
                     cube_m: float = CUBE_M
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_filler`` (descriptors int8, points f32) pairs made from the
    quantised ``real`` (descriptors, points) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_filler):
        desc, _ = real[j % len(real)]
        n = desc.shape[0]
        step = rng.integers(-noise, noise + 1, (n, desc.shape[1]),
                            dtype=np.int16)
        pts = rng.uniform(-cube_m / 2, cube_m / 2, (n, 3)).astype(np.float32)
        out.append((np.clip(desc + step, 0, 127).astype(np.int8), pts))
    return out


def filler_arrays_l2_on(device, real: Sequence[Tuple[np.ndarray, np.ndarray]],
                        first: int, n_filler: int, seed: int = SEED,
                        noise: int = L2_NOISE, cube_m: float = CUBE_M
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Fillers ``first .. first + n_filler - 1`` made as
    :func:`filler_arrays_l2` makes them, but drawn on ``device`` from a
    seeded ``torch.Generator``: the same distribution, other draws."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + first)
    sources = [torch.from_numpy(d).to(device=device, dtype=torch.int16)
               for d, _ in real]
    out = []
    for j in range(first, first + n_filler):
        desc = sources[j % len(real)]
        step = torch.randint(-noise, noise + 1, desc.shape, generator=gen,
                             device=device, dtype=torch.int16)
        pts = (torch.rand((desc.shape[0], 3), generator=gen, device=device)
               - 0.5) * cube_m
        out.append(((desc + step).clamp_(0, 127).to(torch.int8).cpu().numpy(),
                    pts.cpu().numpy().astype(np.float32)))
    return out


def edge_case_arrays_l2(seed: int, long_rows: int = 9000, n_q: int = 300
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(int8 descriptors per object, int8 queries) that hit the L2 matcher
    kernels' edges: an empty object (1), an object of one row (5), objects
    spanning several row tiles and DB chunks, duplicate rows within (object
    3, rows 5 and 10-19) and across row tiles (object 2, rows 7, 40, 300
    and ``long_rows`` - 100: the lowest-row tie rule), and queries equal to
    a row (0: object 4's row 123; 1: object 3's row 5; 2: object 2's row 7)
    and all zero (3)."""
    rng = np.random.default_rng(seed)
    sizes = [300, 0, long_rows, 64, 700, 1, 4096, 129]
    descs = [rng.integers(0, 128, (n, 128)).astype(np.int8) for n in sizes]
    descs[3][10:20] = descs[3][5]
    descs[2][[40, 300, long_rows - 100]] = descs[2][7]
    q = rng.integers(0, 128, (max(n_q, 4), 128)).astype(np.int8)
    q[0] = descs[4][123]
    q[1] = descs[3][5]
    q[2] = descs[2][7]
    q[3] = 0
    return descs, q[:n_q]


def edge_case_arrays_hamming(seed: int, n_rows: int, n_q: int,
                             boundaries: Sequence[int]
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(DB rows (n_rows, 32) u8, queries (n_q >= 70, 32) u8) that hit the
    radius k-NN matcher's edges: row 10 copied to the six rows around each
    of ``boundaries`` (chunk or split boundaries: the earlier block must win
    the tie) and to rows 1000-1003 (ties inside one block); queries 2-65
    rows in [2000, n_rows - 128) with ~5 % of their bits flipped (a few hits within a radius of
    35), query 66 a row with 20 bits flipped (one hit: fewer than
    k), the rest random (no hit within 35). Query 0 is at distance 0, and
    query 1 at distance 1, from row 10 and every copy. With more than 3000
    rows, row 3000 is copied across the tensor-core sweep's 8-row
    fragments and the lanes of a quad (rows 3-9) and across its 128-row
    tiles (rows 127-129, 255, 256), and query 67 equals it."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, (n_rows, 32), dtype=np.uint8)
    q = rng.integers(0, 256, (n_q, 32), dtype=np.uint8)
    dup = db[10].copy()
    for b in boundaries:
        db[b - 3:b + 3] = dup
    db[1000:1004] = dup
    q[0] = dup
    q[1] = dup
    q[1, 0] ^= 1
    src = rng.choice(np.arange(2000, n_rows - 128), 64, replace=False)
    flips = np.packbits(rng.random((64, 256)) < 0.05, axis=1,
                        bitorder="little")
    q[2:66] = db[src] ^ flips
    mask = np.zeros(256, bool)
    mask[rng.choice(256, 20, replace=False)] = True
    q[66] = db[1500] ^ np.packbits(mask, bitorder="little")
    if n_rows > 3000:
        db[[3, 4, 5, 6, 7, 8, 9, 127, 128, 129, 255, 256]] = db[3000]
        q[67] = db[3000]
    return db, q


HAMMING_TILE_TIES = [3, 4, 5, 6, 7, 8, 9, 127, 128, 129, 255, 256]


def edge_case_arrays_l2_int8(seed: int, n_q: int
                             ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(int8 descriptors per object, int8 queries) over the full int8 range
    -128..127 that hit kernel B3's tile edges: objects of 17, 0, 1, 15, 16,
    127, 128, 129 and 300 rows; object 8's row 40 copied to rows 7-9, 127,
    128, 255, 256 and 299 (ties across 8-row fragments and 128-row tiles),
    its rows 200 / 201 all -128 / all 127. Query 0 equals object 8's row
    40, query 1 is all -128, query 2 all 127 (the extremes of the squared
    distance), query 3 equals object 7's row 128."""
    rng = np.random.default_rng(seed)
    sizes = [17, 0, 1, 15, 16, 127, 128, 129, 300]
    descs = [rng.integers(-128, 128, (n, 128)).astype(np.int8)
             for n in sizes]
    descs[8][[7, 8, 9, 127, 128, 255, 256, 299]] = descs[8][40]
    descs[8][200] = -128
    descs[8][201] = 127
    q = rng.integers(-128, 128, (max(n_q, 4), 128)).astype(np.int8)
    q[0] = descs[8][40]
    q[1] = -128
    q[2] = 127
    q[3] = descs[7][128]
    return descs, q[:n_q]


def edge_case_arrays_hamming_tiles(seed: int, n_q: int
                                   ) -> Tuple[List[np.ndarray], np.ndarray]:
    """(u8 descriptors per object, u8 queries) that hit kernel B1's
    tensor-core tile edges: objects of 17, 0, 1, 15, 16, 127, 128, 129 and
    300 rows; object 8's row 40 copied to rows 7-9, 127, 128, 255, 256 and
    299 (ties across 8-row fragments, the lanes of a quad and 128-row
    tiles), its rows 200 / 201 all zero / all ones. Query 0 equals object
    8's row 40, query 1 is all zero, query 2 all ones (the extremes of
    ``|q|``), query 3 equals object 7's row 128."""
    rng = np.random.default_rng(seed)
    sizes = [17, 0, 1, 15, 16, 127, 128, 129, 300]
    descs = [rng.integers(0, 256, (n, 32), dtype=np.uint8) for n in sizes]
    descs[8][[7, 8, 9, 127, 128, 255, 256, 299]] = descs[8][40]
    descs[8][200] = 0
    descs[8][201] = 255
    q = rng.integers(0, 256, (max(n_q, 4), 32), dtype=np.uint8)
    q[0] = descs[8][40]
    q[1] = 0
    q[2] = 255
    q[3] = descs[7][128]
    return descs, q[:n_q]


def dedup_case_arrays(seed: int, n_rows: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(descriptors (n_rows, 32) u8, points (n_rows, 3) f32) for the model
    dedup (``ops/compress.py``), n_rows >= 64: a quarter random rows in a
    10 cm cube; a quarter copies of earlier rows with 0-12 bits flipped,
    0-8 mm away (duplicates on both sides of the 8-bit and 5 mm
    thresholds); chains of four rows, each 5 bits and 3 mm from the one
    before (a row whose suppressor is itself suppressed survives); twelve
    copies of one row at one point (more equal neighbours than k = 8); and
    rows 4 bits either side of a row, at equal distance (ties in (dist,
    row) order)."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 256, (n_rows, 32), dtype=np.uint8)
    pts = rng.uniform(-0.05, 0.05, (n_rows, 3))

    def flipped(row, n_bits):
        mask = np.zeros(256, bool)
        mask[rng.choice(256, n_bits, replace=False)] = True
        return row ^ np.packbits(mask, bitorder="little")

    q = n_rows // 4
    for r in range(q, 2 * q):
        src = int(rng.integers(0, r))
        desc[r] = flipped(desc[src], int(rng.integers(0, 13)))
        pts[r] = pts[src] + rng.uniform(-0.008, 0.008, 3) / np.sqrt(3)
    for r in range(2 * q, 3 * q - 3, 4):
        for c in range(1, 4):
            desc[r + c] = flipped(desc[r + c - 1], 5)
            pts[r + c] = pts[r + c - 1] + (0.003, 0.0, 0.0)
    desc[3 * q:3 * q + 12] = desc[5]
    pts[3 * q:3 * q + 12] = pts[5]
    for r in range(3 * q + 12, n_rows - 1, 2):
        src = int(rng.integers(0, 3 * q))
        desc[r] = flipped(desc[src], 4)
        desc[r + 1] = flipped(desc[src], 4)
        pts[r] = pts[src] + (0.002, 0.0, 0.0)
        pts[r + 1] = pts[src] - (0.002, 0.0, 0.0)
    return desc, pts.astype(np.float32)


def smoke_catalog(real_ids: Sequence[str],
                  real: Sequence[Tuple[np.ndarray, np.ndarray]],
                  n_objects: int = 100, seed: int = SEED, device=None
                  ) -> Tuple[List[str], List[Tuple[np.ndarray, np.ndarray]]]:
    """(object ids, (descriptors, points) per object): the real models
    first, then fillers named ``filler###`` up to ``n_objects``. With a
    ``device``, the fillers past the first 100 objects are drawn there
    (:func:`filler_arrays_on`), so the first 100 are the 100-object
    catalog's. Quantised SIFT models (int8 descriptors) get the integer-noise
    fillers, ORB models (uint8) the bit-flip ones."""
    on_host, on_device = (
        (filler_arrays_l2, filler_arrays_l2_on)
        if real[0][0].dtype == np.int8 else (filler_arrays, filler_arrays_on))
    n_host = n_objects if device is None else min(n_objects, 100)
    fill = on_host(real, n_host - len(real), seed)
    if n_objects > n_host:
        fill += on_device(device, real, len(fill), n_objects - n_host, seed)
    ids = list(real_ids) + [f"filler{j:03d}" for j in range(len(fill))]
    return ids, list(real) + fill
