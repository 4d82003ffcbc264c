"""The smoke catalog: a few trained models plus seeded filler objects.

A 100-object catalog trained like the bench's is ~2.2M rows, too large to
ship. The smoke catalog keeps the bench's rows per object instead: filler
object ``j`` is a copy of trained model ``j % n_real`` with every descriptor
bit flipped with probability ``flip_p`` and its points redrawn uniformly in
a cube of ``cube_m``. The matcher then meets real in-radius junk, but the
fillers carry no geometric consistency. Numpy only, so the fixture generator
(with the reference) and the smoke run (with the port) build the same
catalog from the same seed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SEED = 20260
FLIP_P = 0.1
CUBE_M = 0.25


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


def smoke_catalog(real_ids: Sequence[str],
                  real: Sequence[Tuple[np.ndarray, np.ndarray]],
                  n_objects: int = 100, seed: int = SEED, device=None
                  ) -> Tuple[List[str], List[Tuple[np.ndarray, np.ndarray]]]:
    """(object ids, (descriptors, points) per object): the real models
    first, then fillers named ``filler###`` up to ``n_objects``. With a
    ``device``, the fillers past the first 100 objects are drawn there
    (:func:`filler_arrays_on`), so the first 100 are the 100-object
    catalog's."""
    n_host = n_objects if device is None else min(n_objects, 100)
    fill = filler_arrays(real, n_host - len(real), seed)
    if n_objects > n_host:
        fill += filler_arrays_on(device, real, len(fill),
                                 n_objects - n_host, seed)
    ids = list(real_ids) + [f"filler{j:03d}" for j in range(len(fill))]
    return ids, list(real) + fill
