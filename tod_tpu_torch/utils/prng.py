"""Threefry-2x32 keys and random bits, drawn as ``jax.random`` draws them.

The reference draws its RANSAC noise from ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``, 32-bit mode). This module is the
port's own copy of that path, so that the port draws the very same noise
on any device. Copied from JAX 0.9.0: ``jax/_src/prng.py``
(``threefry_seed``, ``iota_2x32_shape``, ``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_gumbel`` in mode "low").

A key is a numpy ``uint32`` array ``(..., 2)``, as ``jax.random``'s raw
keys: keys live on the host, where :func:`prng_key` and :func:`split` run
in numpy. :func:`random_bits`, :func:`uniform` and :func:`gumbel` run in
PyTorch on the device they are given, vectorised over a leading batch of
keys, with uint32 arithmetic emulated in int64 (PyTorch's uint32 has no
add or shifts). The keys go up once, from pinned memory without a wait, so
a draw adds no host/device synchronisation.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_ONE_BITS = 0x3F800000     # 1.0f: the exponent the mantissa bits fill
F32_NMANT = 23
F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counts ``(x1, x2)`` under the key
    ``(k1, k2)``. Operands are uint32 values held in int64 numpy arrays,
    int64 tensors or Python ints, broadcast together; only operators are
    used, so the same code runs in numpy and in PyTorch on any device.

    Only ``x2`` is reduced to 32 bits in the rounds: the rotation needs it
    exact, while ``x1`` only feeds sums and the low bits of an xor, so it
    grows below 2^37 and is reduced once at the end (one elementwise
    operation fewer a round, on the device's memory)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & MASK
    return x1 & MASK, x2


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: ``[0, seed mod 2^32]``
    (the seed is cut to 32 bits before ``threefry_seed`` splits it)."""
    return np.array([0, int(seed) & MASK], np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)`` of every key of ``key`` (..., 2):
    (..., n, 2). The fold-like split hashes the counts 0 .. n-1 (high word
    0) and keeps both output words."""
    k = np.asarray(key, np.uint32).astype(np.int64)[..., None, :]
    lo = np.arange(n, dtype=np.int64)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], 0, lo)
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def _keys_on(keys: np.ndarray, device: torch.device) -> torch.Tensor:
    """(..., 2) host keys as an int64 tensor on ``device``, sent from
    pinned memory to a card without waiting for it."""
    host = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def random_bits(keys: np.ndarray, shape: Sequence[int],
                device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for every key of ``keys``
    (..., 2): (..., *shape) int64 holding uint32 values. Counts are the
    flat row-major index as a 64-bit number split into (high, low) words,
    and a draw is the xor of the two output words."""
    device = torch.device(device)
    k = _keys_on(keys, device)
    lead = k.shape[:-1]
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = ((count >> 32, count & MASK) if n > MASK + 1 else (0, count))
    k1 = k[..., 0].reshape(*lead, 1)
    k2 = k[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(keys: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0,
            device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for every
    key: the top 23 bits fill the mantissa of a float in [1, 2), less 1,
    scaled into [minval, maxval) and clamped below at ``minval``."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    bits = random_bits(keys, shape, device)
    mant = ((bits >> (32 - F32_NMANT)) | F32_ONE_BITS).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(keys: np.ndarray, shape: Sequence[int],
           device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low") for every
    key: ``-log(-log(u))`` of ``uniform(tiny, 1)``."""
    u = uniform(keys, shape, F32_TINY, 1.0, device)
    return -torch.log(-torch.log(u))
