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
in numpy. The keys go up once, from pinned memory without a wait, so a
draw adds no host/device synchronisation.

:func:`gumbel` (the RANSAC's noise) and :func:`threefry_bits` launch the
hand-written kernel N1, ``csrc/threefry_gumbel.cu`` (threefry, uniform and
Gumbel fused, one launch a batch of keys, 4 bytes written a draw), on a
CUDA device, and run their plain PyTorch twins :func:`gumbel_torch` and
:func:`threefry_bits_torch` on the CPU. The twins, :func:`random_bits` and
:func:`uniform` run in PyTorch on the device they are given, vectorised
over a leading batch of keys, with uint32 arithmetic emulated in int64
(PyTorch's uint32 has no add or shifts).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from tod_tpu_torch import kernels

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_ONE_BITS = 0x3F800000     # 1.0f: the exponent the mantissa bits fill
F32_NMANT = 23
F32_TINY = float(np.finfo(np.float32).tiny)
MAX_DRAWS = 2**31 - 1   # draws a key that kernel N1 takes (a 32-bit count)


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


def _keys_on(keys: np.ndarray, device: torch.device,
             words: bool = False) -> torch.Tensor:
    """(..., 2) host keys on ``device``, as int64 values or (``words``) as
    their uint32 words in an int32 tensor, sent from pinned memory to a card
    without waiting for it."""
    keys = np.ascontiguousarray(keys, np.uint32)
    host = torch.from_numpy(keys.view(np.int32) if words
                            else keys.astype(np.int64))
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


def gumbel_torch(keys: np.ndarray, shape: Sequence[int],
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain PyTorch twin of kernel N1's Gumbel mode:
    ``jax.random.gumbel(key, shape, float32)`` (mode "low") for every key,
    ``-log(-log(u))`` of ``uniform(tiny, 1)``."""
    u = uniform(keys, shape, F32_TINY, 1.0, device)
    return -torch.log(-torch.log(u))


def threefry_bits_torch(keys: np.ndarray, shape: Sequence[int],
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain PyTorch twin of kernel N1's bits mode: :func:`random_bits` as
    int32 (the uint32 bits reinterpreted)."""
    bits = random_bits(keys, shape, device)
    return ((bits ^ 0x80000000) - 0x80000000).to(torch.int32)


def _checked(keys: np.ndarray, shape: Sequence[int],
             device: torch.device | str):
    """``(keys, n, device)`` as kernel N1 takes them, or raise: (..., 2)
    keys, at most MAX_DRAWS draws a key, on a CPU or CUDA device."""
    keys = np.asarray(keys)
    if keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., 2), got {keys.shape}")
    n = math.prod(shape)
    if n > MAX_DRAWS:
        raise ValueError(f"{n} draws a key exceed the kernel's {MAX_DRAWS}")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no threefry path for {device}")
    return keys, n, device


def _launch(keys: np.ndarray, shape: Sequence[int], n: int,
            device: torch.device, bits: bool) -> torch.Tensor:
    """One launch of kernel N1 for all ``keys`` on the current stream."""
    out = torch.empty((*keys.shape[:-1], *shape),
                      dtype=torch.int32 if bits else torch.float32,
                      device=device)
    if out.numel():
        k = _keys_on(keys, device, words=True)
        kernels.call("threefry_gumbel", "tod_threefry_gumbel",
                     (k.data_ptr(), out.data_ptr()),
                     (keys.size // 2, n, int(bits)),
                     torch.cuda.current_stream(device).cuda_stream)
    return out


def gumbel(keys: np.ndarray, shape: Sequence[int],
           device: torch.device | str = "cuda") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` for every key of ``keys``
    (..., 2): (..., *shape) float32. A CUDA device runs kernel N1 (one
    launch; or raise), the CPU :func:`gumbel_torch`."""
    keys, n, device = _checked(keys, shape, device)
    if device.type == "cpu":
        return gumbel_torch(keys, shape, device)
    out = _launch(keys, shape, n, device, bits=False)
    gumbel.launches += bool(out.numel())
    return out


gumbel.launches = 0


def threefry_bits(keys: np.ndarray, shape: Sequence[int],
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for every key, as int32:
    kernel N1's bits mode on a CUDA device (or raise),
    :func:`threefry_bits_torch` on the CPU."""
    keys, n, device = _checked(keys, shape, device)
    if device.type == "cpu":
        return threefry_bits_torch(keys, shape, device)
    out = _launch(keys, shape, n, device, bits=True)
    threefry_bits.launches += bool(out.numel())
    return out


threefry_bits.launches = 0
