"""Bit helpers for 256-bit binary descriptors (tod_tpu/ops/matching.py)."""

from __future__ import annotations

import torch


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
