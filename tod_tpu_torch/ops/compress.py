"""Model compression: drop (descriptor, point) rows that duplicate an
earlier row (tod_tpu/ops/compress.py).

A row is dropped iff an earlier surviving row lies within
``hamming_threshold`` bits and ``point_threshold`` meters of it. The
reference finds the candidates with an exact Hamming k-NN of the model
against itself on the CPU (``hamming_knn_cpu``: the k smallest (distance,
row) pairs); the port runs kernel B5, whose radius top-k has the same
(distance, row) order: within the radius its k entries are the leading
entries of the unrestricted top-k, and only entries within the radius can
suppress. The 3D test and the forward chain-safety pass are the
reference's own numpy on the host, so every float decision is the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.hamming import hamming_topk_fused, pack_db_bits


def self_knn(descriptors: np.ndarray, k: int, radius: int,
             device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """``(idx (N,k) int32, dist (N,k) f32)`` of each row's k nearest rows
    of the same model within ``radius`` bits, ascending by (dist, row);
    (-1, 1e9) where fewer rows are within the radius. Kernel B5 on a CUDA
    device, its twin on the CPU."""
    rows = torch.from_numpy(np.ascontiguousarray(descriptors, np.uint8))
    rows = rows.to(device)
    dist, idx = hamming_topk_fused(rows, pack_db_bits(rows), rows.shape[0],
                                   k=k, radius=radius)
    return idx.cpu().numpy(), dist.cpu().numpy()


def compress_model(descriptors: np.ndarray, points: np.ndarray,
                   hamming_threshold: int = 8,
                   point_threshold: float = 0.005,
                   k_neighbors: int = 8,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Drop rows duplicating an earlier (descriptor, point) pair.

    ``descriptors`` (N, 32) uint8, ``points`` (N, 3) float32; returns the
    kept (descriptors, points) in order. The k-NN runs on ``device``."""
    n = len(descriptors)
    if n <= 1:
        return descriptors, points
    idx, dist = self_knn(descriptors, min(k_neighbors, n),
                         int(hamming_threshold), device)
    pts = np.asarray(points, np.float32)
    # from here on the reference's own code (tod_tpu/ops/compress.py:45-61)
    nb_pts = pts[idx]                                    # (N, k, 3)
    d3 = np.linalg.norm(nb_pts - pts[:, None, :], axis=-1)
    dup_pair = ((idx >= 0)
                & (dist <= hamming_threshold)
                & (d3 <= point_threshold)
                & (idx < np.arange(n)[:, None]))
    is_dup = dup_pair.any(axis=1)
    keep = np.ones(n, bool)
    for i in np.nonzero(is_dup)[0]:
        js = idx[i][dup_pair[i]]
        keep[i] = not keep[js].any()
    return descriptors[keep], points[keep]
