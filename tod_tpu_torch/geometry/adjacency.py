"""Geometric-consistency adjacency graphs over match sets
(tod_tpu/geometry/adjacency.py).

Dense boolean M x M matrices plus a validity mask; every function takes a
leading batch of objects (shape (A, M, ...)), so one call serves all of a
frame's objects. Semantics (FillAdjacency, adjacency_ransac.cpp:128-172):
  * physical edge (i, j):  |q_i - q_j| <= span + 2*sigma   and
                           | |t_i - t_j| - |q_i - q_j| | <= 4*sigma
  * sample edge (i, j):    physical  and  pixel dist > 20 px  and
                           | |t| - |q| | < 2*sigma
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MIN_SAMPLE_SIZE = 3
PIXEL_SEP_SQ = 20.0 * 20.0
PRUNE_ITERS = 8


def pairwise_sq_dists(a: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) -> (..., M, M) squared distances as |a|^2 + |b|^2 - 2 a.b
    (an f32 product; callers keep TF32 off on the card)."""
    sq = (a * a).sum(-1)
    dot = a @ a.transpose(-1, -2)
    d = sq[..., :, None] + sq[..., None, :] - 2.0 * dot
    return torch.clamp_min(d, 0.0)


class ObjectMatches(NamedTuple):
    """Fixed-capacity per-object correspondence stores, (A, M, ...)."""

    query_pts: torch.Tensor   # (A,M,3) camera-frame 3D query points
    train_pts: torch.Tensor   # (A,M,3) object-frame 3D model points
    query_idx: torch.Tensor   # (A,M) int64 source keypoint index (-1 = none)
    query_xy: torch.Tensor    # (A,M,2) float32 keypoint pixel coords
    valid: torch.Tensor       # (A,M) bool


class AdjacencyGraphs(NamedTuple):
    physical: torch.Tensor    # (A,M,M) bool, symmetric, no self-loops
    sample: torch.Tensor      # (A,M,M) bool
    valid: torch.Tensor       # (A,M) bool after degree pruning


def prune_low_degree(sample: torch.Tensor, valid: torch.Tensor,
                     min_degree: int = MIN_SAMPLE_SIZE,
                     max_iters: int = PRUNE_ITERS) -> torch.Tensor:
    """Drop vertices with < min_degree sample-neighbours among the still
    valid set, ``max_iters`` times. The reference stops when nothing
    changes; once nothing changes every further pass is a no-op, so the
    fixed count gives its result without a host round trip."""
    for _ in range(max_iters):
        deg = (sample & valid[..., None, :]).sum(-1)
        valid = valid & (deg >= min_degree)
    return valid


def fill_adjacency(m: ObjectMatches, span: torch.Tensor,
                   sensor_error: float) -> AdjacencyGraphs:
    """Both adjacency matrices + degree-pruned validity. ``span``: (A,)."""
    dq2 = pairwise_sq_dists(m.query_pts)
    dq = torch.sqrt(dq2)
    dt = torch.sqrt(pairwise_sq_dists(m.train_pts))
    xy0 = torch.cat([m.query_xy, torch.zeros_like(m.query_xy[..., :1])], -1)
    dpix2 = pairwise_sq_dists(xy0)
    cons = torch.abs(dt - dq)
    gate = (span + 2.0 * sensor_error) ** 2
    span_gate = dq2 <= gate[..., None, None]
    pair_valid = m.valid[..., :, None] & m.valid[..., None, :]
    n = m.valid.shape[-1]
    not_diag = ~torch.eye(n, dtype=torch.bool, device=m.valid.device)
    physical = (span_gate & (cons <= 4.0 * sensor_error) & pair_valid
                & not_diag)
    sample = physical & (dpix2 > PIXEL_SEP_SQ) & (cons < 2.0 * sensor_error)
    return AdjacencyGraphs(physical=physical, sample=sample,
                           valid=prune_low_degree(sample, m.valid))


def invalidate_query_indices(graphs_valid: torch.Tensor,
                             sample: torch.Tensor, query_idx: torch.Tensor,
                             inlier_mask: torch.Tensor) -> torch.Tensor:
    """Remove every match sharing a query keypoint with an inlier, then
    degree-prune: one keypoint explains at most one detection."""
    shares = ((query_idx[..., :, None] == query_idx[..., None, :])
              & inlier_mask[..., None, :])
    return prune_low_degree(sample, graphs_valid & ~shares.any(-1))


def count_unique_query_indices(query_idx: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Number of distinct keypoints among masked matches."""
    eq = query_idx[..., :, None] == query_idx[..., None, :]
    both = mask[..., :, None] & mask[..., None, :]
    n = mask.shape[-1]
    earlier = torch.ones((n, n), dtype=torch.bool,
                         device=mask.device).tril(-1)
    dup = (eq & both & earlier).any(-1)
    return (mask & ~dup).sum(-1)
