"""Segmented two-tier frame detection (tod_tpu/geometry/detection.py, the
serving subset).

Per-(query, object) matches go into margin-ordered per-object stores; a
cheap margin-mass statistic pre-screens objects, a lean RANSAC (tier 1)
scores their geometric presence, and the full certified multi-instance
RANSAC (tier 2) runs on the activated set. The reference maps its per-object
work over objects in batches; here each tier runs as one batch over its
objects.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tod_tpu_torch.geometry.adjacency import ObjectMatches, fill_adjacency
from tod_tpu_torch.geometry.ransac import (NoiseFn, ObjectDetections,
                                           RansacConfig,
                                           detect_object_instances,
                                           presence_score)
from tod_tpu_torch.ops.fast import stable_topk


@dataclasses.dataclass(frozen=True)
class GuessConfig:
    """Static shape/algorithm knobs for the frame-level pose search."""

    ransac: RansacConfig = RansacConfig()
    max_matches_per_object: int = 512
    object_batch: int = 8          # the reference's lax.map batch (unused)
    max_active_objects: int = 16

    @property
    def sensor_error(self) -> float:
        return self.ransac.sensor_error


@dataclasses.dataclass(frozen=True)
class ActivationConfig:
    """Tier-1 presence scoring knobs."""

    m_cap: int = 256
    n_hypotheses: int = 256
    object_batch: int = 20         # the reference's lax.map batch (unused)
    min_score: int = 4
    prescreen: int = 0
    prescreen_top: int = 64
    active_reserve: int = 4        # only used with tracked slots (not ported)


MARGIN_ALPHA = 0.75     # cap priority = dist - alpha * cross-object level


def median_level(dist: torch.Tensor) -> torch.Tensor:
    """Per-query cross-object median of (Q, O) distances, the mean of the
    two middle values for an even count (``jnp.median``; ``torch.median``
    would return the lower one)."""
    s = torch.sort(dist, dim=1).values
    o = dist.shape[1]
    return (s[:, (o - 1) // 2] + s[:, o // 2]) * 0.5


def build_object_stores(dist: torch.Tensor, rows: torch.Tensor,
                        q_valid: torch.Tensor, query_pts: torch.Tensor,
                        query_xy: torch.Tensor, points: torch.Tensor,
                        obj_start: torch.Tensor, sel: torch.Tensor,
                        m_cap: int, radius: float,
                        level: torch.Tensor) -> ObjectMatches:
    """Per-object stores of the ``m_cap`` in-radius matches with the most
    negative cross-object margin d[q,o] - alpha*level[q] (ties: lower
    query index). ``sel``: (A,) object indices, -1 = empty slot."""
    q_n = dist.shape[0]
    cap = min(m_cap, q_n)
    pad = m_cap - cap
    o_safe = sel.clamp_min(0).long()
    d = dist[:, o_safe].T                                       # (A,Q)
    pri = d - MARGIN_ALPHA * level[None, :]
    ok = (d <= radius) & q_valid[None, :] & (sel >= 0)[:, None]
    neg_inf = torch.full((), -torch.inf, device=dist.device)
    top, kp = stable_topk(torch.where(ok, -pri, neg_inf), cap)   # (A,cap)
    got = torch.isfinite(top)
    g_row = obj_start[o_safe].long()[:, None] + rows[kp, o_safe[:, None]]
    zero = torch.zeros((), device=dist.device)
    out = ObjectMatches(
        query_pts=torch.where(got[..., None], query_pts[kp], zero),
        train_pts=torch.where(got[..., None], points[g_row], zero),
        query_idx=torch.where(got, kp, -1),
        query_xy=torch.where(got[..., None], query_xy[kp], zero),
        valid=got)
    if pad:   # fewer queries than the capacity: pad the stores up to it
        def grow(x, fill):
            tail = torch.full((x.shape[0], pad) + x.shape[2:], fill,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], 1)

        out = ObjectMatches(grow(out.query_pts, 0), grow(out.train_pts, 0),
                            grow(out.query_idx, -1), grow(out.query_xy, 0),
                            grow(out.valid, False))
    return out


def prescreen_scores(dist: torch.Tensor, level: torch.Tensor,
                     q_valid: torch.Tensor, radius: float,
                     top: int) -> torch.Tensor:
    """Per-object presence proxy: the summed magnitude of the ``top`` most
    negative cross-object margins among in-radius matches. (O,)."""
    m = dist - MARGIN_ALPHA * level[:, None]
    inr = (dist <= radius) & q_valid[:, None]
    neg = torch.where(inr, torch.clamp_min(-m, 0.0),
                      torch.zeros((), device=dist.device))
    k = min(top, neg.shape[0])
    # the values are multiples of 1/8 below 2^20: the sum is exact in any
    # order; + 0.0 turns an all -0.0 sum into the reference's +0.0
    return torch.topk(neg.T, k, dim=1).values.sum(-1) + 0.0


def activation_cut(scores: torch.Tensor, n_active: int,
                   act: ActivationConfig) -> torch.Tensor:
    """Top ``n_active`` object indices by tier-1 score (ties: lower index),
    -1 below ``min_score`` (the reference's cut with no forced slots)."""
    top_scores, active = stable_topk(scores, n_active)
    return torch.where(top_scores >= act.min_score, active, -1)


def detect_objects(noise: NoiseFn, matches: ObjectMatches,
                   spans: torch.Tensor, cfg: GuessConfig) -> ObjectDetections:
    """Adjacency fill + multi-instance RANSAC for a batch of objects."""
    graphs = fill_adjacency(matches, spans, cfg.sensor_error)
    n_obj, m = matches.valid.shape
    gumbels = [noise(f"round{i}", (n_obj, 3, cfg.ransac.round_hypotheses(i),
                                   m))
               for i in range(cfg.ransac.max_instances)]
    return detect_object_instances(gumbels, matches, graphs, cfg.ransac)


def scatter_detections(det: ObjectDetections, active: torch.Tensor,
                       n_objects: int) -> ObjectDetections:
    """Scatter active-object results back to the full object axis; -1 slots
    are dropped (they never clobber object 0)."""
    safe = torch.where(active >= 0, active, n_objects).long()
    acc = det.accepted & (active >= 0)[:, None]

    def put(x):
        full = torch.zeros((n_objects + 1,) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        full[safe] = x
        return full[:n_objects]

    zero = torch.zeros((), device=acc.device)
    return ObjectDetections(
        R=put(det.R), T=put(det.T),
        n_inliers=put(torch.where(acc, det.n_inliers, 0)),
        accepted=put(acc),
        rms_residual=put(torch.where(acc, det.rms_residual, zero)),
        clique_size=put(torch.where(acc, det.clique_size, 0)))


def detect_frame_segmented(
        noise: NoiseFn, dist: torch.Tensor, rows: torch.Tensor,
        q_valid: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, points: torch.Tensor,
        obj_start: torch.Tensor, spans: torch.Tensor, cfg: GuessConfig,
        act: ActivationConfig, radius: float
) -> Tuple[torch.Tensor, ObjectDetections]:
    """Tier-1 presence scoring on the pre-screened objects + tier-2
    certified multi-instance RANSAC on the activated set. Returns
    ``(scores (O,), ObjectDetections (O, I, ...))``."""
    n_objects = spans.shape[0]
    dev = dist.device
    level = median_level(dist)
    n_pre = min(act.prescreen, n_objects) if act.prescreen > 0 else n_objects
    if n_pre < n_objects:
        pre = prescreen_scores(dist, level, q_valid, radius,
                               act.prescreen_top)
        pre_ids = stable_topk(pre, n_pre)[1]
    else:
        pre_ids = torch.arange(n_objects, device=dev)

    # ---- tier 1: lean presence scores -------------------------------------
    stores = build_object_stores(dist, rows, q_valid, query_pts, query_xy,
                                 points, obj_start, pre_ids, act.m_cap,
                                 radius, level)
    graphs = fill_adjacency(stores, spans[pre_ids], cfg.sensor_error)
    g1 = noise("tier1", (n_pre, 3, act.n_hypotheses, act.m_cap))
    pre_scores = presence_score(g1, stores, graphs, cfg.sensor_error)
    scores = torch.zeros(n_objects, dtype=pre_scores.dtype, device=dev)
    scores[pre_ids] = pre_scores       # un-screened objects keep score 0

    # ---- tier 2: full certified RANSAC on the activated set ---------------
    active = activation_cut(scores, min(cfg.max_active_objects, n_objects),
                            act)
    stores = build_object_stores(dist, rows, q_valid, query_pts, query_xy,
                                 points, obj_start, active,
                                 cfg.max_matches_per_object, radius, level)
    det = detect_objects(noise, stores, spans[active.clamp_min(0)], cfg)
    det = det._replace(accepted=det.accepted & (active >= 0)[:, None])
    return scores, scatter_detections(det, active, n_objects)
