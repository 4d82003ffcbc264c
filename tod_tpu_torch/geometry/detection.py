"""Frame-level detection (tod_tpu/geometry/detection.py, the serving
subset): the global-kNN path's clustering, the segmented two-tier path, and
the coarse->fine selection and streaming state.

The global-kNN path groups the matcher's flat (Q, k) matches into
per-object stores for the objects with the most matches
(:func:`detect_frame_from_matches`) and runs the multi-instance RANSAC on
them.

Per-(query, object) matches go into margin-ordered per-object stores; a
cheap margin-mass statistic pre-screens objects, a lean RANSAC (tier 1)
scores their geometric presence, and the full certified multi-instance
RANSAC (tier 2) runs on the activated set. The reference maps its per-object
work over objects in batches; here each tier runs as one batch over its
objects.

Coarse->fine serving screens the catalog on a stride-subsampled sweep
(:func:`coarse_select`), runs the exact match and both tiers on the selected
slab only (:func:`detect_frame_gathered`), and carries per-object state from
frame to frame: frames since last accepted (:func:`update_age`), tracked
slab slots (:func:`tracked_needy`), and the last accepted pose as a tier-2
seed (:func:`fold_best_pose`, :func:`seeds_from_state`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from tod_tpu_torch.geometry.adjacency import ObjectMatches, fill_adjacency
from tod_tpu_torch.geometry.ransac import (NoiseFn, ObjectDetections,
                                           RansacConfig, SeedPose,
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
    active_reserve: int = 4        # tier-2 slots kept for unforced finds


MARGIN_ALPHA = 0.75     # cap priority = dist - alpha * cross-object level
ACTIVE_BOOST = 1e6      # f32 boost of forced/reserved slots in the cut


def median_level(dist: torch.Tensor) -> torch.Tensor:
    """Per-query cross-object median of (..., Q, O) distances, the mean of
    the two middle values for an even count (``jnp.median``;
    ``torch.median`` would return the lower one)."""
    s = torch.sort(dist, dim=-1).values
    o = dist.shape[-1]
    return (s[..., (o - 1) // 2] + s[..., o // 2]) * 0.5


def _pad_stores(out: ObjectMatches, pad: int) -> ObjectMatches:
    """Stores grown by ``pad`` empty slots (fewer candidates than the
    capacity)."""
    if not pad:
        return out

    def grow(x, fill):
        tail = torch.full((x.shape[0], pad) + x.shape[2:], fill,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail], 1)

    return ObjectMatches(grow(out.query_pts, 0), grow(out.train_pts, 0),
                         grow(out.query_idx, -1), grow(out.query_xy, 0),
                         grow(out.valid, False))


def _stacked(x: torch.Tensor) -> torch.Tensor:
    """(B, A, ...) -> (B * A, ...): frame b's objects at rows b*A.."""
    return x.flatten(0, 1)


def build_object_stores(dist: torch.Tensor, rows: torch.Tensor,
                        q_valid: torch.Tensor, query_pts: torch.Tensor,
                        query_xy: torch.Tensor, points: torch.Tensor,
                        obj_start: torch.Tensor, sel: torch.Tensor,
                        m_cap: int, radius: float,
                        level: torch.Tensor) -> ObjectMatches:
    """Per-object stores of the ``m_cap`` in-radius matches with the most
    negative cross-object margin d[q,o] - alpha*level[q] (ties: lower
    query index). ``sel``: (A,) object indices, -1 = empty slot. With a
    leading frame axis (``dist`` (B, Q, O), ``sel`` (B, A) and the query
    tensors (B, Q, ...)) the stores of all frames come out stacked, (B * A,
    m_cap, ...), frame b's at rows b*A to (b+1)*A - 1."""
    if dist.dim() == 2:
        return build_object_stores(dist[None], rows[None], q_valid[None],
                                   query_pts[None], query_xy[None], points,
                                   obj_start, sel[None], m_cap, radius,
                                   level[None])
    n_b, q_n, _ = dist.shape
    cap = min(m_cap, q_n)
    o_safe = sel.clamp_min(0).long()                            # (B,A)
    bi = torch.arange(n_b, device=dist.device)[:, None]
    d = dist.transpose(1, 2)[bi, o_safe]                        # (B,A,Q)
    pri = d - MARGIN_ALPHA * level[:, None, :]
    ok = (d <= radius) & q_valid[:, None, :] & (sel >= 0)[..., None]
    neg_inf = torch.full((), -torch.inf, device=dist.device)
    top, kp = stable_topk(torch.where(ok, -pri, neg_inf), cap)  # (B,A,cap)
    got = torch.isfinite(top)
    b3 = bi[..., None]
    # a hole slot's rows (HOLE_ROW) are never gathered: the reference clamps
    # the index and masks the value, the port masks the index
    g_row = torch.where(got, obj_start[o_safe].long()[..., None]
                        + rows[b3, kp, o_safe[..., None]], 0)
    zero = torch.zeros((), device=dist.device)
    return _pad_stores(ObjectMatches(
        query_pts=_stacked(torch.where(got[..., None], query_pts[b3, kp],
                                       zero)),
        train_pts=_stacked(torch.where(got[..., None], points[g_row], zero)),
        query_idx=_stacked(torch.where(got, kp, -1)),
        query_xy=_stacked(torch.where(got[..., None], query_xy[b3, kp],
                                      zero)),
        valid=_stacked(got)), m_cap - cap)


def prescreen_scores(dist: torch.Tensor, level: torch.Tensor,
                     q_valid: torch.Tensor, radius: float,
                     top: int) -> torch.Tensor:
    """Per-object presence proxy: the summed magnitude of the ``top`` most
    negative cross-object margins among in-radius matches. (..., O) of
    (..., Q, O) distances."""
    m = dist - MARGIN_ALPHA * level[..., None]
    inr = (dist <= radius) & q_valid[..., None]
    neg = torch.where(inr, torch.clamp_min(-m, 0.0),
                      torch.zeros((), device=dist.device))
    k = min(top, neg.shape[-2])
    # the values are multiples of 1/8 below 2^20: the sum is exact in any
    # order; + 0.0 turns an all -0.0 sum into the reference's +0.0
    return torch.topk(neg.transpose(-1, -2), k, dim=-1).values.sum(-1) + 0.0


def activation_cut(scores: torch.Tensor, n_active: int,
                   act: ActivationConfig,
                   force_active: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Top ``n_active`` object indices by tier-1 score (ties: lower index),
    -1 below ``min_score``, along the last axis of (..., O) ``scores``.
    ``force_active`` (bool, ``scores``' shape) objects are boosted above
    every unforced score (keeping their own as the tie-break), and so are
    the top ``act.active_reserve`` score-qualified unforced ones, so a full
    tracked slab never displaces a fresh find from tier 2."""
    cut = scores
    if force_active is not None:
        boost = force_active
        r = min(act.active_reserve, n_active)
        if r > 0:
            neg_inf = torch.full((), -torch.inf, device=scores.device)
            nf = torch.where(force_active, neg_inf, scores.float())
            picked = torch.zeros_like(force_active)
            picked.scatter_(-1, stable_topk(nf, r)[1], True)
            boost = force_active | (picked & (scores >= act.min_score)
                                    & ~force_active)
        cut = torch.where(boost, scores + ACTIVE_BOOST, scores)
    top_scores, active = stable_topk(cut, n_active)
    return torch.where(top_scores >= act.min_score, active, -1)


def detect_objects(noise: NoiseFn, matches: ObjectMatches,
                   spans: torch.Tensor, cfg: GuessConfig,
                   seeds: Optional[SeedPose] = None) -> ObjectDetections:
    """Adjacency fill + multi-instance RANSAC for a batch of objects;
    ``seeds`` (A, ...) enter every round of their object."""
    graphs = fill_adjacency(matches, spans, cfg.sensor_error)
    n_obj, m = matches.valid.shape
    gumbels = [noise(f"round{i}", (n_obj, 3, cfg.ransac.round_hypotheses(i),
                                   m))
               for i in range(cfg.ransac.max_instances)]
    return detect_object_instances(gumbels, matches, graphs, cfg.ransac,
                                   seeds)


def scatter_detections(det: ObjectDetections, active: torch.Tensor,
                       n_objects: int) -> ObjectDetections:
    """Scatter active-object results back to the full object axis: ``det``
    holds one row per entry of ``active`` (..., A), in its order; -1 slots
    are dropped (they never clobber object 0). Returns (..., n_objects, I,
    ...)."""
    lead = active.shape[:-1]
    act = active.reshape(-1, active.shape[-1])
    n_b, n_a = act.shape
    safe = torch.where(act >= 0, act, n_objects).long()
    bi = torch.arange(n_b, device=act.device)[:, None]
    acc = det.accepted & (act >= 0).reshape(-1)[:, None]

    def put(x):
        x = x.reshape((n_b, n_a) + x.shape[1:])
        full = torch.zeros((n_b, n_objects + 1) + x.shape[2:], dtype=x.dtype,
                           device=x.device)
        full[bi, safe] = x
        return full[:, :n_objects].reshape(lead + (n_objects,) + x.shape[2:])

    zero = torch.zeros((), device=acc.device)
    return ObjectDetections(
        R=put(det.R), T=put(det.T),
        n_inliers=put(torch.where(acc, det.n_inliers, 0)),
        accepted=put(acc),
        rms_residual=put(torch.where(acc, det.rms_residual, zero)),
        clique_size=put(torch.where(acc, det.clique_size, 0)))


def frame_rows(det: ObjectDetections, n_b: int) -> ObjectDetections:
    """(B * O, ...) detections of B frames as (B, O, ...)."""
    return ObjectDetections(*(x.unflatten(0, (n_b, -1)) for x in det))


# ---- the global-kNN path: flat (Q, k) matches ------------------------------


def cluster_matches(obj_idx: torch.Tensor, dist: torch.Tensor,
                    valid: torch.Tensor, train_pts: torch.Tensor,
                    query_pts: torch.Tensor, query_xy: torch.Tensor,
                    object_ids: torch.Tensor,
                    max_matches: int) -> ObjectMatches:
    """Group flat (Q, k) matches into per-object stores of ``max_matches``
    for the objects ``object_ids`` (A,) (-1 = empty slot): per object the
    valid matches of finite query points, best priority first, where the
    priority is (rank within its query, then distance) as ``rank * stride +
    dist`` with the stride one above the frame's largest valid distance,
    ties to the lower flat index. The reference vmaps one object's top-k;
    here the objects are a batch dimension. With a leading frame axis (the
    matches (B, Q, k, ...), ``object_ids`` (B, A)) the stores of all frames
    come out stacked, (B * A, max_matches, ...)."""
    if obj_idx.dim() == 2:
        return cluster_matches(obj_idx[None], dist[None], valid[None],
                               train_pts[None], query_pts[None],
                               query_xy[None], object_ids[None], max_matches)
    n_b, q, k = obj_idx.shape
    qk = q * k
    dev = dist.device
    obj_flat = obj_idx.reshape(n_b, qk)
    dist_flat = dist.reshape(n_b, qk)
    rank_flat = torch.arange(k, dtype=torch.float32, device=dev).repeat(q)
    q_finite = torch.isfinite(query_pts).all(-1)
    valid_flat = valid.reshape(n_b, qk) & q_finite.repeat_interleave(k, 1)
    t_flat = train_pts.reshape(n_b, qk, 3)
    kp_of_flat = torch.arange(q, device=dev).repeat_interleave(k)
    zero = torch.zeros((), device=dev)
    stride = torch.where(valid_flat, dist_flat, zero).amax(-1, True) + 1.0
    priority = rank_flat * stride + dist_flat                   # (B,QK)
    cap = min(max_matches, qk)
    ids = object_ids.to(obj_flat.dtype)
    mask = valid_flat[:, None, :] & (obj_flat[:, None, :] == ids[..., None]) \
        & (ids >= 0)[..., None]                                 # (B,A,QK)
    neg_inf = torch.full((), -torch.inf, device=dev)
    top, sel = stable_topk(torch.where(mask, -priority[:, None, :], neg_inf),
                           cap)                                 # (B,A,cap)
    ok = torch.isfinite(top)
    kp = kp_of_flat[sel]
    b3 = torch.arange(n_b, device=dev)[:, None, None]
    return _pad_stores(ObjectMatches(
        query_pts=_stacked(torch.where(ok[..., None], query_pts[b3, kp],
                                       zero)),
        train_pts=_stacked(torch.where(ok[..., None], t_flat[b3, sel], zero)),
        query_idx=_stacked(torch.where(ok, kp, -1)),
        query_xy=_stacked(torch.where(ok[..., None], query_xy[b3, kp], zero)),
        valid=_stacked(ok)), max_matches - cap)


def active_objects(obj_idx: torch.Tensor, valid: torch.Tensor,
                   query_pts: torch.Tensor, n_objects: int,
                   n_active: int) -> torch.Tensor:
    """The ``n_active`` objects (int32) with the most valid matches of
    finite query points, ties to the lower index; -1 where an object has
    none. Every object, in order, when ``n_active`` covers the catalog.
    (A,) of one frame's (Q, k) matches; (B, A) of B frames' (B, Q, k)."""
    dev = obj_idx.device
    lead = obj_idx.shape[:-2]
    if n_active >= n_objects:
        return torch.arange(n_objects, dtype=torch.int32,
                            device=dev).expand(lead + (n_objects,))
    v = valid & torch.isfinite(query_pts).all(-1)[..., None]
    n_b = math.prod(lead)
    # each frame counts into its own n_objects bins
    offset = torch.arange(n_b, device=dev).reshape(lead + (1, 1)) * n_objects
    counts = torch.zeros(n_b * n_objects, dtype=torch.int32, device=dev)
    counts.index_add_(0, (obj_idx.clamp_min(0).long() + offset).reshape(-1),
                      v.reshape(-1).to(torch.int32))
    top, active = stable_topk(counts.reshape(lead + (n_objects,)), n_active)
    return torch.where(top > 0, active, -1).to(torch.int32)


def detect_frames_from_matches(
        noise: NoiseFn, obj_idx: torch.Tensor, dist: torch.Tensor,
        valid: torch.Tensor, train_pts: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, spans: torch.Tensor,
        cfg: GuessConfig) -> Tuple[ObjectMatches, ObjectDetections]:
    """Cluster + detect (GuessGenerator::process) for B frames at once, the
    matches (B, Q, k, ...): each frame's active set
    (:func:`active_objects`) and its stores (:func:`cluster_matches`), then
    the multi-instance RANSAC once over the B frames' stacked objects
    (``noise`` draws (B * A, ...), frame b's objects at rows b*A..).
    Detections are (B, O, I, ...); objects outside a frame's active set
    carry accepted=False rows."""
    n_b = obj_idx.shape[0]
    n_objects = spans.shape[0]
    n_active = min(cfg.max_active_objects, n_objects)
    active = active_objects(obj_idx, valid, query_pts, n_objects, n_active)
    clustered = cluster_matches(obj_idx, dist, valid, train_pts, query_pts,
                                query_xy, active, cfg.max_matches_per_object)
    det = detect_objects(noise, clustered,
                         spans[active.clamp_min(0).long()].reshape(-1), cfg)
    if n_active == n_objects:
        return clustered, frame_rows(det, n_b)
    return clustered, scatter_detections(det, active, n_objects)


def detect_frame_from_matches(
        noise: NoiseFn, obj_idx: torch.Tensor, dist: torch.Tensor,
        valid: torch.Tensor, train_pts: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, spans: torch.Tensor,
        cfg: GuessConfig) -> Tuple[ObjectMatches, ObjectDetections]:
    """:func:`detect_frames_from_matches` of one frame's (Q, k) matches:
    detections with leading dim O."""
    clustered, det = detect_frames_from_matches(
        noise, obj_idx[None], dist[None], valid[None], train_pts[None],
        query_pts[None], query_xy[None], spans, cfg)
    return clustered, ObjectDetections(*(x[0] for x in det))


def detect_frames_segmented(
        noise: NoiseFn, dist: torch.Tensor, rows: torch.Tensor,
        q_valid: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, points: torch.Tensor,
        obj_start: torch.Tensor, spans: torch.Tensor, cfg: GuessConfig,
        act: ActivationConfig, radius: float,
        force: Optional[torch.Tensor] = None, n_forced: int = 0,
        force_active: Optional[torch.Tensor] = None,
        seeds: Optional[SeedPose] = None
) -> Tuple[torch.Tensor, ObjectDetections]:
    """Tier-1 presence scoring on the pre-screened objects + tier-2
    certified multi-instance RANSAC on the activated set, for B frames at
    once: ``dist``/``rows`` (B, Q, O), the query tensors (B, Q, ...).
    Each frame is pre-screened, stored and cut on its own; the adjacency
    fill and both RANSAC tiers run once over the B frames' stacked objects
    (``noise`` draws (B * A, ...), frame b's objects at rows b*A..).
    Returns ``(scores (B, O), ObjectDetections (B, O, I, ...))``.

    ``force`` (bool (B, O)): objects that bypass the prescreen ranking (the
    reserved coarse->fine slots); ``n_forced`` widens the tier-1 set by the
    reserved-slot count so they never displace ranked objects.
    ``force_active`` (bool (B, O), tracked slots only) also bypasses the
    activation cut (:func:`activation_cut`). ``seeds`` (SeedPose (B, O,
    ...)) enter each activated object's tier-2 rounds."""
    n_b, _, n_objects = dist.shape
    dev = dist.device
    bi = torch.arange(n_b, device=dev)[:, None]
    level = median_level(dist)
    n_pre = (min(act.prescreen + (n_forced if force is not None else 0),
                 n_objects) if act.prescreen > 0 else n_objects)
    if n_pre < n_objects:
        pre = prescreen_scores(dist, level, q_valid, radius,
                               act.prescreen_top)
        if force is not None:
            pre = torch.where(force, torch.full((), torch.inf, device=dev),
                              pre)
        pre_ids = stable_topk(pre, n_pre)[1]
    else:
        pre_ids = torch.arange(n_objects, device=dev).expand(n_b, n_objects)

    # ---- tier 1: lean presence scores -------------------------------------
    stores = build_object_stores(dist, rows, q_valid, query_pts, query_xy,
                                 points, obj_start, pre_ids, act.m_cap,
                                 radius, level)
    graphs = fill_adjacency(stores, spans[pre_ids].reshape(-1),
                            cfg.sensor_error)
    g1 = noise("tier1", (n_b * n_pre, 3, act.n_hypotheses, act.m_cap))
    pre_scores = presence_score(g1, stores, graphs, cfg.sensor_error)
    scores = torch.zeros((n_b, n_objects), dtype=pre_scores.dtype,
                         device=dev)
    # un-screened objects keep score 0
    scores.scatter_(1, pre_ids, pre_scores.reshape(n_b, n_pre))

    # ---- tier 2: full certified RANSAC on the activated set ---------------
    active = activation_cut(scores, min(cfg.max_active_objects, n_objects),
                            act, force_active)
    stores = build_object_stores(dist, rows, q_valid, query_pts, query_xy,
                                 points, obj_start, active,
                                 cfg.max_matches_per_object, radius, level)
    a_safe = active.clamp_min(0)
    act_seeds = None
    if seeds is not None:
        act_seeds = SeedPose(R=_stacked(seeds.R[bi, a_safe]),
                             T=_stacked(seeds.T[bi, a_safe]),
                             ok=_stacked(seeds.ok[bi, a_safe] & (active >= 0)))
    det = detect_objects(noise, stores, spans[a_safe].reshape(-1), cfg,
                         act_seeds)
    return scores, scatter_detections(det, active, n_objects)


def detect_frame_segmented(
        noise: NoiseFn, dist: torch.Tensor, rows: torch.Tensor,
        q_valid: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, points: torch.Tensor,
        obj_start: torch.Tensor, spans: torch.Tensor, cfg: GuessConfig,
        act: ActivationConfig, radius: float,
        force: Optional[torch.Tensor] = None, n_forced: int = 0,
        force_active: Optional[torch.Tensor] = None,
        seeds: Optional[SeedPose] = None
) -> Tuple[torch.Tensor, ObjectDetections]:
    """:func:`detect_frames_segmented` of one frame: ``dist``/``rows`` (Q,
    O), ``force``/``force_active`` (O,), ``seeds`` on the (O,) axis.
    Returns ``(scores (O,), ObjectDetections (O, I, ...))``."""
    def one(x):
        return None if x is None else x[None]

    scores, det = detect_frames_segmented(
        noise, dist[None], rows[None], q_valid[None], query_pts[None],
        query_xy[None], points, obj_start, spans, cfg, act, radius,
        one(force), n_forced, one(force_active),
        None if seeds is None else SeedPose(*(x[None] for x in seeds)))
    return scores[0], ObjectDetections(*(x[0] for x in det))


# ---- coarse->fine selection and streaming state --------------------------


def coarse_select(dist_c: torch.Tensor, q_valid: torch.Tensor, radius: float,
                  slack: float, width: int, top: int) -> torch.Tensor:
    """The top ``width`` objects (int32) by the prescreen margin-mass
    statistic of a coarse (stride-subsampled) sweep's (Q, O) distances,
    counted in radius ``radius + slack`` (coarse distances are biased
    up)."""
    pre = prescreen_scores(dist_c, median_level(dist_c), q_valid,
                           radius + slack, top)
    return stable_topk(pre, min(width, dist_c.shape[1]))[1].to(torch.int32)


AGE_NEVER = 1 << 20   # "never accepted"; update_age saturates here


def tracked_from_age(age: torch.Tensor, width: int, ttl: int,
                     needy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``width`` tracked object indices (int32, -1 = empty): objects
    accepted within ``ttl`` frames, most recent first; ``needy`` objects
    (bool (O,): not selected by last frame's coarse screen) before all
    others."""
    w = min(width, age.shape[0])
    score = ttl + 1 - age.clamp_max(ttl + 1)              # ttl+1 .. 0
    if needy is not None:
        score = score + needy.to(score.dtype) * (ttl + 2)
    score = torch.where(age <= ttl, score, -1).to(torch.int32)
    top, ids = stable_topk(score, w)
    return torch.where(top >= 0, ids.to(torch.int32), -1)


def merge_tracked(sel_main: torch.Tensor, tracked: torch.Tensor
                  ) -> torch.Tensor:
    """``sel_main`` followed by the reserved ids, each already in
    ``sel_main`` (or -1) holed out to -1, so slab ids stay unique."""
    dup = (tracked[:, None] == sel_main[None, :]).any(dim=1)
    return torch.cat([sel_main, torch.where(dup | (tracked < 0), -1,
                                            tracked)])


def reserved_force_mask(sel: torch.Tensor, *reserved) -> torch.Tensor:
    """Bool mask of the slab slots whose object is in one of the
    ``reserved`` id lists (tracked / exploration; ``None`` entries skipped),
    by membership, so a reserved object merged into its coarse slot stays
    forced; -1 holes never match."""
    ids = torch.cat([torch.where(r >= 0, r, -2) for r in reserved
                     if r is not None])
    return (sel[:, None] == ids[None, :]).any(dim=1)


def update_age(age: torch.Tensor, det: ObjectDetections,
               min_confidence: float = 0.0) -> torch.Tensor:
    """Frames since last accepted, advanced by one frame: 0 where ``det``
    accepted an instance with at least ``min_confidence`` unique inliers
    (the latch gate), +1 (saturating at AGE_NEVER + 1) elsewhere."""
    acc = det.accepted
    if min_confidence > 0:
        acc = acc & (det.n_inliers >= min_confidence)
    return torch.where(acc.any(dim=1), 0,
                       age.clamp_max(AGE_NEVER) + 1).to(torch.int32)


def tracked_needy(age: torch.Tensor, last_coarse_sel: torch.Tensor,
                  width: int, ttl: int) -> torch.Tensor:
    """:func:`tracked_from_age` with neediness: objects that last frame's
    coarse screen did not select (-1 slots are dropped)."""
    n = age.shape[0]
    safe = torch.where(last_coarse_sel >= 0, last_coarse_sel, n).long()
    needy = torch.ones(n + 1, dtype=torch.bool, device=age.device)
    needy[safe] = False
    return tracked_from_age(age, width, ttl, needy[:n])


def seeds_from_state(age: torch.Tensor, last_r: torch.Tensor,
                     last_t: torch.Tensor, ttl: int) -> SeedPose:
    """Every object accepted within ``ttl`` frames seeds tier 2 with its
    last accepted pose."""
    return SeedPose(R=last_r, T=last_t, ok=age <= ttl)


def fold_best_pose(last_r: torch.Tensor, last_t: torch.Tensor,
                   det: ObjectDetections
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per object, the accepted instance with the most inliers (the first
    of equals) replaces the last accepted pose; unchanged where nothing was
    accepted. As in the reference, ``track_min_confidence`` does not gate
    this fold (ROADMAP queue C)."""
    score = torch.where(det.accepted, det.n_inliers, -1)
    best = torch.argmax(score, dim=1)
    o = torch.arange(last_r.shape[0], device=last_r.device)
    acc = det.accepted.any(dim=1)
    return (torch.where(acc[:, None, None], det.R[o, best], last_r),
            torch.where(acc[:, None], det.T[o, best], last_t))


def detect_frame_gathered(
        noise: NoiseFn, dist: torch.Tensor, rows: torch.Tensor,
        sel: torch.Tensor, q_valid: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, points: torch.Tensor,
        obj_start: torch.Tensor, spans: torch.Tensor, cfg: GuessConfig,
        act: ActivationConfig, radius: float,
        force: Optional[torch.Tensor] = None, n_forced: int = 0,
        force_active: Optional[torch.Tensor] = None,
        seeds: Optional[SeedPose] = None
) -> Tuple[torch.Tensor, ObjectDetections]:
    """:func:`detect_frame_segmented` over a gathered (Q, C) slab whose
    columns are the objects ``sel`` (-1 = empty slot, HOLE_DIST columns;
    other ids unique). ``force``/``force_active`` are on the slab axis,
    ``seeds`` on the full object axis (gathered here). Results are
    scattered back: ``(scores (O,), ObjectDetections (O, I, ...))``."""
    n_objects = spans.shape[0]
    sel_safe = sel.clamp_min(0).long()
    slab_seeds = None
    if seeds is not None:
        slab_seeds = SeedPose(R=seeds.R[sel_safe], T=seeds.T[sel_safe],
                              ok=seeds.ok[sel_safe] & (sel >= 0))
    scores_c, det_c = detect_frame_segmented(
        noise, dist, rows, q_valid, query_pts, query_xy, points,
        obj_start[sel_safe], spans[sel_safe], cfg, act, radius, force,
        n_forced, force_active, slab_seeds)
    # an empty slot is dropped, so it never clobbers object 0's score
    safe = torch.where(sel >= 0, sel, n_objects).long()
    scores = torch.zeros(n_objects + 1, dtype=scores_c.dtype,
                         device=dist.device)
    scores[safe] = scores_c
    return scores[:n_objects], scatter_detections(det_c, sel, n_objects)
