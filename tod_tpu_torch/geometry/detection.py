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
    # a hole slot's rows (HOLE_ROW) are never gathered: the reference clamps
    # the index and masks the value, the port masks the index
    g_row = torch.where(got, obj_start[o_safe].long()[:, None]
                        + rows[kp, o_safe[:, None]], 0)
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
                   act: ActivationConfig,
                   force_active: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Top ``n_active`` object indices by tier-1 score (ties: lower index),
    -1 below ``min_score``. ``force_active`` (bool (O,)) objects are boosted
    above every unforced score (keeping their own as the tie-break), and so
    are the top ``act.active_reserve`` score-qualified unforced ones, so a
    full tracked slab never displaces a fresh find from tier 2."""
    cut = scores
    if force_active is not None:
        boost = force_active
        r = min(act.active_reserve, n_active)
        if r > 0:
            neg_inf = torch.full((), -torch.inf, device=scores.device)
            nf = torch.where(force_active, neg_inf, scores.float())
            picked = torch.zeros_like(force_active)
            picked[stable_topk(nf, r)[1]] = True
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
    dist`` with the stride one above the largest valid distance, ties to the
    lower flat index. The reference vmaps one object's top-k; here the
    objects are a batch dimension."""
    q, k = obj_idx.shape
    qk = q * k
    dev = dist.device
    obj_flat = obj_idx.reshape(qk)
    dist_flat = dist.reshape(qk)
    rank_flat = torch.arange(k, dtype=torch.float32, device=dev).repeat(q)
    q_finite = torch.isfinite(query_pts).all(-1)
    valid_flat = valid.reshape(qk) & q_finite.repeat_interleave(k)
    t_flat = train_pts.reshape(qk, 3)
    kp_of_flat = torch.arange(q, device=dev).repeat_interleave(k)
    zero = torch.zeros((), device=dev)
    stride = torch.where(valid_flat, dist_flat, zero).max() + 1.0
    priority = rank_flat * stride + dist_flat
    cap = min(max_matches, qk)
    pad = max_matches - cap
    ids = object_ids.to(obj_flat.dtype)
    mask = valid_flat[None, :] & (obj_flat[None, :] == ids[:, None]) \
        & (ids >= 0)[:, None]                                     # (A, QK)
    neg_inf = torch.full((), -torch.inf, device=dev)
    top, sel = stable_topk(torch.where(mask, -priority[None, :], neg_inf), cap)
    ok = torch.isfinite(top)
    kp = kp_of_flat[sel]
    out = ObjectMatches(
        query_pts=torch.where(ok[..., None], query_pts[kp], zero),
        train_pts=torch.where(ok[..., None], t_flat[sel], zero),
        query_idx=torch.where(ok, kp, -1),
        query_xy=torch.where(ok[..., None], query_xy[kp], zero),
        valid=ok)
    if pad:   # fewer flat matches than the capacity: pad the stores up to it
        def grow(x, fill):
            tail = torch.full((x.shape[0], pad) + x.shape[2:], fill,
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], 1)

        out = ObjectMatches(grow(out.query_pts, 0), grow(out.train_pts, 0),
                            grow(out.query_idx, -1), grow(out.query_xy, 0),
                            grow(out.valid, False))
    return out


def active_objects(obj_idx: torch.Tensor, valid: torch.Tensor,
                   query_pts: torch.Tensor, n_objects: int,
                   n_active: int) -> torch.Tensor:
    """The ``n_active`` objects (int32) with the most valid matches of
    finite query points, ties to the lower index; -1 where an object has
    none. Every object, in order, when ``n_active`` covers the catalog."""
    dev = obj_idx.device
    if n_active >= n_objects:
        return torch.arange(n_objects, dtype=torch.int32, device=dev)
    v = valid & torch.isfinite(query_pts).all(-1)[:, None]
    counts = torch.zeros(n_objects, dtype=torch.int32, device=dev)
    counts.index_add_(0, obj_idx.clamp_min(0).reshape(-1).long(),
                      v.reshape(-1).to(torch.int32))
    top, active = stable_topk(counts, n_active)
    return torch.where(top > 0, active, -1).to(torch.int32)


def detect_frame_from_matches(
        noise: NoiseFn, obj_idx: torch.Tensor, dist: torch.Tensor,
        valid: torch.Tensor, train_pts: torch.Tensor, query_pts: torch.Tensor,
        query_xy: torch.Tensor, spans: torch.Tensor,
        cfg: GuessConfig) -> Tuple[ObjectMatches, ObjectDetections]:
    """Cluster + detect (GuessGenerator::process): the active set
    (:func:`active_objects`), its stores (:func:`cluster_matches`) and the
    multi-instance RANSAC on them. Detections have leading dim O; objects
    outside the active set carry accepted=False rows."""
    n_objects = spans.shape[0]
    n_active = min(cfg.max_active_objects, n_objects)
    active = active_objects(obj_idx, valid, query_pts, n_objects, n_active)
    clustered = cluster_matches(obj_idx, dist, valid, train_pts, query_pts,
                                query_xy, active, cfg.max_matches_per_object)
    det = detect_objects(noise, clustered, spans[active.clamp_min(0).long()],
                         cfg)
    if n_active == n_objects:
        return clustered, det
    return clustered, scatter_detections(det, active, n_objects)


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
    """Tier-1 presence scoring on the pre-screened objects + tier-2
    certified multi-instance RANSAC on the activated set. Returns
    ``(scores (O,), ObjectDetections (O, I, ...))``.

    ``force`` (bool (O,)): objects that bypass the prescreen ranking (the
    reserved coarse->fine slots); ``n_forced`` widens the tier-1 set by the
    reserved-slot count so they never displace ranked objects.
    ``force_active`` (bool (O,), tracked slots only) also bypasses the
    activation cut (:func:`activation_cut`). ``seeds`` (SeedPose on this
    object axis) enter each activated object's tier-2 rounds."""
    n_objects = spans.shape[0]
    dev = dist.device
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
                            act, force_active)
    stores = build_object_stores(dist, rows, q_valid, query_pts, query_xy,
                                 points, obj_start, active,
                                 cfg.max_matches_per_object, radius, level)
    a_safe = active.clamp_min(0)
    act_seeds = None
    if seeds is not None:
        act_seeds = SeedPose(R=seeds.R[a_safe], T=seeds.T[a_safe],
                             ok=seeds.ok[a_safe] & (active >= 0))
    det = detect_objects(noise, stores, spans[a_safe], cfg, act_seeds)
    det = det._replace(accepted=det.accepted & (active >= 0)[:, None])
    return scores, scatter_detections(det, active, n_objects)


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
