"""FusedDetector on the segmented serving path (tod_tpu/models/fused.py),
with ORB/Hamming or SIFT/L2 features.

One frame runs as three stages on one device and stream: features with query
compaction, the per-(query, object) matcher (the CUDA kernels of
``ops/segmented.py`` for ORB, of ``ops/segmented_l2.py`` for SIFT, on the
card), and the two-tier segmented geometry. The host reads the detections
back once, as one packed tensor.

With ``coarse_stride > 0`` the matcher runs coarse->fine: the full-sweep
kernel (B1, or B3 for SIFT) sweeps a stride-subsampled companion DB,
:func:`stage_coarse_select` picks a slab of ``fine_width`` objects (plus
tracked and exploration slots), the gathered kernel (B2, or B4) matches
exactly against the slab's objects only, and the geometry runs on the
slab. Tracked slots, the exploration cursor and the last accepted poses
(tier-2 seeds) are state carried from frame to frame.

Configuration values of other serving paths raise ``NotImplementedError``
naming the ROADMAP item that ports them; none falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import (
    AGE_NEVER, ActivationConfig, GuessConfig, coarse_select,
    detect_frame_gathered, detect_frame_segmented, fold_best_pose,
    merge_tracked, reserved_force_mask, seeds_from_state, tracked_from_age,
    tracked_needy, update_age)
from tod_tpu_torch.geometry.ransac import (GumbelNoise, NoiseFn,
                                           ObjectDetections, RansacConfig)
from tod_tpu_torch.ops.depth import depth_to_3d_sparse, to_metric_depth
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.image import rgb_to_gray
from tod_tpu_torch.ops.orb import orb_detect_and_compute
from tod_tpu_torch.ops.segmented import (SegmentedDb, object_top1,
                                         object_top1_gathered, pack_segmented,
                                         subsample_models)
from tod_tpu_torch.ops.segmented_l2 import (SegmentedDbF, object_top1_l2,
                                            object_top1_l2_gathered,
                                            pack_segmented_l2,
                                            quantize_descriptors)
from tod_tpu_torch.ops.sift import sift_detect_and_compute
from tod_tpu_torch.types import PoseResult, TodModel


@dataclasses.dataclass(frozen=True)
class FusedDetectorConfig:
    """The reference's operating point, field for field (same names and
    defaults), so a reference config converts one to one
    (``convert.config_from_dict``)."""

    n_features: int = 5000
    n_levels: int = 3
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    feature: str = "ORB"
    subpixel: bool = False
    k_matches: int = 5
    radius: float = 35.0
    db_chunk: int = 16384
    matcher: str = "auto"
    guess: GuessConfig = GuessConfig(
        ransac=RansacConfig(n_hypotheses=1024, min_inliers=8,
                            sensor_error=0.01))
    pipeline: str = "global"
    q_cap: int = 2048
    bucket_grid: Optional[Tuple[int, int]] = None
    activation: ActivationConfig = ActivationConfig()
    coarse_stride: int = 0
    fine_width: int = 128
    coarse_q_stride: int = 1
    track_width: int = 0
    track_ttl: int = 2
    track_min_confidence: float = 16.0
    explore_width: int = 0
    catalog_capacity: int = 0
    reserve_rows: int = 0
    coarse_slack: Optional[float] = None
    min_confidence: float = 0.0
    min_quality: float = 0.0

    @property
    def resolved_coarse_slack(self) -> float:
        """coarse_slack in the feature's distance units (None = default)."""
        if self.coarse_slack is not None:
            return self.coarse_slack
        return 0.15 if self.feature == "SIFT" else 16.0


def check_ported(cfg: FusedDetectorConfig) -> None:
    """Raise for configuration values of paths this package has not ported.
    (``k_matches``, ``db_chunk`` and ``matcher`` belong to the global path
    and are carried for config round trips only.)"""
    missing = [
        (cfg.pipeline != "segmented",
         f"pipeline={cfg.pipeline!r}: the global-kNN path is ROADMAP A12"),
        (cfg.subpixel, "subpixel keypoints are ROADMAP A16"),
    ]
    for bad, why in missing:
        if bad:
            raise NotImplementedError(f"tod_tpu_torch: {why}")


CLIQUE_WEIGHT = 16.0


def confidence_v2(n_inliers: float, clique_size: int) -> float:
    """Fused serving confidence: inlier count + weighted inlier-clique
    depth (the reference's confidence_v2; its residual argument is reported
    on PoseResult, not fused)."""
    return float(n_inliers) + CLIQUE_WEIGHT * float(clique_size)


def _full(value, like: torch.Tensor) -> torch.Tensor:
    # a device scalar: CUDA rounds arithmetic with a host scalar differently
    # for division (reciprocal multiply)
    return torch.full((), value, dtype=torch.float32, device=like.device)


def bucketed_scores(xy: torch.Tensor, response: torch.Tensor,
                    finite: torch.Tensor, hw: Tuple[int, int],
                    grid: Tuple[int, int]) -> torch.Tensor:
    """Spatially-bucketed compaction scores: corners ordered by
    within-cell response rank first (cell round-robin), response second;
    non-finite keypoints get -inf."""
    gh, gw = grid
    h, w = hw
    cy = torch.clamp(torch.div(xy[:, 1] * gh, _full(h, xy),
                               rounding_mode="floor"), 0, gh - 1)
    cx = torch.clamp(torch.div(xy[:, 0] * gw, _full(w, xy),
                               rounding_mode="floor"), 0, gw - 1)
    cell = (cy * gw + cx).to(torch.int32)
    neg_inf = _full(-torch.inf, xy)
    base = torch.where(finite, response, neg_inf)
    # lexsort((-base, cell)): cell ascending, then response descending,
    # then index — two stable sorts, the minor key first
    order = torch.sort(-base, stable=True).indices
    order = order[torch.sort(cell[order], stable=True).indices]
    n = base.shape[0]
    pos = torch.arange(n, device=xy.device)
    sc = cell[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=xy.device),
                          sc[1:] != sc[:-1]])
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.zeros(n, dtype=torch.int64, device=xy.device)
    rank[order] = pos - seg_start
    top = torch.max(torch.where(finite, response, _full(0.0, xy)))
    resp01 = torch.clamp(response / (top + 1e-9), 0.0, 1.0)
    return torch.where(finite, resp01 - rank.to(torch.float32), neg_inf)


def match_full(dsc: torch.Tensor, db):
    """The full sweep on the DB's own kernel: B1 over a ``SegmentedDb``, B3
    over a ``SegmentedDbF``."""
    return (object_top1 if isinstance(db, SegmentedDb)
            else object_top1_l2)(dsc, db)


def match_gathered(dsc: torch.Tensor, db, sel: torch.Tensor):
    """The fine pass on the DB's own kernel: B2 or B4."""
    return (object_top1_gathered if isinstance(db, SegmentedDb)
            else object_top1_l2_gathered)(dsc, db, sel)


def stage_coarse_select(dsc: torch.Tensor, ok: torch.Tensor,
                        cdb: SegmentedDb | SegmentedDbF,
                        cfg: FusedDetectorConfig,
                        tracked: Optional[torch.Tensor] = None,
                        explore: Optional[torch.Tensor] = None):
    """The frame's slab: the coarse screen's top objects (kernel B1, or B3
    for SIFT, on the coarse DB, every ``coarse_q_stride``-th query), then
    the tracked and exploration ids with duplicates holed out. Returns
    ``(sel (C,) int32, force, force_act)``: ``force`` marks slots of
    reserved objects (they bypass the in-slab prescreen), ``force_act``
    those of tracked objects (they also bypass the activation cut); both
    None without reserved slots."""
    if cfg.coarse_q_stride > 1:     # ranking only: the fine pass sees all
        dsc = dsc[::cfg.coarse_q_stride]
        ok = ok[::cfg.coarse_q_stride]
    dist_c, _ = match_full(dsc, cdb)
    width = cfg.fine_width \
        - (cfg.track_width if tracked is not None else 0) \
        - (cfg.explore_width if explore is not None else 0)
    sel = coarse_select(dist_c, ok, cfg.radius, cfg.resolved_coarse_slack,
                        width, cfg.activation.prescreen_top)
    for ids in (tracked, explore):
        if ids is not None:
            sel = merge_tracked(sel, ids)
    force = force_act = None
    if tracked is not None or explore is not None:
        force = reserved_force_mask(sel, tracked, explore)
    if tracked is not None:
        force_act = reserved_force_mask(sel, tracked)
    return sel, force, force_act


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stage_features_compact(gray: torch.Tensor, depth: torch.Tensor,
                           K: torch.Tensor, cfg: FusedDetectorConfig):
    """Features + 3D + query compaction: keep the ``q_cap`` best keypoints
    with valid 3D, padded to a multiple of 512. Returns ``(xy, qp, dsc,
    ok)``; ``dsc`` is (Q, 32) uint8 for ORB, (Q, 128) int8 (quantised) for
    SIFT."""
    extract = dict(n_features=cfg.n_features, n_levels=cfg.n_levels,
                   scale_factor=cfg.scale_factor,
                   fast_threshold=cfg.fast_threshold)
    if cfg.feature == "SIFT":
        kps, desc = sift_detect_and_compute(gray, **extract)
        desc = quantize_descriptors(desc)
    else:
        kps, desc = orb_detect_and_compute(gray, **extract)
    query_pts = depth_to_3d_sparse(to_metric_depth(depth), K, kps.xy)
    finite = torch.isfinite(query_pts).all(-1) & kps.valid
    k = min(cfg.q_cap, cfg.n_features)
    if cfg.bucket_grid is not None:
        score = bucketed_scores(kps.xy, kps.response, finite,
                                tuple(gray.shape), cfg.bucket_grid)
    else:
        score = torch.where(finite, kps.response, _full(-torch.inf, gray))
    sel = stable_topk(score, k)[1]
    ok = finite[sel]
    pad = _round_up(k, 512) - k

    def padded(x, fill):
        if not pad:
            return x
        tail = torch.full((pad,) + x.shape[1:], fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    nan = _full(torch.nan, gray)
    xy = padded(kps.xy[sel], 0)
    qp = padded(torch.where(ok[:, None], query_pts[sel], nan), torch.nan)
    dsc = padded(torch.where(ok[:, None], desc[sel],
                             torch.zeros((), dtype=desc.dtype,
                                         device=desc.device)), 0)
    return xy, qp, dsc, padded(ok, False)


class FusedDetector:
    """Load models once, detect many frames, on one device: the card,
    unless the caller names another."""

    def __init__(self, models: Sequence[TodModel],
                 config: Optional[FusedDetectorConfig] = None,
                 seed: int = 0, device: torch.device | str = "cuda"):
        self.config = cfg = config or FusedDetectorConfig()
        if cfg.feature == "SIFT" and cfg.pipeline != "segmented":
            raise ValueError(
                "FusedDetector serves SIFT/L2 through the segmented "
                "pipeline only (pipeline='segmented')")
        check_ported(cfg)
        if cfg.track_width or cfg.explore_width:
            if cfg.coarse_stride <= 0:
                raise ValueError(
                    "track_width/explore_width reserve coarse->fine slab "
                    "slots; they require coarse_stride > 0 (the full exact "
                    "sweep already scores every object)")
            reserved = cfg.track_width + cfg.explore_width
            if reserved >= cfg.fine_width:
                raise ValueError(
                    f"track_width + explore_width ({reserved}) must leave "
                    f"coarse slots: fine_width is {cfg.fine_width}")
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise: NoiseFn = GumbelNoise(self.generator)
        models = list(models)
        sift = cfg.feature == "SIFT"
        pack = pack_segmented_l2 if sift else pack_segmented
        if cfg.catalog_capacity > len(models):
            empty = (np.zeros((0, 128), np.float32) if sift
                     else np.zeros((0, 32), np.uint8))
            models += [TodModel("", empty, np.zeros((0, 3), np.float32))
                       for _ in range(cfg.catalog_capacity - len(models))]
        self.sdb = pack(models, reserve_rows=cfg.reserve_rows,
                        device=self.device)
        self.object_ids = [m.object_id for m in models]
        # streaming state of coarse->fine serving, per object slot: frames
        # since last accepted, the last accepted pose, the exploration
        # cursor and last frame's coarse slots
        n_slots = max(len(models), 1)
        self._age = torch.full((n_slots,), AGE_NEVER, dtype=torch.int32,
                               device=self.device)
        self._last_R = torch.zeros((n_slots, 3, 3), device=self.device)
        self._last_T = torch.zeros((n_slots, 3), device=self.device)
        self._explore_pos = 0
        self._last_coarse_sel: Optional[torch.Tensor] = None
        self.slab = None   # the last frame's (sel, force, force_act)
        self.cdb: Optional[SegmentedDb | SegmentedDbF] = None
        if cfg.coarse_stride > 0 and models:
            # the coarse DB is chunked to the SUBSAMPLED segment length, as
            # the reference packs it (its layout is the reference's)
            sub = subsample_models(models, cfg.coarse_stride)
            med_rows = int(np.median([max(m.n_points, 1) for m in sub]))
            c_chunk = next((c for c in (512, 1024, 2048, 4096)
                            if c >= med_rows), 4096)
            self.cdb = pack(
                sub, db_chunk=c_chunk,
                reserve_rows=-(-cfg.reserve_rows // cfg.coarse_stride),
                device=self.device)

    def _explore_ids(self) -> torch.Tensor:
        """The next ``explore_width`` catalog indices of the deterministic
        rotation over REAL slots (not ``catalog_capacity`` padding), -1
        padded when the catalog is smaller; each call advances one frame."""
        real = np.asarray([i for i, oid in enumerate(self.object_ids)
                           if oid], np.int32)
        n, e = len(real), self.config.explore_width
        if e >= n:
            ids = np.concatenate([real, np.full(e - n, -1, np.int32)])
        else:
            ids = real[(self._explore_pos + np.arange(e)) % n]
            self._explore_pos = int((self._explore_pos + e) % n)
        return torch.from_numpy(ids).to(self.device)

    def prepare_frame(self, image: np.ndarray, depth: np.ndarray,
                      K: np.ndarray):
        """Upload one frame once: (gray f32, depth, K f32) on the device.
        Integer depth goes up as int32 (millimeters)."""
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        gray = rgb_to_gray(img)
        depth = np.asarray(depth)
        if not np.issubdtype(depth.dtype, np.floating):
            depth = depth.astype(np.int32)
        return (gray, torch.from_numpy(np.ascontiguousarray(depth)).to(
                    self.device),
                torch.from_numpy(np.asarray(K, np.float32)).to(self.device))

    def detect_raw(self, image, depth, K) -> Optional[ObjectDetections]:
        """Device-level API: detections (O, I, ...) as device tensors, or
        None for an empty catalog. Accepts numpy frames or the tensors of
        :meth:`prepare_frame`."""
        if isinstance(image, torch.Tensor) and image.dim() == 2:
            gray, depth_t, K_t = image, depth, K
        else:
            gray, depth_t, K_t = self.prepare_frame(image, depth, K)
        cfg = self.config
        xy, qp, dsc, ok = stage_features_compact(gray, depth_t, K_t, cfg)
        if not self.object_ids:
            return None
        if self.cdb is not None:
            return self._detect_coarse_fine(xy, qp, dsc, ok)
        dist, rows = match_full(dsc, self.sdb)
        return detect_frame_segmented(
            self.noise, dist, rows, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius)[1]

    def _detect_coarse_fine(self, xy, qp, dsc, ok) -> ObjectDetections:
        """One coarse->fine frame (B1 or B3 on the coarse DB, B2 or B4 on
        the slab), advancing the streaming state."""
        cfg = self.config
        track, explore = cfg.track_width > 0, cfg.explore_width > 0
        tracked = None
        if track:
            tracked = (tracked_from_age(self._age, cfg.track_width,
                                        cfg.track_ttl)
                       if self._last_coarse_sel is None else
                       tracked_needy(self._age, self._last_coarse_sel,
                                     cfg.track_width, cfg.track_ttl))
        sel, force, force_act = stage_coarse_select(
            dsc, ok, self.cdb, cfg, tracked,
            self._explore_ids() if explore else None)
        self.slab = (sel, force, force_act)
        seeds = None
        if track:
            # the coarse prefix only, clamped as coarse_select clamps it: an
            # object held by its reserved slot still needs one next frame
            n_coarse = min(cfg.fine_width - cfg.track_width
                           - (cfg.explore_width if explore else 0),
                           len(self.object_ids))
            self._last_coarse_sel = sel[:n_coarse]
            seeds = seeds_from_state(self._age, self._last_R, self._last_T,
                                     cfg.track_ttl)
        dist, rows = match_gathered(dsc, self.sdb, sel)
        det = detect_frame_gathered(
            self.noise, dist, rows, sel, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius, force, cfg.track_width + cfg.explore_width,
            force_act, seeds)[1]
        if track:
            self._age = update_age(self._age, det, cfg.track_min_confidence)
            self._last_R, self._last_T = fold_best_pose(self._last_R,
                                                        self._last_T, det)
        return det

    def detect_batch_raw(self, grays, depths, Ks):
        raise NotImplementedError(
            "tod_tpu_torch: batched detection is ROADMAP A16")

    def update_models(self, models: Sequence[TodModel]) -> None:
        raise NotImplementedError(
            "tod_tpu_torch: hot catalog updates are ROADMAP A16")

    def detect(self, image, depth, K) -> List[PoseResult]:
        """Poses of one frame, gated by ``min_confidence`` (inliers) and
        ``min_quality`` (:func:`confidence_v2`)."""
        return self.poses(self.detect_raw(image, depth, K))

    def poses(self, det: Optional[ObjectDetections]) -> List[PoseResult]:
        """The gated poses of :meth:`detect_raw`'s detections, read back to
        the host once."""
        if det is None:
            return []
        n_obj, n_inst = det.accepted.shape
        packed = torch.cat([
            det.R.reshape(n_obj, n_inst, 9), det.T,
            det.n_inliers[..., None].float(), det.accepted[..., None].float(),
            det.rms_residual[..., None], det.clique_size[..., None].float()],
            dim=-1).cpu().numpy()                   # the one device read
        results: List[PoseResult] = []
        for o, object_id in enumerate(self.object_ids):
            for inst in range(n_inst):
                row = packed[o, inst]
                n_in, accepted = float(row[12]), bool(row[13])
                if not accepted or n_in < self.config.min_confidence:
                    continue
                clique = int(row[15])
                quality = confidence_v2(n_in, clique)
                if quality < self.config.min_quality:
                    continue
                results.append(PoseResult(
                    R=row[:9].reshape(3, 3).copy(), T=row[9:12].copy(),
                    object_id=object_id, confidence=n_in,
                    rms_residual=float(row[14]), clique_size=clique,
                    quality=quality))
        return results
