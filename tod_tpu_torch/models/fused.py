"""FusedDetector (tod_tpu/models/fused.py) on its two serving paths, the
segmented one with ORB/Hamming or SIFT/L2 features and the global-kNN one
with ORB.

``pipeline="segmented"``: one frame runs as three stages on one device and
stream: features with query compaction, the per-(query, object) matcher
(the CUDA kernels of ``ops/segmented.py`` for ORB, of
``ops/segmented_l2.py`` for SIFT, on the card), and the two-tier segmented
geometry. The host reads the detections back once, as one packed tensor.

With ``coarse_stride > 0`` the matcher runs coarse->fine: the full-sweep
kernel (B1, or B3 for SIFT) sweeps a stride-subsampled companion DB,
:func:`stage_coarse_select` picks a slab of ``fine_width`` objects (plus
tracked and exploration slots), the gathered kernel (B2, or B4) matches
exactly against the slab's objects only, and the geometry runs on the
slab. Tracked slots, the exploration cursor and the last accepted poses
(tier-2 seeds) are state carried from frame to frame.

``pipeline="global"`` (the default, the reference's matching contract):
every keypoint's descriptor is matched by an exact radius k-NN over the
whole catalog (kernel B5 of ``ops/hamming.py`` on the card), the objects
with the most matches form the active set, their matches are clustered per
object and the multi-instance RANSAC runs on them.

:meth:`FusedDetector.detect_batch_raw` detects B frames at once on either
path: one matcher launch over the B frames' queries, and the geometry's
tiers once over the B frames' objects (one N1 launch a stage).
:meth:`FusedDetector.update_models` swaps the segmented catalog, in place
when it fits the ``catalog_capacity`` / ``reserve_rows`` reservation.
``subpixel`` refines the ORB keypoints' reported coords (SIFT keeps integer
coords, as in the reference).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import (
    AGE_NEVER, ActivationConfig, GuessConfig, coarse_select,
    detect_frame_from_matches, detect_frame_gathered, detect_frame_segmented,
    detect_frames_from_matches, detect_frames_segmented, fold_best_pose,
    merge_tracked, reserved_force_mask, seeds_from_state, tracked_from_age,
    tracked_needy, update_age)
from tod_tpu_torch.geometry.ransac import (BatchNoise, NoiseFn,
                                           ObjectDetections, RansacConfig,
                                           ThreefryNoise)
from tod_tpu_torch.ops.depth import depth_to_3d_sparse, to_metric_depth
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.hamming import hamming_topk_fused, pack_db_bits
from tod_tpu_torch.ops.image import rgb_to_gray
from tod_tpu_torch.ops.matching import BIG_DIST, pad_db
from tod_tpu_torch.ops.orb import Keypoints, orb_detect_and_compute
from tod_tpu_torch.ops.segmented import (SegmentedDb, object_top1,
                                         object_top1_gathered, pack_segmented,
                                         subsample_models)
from tod_tpu_torch.ops.segmented_l2 import (SegmentedDbF, object_top1_l2,
                                            object_top1_l2_gathered,
                                            pack_segmented_l2,
                                            quantize_descriptors)
from tod_tpu_torch.ops.sift import sift_detect_and_compute
from tod_tpu_torch.types import PoseResult, TodModel
from tod_tpu_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class FusedDetectorConfig:
    """The reference's operating point, field for field (same names and
    defaults), so a reference config converts one to one
    (``convert.config_from_dict``). ``k_matches`` and ``db_chunk`` serve
    the global path (the DB is padded to ``db_chunk`` rows, as the
    reference pads it). ``matcher`` selects nothing here: whatever its
    value, a CUDA tensor runs kernel B5 and a CPU tensor its plain twin."""

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


CLIQUE_WEIGHT = 16.0


def confidence_v2(n_inliers: float, rms_residual: float, clique_size: int,
                  sensor_error: float) -> float:
    """Fused serving confidence: inlier count + weighted inlier-clique
    depth (the reference's confidence_v2, with its arguments). The RMS
    residual and the sensor error are reported on PoseResult, not fused."""
    del rms_residual, sensor_error
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
    SIFT. ``cfg.subpixel`` refines the ORB keypoints only."""
    extract = dict(n_features=cfg.n_features, n_levels=cfg.n_levels,
                   scale_factor=cfg.scale_factor,
                   fast_threshold=cfg.fast_threshold)
    if cfg.feature == "SIFT":
        kps, desc = sift_detect_and_compute(gray, **extract)
        desc = quantize_descriptors(desc)
    else:
        kps, desc = orb_detect_and_compute(gray, subpixel=cfg.subpixel,
                                           **extract)
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


# ---- the global-kNN path (pipeline="global") -------------------------------


@dataclasses.dataclass
class ModelDb:
    """The whole catalog as one flat DB, padded to a multiple of the
    config's ``db_chunk`` as the reference pads it; rows from ``n_valid``
    on are padding that no matcher returns."""

    words: torch.Tensor       # (N_pad, 8) int32 packed descriptor bits
    points: torch.Tensor      # (N_pad, 3) f32 model points (0 on padding)
    obj_of_row: torch.Tensor  # (N_pad,) int32 object of each row, -1 padding
    n_valid: int              # real rows, a host integer (a kernel argument)
    spans: torch.Tensor       # (O,) f32 model AABB diagonals

    @property
    def descriptors(self) -> torch.Tensor:
        """(N_pad, 32) uint8: the reference's ``descriptors`` field."""
        return self.words.view(torch.uint8)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.words, self.points, self.obj_of_row, self.spans))


def model_db_from_arrays(desc_u8: np.ndarray, points: np.ndarray,
                         obj_of_row: np.ndarray, n_valid: int,
                         spans: np.ndarray,
                         device: torch.device | str) -> ModelDb:
    """Upload host arrays in the flat layout (desc (N_pad, 32) u8)."""
    desc = torch.from_numpy(np.array(desc_u8, np.uint8, order="C"))
    return ModelDb(
        words=pack_db_bits(desc).to(device),
        points=torch.from_numpy(np.array(points, np.float32)).to(device),
        obj_of_row=torch.from_numpy(np.array(obj_of_row, np.int32)).to(device),
        n_valid=int(n_valid),
        spans=torch.from_numpy(np.array(spans, np.float32)).to(device))


def pack_models(models: Sequence[TodModel], chunk: int,
                device: torch.device | str = "cuda"
                ) -> Tuple[ModelDb, List[str]]:
    """Concatenate the models' rows into one DB padded to ``chunk`` rows
    (host-side, at load time); an empty catalog gives an empty DB."""
    if models:
        desc = np.concatenate([m.descriptors for m in models])
        pts = np.concatenate([m.points for m in models]).astype(np.float32)
        obj = np.concatenate([np.full(m.n_points, i, np.int32)
                              for i, m in enumerate(models)])
        spans = np.asarray([m.span for m in models], np.float32)
    else:
        desc = np.zeros((0, 32), np.uint8)
        pts = np.zeros((0, 3), np.float32)
        obj = np.zeros(0, np.int32)
        spans = np.zeros(0, np.float32)
    padded, n = pad_db(desc, chunk)
    n_pad = len(padded) - n
    db = model_db_from_arrays(
        padded, np.concatenate([pts, np.zeros((n_pad, 3), np.float32)]),
        np.concatenate([obj, np.full(n_pad, -1, np.int32)]), n, spans,
        device)
    return db, [m.object_id for m in models]


def match_against_db(desc: torch.Tensor, db: ModelDb,
                     cfg: FusedDetectorConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact radius k-NN of every query over the catalog: kernel B5 on
    the card, its twin on the CPU. An empty DB gives all holes
    ``(1e9, -1)``, as the reference's matcher does."""
    if db.words.shape[0] == 0:
        q = desc.shape[0]
        return (torch.full((q, cfg.k_matches), BIG_DIST, dtype=torch.float32,
                           device=desc.device),
                torch.full((q, cfg.k_matches), -1, dtype=torch.int32,
                           device=desc.device))
    return hamming_topk_fused(desc, db.words, db.n_valid, k=cfg.k_matches,
                              radius=cfg.radius)


def stage_features(gray: torch.Tensor, depth: torch.Tensor, K: torch.Tensor,
                   cfg: FusedDetectorConfig
                   ) -> Tuple[Keypoints, torch.Tensor, torch.Tensor]:
    """Features without compaction: all ``n_features`` keypoints, their
    (n_features, 32) uint8 descriptors and 3D query points (NaN where a
    keypoint is invalid or has no depth)."""
    kps, desc = orb_detect_and_compute(
        gray, n_features=cfg.n_features, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor, fast_threshold=cfg.fast_threshold,
        subpixel=cfg.subpixel)
    query_pts = depth_to_3d_sparse(to_metric_depth(depth), K, kps.xy)
    query_pts = torch.where(kps.valid[:, None], query_pts,
                            _full(torch.nan, query_pts))
    return kps, desc, query_pts


@dataclasses.dataclass
class GeomDb:
    """The geometry stage's slice of the model DB."""

    points: torch.Tensor      # (N_pad, 3)
    obj_of_row: torch.Tensor  # (N_pad,)
    spans: torch.Tensor       # (O,)


def geom_db(db: ModelDb) -> GeomDb:
    return GeomDb(points=db.points, obj_of_row=db.obj_of_row, spans=db.spans)


def flat_matches(kps_valid: torch.Tensor, dist: torch.Tensor,
                 rows: torch.Tensor, geom: GeomDb, radius: float):
    """``(obj_idx, valid, train_pts)`` of the matcher's (..., Q, k)
    output: valid where the row is real, within ``radius`` and the keypoint
    valid; ``obj_idx`` -1 elsewhere."""
    valid = (rows >= 0) & (dist <= radius) & kps_valid[..., None]
    safe = rows.clamp_min(0).long()
    obj_idx = torch.where(valid, geom.obj_of_row[safe], -1)
    return obj_idx, valid, geom.points[safe]


def stage_geometry(noise: NoiseFn, kps_xy: torch.Tensor,
                   kps_valid: torch.Tensor, dist: torch.Tensor,
                   rows: torch.Tensor, query_pts: torch.Tensor,
                   geom: GeomDb, cfg: FusedDetectorConfig
                   ) -> ObjectDetections:
    """The active set, per-object clustering and multi-instance RANSAC of
    one frame's flat matches."""
    obj_idx, valid, train_pts = flat_matches(kps_valid, dist, rows, geom,
                                             cfg.radius)
    return detect_frame_from_matches(noise, obj_idx, dist, valid, train_pts,
                                     query_pts, kps_xy, geom.spans,
                                     cfg.guess)[1]


def empty_detections(n_objects: int, cfg: FusedDetectorConfig,
                     device: torch.device | str,
                     lead: Tuple[int, ...] = ()) -> ObjectDetections:
    """All-empty detections, for an empty catalog: (*lead, n_objects, I,
    ...)."""
    n_inst = cfg.guess.ransac.max_instances

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(lead + (n_objects, n_inst) + shape, dtype=dtype,
                           device=device)

    return ObjectDetections(
        R=zeros(3, 3), T=zeros(3), n_inliers=zeros(dtype=torch.int64),
        accepted=zeros(dtype=torch.bool), rms_residual=zeros(),
        clique_size=zeros(dtype=torch.int64))


def load_db(old, new, device: torch.device):
    """``new`` (a DB packed on the host) on ``device``: written into
    ``old``'s tensors when ``old`` is a DB of the same kind whose every
    tensor has the shape and dtype of ``new``'s (their storage does not
    move), else uploaded into new tensors."""
    names = [f.name for f in dataclasses.fields(new)
             if isinstance(getattr(new, f.name), torch.Tensor)]
    fits = type(old) is type(new) and all(
        getattr(old, n).shape == getattr(new, n).shape
        and getattr(old, n).dtype == getattr(new, n).dtype for n in names)
    if fits:
        for n in names:
            getattr(old, n).copy_(getattr(new, n))
        return dataclasses.replace(new, **{n: getattr(old, n) for n in names})
    return dataclasses.replace(new, **{n: getattr(new, n).to(device)
                                       for n in names})


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
        # the reference's key; each frame splits off its own (detect_raw)
        self._key = prng.prng_key(seed)
        # a test's noise in place of the frame key's draws (None: the key's)
        self.noise: Optional[NoiseFn] = None
        self.segmented = cfg.pipeline == "segmented"
        if not self.segmented:
            self.db, self.object_ids = pack_models(list(models),
                                                   cfg.db_chunk,
                                                   device=self.device)
            return
        self.sdb: Optional[SegmentedDb | SegmentedDbF] = None
        self.cdb: Optional[SegmentedDb | SegmentedDbF] = None
        self._pack_catalog(models)

    def _pack_catalog(self, models: Sequence[TodModel]) -> None:
        """Pack (or re-pack) the segmented DB and, with ``coarse_stride >
        0``, its stride-subsampled companion, padded to
        ``catalog_capacity`` slots with empty ones and each object's segment
        to at least ``reserve_rows`` rows; then reset the streaming state
        (slot indices may mean other objects now). Each DB is packed on the
        host and uploaded into the tensors of the DB it replaces when every
        tensor keeps its shape and dtype (a catalog that fits the
        reservation: one upload, the storage stays where it was), else into
        new ones."""
        cfg = self.config
        models = list(models)
        sift = cfg.feature == "SIFT"
        pack = pack_segmented_l2 if sift else pack_segmented
        if cfg.catalog_capacity > len(models):
            empty = (np.zeros((0, 128), np.float32) if sift
                     else np.zeros((0, 32), np.uint8))
            models += [TodModel("", empty, np.zeros((0, 3), np.float32))
                       for _ in range(cfg.catalog_capacity - len(models))]
        self.sdb = load_db(self.sdb, pack(models,
                                          reserve_rows=cfg.reserve_rows,
                                          device="cpu"), self.device)
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
        if cfg.coarse_stride > 0 and models:
            # the coarse DB is chunked to the SUBSAMPLED segment length, as
            # the reference packs it (its layout is the reference's)
            sub = subsample_models(models, cfg.coarse_stride)
            med_rows = int(np.median([max(m.n_points, 1) for m in sub]))
            c_chunk = next((c for c in (512, 1024, 2048, 4096)
                            if c >= med_rows), 4096)
            self.cdb = load_db(self.cdb, pack(
                sub, db_chunk=c_chunk,
                reserve_rows=-(-cfg.reserve_rows // cfg.coarse_stride),
                device="cpu"), self.device)
        else:
            self.cdb = None

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

    def detect_raw(self, image, depth, K):
        """Device-level API; accepts numpy frames or the tensors of
        :meth:`prepare_frame`. Returns ``(keypoints, detections)`` as the
        reference does: the keypoints are None on the segmented paths, and
        an empty catalog gives empty detections."""
        if isinstance(image, torch.Tensor) and image.dim() == 2:
            gray, depth_t, K_t = image, depth, K
        else:
            gray, depth_t, K_t = self.prepare_frame(image, depth, K)
        cfg = self.config
        # every frame splits the key, an empty catalog's too, as the
        # reference does
        self._key, sub = prng.split(self._key)
        noise = self.noise if self.noise is not None else ThreefryNoise(
            sub, cfg.guess.ransac.max_instances, self.segmented, self.device)
        if not self.segmented:
            kps, desc, query_pts = stage_features(gray, depth_t, K_t, cfg)
            if not self.object_ids:
                return kps, empty_detections(0, cfg, self.device)
            dist, rows = match_against_db(desc, self.db, cfg)
            return kps, stage_geometry(noise, kps.xy, kps.valid, dist,
                                       rows, query_pts, geom_db(self.db), cfg)
        xy, qp, dsc, ok = stage_features_compact(gray, depth_t, K_t, cfg)
        if not self.object_ids:
            return None, empty_detections(0, cfg, self.device)
        if self.cdb is not None:
            return None, self._detect_coarse_fine(noise, xy, qp, dsc, ok)
        dist, rows = match_full(dsc, self.sdb)
        return None, detect_frame_segmented(
            noise, dist, rows, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius)[1]

    def _detect_coarse_fine(self, noise: NoiseFn, xy, qp, dsc, ok
                            ) -> ObjectDetections:
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
            noise, dist, rows, sel, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius, force, cfg.track_width + cfg.explore_width,
            force_act, seeds)[1]
        if track:
            self._age = update_age(self._age, det, cfg.track_min_confidence)
            self._last_R, self._last_T = fold_best_pose(self._last_R,
                                                        self._last_T, det)
        return det

    def detect_batch_raw(self, grays: torch.Tensor, depths: torch.Tensor,
                         Ks: torch.Tensor):
        """B frames at once: (B, H, W) gray frames and depths and (B, 3, 3)
        K on the device (stacked :meth:`prepare_frame` tensors) in,
        ``(keypoints, detections (B, O, I, ...))`` out as the reference
        returns them: the keypoints (fields (B, n_features, ...)) on the
        global path, None on the segmented ones. The key splits once a
        batch, ``keys = split(sub, B)``, and frame b draws its noise from
        ``keys[b]`` down the per-frame key path. Features run frame by
        frame; the matcher runs once over the B frames' queries (one B1,
        B3 or B5 launch) and each geometry stage once over their objects
        (one N1 launch). The segmented paths run the full exact sweep even
        with ``coarse_stride > 0`` and leave the streaming state as it
        is."""
        if self.noise is not None:
            raise ValueError("detect_batch_raw draws its noise from the "
                             "detector's key; unset detector.noise")
        cfg = self.config
        n_b = grays.shape[0]
        self._key, sub = prng.split(self._key)
        noise = BatchNoise([
            ThreefryNoise(k, cfg.guess.ransac.max_instances, self.segmented,
                          self.device) for k in prng.split(sub, n_b)])
        if not self.segmented:
            feats = [stage_features(*frame, cfg)
                     for frame in zip(grays, depths, Ks)]
            kps = Keypoints(*(torch.stack(f) for f in
                              zip(*(kp for kp, _, _ in feats))))
            desc = torch.stack([d for _, d, _ in feats])
            query_pts = torch.stack([q for _, _, q in feats])
            if not self.object_ids:
                return kps, empty_detections(0, cfg, self.device, (n_b,))
            dist, rows = (t.unflatten(0, (n_b, -1)) for t in
                          match_against_db(desc.flatten(0, 1), self.db, cfg))
            geom = geom_db(self.db)
            obj_idx, valid, train_pts = flat_matches(kps.valid, dist, rows,
                                                     geom, cfg.radius)
            return kps, detect_frames_from_matches(
                noise, obj_idx, dist, valid, train_pts, query_pts, kps.xy,
                geom.spans, cfg.guess)[1]
        xy, qp, dsc, ok = (torch.stack(t) for t in zip(*(
            stage_features_compact(*frame, cfg)
            for frame in zip(grays, depths, Ks))))
        if not self.object_ids:
            return None, empty_detections(0, cfg, self.device, (n_b,))
        dist, rows = (t.unflatten(0, (n_b, -1))
                      for t in match_full(dsc.flatten(0, 1), self.sdb))
        return None, detect_frames_segmented(
            noise, dist, rows, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius)[1]

    def update_models(self, models: Sequence[TodModel]) -> None:
        """Hot catalog update of the segmented pipeline: re-pack and swap
        the DB (and the coarse DB) and reset the streaming state. When the
        detector was built with ``catalog_capacity`` / ``reserve_rows`` and
        the new catalog fits (same slot count, every object within the
        reservation), the DB's tensors keep their shapes and storage and
        the swap is one upload; a catalog that outgrows its reservation
        gets new tensors."""
        if not self.segmented:
            raise ValueError("update_models is a segmented-pipeline API; "
                             "rebuild the FusedDetector for the global-kNN "
                             "path")
        self._pack_catalog(models)

    def detect(self, image, depth, K) -> List[PoseResult]:
        """Poses of one frame, gated by ``min_confidence`` (inliers) and
        ``min_quality`` (:func:`confidence_v2`)."""
        return self.poses(self.detect_raw(image, depth, K)[1])

    def poses(self, det: ObjectDetections) -> List[PoseResult]:
        """The gated poses of :meth:`detect_raw`'s detections, read back to
        the host once."""
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
                quality = confidence_v2(n_in, float(row[14]), clique,
                                        self.config.guess.sensor_error)
                if quality < self.config.min_quality:
                    continue
                results.append(PoseResult(
                    R=row[:9].reshape(3, 3).copy(), T=row[9:12].copy(),
                    object_id=object_id, confidence=n_in,
                    rms_residual=float(row[14]), clique_size=clique,
                    quality=quality))
        return results
