"""FusedDetector on the segmented ORB serving path (tod_tpu/models/fused.py).

One frame runs as three stages on one device and stream: ORB features with
query compaction, the per-(query, object) matcher (the CUDA kernel of
``ops/segmented.py`` on the card), and the two-tier segmented geometry. The
host reads the detections back once, as one packed tensor.

Configuration values of other serving paths raise ``NotImplementedError``
naming the ROADMAP item that ports them; none falls back silently.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import (ActivationConfig, GuessConfig,
                                              detect_frame_segmented)
from tod_tpu_torch.geometry.ransac import (GumbelNoise, NoiseFn,
                                           ObjectDetections, RansacConfig)
from tod_tpu_torch.ops.depth import depth_to_3d_sparse, to_metric_depth
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.image import rgb_to_gray
from tod_tpu_torch.ops.orb import orb_detect_and_compute
from tod_tpu_torch.ops.segmented import object_top1, pack_segmented
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


def check_ported(cfg: FusedDetectorConfig) -> None:
    """Raise for configuration values of paths this package has not ported.
    (``k_matches``, ``db_chunk`` and ``matcher`` belong to the global path
    and are carried for config round trips only.)"""
    missing = [
        (cfg.pipeline != "segmented",
         f"pipeline={cfg.pipeline!r}: the global-kNN path is ROADMAP A12"),
        (cfg.feature != "ORB",
         f"feature={cfg.feature!r}: the SIFT/L2 path is ROADMAP A11"),
        (cfg.subpixel, "subpixel keypoints are ROADMAP A16"),
        (cfg.coarse_stride > 0, "coarse->fine matching is ROADMAP A10"),
        (cfg.track_width > 0, "tracked slab slots are ROADMAP A10"),
        (cfg.explore_width > 0, "exploration slots are ROADMAP A10"),
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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stage_features_compact(gray: torch.Tensor, depth: torch.Tensor,
                           K: torch.Tensor, cfg: FusedDetectorConfig):
    """ORB + 3D + query compaction: keep the ``q_cap`` best keypoints with
    valid 3D, padded to a multiple of 512. Returns ``(xy, qp, dsc, ok)``."""
    kps, desc = orb_detect_and_compute(
        gray, n_features=cfg.n_features, n_levels=cfg.n_levels,
        scale_factor=cfg.scale_factor, fast_threshold=cfg.fast_threshold)
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
                             torch.zeros((), dtype=torch.uint8,
                                         device=desc.device)), 0)
    return xy, qp, dsc, padded(ok, False)


class FusedDetector:
    """Load models once, detect many frames, on one explicit device."""

    def __init__(self, models: Sequence[TodModel],
                 config: Optional[FusedDetectorConfig] = None,
                 seed: int = 0, device: torch.device | str = "cpu"):
        self.config = config or FusedDetectorConfig()
        check_ported(self.config)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.noise: NoiseFn = GumbelNoise(self.generator)
        cfg = self.config
        models = list(models)
        if cfg.catalog_capacity > len(models):
            models += [TodModel("", np.zeros((0, 32), np.uint8),
                                np.zeros((0, 3), np.float32))
                       for _ in range(cfg.catalog_capacity - len(models))]
        self.sdb = pack_segmented(models, reserve_rows=cfg.reserve_rows,
                                  device=self.device)
        self.object_ids = [m.object_id for m in models]

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
        dist, rows = object_top1(dsc, self.sdb)
        return detect_frame_segmented(
            self.noise, dist, rows, ok, qp, xy, self.sdb.points,
            self.sdb.obj_start, self.sdb.spans, cfg.guess, cfg.activation,
            cfg.radius)[1]

    def detect_batch_raw(self, grays, depths, Ks):
        raise NotImplementedError(
            "tod_tpu_torch: batched detection is ROADMAP A16")

    def update_models(self, models: Sequence[TodModel]) -> None:
        raise NotImplementedError(
            "tod_tpu_torch: hot catalog updates are ROADMAP A16")

    def detect(self, image, depth, K) -> List[PoseResult]:
        """Poses of one frame, gated by ``min_confidence`` (inliers) and
        ``min_quality`` (:func:`confidence_v2`)."""
        det = self.detect_raw(image, depth, K)
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
