"""SegmentedDetector cell: the segmented serving pipeline as a graph cell
(tod_tpu/cells/serving.py).

Makes the serving path (per-(query, object) matching + tier-1 geometric
activation + tier-2 certified RANSAC — see
tod_tpu_torch.models.fused.FusedDetector, kernels B1-B4 and N1 on the card)
reachable from a detection ``.ork``: ``pipeline: segmented``
(conf/detection.serving.ork) switches TodDetector to this cell, so
``python -m tod_tpu_torch.cli detection`` serves it. This cell carries the
same tendril contract as the global-kNN cell graph (pose_results out).
Not ported: the ``visualize`` overlays.
"""

from __future__ import annotations

from typing import List

import numpy as np

import torch

from tod_tpu_torch.cells.features import declare_device
from tod_tpu_torch.cells.guess import no_visualize
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.utils.config import parse_json_params


def _parse_bucket_grid(value):
    """'6x8' / [6, 8] / '' -> (6, 8) or None."""
    if not value:
        return None
    if isinstance(value, str):
        rows, cols = value.lower().split("x")
        return int(rows), int(cols)
    rows, cols = value
    return int(rows), int(cols)


def _clamped_hypotheses(n: int) -> int:
    """Clamp the tier-2 hypothesis batch to the compiled program's
    supported range [128, 4096], warning when the .ork value is changed
    (the GuessGenerator cell pipeline honors the knob verbatim)."""
    clamped = max(128, min(n, 4096))
    if clamped != n:
        import warnings

        warnings.warn(
            f"n_ransac_iterations={n} is outside the segmented pipeline's "
            f"supported hypothesis-batch range [128, 4096]; using {clamped}",
            stacklevel=2)
    return clamped


class SegmentedDetector(Cell):
    """One cell wrapping the staged segmented FusedDetector (features +
    query compaction | per-object matching kernels | two-tier geometry)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("json_feature_params",
                  'Feature params JSON ({"type": "ORB", "n_features": ...}).',
                  default='{"type": "ORB", "n_features": 5000}')
        p.declare("json_descriptor_params",
                  "Accepted for .ork schema compatibility (ORB descriptors "
                  "are implied by the feature type).",
                  default='{"type": "ORB"}')
        p.declare("search_json_params",
                  'JSON: {"radius": Hamming acceptance radius} (the segmented '
                  "matcher is per-object top-1; k/LSH knobs are accepted and "
                  "ignored).", default="{}")
        p.declare("json_db", "The DB parameters as a JSON string.",
                  default="{}")
        p.declare("json_object_ids",
                  'The object ids to load, as a JSON list or "all".',
                  default="all")
        p.declare("q_cap", "Matched-keypoint budget: queries are compacted "
                  "to this many highest-response keypoints with valid 3D.",
                  default=2048)
        p.declare("n_ransac_iterations",
                  "Tier-2 RANSAC hypothesis batch size (clamped to "
                  "[128, 4096] with a warning).", default=768)
        p.declare("min_inliers", "Minimum unique-keypoint inliers to accept "
                  "a pose.", default=8)
        p.declare("sensor_error", "The error (in meters) from the sensor.",
                  default=0.01)
        p.declare("max_instances",
                  "Static cap on instances found per object.", default=3)
        p.declare("max_matches_per_object",
                  "Tier-2 per-object match capacity.", default=384)
        p.declare("max_active_objects",
                  "Objects entering tier-2 (top-N by tier-1 presence score).",
                  default=16)
        p.declare("activation_m_cap",
                  "Tier-1 per-object match capacity.", default=192)
        p.declare("activation_hypotheses",
                  "Tier-1 lean-RANSAC budget per object.", default=192)
        p.declare("activation_min_score",
                  "Tier-1 score below which an object is never activated.",
                  default=4)
        p.declare("activation_prescreen",
                  "Tier-1 pre-screen width P: lean RANSAC scores only the "
                  "top-P objects by the cheap cross-object margin-mass "
                  "statistic, bounding the one linear-in-catalog stage. "
                  "0 = score every object.", default=0)
        p.declare("tight_final_fit",
                  "Refit the final pose on the strict-sigma inlier set.",
                  default=True)
        p.declare("bucket_grid",
                  "Spatially-bucketed query compaction, 'RxC' (e.g. '6x8') "
                  "or [rows, cols]: keeps each grid cell's best corners "
                  "round-robin so corner-rich clutter cannot monopolize "
                  "q_cap. Empty = plain response ranking.", default="")
        p.declare("min_confidence",
                  "Serving-side acceptance gate: drop poses with fewer "
                  "inliers than this after detection (bench curve: >=24 "
                  "reaches ~0.96 precision at <=0.04 recall cost). "
                  "0 = report everything.", default=0)
        p.declare("min_quality",
                  "Serving-side gate on the fused confidence "
                  "(inliers + 16*inlier-clique depth). Measured: >= ~156 "
                  "reaches recall 1.000 / precision 1.000 on the bench "
                  "workload where the inlier gate peaks at 0.958/0.920. "
                  "0 = off.", default=0)
        p.declare("coarse_stride",
                  "Coarse->fine matching (large catalogs): screen objects "
                  "on a stride-subsampled sweep, run the exact segmented "
                  "match on only the top fine_width objects. Match cost "
                  "becomes sub-linear in the catalog. 0 = off (full exact "
                  "sweep).", default=0)
        p.declare("fine_width",
                  "Objects surviving the coarse screen (the exact-match "
                  "set).", default=128)
        p.declare("track_width",
                  "Coarse->fine slab slots reserved for recently-detected "
                  "objects (temporal persistence in a streaming loop): a "
                  "found object stays in the exact fine pass instead of "
                  "re-competing through the coarse statistic every frame. "
                  "0 = off.", default=0)
        p.declare("track_ttl",
                  "Frames a tracked object survives without re-detection "
                  "before its reserved slot is released.", default=2)
        p.declare("track_min_confidence",
                  "Latch gate: only accepted poses with at least this many "
                  "unique inliers refresh the tracked/seed state. Keeps "
                  "the ~8-16-inlier junk accepts of the ungated reference "
                  "contract out of the tracked slab (slot churn / "
                  "activation-cut saturation). 0 = every accepted pose "
                  "latches.", default=16)
        p.declare("activation_reserve",
                  "Tier-2 slots guaranteed to score-qualified non-tracked "
                  "candidates when tracked (force-active) slots exist, so "
                  "a full tracked slab can never displace a fresh "
                  "discovery from tier-2.", default=4)
        p.declare("explore_width",
                  "Coarse->fine slab slots cycling deterministically "
                  "through the whole catalog (bounded-latency discovery): "
                  "any present object reaches the exact fine pass within "
                  "ceil(objects / explore_width) frames even if the coarse "
                  "statistic never ranks it, then track_width latches it. "
                  "0 = off.", default=0)
        p.declare("catalog_capacity",
                  "Pad the catalog to this many object slots at pack time "
                  "so hot catalog updates keep the array shapes "
                  "(FusedDetector.update_models). 0 = pack exactly.",
                  default=0)
        p.declare("reserve_rows",
                  "Per-object-slot row reservation (poisoned padding) for "
                  "shape-stable hot catalog updates. 0 = no reservation.",
                  default=0)
        p.declare("seed", "PRNG seed for hypothesis sampling.", default=0)
        p.declare("visualize", "Pose overlays (not ported: raises if set).",
                  default=False)
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("image", "(H,W,3) u8 or (H,W) gray frame.")
        i.declare("depth", "(H,W) depth (u16 mm or f32 metric).")
        i.declare("K", "(3,3) camera intrinsics.")
        o.declare("pose_results", "List of PoseResult.")
        o.declare("Rs", "Rotations of the poses (for visualization).")
        o.declare("Ts", "Translations of the poses.")
        o.declare("object_ids", "The ids of the loaded objects.")
        o.declare("keypoints", "None (features live inside the fused stages; "
                  "declared for PoseDrawer wiring parity).")

    def configure(self) -> None:
        from tod_tpu_torch.cells.matcher import parse_object_ids
        from tod_tpu_torch.db import (ObjectDbParameters,
                                      load_models_for_objects)
        from tod_tpu_torch.geometry.detection import (ActivationConfig,
                                                      GuessConfig)
        from tod_tpu_torch.geometry.ransac import RansacConfig
        from tod_tpu_torch.models.fused import (FusedDetector,
                                                FusedDetectorConfig)

        no_visualize(self.params["visualize"])
        feat = parse_json_params(self.params["json_feature_params"])
        feat_type = feat.get("type", "ORB")
        if feat_type not in ("ORB", "SIFT"):
            raise ValueError(
                f"unsupported feature type {feat_type!r} for the segmented "
                "serving pipeline (ORB/Hamming or SIFT/L2)")
        search = parse_json_params(self.params["search_json_params"])
        # Hamming radii are integers in [0, 256]; L2 radii on unit-norm SIFT
        # are small floats — keep separate defaults
        default_radius = 50 if feat_type == "ORB" else 0.9

        self._db_params = parse_json_params(self.params["json_db"])
        db = ObjectDbParameters(self.params["json_db"]).generate_db()
        models = load_models_for_objects(
            db, parse_object_ids(self.params["json_object_ids"]))

        cfg = FusedDetectorConfig(
            n_features=int(feat.get("n_features", 5000)),
            n_levels=int(feat.get("n_levels", 3)),
            scale_factor=float(feat.get("scale_factor", 1.2)),
            fast_threshold=float(feat.get("fast_threshold", 20)),
            subpixel=bool(feat.get("subpixel", False)),
            feature=feat_type,
            radius=float(search["radius"] if search.get("radius") is not None
                         else default_radius),
            pipeline="segmented",
            q_cap=int(self.params["q_cap"]),
            bucket_grid=_parse_bucket_grid(self.params["bucket_grid"]),
            min_confidence=float(self.params["min_confidence"]),
            min_quality=float(self.params["min_quality"]),
            coarse_stride=int(self.params["coarse_stride"]),
            fine_width=int(self.params["fine_width"]),
            track_width=int(self.params["track_width"]),
            track_ttl=int(self.params["track_ttl"]),
            track_min_confidence=float(
                self.params["track_min_confidence"]),
            explore_width=int(self.params["explore_width"]),
            catalog_capacity=int(self.params["catalog_capacity"]),
            reserve_rows=int(self.params["reserve_rows"]),
            activation=ActivationConfig(
                m_cap=int(self.params["activation_m_cap"]),
                n_hypotheses=int(self.params["activation_hypotheses"]),
                min_score=int(self.params["activation_min_score"]),
                prescreen=int(self.params["activation_prescreen"]),
                active_reserve=int(self.params["activation_reserve"])),
            guess=GuessConfig(
                ransac=RansacConfig(
                    n_hypotheses=_clamped_hypotheses(
                        int(self.params["n_ransac_iterations"])),
                    min_inliers=int(self.params["min_inliers"]),
                    sensor_error=float(self.params["sensor_error"]),
                    max_instances=int(self.params["max_instances"]),
                    tight_final_fit=bool(self.params["tight_final_fit"])),
                max_matches_per_object=int(
                    self.params["max_matches_per_object"]),
                max_active_objects=int(self.params["max_active_objects"])))
        self._detector = FusedDetector(models, cfg,
                                       seed=int(self.params["seed"]),
                                       device=torch.device(
                                           self.params["device"]))

    def process(self) -> None:
        image = np.asarray(self.inputs["image"])
        depth = np.asarray(self.inputs["depth"])
        K = np.asarray(self.inputs["K"], np.float32)
        results = self._detector.detect(image, depth, K)
        for r in results:
            r.db_params = self._db_params
        self.outputs["pose_results"] = results
        self.outputs["Rs"] = [r.R for r in results]
        self.outputs["Ts"] = [r.T for r in results]
        self.outputs["object_ids"] = list(self._detector.object_ids)
        self.outputs["keypoints"] = None
