"""GuessGenerator cell: matches -> 6-DoF object pose guesses
(tod_tpu/cells/guess.py).

The reference's src/detection/GuessGenerator.cpp: cluster matches per
object, build geometric-consistency graphs, repeatedly run graph-constrained
RANSAC with inlier invalidation, and emit PoseResults + Rs/Ts. The math is
``geometry/detection.py detect_frame_from_matches`` on the cell's device;
its noise is the reference's: ``PRNGKey(seed)`` split once a frame
(``key, sub = split(key)``), ``sub`` drawn by ``ThreefryNoise`` (kernel N1
on the card), so the same seed gives the same hypotheses.

A depthless frame (empty cloud) with ``K`` wired takes the 2D-only path,
the reference's ``_process_2d``: ``geometry/detection2d.py
detect_frame_2d`` over every catalog object, its noise from the same key
path (one N1 launch a round on the card). With ``visualize`` (true, or a
PNG path prefix) a depth frame's keypoints are drawn in their object
clusters' colours and written as ``<prefix>_clusters_<n>.png`` on the host,
as the reference writes them (no channel flip).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import List

import numpy as np
import torch

from tod_tpu_torch.cells.features import declare_device, to_host, upload
from tod_tpu_torch.cells.types import MatchSet, PoseResult
from tod_tpu_torch.cells.viz import viz_prefix
from tod_tpu_torch.geometry.detection import (GuessConfig,
                                              detect_frame_from_matches)
from tod_tpu_torch.geometry.detection2d import Pnp2dConfig, detect_frame_2d
from tod_tpu_torch.geometry.ransac import RansacConfig, ThreefryNoise
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.utils import prng
from tod_tpu_torch.utils.config import parse_json_params
from tod_tpu_torch.utils.png import write_png
from tod_tpu_torch.utils.visualize import draw_clusters


class GuessGenerator(Cell):
    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("min_inliers", "Minimum number of inliers", default=15)
        p.declare("n_ransac_iterations", "Number of RANSAC iterations "
                  "(hypothesis batch size here).", default=1000)
        p.declare("sensor_error", "The error (in meters) from the sensor",
                  default=0.01)
        p.declare("visualize", "Debug overlays: false, true (PNGs under "
                  "/tmp/tod_tpu_viz) or a PNG path prefix.", default=False)
        p.declare("db", "The DB parameters as a JSON string", default="{}")
        p.declare("max_instances",
                  "Static cap on instances found per object", default=5)
        p.declare("max_matches_per_object",
                  "Static per-object match capacity", default=1024)
        p.declare("max_active_objects",
                  "Pose search runs only on the top-N objects by "
                  "within-radius match count (bounds geometry cost as the "
                  "DB grows; the reference iterates every matched object, "
                  "GuessGenerator.cpp:170). A warning is logged when this "
                  "cap drops matched objects.", default=16)
        p.declare("object_batch",
                  "The reference's per-step object batch (accepted; the "
                  "port runs the active objects as one batch).", default=8)
        p.declare("seed", "PRNG seed for hypothesis sampling", default=0)
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("image", "The original image (visualization only).")
        i.declare("K", "3x3 camera matrix — enables the 2D-only P3P path "
                  "when the point cloud is empty.", default=None)
        i.declare("points3d", "(H,W,3) camera-frame point cloud.")
        i.declare("keypoints", "The query keypoints structure.")
        i.declare("matches", "MatchSet from the DescriptorMatcher.")
        i.declare("matches_3d", "(Q,k,3) matched training points.")
        i.declare("spans", "{object_id: span}.")
        i.declare("object_ids", "Model index -> object id list.")
        o.declare("pose_results", "List of PoseResult.")
        o.declare("Rs", "Rotations of the poses (for visualization).")
        o.declare("Ts", "Translations of the poses.")

    def configure(self) -> None:
        self._db_params = parse_json_params(self.params["db"])
        # the reference's hypothesis batch: the iteration count clamped to
        # [128, 4096]
        n_hyp = max(128, min(int(self.params["n_ransac_iterations"]), 4096))
        self._cfg = GuessConfig(
            ransac=RansacConfig(
                n_hypotheses=n_hyp,
                min_inliers=int(self.params["min_inliers"]),
                sensor_error=float(self.params["sensor_error"]),
                max_instances=int(self.params["max_instances"])),
            max_matches_per_object=int(self.params["max_matches_per_object"]),
            max_active_objects=int(self.params["max_active_objects"]),
            object_batch=int(self.params["object_batch"]))
        self._key = prng.prng_key(int(self.params["seed"]))
        self._device = torch.device(self.params["device"])
        # a utils.profiling.StageTimer a caller may set: the 2D-only path
        # then splits its frame into stages (detect_frame_2d's, read-back)
        self.timer = None
        self._viz_counter = 0

    def _emit(self, results: List[PoseResult]) -> None:
        self.outputs["pose_results"] = results
        self.outputs["Rs"] = [r.R for r in results]
        self.outputs["Ts"] = [r.T for r in results]

    def process(self) -> None:
        kps = self.inputs["keypoints"]
        matches: MatchSet = self.inputs["matches"]
        matches_3d = np.asarray(self.inputs["matches_3d"])
        cloud = np.asarray(self.inputs["points3d"])
        object_ids: List[str] = list(self.inputs["object_ids"])
        spans_map = dict(self.inputs["spans"])

        if not object_ids or matches.dist.size == 0:
            self._emit([])
            return
        if cloud.size == 0:
            # the 2D-only path (the reference's _process_2d)
            if self.inputs["K"] is None:
                self._emit([])
                return
            self._process_2d(np.asarray(self.inputs["K"], np.float32))
            return

        kp_xy = np.asarray(kps.xy, np.float32)
        kp_valid = np.asarray(kps.valid)
        h, w = cloud.shape[:2]
        xi = np.clip(kp_xy[:, 0].astype(np.int32), 0, w - 1)
        yi = np.clip(kp_xy[:, 1].astype(np.int32), 0, h - 1)
        query_pts = cloud[yi, xi].astype(np.float32)
        query_pts[~kp_valid] = np.nan

        spans = np.asarray([spans_map[o] for o in object_ids], np.float32)

        n_matched = len(np.unique(
            matches.obj_idx[matches.valid & (matches.obj_idx >= 0)]))
        if n_matched > self._cfg.max_active_objects:
            warnings.warn(
                f"{n_matched} objects have matches but max_active_objects="
                f"{self._cfg.max_active_objects}: pose search drops the "
                f"{n_matched - self._cfg.max_active_objects} least-matched "
                "objects (raise the max_active_objects param to search all)")

        self._key, sub = prng.split(self._key)
        dev = self._device
        noise = ThreefryNoise(sub, self._cfg.ransac.max_instances, False, dev)
        _, det = detect_frame_from_matches(
            noise, upload(matches.obj_idx, dev, torch.int32),
            upload(matches.dist, dev, torch.float32),
            upload(matches.valid, dev), upload(matches_3d, dev, torch.float32),
            upload(query_pts, dev), upload(kp_xy, dev), upload(spans, dev),
            self._cfg)
        self._emit(self._results(object_ids, *to_host(
            det.R, det.T, det.n_inliers, det.accepted)))
        if self.params["visualize"]:
            self._write_clusters(matches, kp_xy, kp_valid)

    def _write_clusters(self, matches: MatchSet, kp_xy: np.ndarray,
                        kp_valid: np.ndarray) -> None:
        """The headless form of the reference's cluster windows
        (GuessGenerator.cpp:163-167, 211-221): each matched keypoint in
        the colour of its highest matched object index."""
        image = np.asarray(self.inputs["image"])
        flat_valid = matches.valid.any(axis=1) & kp_valid
        cluster = np.where(matches.valid, matches.obj_idx, -1).max(axis=1)
        overlay = draw_clusters(image, kp_xy[flat_valid], cluster[flat_valid])
        self._viz_counter += 1
        write_png(f"{viz_prefix(self.params['visualize'])}_clusters_"
                  f"{self._viz_counter:04d}.png", overlay)

    def _process_2d(self, K: np.ndarray) -> None:
        """2D-only pose search for a depthless frame: P3P graph-RANSAC
        scored by reprojection consensus (``geometry/detection2d.py``) over
        every catalog object, at the reference's Pnp2dConfig (the
        hypothesis batch capped at 512)."""
        kps = self.inputs["keypoints"]
        matches: MatchSet = self.inputs["matches"]
        matches_3d = np.asarray(self.inputs["matches_3d"])
        object_ids: List[str] = list(self.inputs["object_ids"])
        kp_xy = np.asarray(kps.xy, np.float32)
        valid = matches.valid & np.asarray(kps.valid)[:, None]

        rcfg = self._cfg.ransac
        cfg2d = Pnp2dConfig(n_hypotheses=min(rcfg.n_hypotheses, 512),
                            min_inliers=rcfg.min_inliers,
                            max_instances=rcfg.max_instances)
        self._key, sub = prng.split(self._key)
        dev = self._device
        det = detect_frame_2d(
            ThreefryNoise(sub, cfg2d.max_instances, False, dev),
            upload(matches.obj_idx, dev, torch.int32),
            upload(matches.dist, dev, torch.float32), upload(valid, dev),
            upload(matches_3d, dev, torch.float32), upload(kp_xy, dev),
            upload(K, dev), torch.arange(len(object_ids), device=dev),
            self._cfg.max_matches_per_object, cfg2d, timer=self.timer)
        with (self.timer.stage("read-back") if self.timer
              else contextlib.nullcontext()):
            host = to_host(det.R, det.T, det.n_inliers, det.accepted)
        self._emit(self._results(object_ids, *host))

    def _results(self, object_ids: List[str], det_r, det_t, det_n,
                 det_acc) -> List[PoseResult]:
        """Every accepted (object, instance) as a PoseResult, confidence the
        unique-inlier count, objects in catalog order."""
        return [PoseResult(R=det_r[o, inst], T=det_t[o, inst],
                           object_id=object_id,
                           confidence=float(det_n[o, inst]),
                           db_params=self._db_params)
                for o, object_id in enumerate(object_ids)
                for inst in range(det_acc.shape[1]) if det_acc[o, inst]]
