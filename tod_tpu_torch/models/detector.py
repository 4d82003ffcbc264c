"""TodDetector: the detection pipeline BlackBox (tod_tpu/models/detector.py).

API-parity rebuild of python/object_recognition_tod/detector.py:15-110 —
same cells, same forwards, same direct params, same dataflow wiring — on the
port's pipeline runtime, every computing cell on the ``device`` param (the
card unless the caller names another). ``pipeline: cells`` (the default) is
the reference's global-kNN graph (FeatureDescriptor -> DescriptorMatcher on
kernel B5 -> GuessGenerator, noise on N1); ``pipeline: segmented`` is the
serving cell (cells/serving.py, FusedDetector). ``visualize`` (true, or
a PNG path prefix) adds the reference's PoseDrawer subgraph on both
pipelines (``cells/viz.py``): a PNG a frame of the keypoints and the
detected poses, drawn and written on the host.
"""

from __future__ import annotations

from tod_tpu_torch.cells.features import (
    DepthTo3d,
    FeatureDescriptor,
    RescaledRegisteredDepth,
)
from tod_tpu_torch.cells.guess import GuessGenerator
from tod_tpu_torch.cells.io import PassthroughN
from tod_tpu_torch.cells.matcher import DescriptorMatcher
from tod_tpu_torch.cells.viz import PoseDrawer, viz_prefix
from tod_tpu_torch.pipeline.blackbox import BlackBox
from tod_tpu_torch.pipeline.cell import CellInfo, Forward
from tod_tpu_torch.pipeline.tendril import Tendrils


class TodDetector(BlackBox):
    @classmethod
    def declare_cells(cls, p: Tendrils):
        device = {"device": p["device"]}
        cells = {
            "depth_map": CellInfo(RescaledRegisteredDepth, device),
            "passthrough": CellInfo(
                PassthroughN,
                {"items": {"image": "An image",
                           "K_image": "The camera matrix"}}),
        }
        if p["pipeline"] == "segmented":
            # the serving pipeline behind the same .ork surface: per-object
            # matching + two-tier geometry in one cell (cells/serving.py;
            # selected by `pipeline: segmented` in the detection .ork,
            # conf/detection.serving.ork)
            from tod_tpu_torch.cells.serving import SegmentedDetector

            cells["serving"] = CellInfo(SegmentedDetector, {
                "search_json_params": p["search"],
                "json_db": p["json_db"],
                "json_object_ids": p["json_object_ids"],
                "visualize": p["visualize"], **device})
        else:
            guess_params = {"visualize": p["visualize"], "db": p["json_db"],
                            **device}
            cells["feature_descriptor"] = CellInfo(FeatureDescriptor, device)
            cells["guess_generator"] = CellInfo(GuessGenerator, guess_params)
        if p["visualize"]:
            # the reference's DrawKeypoints + imshow + PosesDrawer subgraph
            # (detector.py:84-108), headless: a PNG sink a frame
            cells["pose_drawer"] = CellInfo(
                PoseDrawer, {"prefix": viz_prefix(p["visualize"])})
        return cells

    @classmethod
    def declare_forwards(cls, _p):
        if _p["pipeline"] == "segmented":
            p = {"serving": [Forward("json_feature_params"),
                             Forward("json_descriptor_params"),
                             Forward("n_ransac_iterations"),
                             Forward("min_inliers"),
                             Forward("sensor_error"),
                             Forward("max_instances"),
                             Forward("max_matches_per_object"),
                             Forward("max_active_objects"),
                             Forward("q_cap"),
                             Forward("activation_m_cap"),
                             Forward("activation_hypotheses"),
                             Forward("activation_min_score"),
                             Forward("activation_prescreen"),
                             Forward("tight_final_fit"),
                             Forward("bucket_grid"),
                             Forward("min_confidence"),
                             Forward("min_quality"),
                             Forward("coarse_stride"),
                             Forward("fine_width"),
                             Forward("track_width"),
                             Forward("track_ttl"),
                             Forward("track_min_confidence"),
                             Forward("activation_reserve"),
                             Forward("explore_width"),
                             Forward("catalog_capacity"),
                             Forward("reserve_rows"),
                             Forward("seed")]}
            i = {"passthrough": [Forward("image"), Forward("K_image")],
                 "depth_map": [Forward("depth_in", "depth")]}
            o = {"serving": [Forward("pose_results")]}
            return p, i, o
        p = {"feature_descriptor": [Forward("json_feature_params"),
                                    Forward("json_descriptor_params")],
             "guess_generator": [Forward("n_ransac_iterations"),
                                 Forward("min_inliers"),
                                 Forward("sensor_error"),
                                 Forward("max_active_objects"),
                                 Forward("object_batch")]}
        i = {"passthrough": [Forward("image"), Forward("K_image")],
             "feature_descriptor": [Forward("mask")],
             "depth_map": [Forward("depth_in", "depth")]}
        o = {"feature_descriptor": [Forward("keypoints")],
             "guess_generator": [Forward("pose_results")]}
        return p, i, o

    @classmethod
    def declare_direct_params(cls, p: Tendrils):
        p.declare("json_db", "The DB to get data from as a JSON string",
                  default="{}")
        p.declare("search", "The search parameters as a JSON string",
                  default="{}")
        p.declare("json_object_ids", "The ids of the objects to find as a "
                  'JSON list or the keyword "all".', default="all")
        p.declare("pipeline", 'Serving architecture: "cells" (the '
                  "reference's global-kNN cell graph) or \"segmented\" (the "
                  "per-object serving pipeline, cells/serving.py). "
                  "Reference .ork files have no such knob and default to "
                  "the cell graph.", default="cells")
        p.declare("visualize", "Debug overlays: false (off), true (PNGs "
                  "under /tmp/tod_tpu_viz), or a string path prefix; where "
                  "the reference pops highgui windows (detector.py:84-108), "
                  "overlays are written as PNG files.", default=False)
        p.declare("device", 'The torch device every computing cell runs '
                  'on ("cuda", "cuda:1", "cpu").', default="cuda")

    def configure_blackbox(self, p, _i, _o):
        if p["pipeline"] == "segmented":
            return
        self.descriptor_matcher = DescriptorMatcher(
            "Matcher",
            search_json_params=p["search"],
            json_db=p["json_db"],
            json_object_ids=p["json_object_ids"],
            device=p["device"])
        self._points3d = DepthTo3d(device=p["device"])

    def connections(self, p):
        if p["pipeline"] == "segmented":
            graph = [self.passthrough["image"] >> self.depth_map["image"],
                     self.passthrough["image"] >> self.serving["image"],
                     self.depth_map["depth"] >> self.serving["depth"],
                     self.passthrough["K_image"] >> self.serving["K"]]
            if p["visualize"]:
                graph += self._drawer_inputs(self.serving["keypoints"],
                                             self.serving["pose_results"])
            return graph
        # depth branch: resize depth to the RGB frame, then back-project the
        # dense cloud the pose search consumes (wiring parity with
        # detector.py:64-69)
        graph = [self.passthrough["image"] >> self.depth_map["image"],
                 self.depth_map["depth"] >> self._points3d["depth"],
                 self.passthrough["K_image"] >> self._points3d["K"],
                 self._points3d["points3d"]
                 >> self.guess_generator["points3d"]]

        graph += [self.passthrough["image"]
                  >> self.feature_descriptor["image"],
                  self.passthrough["image"] >> self.guess_generator["image"],
                  # K feeds the 2D-only path for depthless frames (A13)
                  self.passthrough["K_image"] >> self.guess_generator["K"]]

        graph += [self.descriptor_matcher["spans"]
                  >> self.guess_generator["spans"],
                  self.descriptor_matcher["object_ids"]
                  >> self.guess_generator["object_ids"]]

        graph += [self.feature_descriptor["keypoints"]
                  >> self.guess_generator["keypoints"],
                  self.feature_descriptor["descriptors"]
                  >> self.descriptor_matcher["descriptors"],
                  self.descriptor_matcher["matches", "matches_3d"]
                  >> self.guess_generator["matches", "matches_3d"]]

        if p["visualize"]:
            graph += self._drawer_inputs(
                self.feature_descriptor["keypoints"],
                self.guess_generator["pose_results"])
        return graph

    def _drawer_inputs(self, keypoints, pose_results):
        return [self.passthrough["image"] >> self.pose_drawer["image"],
                self.passthrough["K_image"] >> self.pose_drawer["K_image"],
                keypoints >> self.pose_drawer["keypoints"],
                pose_results >> self.pose_drawer["pose_results"]]
