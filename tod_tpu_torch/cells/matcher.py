"""DescriptorMatcher cell: query descriptors vs the whole trained model DB
(tod_tpu/cells/matcher.py).

The reference's DescriptorMatcher (src/detection/DescriptorMatcher.cpp):
model loading + span computation from the parameter callback (:61-129) and
the knn(k=5) + radius-truncation matching contract (:195-252), with the
FLANN-LSH index replaced by exact search. LSH tuning knobs
(n_tables/key_size/multi_probe_level) are accepted for .ork compatibility
and ignored.

Binary (ORB) models match on kernel B5 (``ops/hamming.py
hamming_topk_fused``, its plain twin for CPU tensors): the unrestricted
top-k of every query in (dist, row) order, as the reference's XLA
``hamming_topk`` gives it; the radius is cut on the host, so that the
``MatchSet``'s distances past the radius and the ratio rule read what the
reference's do. Float (SIFT) models match by ``ops/matching.py l2_topk``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from tod_tpu_torch.cells.features import declare_device, to_host, upload
from tod_tpu_torch.cells.types import MatchSet
from tod_tpu_torch.db import ObjectDbParameters, load_models_for_objects
from tod_tpu_torch.ops.hamming import hamming_topk_fused, pack_db_bits
from tod_tpu_torch.ops.matching import l2_topk, pad_db
from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.utils.config import parse_json_params

L2_CHUNK = 4096   # the reference's l2_topk chunk, min(DB_CHUNK, 4096)


def parse_object_ids(object_ids):
    """A ``json_object_ids`` param as ``load_models_for_objects`` takes it:
    "all", a JSON list, or one bare id."""
    if isinstance(object_ids, str) and object_ids not in ("all", ""):
        # a bare id string would otherwise iterate character-by-character
        object_ids = parse_json_params(object_ids) \
            if object_ids.startswith("[") else [object_ids]
    return object_ids or "all"


class MatcherIndex:
    """The packed model database on the device (the matcher_->add analog,
    DescriptorMatcher.cpp:126-128): the stacked descriptors there (binary:
    (N, 8) int32 words for B5; float: (N_pad, D) float32 padded to
    ``L2_CHUNK`` rows), and on the host the 3D points, each row's object
    and row within it, and each object's span."""

    def __init__(self, models: List, device: torch.device | str):
        self.object_ids = [m.object_id for m in models]
        self.spans = {m.object_id: m.span for m in models}
        self.is_binary = (not models
                          or models[0].descriptors.dtype == np.uint8)
        if models:
            desc = np.concatenate([m.descriptors for m in models])
            pts = np.concatenate([m.points for m in models])
            obj = np.concatenate([np.full(m.n_points, i, np.int32)
                                  for i, m in enumerate(models)])
            local = np.concatenate([np.arange(m.n_points, dtype=np.int32)
                                    for m in models])
        else:
            desc = np.zeros((0, 32), np.uint8)
            pts = np.zeros((0, 3), np.float32)
            obj = np.zeros(0, np.int32)
            local = np.zeros(0, np.int32)
        self.n_descriptors = len(desc)
        if self.is_binary:
            self.descriptors = pack_db_bits(upload(desc, device))
        else:
            padded, _ = pad_db(desc.astype(np.float32), L2_CHUNK)
            self.descriptors = upload(padded, device)
        self.points = np.asarray(pts, np.float32)
        self.obj_of_row = obj
        self.local_of_row = local


class DescriptorMatcher(Cell):
    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("search_json_params",
                  'JSON: {"type": LSH, "radius": eps-NN cut, "ratio": SIFT '
                  "ratio criterion, n_tables/key_size/multi_probe_level "
                  "accepted for compatibility}", required=True)
        p.declare("json_db", "The DB parameters as a JSON string.",
                  default="{}")
        p.declare("json_object_ids",
                  'The object ids to load, as a JSON list or "all".',
                  default="all")
        declare_device(p)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("descriptors", "The descriptors to match to the database.")
        o.declare("matches", "MatchSet: top-k matches per query descriptor.")
        o.declare("matches_3d",
                  "(Q,k,3) 3d positions of the matched training points.")
        o.declare("object_ids", "The ids of the loaded objects.")
        o.declare("spans", "{object_id: span} of the loaded objects.")

    def configure(self) -> None:
        search = parse_json_params(self.params["search_json_params"])
        self._radius = float(search.get("radius", 0) or 0)
        self._ratio = float(search.get("ratio", 0) or 0)
        search_type = search.get("type", "LSH")
        if search_type not in ("LSH", "BruteForce", "L2"):
            raise ValueError(f"search not implemented for type {search_type}")
        self._k = int(search.get("k", 5))  # knnMatch(k=5), :211
        self._use_ratio = bool(search.get("use_ratio", False))
        self._device = torch.device(self.params["device"])
        self.reload_models()

    def reload_models(self) -> None:
        """The parameter_callback analog: (re)load every model from the DB
        and (re)build the matcher index (DescriptorMatcher.cpp:61-129)."""
        db = ObjectDbParameters(self.params["json_db"]).generate_db()
        models = load_models_for_objects(
            db, parse_object_ids(self.params["json_object_ids"]))
        self.index = MatcherIndex(models, self._device)

    def match(self, query: np.ndarray):
        """(dist, rows) of the unrestricted top-k, on the host."""
        idx = self.index
        if idx.is_binary:
            q = upload(query.astype(np.uint8), self._device)
            dist, rows = hamming_topk_fused(q, idx.descriptors,
                                            idx.n_descriptors, k=self._k,
                                            radius=None)
        else:
            q = upload(query.astype(np.float32), self._device)
            d_sq, rows = l2_topk(q, idx.descriptors, idx.n_descriptors,
                                 k=self._k, chunk=L2_CHUNK)
            dist = torch.sqrt(d_sq)   # report plain L2 like cv::BFMatcher
        return to_host(dist, rows)

    def process(self) -> None:
        query = np.ascontiguousarray(self.inputs["descriptors"])
        q = len(query)
        idx = self.index
        self.outputs["object_ids"] = idx.object_ids
        self.outputs["spans"] = idx.spans
        if idx.n_descriptors == 0:
            self.outputs["matches"] = MatchSet(
                dist=np.zeros((q, self._k), np.float32),
                train_idx=np.full((q, self._k), -1, np.int32),
                obj_idx=np.full((q, self._k), -1, np.int32),
                local_idx=np.zeros((q, self._k), np.int32),
                valid=np.zeros((q, self._k), bool))
            self.outputs["matches_3d"] = np.zeros((q, self._k, 3), np.float32)
            return

        dist, rows = self.match(query)
        valid = rows >= 0
        if self._radius:
            # knn then radius truncation (DescriptorMatcher.cpp:211-220)
            valid &= dist <= self._radius
        if self._use_ratio and self._ratio:
            # Lowe ratio criterion: drop queries whose best match is not
            # clearly better than the 2nd-best. The reference declares this
            # but never implements it (dead code via unsigned-int truncation,
            # DescriptorMatcher.cpp:223-227/:257-259), so it is opt-in here
            # (search param "use_ratio": true) to preserve default behavior.
            if dist.shape[1] >= 2:
                ambiguous = dist[:, 0] >= self._ratio * np.maximum(
                    dist[:, 1], 1e-6)
                valid &= ~ambiguous[:, None]
        safe_rows = np.where(valid, rows, 0)
        self.outputs["matches"] = MatchSet(
            dist=dist, train_idx=np.where(valid, rows, -1),
            obj_idx=np.where(valid, idx.obj_of_row[safe_rows], -1),
            local_idx=idx.local_of_row[safe_rows],
            valid=valid)
        self.outputs["matches_3d"] = idx.points[safe_rows]
