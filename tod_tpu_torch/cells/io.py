"""IO / glue cells: Constant, PassthroughN, Dealer, sources, sinks, voter
(a copy of tod_tpu/cells/io.py).

Rebuilds the ecto utility cells the reference pipelines depend on
(ecto.Constant/PassthroughN used in trainer.py:25-31 and detector.py:29-30;
ecto.Dealer in apps/feature_viewer:38) plus the .ork source/sink/voter cell
types (conf/detection.ork:1-8 OpenNI source, conf/detection.ros.ork:11-36
RosKinect/Publisher/Aggregator).

No camera is attached to the serving host, so both source types read
recorded/synthetic RGB-D sequences: ``DatasetSource`` streams frames from a
directory of .npz files (keys: image, depth, K) or from an in-memory list.
OpenNI/RosKinect .ork types map to it via the ``frames``/``path`` params.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np

from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils


class Constant(Cell):
    """Emit a constant value each iteration (ecto.Constant)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("value", "The constant value.")

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        o.declare("out", "The constant value.")

    def process(self) -> None:
        self.outputs["out"] = self.params["value"]


class PassthroughN(Cell):
    """Forward N named inputs to same-named outputs (ecto.PassthroughN,
    detector.py:29-30 uses items image/K_image)."""

    def __init__(self, name=None, items=None, **params):
        self._items = dict(items or {"in": "passthrough"})
        super().__init__(name, **params)

    def declare_io(self, p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        for key, doc in self._items.items():
            i.declare(key, doc)
            o.declare(key, doc)

    def process(self) -> None:
        for key in self._items:
            self.outputs[key] = self.inputs[key]


class Dealer(Cell):
    """Deal one item of an iterable per iteration (ecto.Dealer,
    apps/feature_viewer:38)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("iterable", "The values to deal out.", default=())

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        o.declare("out", "The next value.")
        o.declare("at_end", "True when the iterable is exhausted.")

    def configure(self) -> None:
        self._index = 0

    def process(self) -> None:
        seq = list(self.params["iterable"])
        if self._index < len(seq):
            self.outputs["out"] = seq[self._index]
            self._index += 1
            self.outputs["at_end"] = self._index >= len(seq)
        else:
            self.outputs["at_end"] = True


class DatasetSource(Cell):
    """RGB-D frame source (the OpenNI / RosKinect stand-in).

    Frames come from ``frames`` (list of dicts with image/depth/K) or from
    ``path`` (directory of .npz files, sorted). Loops when ``loop`` is true.
    """

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("frames", "In-memory frames: [{image, depth, K}, ...].",
                  default=None)
        p.declare("path", "Directory of .npz frames.", default=None)
        p.declare("loop", "Wrap around at the end.", default=True)
        # accepted-for-compat knobs from conf/*.ork sources
        for knob in ("image_mode", "depth_mode", "image_fps", "depth_fps",
                     "rgb_frame_id", "rgb_camera_info", "rgb_image_topic",
                     "depth_image_topic", "depth_camera_info"):
            p.declare(knob, "Accepted for .ork compatibility.", default=None)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        o.declare("image", "(H,W,3) u8 RGB frame.")
        o.declare("depth", "(H,W) depth map.")
        o.declare("K", "(3,3) intrinsics.")
        o.declare("K_image", "(3,3) intrinsics (alias, detector.py:66).")
        o.declare("at_end", "True once the (non-looping) stream is done.")

    def configure(self) -> None:
        self._index = 0
        self._frames: Optional[List[Any]] = self.params["frames"]
        self._files: List[str] = []
        if self._frames is None and self.params["path"]:
            self._files = sorted(
                os.path.join(self.params["path"], f)
                for f in os.listdir(self.params["path"]) if f.endswith(".npz"))
        if self._frames is None and not self._files:
            raise ValueError(
                f"{self.name}: no frame source — camera hardware is not "
                "attached; provide 'frames' or 'path'")

    def _n_frames(self) -> int:
        return len(self._frames) if self._frames is not None else len(self._files)

    def process(self) -> None:
        n = self._n_frames()
        idx = self._index % n if self.params["loop"] else min(self._index, n - 1)
        if self._frames is not None:
            frame = self._frames[idx]
            image, depth, K = frame["image"], frame["depth"], frame["K"]
        else:
            data = np.load(self._files[idx])
            image, depth, K = data["image"], data["depth"], data["K"]
        self._index += 1
        self.outputs["image"] = np.asarray(image)
        self.outputs["depth"] = np.asarray(depth)
        self.outputs["K"] = np.asarray(K)
        self.outputs["K_image"] = np.asarray(K)
        self.outputs["at_end"] = (not self.params["loop"]
                                  and self._index >= n)


class Publisher(Cell):
    """Detection sink (the object_recognition_ros Publisher analog,
    conf/detection.ros.ork:21-31): collects pose results; optional callback."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("visualize", "Accepted for compatibility.", default=False)
        p.declare("object_ids", "Accepted for compatibility.", default="all")
        p.declare("callback", "Optional callable(pose_results).", default=None)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("pose_results", "The detection results.", default=[])
        i.declare("image", "Pass-through frame (optional).")

    def configure(self) -> None:
        self.published: List[Any] = []

    def process(self) -> None:
        results = self.inputs["pose_results"] or []
        self.published.append(list(results))
        cb = self.params["callback"]
        if cb is not None:
            cb(results)


class Aggregator(Cell):
    """Detection voter (object_recognition_core io Aggregator,
    conf/detection.ros.ork:33-36): merges pose results from N pipelines."""

    def __init__(self, name=None, n_inputs: int = 1, **params):
        self._n_inputs = n_inputs
        super().__init__(name, **params)

    @staticmethod
    def _input_name(idx: int) -> str:
        return "pose_results" if idx == 0 else f"pose_results{idx}"

    def declare_io(self, p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        for idx in range(self._n_inputs):
            i.declare(self._input_name(idx),
                      "Pose results from one pipeline.", default=[])
        o.declare("pose_results", "The merged pose results.")

    def process(self) -> None:
        merged: List[Any] = []
        for idx in range(self._n_inputs):
            merged.extend(self.inputs[self._input_name(idx)] or [])
        self.outputs["pose_results"] = merged
