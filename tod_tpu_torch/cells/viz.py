"""Headless visualization cells (tod_tpu/cells/viz.py).

The reference pops highgui windows when ``visualize`` is set: DrawKeypoints +
imshow + PosesDrawer in the detector graph (detector.py:84-108) and
per-observation windows in the trainer (Trainer.cpp:173-180). Headless, the
same observability is a PNG a frame, drawn by ``utils/visualize.py`` and
written by ``utils/png.py`` on the host (no cv2).
"""

from __future__ import annotations

import numpy as np

from tod_tpu_torch.pipeline.cell import Cell
from tod_tpu_torch.pipeline.tendril import Tendrils
from tod_tpu_torch.utils.png import write_png
from tod_tpu_torch.utils.visualize import draw_detections, draw_keypoints

DEFAULT_PREFIX = "/tmp/tod_tpu_viz"         # the reference's prefixes
DEFAULT_TRAIN_PREFIX = "/tmp/tod_tpu_train"


def viz_prefix(visualize, default: str = DEFAULT_PREFIX) -> str:
    """A ``visualize`` param's PNG prefix: a string is the prefix, any
    other true value the reference's default."""
    return visualize if isinstance(visualize, str) else default


class PoseDrawer(Cell):
    """Draw detected keypoints + 6-DoF pose axes onto the frame and write a
    PNG per processed frame (the DrawKeypoints + PosesDrawer + imshow
    subgraph of the reference detector, detector.py:84-108)."""

    @staticmethod
    def declare_params(p: Tendrils) -> None:
        p.declare("prefix", "Output path prefix for the PNGs.",
                  default=DEFAULT_PREFIX)

    @staticmethod
    def declare_io(p: Tendrils, i: Tendrils, o: Tendrils) -> None:
        i.declare("image", "The frame (H,W[,3]) to draw on.")
        i.declare("K_image", "(3,3) camera intrinsics.")
        i.declare("keypoints", "Keypoints structure (padded, masked).")
        i.declare("pose_results", "List of PoseResult to draw.")
        o.declare("image_out", "The annotated image (also written as PNG).")

    def configure(self) -> None:
        self._counter = 0

    def process(self) -> None:
        image = np.asarray(self.inputs["image"])
        K = np.asarray(self.inputs["K_image"], np.float64)
        kps = self.inputs["keypoints"]
        out = image
        if kps is not None:
            valid = np.asarray(kps.valid)
            out = draw_keypoints(out, np.asarray(kps.xy)[valid])
        poses = self.inputs["pose_results"] or []
        if poses:
            out = draw_detections(out, K, poses)
        self._counter += 1
        path = f"{self.params['prefix']}_poses_{self._counter:04d}.png"
        write_png(path, out if out.ndim == 2 else out[..., ::-1])
        self.outputs["image_out"] = out
