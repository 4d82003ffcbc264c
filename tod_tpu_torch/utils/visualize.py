"""Keypoint, cluster and pose-axis overlays without cv2
(tod_tpu/utils/visualize.py).

The reference draws its debug overlays with cv2: ``cv2.circle`` (radius 3,
thickness 1), ``cv2.line`` (thickness 2) and ``cv2.putText``
(``FONT_HERSHEY_SIMPLEX`` at scale 0.5). This module draws the same pixels
with numpy, following OpenCV's rasterisers in its 16-bit fixed point:

- a circle of thickness 1 is OpenCV's integer midpoint circle, each pixel
  off the image dropped on its own;
- a line of thickness 2 is clipped to the image grown by its thickness,
  then drawn as a filled convex quadrilateral (its outline drawn by
  OpenCV's fixed-point line after clipping it to the image, then its
  scanlines) plus a filled round cap of radius 1 at each end;
- a label is composed glyph by glyph. cv2 (OpenCV 5) draws
  ``FONT_HERSHEY_SIMPLEX`` anti-aliased from a built-in outline font and
  exposes neither its outlines nor its coverage, so
  ``hershey_simplex.npz`` (made with cv2 by ``tools/make_torch_hershey.py``,
  which checks the composition against cv2) holds each printable
  character's coverage at scale 0.5 and its whole-pixel advance; each
  glyph is blended in turn, ``(bg * (255 - a) + color * a + 127) // 255``
  a channel, its pixels off the image dropped.

Every function takes and returns images as the reference does: a gray
image becomes three channels, colours are in cv2's BGR order.
"""

from __future__ import annotations

import functools
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np

# the rasterisers live in utils/raster.py, shared with the synthetic renderer
from tod_tpu_torch.utils.raster import _circle_offsets, _put, _thick_line

# the reference's debug color rotation (GuessGenerator.cpp:71-81 configure)
COLORS: List[Tuple[int, int, int]] = [
    (255, 255, 0), (0, 255, 255), (255, 0, 255), (255, 0, 0), (0, 255, 0),
    (0, 0, 255), (0, 0, 0), (85, 85, 85), (170, 170, 170), (255, 255, 255),
]

GLYPHS_PATH = os.path.join(os.path.dirname(__file__), "hershey_simplex.npz")


def _as_bgr(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 2:
        return np.repeat(img.astype(np.uint8)[..., None], 3, -1)
    return np.ascontiguousarray(img.astype(np.uint8))


@functools.lru_cache(maxsize=1)
def _glyphs():
    """{character code: (advance in pixels, (N, 2) (dx, dy) from the
    cursor and the origin's row, (N,) coverage)} for printable ASCII."""
    with np.load(GLYPHS_PATH) as data:
        starts = data["starts"]
        return {int(code): (int(data["advance"][i]),
                            data["offsets"][starts[i]:starts[i + 1]].astype(
                                np.int64),
                            data["alpha"][starts[i]:starts[i + 1]].astype(
                                np.int64)[:, None])
                for i, code in enumerate(data["codes"].tolist())}


def put_text(out: np.ndarray, text: str, org: Tuple[int, int],
             color) -> None:
    """``cv2.putText(out, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``
    on a BGR image, in place. A character outside printable ASCII draws as
    ``?`` (cv2 draws control characters so, but other Unicode characters
    from its font)."""
    table = _glyphs()
    h, w = out.shape[:2]
    color = np.asarray(color, np.int64)
    x = int(org[0])
    for ch in str(text):
        code = ord(ch) if 32 <= ord(ch) < 127 else ord("?")
        adv, off, alpha = table[code]
        xs, ys = off[:, 0] + x, off[:, 1] + int(org[1])
        on = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        bg = out[ys[on], xs[on]].astype(np.int64)
        a = alpha[on]
        out[ys[on], xs[on]] = (bg * (255 - a) + color * a + 127) // 255
        x += adv


def _centres(xy: np.ndarray, valid: Optional[np.ndarray]
             ) -> Tuple[List[int], np.ndarray]:
    """The indices of the valid rows of ``xy`` and their circle centres,
    ``int(round(float(v)))`` of each coordinate (Python's half-to-even
    round, as the reference)."""
    keep = [i for i in range(len(xy)) if valid is None or valid[i]]
    pts = [(int(round(float(xy[i][0]))), int(round(float(xy[i][1]))))
           for i in keep]
    return keep, np.asarray(pts, np.int64).reshape(-1, 2)


def draw_keypoints(image: np.ndarray, xy: np.ndarray,
                   valid: Optional[np.ndarray] = None,
                   color: Tuple[int, int, int] = (255, 0, 0),
                   radius: int = 3) -> np.ndarray:
    """ecto_opencv DrawKeypoints analog: circles at keypoint locations."""
    out = _as_bgr(image)
    _, pts = _centres(np.asarray(xy), valid)
    dxs, dys = _circle_offsets(int(radius))
    _put(out, (pts[:, 0:1] + dxs).reshape(-1),
         (pts[:, 1:2] + dys).reshape(-1), color)
    return out


def draw_clusters(image: np.ndarray, xy: np.ndarray,
                  cluster_ids: np.ndarray,
                  valid: Optional[np.ndarray] = None) -> np.ndarray:
    """DrawClustersPerObject analog (adjacency_ransac.cpp:208-230): one color
    per object cluster, a later keypoint's circle over an earlier one."""
    out = _as_bgr(image)
    keep, pts = _centres(np.asarray(xy), valid)
    colors = np.asarray([COLORS[int(cluster_ids[i]) % len(COLORS)]
                         for i in keep], np.uint8).reshape(-1, 3)
    dxs, dys = _circle_offsets(3)
    _put(out, (pts[:, 0:1] + dxs).reshape(-1),
         (pts[:, 1:2] + dys).reshape(-1), np.repeat(colors, len(dxs), 0))
    return out


def draw_pose_axes(image: np.ndarray, K: np.ndarray, R: np.ndarray,
                   T: np.ndarray, axis_len: float = 0.1,
                   thickness: int = 2) -> np.ndarray:
    """PosesDrawer analog (detector.py:105-108): project the object frame's
    axes through the pose (model->camera) and draw x=red, y=green, z=blue."""
    out = _as_bgr(image)
    K = np.asarray(K, np.float64)
    pts_obj = np.float64([[0, 0, 0], [axis_len, 0, 0], [0, axis_len, 0],
                          [0, 0, axis_len]])
    cam = pts_obj @ np.asarray(R, np.float64).T + np.asarray(T, np.float64)
    if (cam[:, 2] <= 1e-6).any():
        return out
    pix = (cam @ K.T)
    pix = (pix[:, :2] / pix[:, 2:3]).astype(int)
    o = tuple(pix[0])
    for end, color in zip(pix[1:], [(0, 0, 255), (0, 255, 0), (255, 0, 0)]):
        _thick_line(out, o, tuple(end), color, thickness)
    return out


def draw_detections(image: np.ndarray, K: np.ndarray,
                    pose_results: Iterable) -> np.ndarray:
    """Overlay every detected pose's axes + object id label."""
    out = _as_bgr(image)
    for i, r in enumerate(pose_results):
        out = draw_pose_axes(out, K, r.R, r.T)
        cam = np.asarray(r.T, np.float64)
        pix = K @ cam
        if pix[2] > 1e-6:
            x, y = int(pix[0] / pix[2]), int(pix[1] / pix[2])
            put_text(out, f"{r.object_id} ({int(r.confidence)})",
                     (x + 6, y - 6), COLORS[i % len(COLORS)])
    return out
