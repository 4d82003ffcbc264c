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
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# the reference's debug color rotation (GuessGenerator.cpp:71-81 configure)
COLORS: List[Tuple[int, int, int]] = [
    (255, 255, 0), (0, 255, 255), (255, 0, 255), (255, 0, 0), (0, 255, 0),
    (0, 0, 255), (0, 0, 0), (85, 85, 85), (170, 170, 170), (255, 255, 255),
]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
GLYPHS_PATH = os.path.join(os.path.dirname(__file__), "hershey_simplex.npz")


def _as_bgr(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 2:
        return np.repeat(img.astype(np.uint8)[..., None], 3, -1)
    return np.ascontiguousarray(img.astype(np.uint8))


def _put(out: np.ndarray, xs, ys, colors) -> None:
    """Set pixels (xs, ys) that lie on the image; ``colors`` is one BGR
    triple or one a pixel, and a later pixel wins over an earlier one."""
    xs = np.asarray(xs, np.int64).reshape(-1)
    ys = np.asarray(ys, np.int64).reshape(-1)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    if len(colors) == 1:
        colors = np.broadcast_to(colors, (len(xs), 3))
    h, w = out.shape[:2]
    on = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = (ys * w + xs)[on]
    colors = colors[on]
    # keep each pixel's last write
    _, last = np.unique(flat[::-1], return_index=True)
    keep = len(flat) - 1 - last
    out.reshape(-1, 3)[flat[keep]] = colors[keep]


@functools.lru_cache(maxsize=8)
def _circle_offsets(radius: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``Circle`` (drawing.cpp) outline of ``radius``: (dx, dy)
    of every pixel it sets around the centre."""
    pts = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        pts += [(-dx, -dy), (dx, -dy), (-dx, dy), (dx, dy),
                (-dy, -dx), (dy, -dx), (-dy, dx), (dy, dx)]
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    pts = sorted(set(pts))
    return (np.asarray([p[0] for p in pts]), np.asarray([p[1] for p in pts]))


def _fill_circle(out: np.ndarray, cx: int, cy: int, radius: int,
                 color) -> None:
    """OpenCV's filled ``Circle``: a horizontal span for every row of the
    midpoint circle, clipped to the image."""
    dxs, dys = _circle_offsets(radius)
    for row in np.unique(dys):
        half = int(dxs[dys == row].max())
        xs = np.arange(cx - half, cx + half + 1)
        _put(out, xs, np.full_like(xs, cy + int(row)), color)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` for an image of w x h (here in fixed point):
    the clipped end points, or None when the line misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line2(out: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
           color) -> None:
    """OpenCV's fixed-point ``Line2`` (8-connected, end points in 16-bit
    fixed point), clipped to the image first as it is."""
    h, w = out.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _trunc_div(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _trunc_div(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    steps = np.arange(ecount + 1, dtype=np.int64) if ecount >= 0 \
        else np.zeros(0, np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + steps
        ys = (y1 + steps * y_step) >> XY_SHIFT
    else:
        xs = (x1 + steps * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + steps
    end_x = (x2 + (XY_ONE >> 1)) >> XY_SHIFT
    end_y = (y2 + (XY_ONE >> 1)) >> XY_SHIFT
    _put(out, np.append(end_x, xs), np.append(end_y, ys), color)


def _fill_convex(out: np.ndarray, v: Sequence[Tuple[int, int]],
                 color) -> None:
    """OpenCV's ``FillConvexPoly`` for 8-connected drawing, vertices in
    16-bit fixed point: the outline with :func:`_line2`, then one span a
    scanline between the two edges walked down from the top vertex."""
    h, w = out.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(out, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin = (min(p[0] for p in v) + delta) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + delta) >> XY_SHIFT
    ymin = (min(ys) + delta) >> XY_SHIFT
    ymax = (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    edges = npts
    y = ymin
    spans = []
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _trunc_div((xe - xs) * 2 + (ty - y),
                                             2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                spans.append((y, max(xx1, 0), min(xx2, w - 1)))
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break
    for row, a, b in spans:
        out[row, a:b + 1] = color


def _thick_line(out: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.line(out, pt1, pt2, color, thickness)`` for thickness > 1 with
    ``LINE_8``: OpenCV's ``ThickLine`` (a line of thickness 1 takes cv2's
    integer line iterator, which this module does not draw)."""
    if thickness < 2:
        raise ValueError("only lines of thickness 2 and more are drawn")
    # cv2 first clips the line to the image grown by the thickness on
    # every side (read off cv2: no other margin gives its pixels)
    h, w = out.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, int(pt1[0]) + m,
                         int(pt1[1]) + m, int(pt2[0]) + m, int(pt2[1]) + m)
    if clipped is None:
        return
    x1, y1, x2, y2 = (v - m for v in clipped)
    p0 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    p1 = (x2 << XY_SHIFT, y2 << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex(out, [(p0[0] + dpx, p0[1] + dpy),
                           (p0[0] - dpx, p0[1] - dpy),
                           (p1[0] - dpx, p1[1] - dpy),
                           (p1[0] + dpx, p1[1] + dpy)], color)
    radius = (thick + (XY_ONE >> 1)) >> XY_SHIFT
    for p in (p0, p1):
        _fill_circle(out, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                     (p[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


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
