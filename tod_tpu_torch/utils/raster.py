"""The cv2 raster operations the synthetic renderer and the overlays call,
in numpy, each giving cv2 5.0's pixels bit for bit (host only).

cv2 is the oracle in ``tests/test_torch_raster.py``; what each function
follows was read off cv2 5.0.0 (x86-64 wheel, AVX-512 dispatch):

- ``resize_linear`` of float32: the lerp form ``fma(f, b - a, a)`` along
  x, then along y, the fraction ``f`` taken in f64 from
  ``(d + 0.5) * src / dst - 0.5`` then rounded to f32, positions off the
  source clamped to its edge;
- ``resize_linear`` of uint8: OpenCV's classic fixed-point path (11-bit
  coefficients rounded from f32 fractions, integer rows, then
  ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2 >> 2``), not
  the bit-exact ``INTER_LINEAR_EXACT`` one;
- ``warp_perspective``: OpenCV 5's float kernel. The inverse map (cv's
  3x3 cofactor ``invert``) is rounded to f32; a pixel's source is
  ``fma(M0, x, y * M1 + M2) / fma(M6, x, y * M7 + M8)`` (the row term
  unfused, the column term fused); ``INTER_NEAREST`` rounds it half to
  even, ``INTER_LINEAR`` blends ``fma(a, p01 - p00, p00)``, the rows the
  same way, rounds half to even; a neighbour off the source reads 0
  (``BORDER_CONSTANT``);
- ``get_perspective_transform``: cv's 8x8 system (its ``-x * u`` terms
  are f32 products) solved by OpenCV's own partial-pivot LU in f64,
  nothing fused;
- ``gaussian_blur_u8``: OpenCV's bit-exact 8U Gaussian, an 8-bit
  fixed-point kernel from ``getGaussianKernelBitExact`` with its error
  diffusion, rows then columns in integers, ``BORDER_REFLECT_101``;
- ``fill_poly``: ``FillEdgeCollection`` after each edge's 8-connected
  integer line; ``rectangle``/``circle`` (filled) and ``line`` (thickness
  2 and more) are ``FillConvexPoly``, ``Circle`` and ``ThickLine`` in
  OpenCV's 16-bit fixed point.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _fma32(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once (a fused multiply-add): the product
    is exact in f64, the f64 sum is rounded to odd, and rounding that to
    f32 is then correct."""
    p = np.asarray(a, np.float32).astype(np.float64) \
        * np.asarray(b, np.float32).astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    bits = s.view(np.int64)
    step = np.where((err != 0) & ((bits & 1) == 0),
                    np.where((err > 0) == (s > 0), 1, -1), 0)
    return (bits + step).view(np.float64).astype(np.float32)


# -- drawing (drawing.cpp), 16-bit fixed point -------------------------------

def _put(out: np.ndarray, xs, ys, colors) -> None:
    """Set pixels (xs, ys) that lie on the image; ``colors`` is one colour
    (a scalar on a gray image, a BGR triple on a colour one) or one a
    pixel, and a later pixel wins over an earlier one."""
    xs = np.asarray(xs, np.int64).reshape(-1)
    ys = np.asarray(ys, np.int64).reshape(-1)
    cn = out.shape[2] if out.ndim == 3 else 1
    colors = np.asarray(colors, out.dtype).reshape(-1, cn)
    if len(colors) == 1:
        colors = np.broadcast_to(colors, (len(xs), cn))
    h, w = out.shape[:2]
    on = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = (ys * w + xs)[on]
    colors = colors[on]
    # keep each pixel's last write
    _, last = np.unique(flat[::-1], return_index=True)
    keep = len(flat) - 1 - last
    out.reshape(-1, cn)[flat[keep]] = colors[keep]


@functools.lru_cache(maxsize=32)
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
    """OpenCV's ``clipLine`` for an image of w x h (in pixels or in fixed
    point): the clipped end points, or None when the line misses it."""
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


def _line_iter(p1: Tuple[int, int],
               p2: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of OpenCV's 8-connected integer ``LineIterator`` (left
    to right) from p1 to p2, both on the image."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # err starts at dx - 2 dy and moves by -2 dy, plus 2 dx after a step
    # taken with err < 0, which also moves the minor coordinate
    i = np.arange(dx + 1, dtype=np.int64)
    minor = np.zeros(dx + 1, np.int64)
    err = dx - 2 * dy
    for k in range(dx):
        neg = err < 0
        minor[k + 1] = minor[k] + neg
        err += -2 * dy + (2 * dx if neg else 0)
    if vert:
        return x1 + minor, y1 + sy * i
    return x1 + i, y1 + sy * minor


def fill_poly(img: np.ndarray, pts, color) -> None:
    """``cv2.fillPoly(img, [pts], color)`` (``LINE_8``, no shift) of a
    polygon whose vertices lie on the image, as make_texture draws them,
    in place: each edge's integer line, then OpenCV's
    ``FillEdgeCollection`` scanlines (a span from the ceiling of its left
    edge to the floor of its right edge; an edge holds its top row, not
    its bottom one). cv2 walks an edge that leaves the image from its
    clipped end points, which this function does not: it raises
    ValueError for a vertex off the image."""
    h, w = img.shape[:2]
    v = [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]
    if any(not (0 <= x < w and 0 <= y < h) for x, y in v):
        raise ValueError("fill_poly draws polygons whose vertices lie on "
                         "the image")
    edges = []
    p0 = v[-1]
    for p1 in v:
        xs, ys = _line_iter(p0, p1)
        img[ys, xs] = color
        if p0[1] != p1[1]:
            a, b = (p0, p1) if p0[1] < p1[1] else (p1, p0)
            dx = _trunc_div((p1[0] - p0[0]) << XY_SHIFT, p1[1] - p0[1])
            edges.append([a[1], b[1], a[0] << XY_SHIFT, dx])
        p0 = p1
    if len(edges) < 2:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    active: list = []
    i = 0
    for y in range(edges[0][0], max(e[1] for e in edges)):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            e = edges[i]
            i += 1
            k = 0
            while k < len(active) and active[k][2] < e[2]:
                k += 1
            active.insert(k, e)
        for j in range(0, len(active) - 1, 2):
            a, b = active[j], active[j + 1]
            lo, hi = (b, a) if a[2] > b[2] else (a, b)
            img[y, (lo[2] + XY_ONE - 1) >> XY_SHIFT:
                (hi[2] >> XY_SHIFT) + 1] = color
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = -1) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: OpenCV fills the four
    corners as a convex polygon."""
    if thickness >= 0:
        raise ValueError("only filled rectangles (thickness < 0) are drawn")
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]),
                                                      int(pt2[1]))
    _fill_convex(img, [(x1 << XY_SHIFT, y1 << XY_SHIFT),
                       (x2 << XY_SHIFT, y1 << XY_SHIFT),
                       (x2 << XY_SHIFT, y2 << XY_SHIFT),
                       (x1 << XY_SHIFT, y2 << XY_SHIFT)], color)


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = -1) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (filled)."""
    if thickness >= 0:
        raise ValueError("only filled circles (thickness < 0) are drawn")
    _fill_circle(img, int(center[0]), int(center[1]), int(radius), color)


def line(img: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` for thickness >= 2."""
    _thick_line(img, pt1, pt2, color, int(thickness))


# -- geometry (imgwarp.cpp, lapack.cpp) --------------------------------------

def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)`` of four f32 points each:
    the 8x8 system solved by OpenCV's ``LUImpl`` (partial pivoting, the
    eliminations and the back substitution unfused, f64). A singular
    system gives zeros with ``M[2, 2] = 1``, as cv2."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy = float(s[i, 0]), float(s[i, 1])
        a[i][0] = a[i + 4][3] = sx
        a[i][1] = a[i + 4][4] = sy
        a[i][2] = a[i + 4][5] = 1.0
        # float * float in cv: rounded to f32 before it widens
        a[i][6] = -float(s[i, 0] * d[i, 0])
        a[i][7] = -float(s[i, 1] * d[i, 0])
        a[i + 4][6] = -float(s[i, 0] * d[i, 1])
        a[i + 4][7] = -float(s[i, 1] * d[i, 1])
        b[i] = float(d[i, 0])
        b[i + 4] = float(d[i, 1])
    x = _lu_solve(a, b, np.finfo(np.float64).eps * 100)
    if x is None:
        raise ValueError("the four point pairs give a singular system")
    return np.asarray(x + [1.0]).reshape(3, 3)


def _lu_solve(A, b, eps):
    """OpenCV's ``LUImpl`` on Python floats (each operation one f64
    rounding): the solution, or None when a pivot is below ``eps``."""
    m = len(A)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(A[j][i]) > abs(A[k][i]):
                k = j
        if abs(A[k][i]) < eps:
            return None
        if k != i:
            A[i], A[k] = A[k], A[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / A[i][i]
        for j in range(i + 1, m):
            alpha = A[j][i] * d
            for c in range(i + 1, m):
                A[j][c] += alpha * A[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= A[i][c] * b[c]
        b[i] = s / A[i][i]
    return b


def invert(M) -> np.ndarray:
    """``cv2.invert`` of a 3x3 f64 matrix (``DECOMP_LU``): OpenCV's
    cofactor formula scaled by the reciprocal determinant; a singular
    matrix gives zeros."""
    S = [[float(v) for v in row] for row in np.asarray(M, np.float64)]
    det = (S[0][0] * (S[1][1] * S[2][2] - S[1][2] * S[2][1])
           - S[0][1] * (S[1][0] * S[2][2] - S[1][2] * S[2][0])
           + S[0][2] * (S[1][0] * S[2][1] - S[1][1] * S[2][0]))
    if det == 0:
        return np.zeros((3, 3))
    d = 1.0 / det
    return np.asarray([
        (S[1][1] * S[2][2] - S[1][2] * S[2][1]) * d,
        (S[0][2] * S[2][1] - S[0][1] * S[2][2]) * d,
        (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * d,
        (S[1][2] * S[2][0] - S[1][0] * S[2][2]) * d,
        (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * d,
        (S[0][2] * S[1][0] - S[0][0] * S[1][2]) * d,
        (S[1][0] * S[2][1] - S[1][1] * S[2][0]) * d,
        (S[0][1] * S[2][0] - S[0][0] * S[2][1]) * d,
        (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * d]).reshape(3, 3)


def _fetch(src: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """src[Y, X] as f32, 0 where (X, Y) is off the source."""
    h, w = src.shape[:2]
    ok = (X >= 0) & (X < w) & (Y >= 0) & (Y < h)
    out = np.zeros(X.shape, np.float32)
    out[ok] = src[Y[ok], X[ok]]
    return out


def warp_perspective(src: np.ndarray, H, dsize: Tuple[int, int],
                     nearest: bool = False,
                     roi: Tuple[slice, slice] = None) -> np.ndarray:
    """``cv2.warpPerspective(src, H, dsize, flags=INTER_LINEAR or
    INTER_NEAREST)`` of a 2-D uint8 image, border 0. With ``roi`` (row and
    column slices of the destination) only those pixels are computed and
    returned; each pixel depends on nothing but its own position, so they
    equal the full warp's."""
    w, h = int(dsize[0]), int(dsize[1])
    if src.ndim != 2 or src.dtype != np.uint8:
        raise ValueError("warp_perspective takes a 2-D uint8 image")
    rows, cols = roi if roi is not None else (slice(0, h), slice(0, w))
    M = invert(H).reshape(-1).astype(np.float32)
    x = np.arange(w, dtype=np.float32)[cols][None, :]
    y = np.arange(h, dtype=np.float32)[rows][:, None]

    def coord(a, b, c):
        return _fma32(a, x, (y * b).astype(np.float32) + c)

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        wv = coord(M[6], M[7], M[8])
        sx = coord(M[0], M[1], M[2]) / wv
        sy = coord(M[3], M[4], M[5]) / wv
        big = float(1 << 30)
        sx = np.nan_to_num(sx, nan=-big, posinf=big, neginf=-big)
        sy = np.nan_to_num(sy, nan=-big, posinf=big, neginf=-big)
        sx = np.clip(sx, -big, big).astype(np.float32)
        sy = np.clip(sy, -big, big).astype(np.float32)
    if nearest:
        X = np.rint(sx).astype(np.int64)
        Y = np.rint(sy).astype(np.int64)
        return _fetch(src, X, Y).astype(np.uint8)
    ix = np.floor(sx).astype(np.int64)
    iy = np.floor(sy).astype(np.int64)
    a = (sx - ix.astype(np.float32)).astype(np.float32)
    b = (sy - iy.astype(np.float32)).astype(np.float32)
    p00, p01 = _fetch(src, ix, iy), _fetch(src, ix + 1, iy)
    p10, p11 = _fetch(src, ix, iy + 1), _fetch(src, ix + 1, iy + 1)
    f0 = _fma32(a, p01 - p00, p00)
    f1 = _fma32(a, p11 - p10, p10)
    v = _fma32(b, f1 - f0, f0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


# -- resize (resize.cpp) -----------------------------------------------------

def _positions(n_src: int, n_dst: int) -> np.ndarray:
    """Each destination index's source position, half-pixel centres, f64."""
    return (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5


def _taps_f32(n_src: int, n_dst: int):
    """The two source indices and the f32 fraction (taken in f64) of each
    destination index; a position off the source takes its edge sample
    whole."""
    f = _positions(n_src, n_dst)
    s = np.floor(f).astype(np.int64)
    frac = (f - s).astype(np.float32)
    lo, hi = s < 0, s >= n_src - 1
    frac[lo | hi] = 0
    s = np.clip(s, 0, n_src - 1)
    return s, np.minimum(s + 1, n_src - 1), frac


def _taps_u8(n_src: int, n_dst: int, rows: bool = False):
    """11-bit coefficients from the f32 fractions. Along x a position off
    the source takes its edge sample whole; along y OpenCV keeps the
    fraction and clamps only the two rows it reads."""
    f = _positions(n_src, n_dst).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    if not rows:
        frac[(s < 0) | (s >= n_src - 1)] = 0
        s = np.clip(s, 0, n_src - 1)
    c0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    c1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), c0, c1


def resize_linear(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=INTER_LINEAR)`` of a 2-D
    float32 or uint8 image (``dsize`` is (width, height))."""
    w, h = int(dsize[0]), int(dsize[1])
    if src.ndim != 2 or min(src.shape) < 2:
        raise ValueError("resize_linear takes a 2-D image of 2 x 2 or more")
    if src.dtype == np.float32:
        s0, s1, f = _taps_f32(src.shape[1], w)
        rows = _fma32(f, src[:, s1] - src[:, s0], src[:, s0])
        s0, s1, f = _taps_f32(src.shape[0], h)
        f = f[:, None]
        return _fma32(f, rows[s1] - rows[s0], rows[s0])
    if src.dtype == np.uint8:
        s0, s1, c0, c1 = _taps_u8(src.shape[1], w)
        img = src.astype(np.int64)
        rows = img[:, s0] * c0 + img[:, s1] * c1
        s0, s1, c0, c1 = _taps_u8(src.shape[0], h, rows=True)
        out = ((((rows[s0] >> 4) * c0[:, None]) >> 16)
               + (((rows[s1] >> 4) * c1[:, None]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    raise ValueError(f"resize_linear takes float32 or uint8, not {src.dtype}")


# -- smoothing (smooth.dispatch.cpp, fixedpoint.inl.hpp) ---------------------

@functools.lru_cache(maxsize=8)
def gaussian_kernel_u8(ksize: int, sigma: float) -> Tuple[int, ...]:
    """OpenCV's 8-bit fixed-point Gaussian taps (``sum == 256``):
    ``getGaussianKernelBitExact`` rounded with its error diffusion from
    the outside in, the centre tap taking what is left."""
    if ksize % 2 != 1 or sigma <= 0:
        raise ValueError("an odd kernel size and a positive sigma")
    scale2 = -0.125 / (sigma * sigma)
    half = ksize // 2
    vals = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 0, 2)]
    mul1 = 1.0 / (sum(vals) * 2.0 + 1.0)
    taps = [0] * ksize
    err, total = 0.0, 0
    for i in range(half):
        adj = vals[i] * mul1 * 256.0 + err
        v0 = round(adj)
        err = adj - v0
        taps[i] = taps[ksize - 1 - i] = v0
        total += v0
    taps[half] = 256 - 2 * total
    return tuple(taps)


def gaussian_blur_u8(img: np.ndarray, ksize: int = 5,
                     sigma: float = 3.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a 2-D uint8
    image: rows then columns in integers, rounded once at the end
    (``(v + 2^15) >> 16``), ``BORDER_REFLECT_101``."""
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError("gaussian_blur_u8 takes a 2-D uint8 image")
    k = gaussian_kernel_u8(int(ksize), float(sigma))
    r = len(k) // 2
    h, w = img.shape
    p = np.pad(img.astype(np.int64), r, mode="reflect")
    rows = sum(k[i] * p[:, i:i + w] for i in range(len(k)))
    out = sum(k[i] * rows[i:i + h] for i in range(len(k)))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)
