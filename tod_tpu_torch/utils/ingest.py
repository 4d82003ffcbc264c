"""Real-capture ingest: an RGB-D recording as DatasetSource ``.npz`` frames
(tools/ingest_frames.py).

The frame source (``cells/io.py DatasetSource``) reads a directory of
``.npz`` files, each with ``image`` (H,W,3 u8 RGB), ``depth`` (H,W u16
millimeters) and ``K`` (3,3 f32). This turns a recording into such a
directory:

* **TUM RGB-D** (``--format tum``): ``rgb.txt``/``depth.txt`` timestamped
  file lists with ``rgb/*.png`` (8-bit color) and ``depth/*.png`` (16-bit,
  5000 units/m), pairs associated by nearest timestamp within
  ``--max-dt``; intrinsics default to the freiburg Kinect calibration
  (525.0, 525.0, 319.5, 239.5).
* **Paired directory** (``--format pairs``): sorted color/depth images
  selected by ``--rgb-glob`` / ``--depth-glob``; ``--depth-scale`` gives the
  recorder's depth units per meter (default 1000).

Images are read as ``cv2.imread`` reads them (``utils/png.py``,
``utils/jpeg.py``): the color image as ``IMREAD_COLOR`` (its EXIF
orientation applied, gray copied to three channels), then RGB; the depth
image as ``IMREAD_UNCHANGED``.

Usage:
  python -m tod_tpu_torch.cli ingest --format tum <recording_dir> <out_dir>
  python -m tod_tpu_torch.cli ingest --format pairs <recording_dir> \\
      <out_dir> --rgb-glob 'color_*.png' --depth-glob 'depth_*.png' \\
      --fx 612.1 --fy 612.0 --cx 318.6 --cy 242.0 --depth-scale 1000
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from tod_tpu_torch.utils.jpeg import JpegError, decode_jpeg
from tod_tpu_torch.utils.png import SIGNATURE, PngError, decode_png


def _imread(path: str, color: bool, what: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR or IMREAD_UNCHANGED)`` for a PNG
    or a JPEG; an unreadable file stops the tool."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        data = b""
    if data[:2] == b"\xff\xd8":
        decode, error = decode_jpeg, JpegError
    elif data[:8] == SIGNATURE:
        decode, error = decode_png, PngError
    else:
        raise SystemExit(f"unreadable {what} image: {path}")
    try:
        return decode(data, color=color)
    except error as err:
        raise SystemExit(f"unreadable {what} image: {path} ({err})") \
            from None


def _imread_rgb(path: str) -> np.ndarray:
    return np.ascontiguousarray(_imread(path, True, "color")[..., ::-1])


def _imread_depth(path: str, units_per_m: float) -> np.ndarray:
    d = _imread(path, False, "depth")
    if d.ndim != 2:
        raise SystemExit(f"depth image is not single-channel: {path}")
    # -> u16 millimeters (the DatasetSource/to_metric_depth contract;
    # 0 stays 0 = invalid)
    mm = d.astype(np.float64) * (1000.0 / units_per_m)
    return np.clip(np.rint(mm), 0, 65535).astype(np.uint16)


def _read_tum_list(path: str):
    """TUM list file: '# comment' lines then 'timestamp filename'."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, _, fname = line.partition(" ")
            out.append((float(ts), fname.strip()))
    return out


def _associate(rgb, depth, max_dt: float):
    """Nearest-timestamp association (TUM associate.py semantics: greedy
    best-pair within max_dt, each frame used once)."""
    cands = sorted(
        ((abs(ta - tb), i, j) for i, (ta, _) in enumerate(rgb)
         for j, (tb, _) in enumerate(depth) if abs(ta - tb) <= max_dt))
    used_a, used_b, pairs = set(), set(), []
    for _dt, i, j in cands:
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((i, j))
    pairs.sort()
    return pairs


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("src", help="recording directory")
    ap.add_argument("out", help="output frame directory")
    ap.add_argument("--format", choices=("tum", "pairs"), default="tum")
    ap.add_argument("--rgb-glob", default="color_*.png")
    ap.add_argument("--depth-glob", default="depth_*.png")
    ap.add_argument("--depth-scale", type=float, default=None,
                    help="depth units per meter (default: 5000 for tum, "
                         "1000 for pairs)")
    ap.add_argument("--max-dt", type=float, default=0.02,
                    help="tum: max rgb/depth timestamp gap (s)")
    ap.add_argument("--fx", type=float, default=525.0)
    ap.add_argument("--fy", type=float, default=525.0)
    ap.add_argument("--cx", type=float, default=319.5)
    ap.add_argument("--cy", type=float, default=239.5)
    ap.add_argument("--limit", type=int, default=0,
                    help="stop after this many frames (0 = all)")


def ingest(args: argparse.Namespace) -> int:
    """Write the recording's frames; returns how many."""
    units = args.depth_scale or (5000.0 if args.format == "tum" else 1000.0)
    K = np.asarray([[args.fx, 0.0, args.cx],
                    [0.0, args.fy, args.cy],
                    [0.0, 0.0, 1.0]], np.float32)

    if args.format == "tum":
        rgb = _read_tum_list(os.path.join(args.src, "rgb.txt"))
        dep = _read_tum_list(os.path.join(args.src, "depth.txt"))
        pairs = _associate(rgb, dep, args.max_dt)
        if not pairs:
            raise SystemExit("no rgb/depth pairs within --max-dt")
        items = [(os.path.join(args.src, rgb[i][1]),
                  os.path.join(args.src, dep[j][1])) for i, j in pairs]
    else:
        rgbs = sorted(glob.glob(os.path.join(args.src, args.rgb_glob)))
        deps = sorted(glob.glob(os.path.join(args.src, args.depth_glob)))
        if not rgbs or len(rgbs) != len(deps):
            raise SystemExit(
                f"pair mismatch: {len(rgbs)} color vs {len(deps)} depth "
                f"({args.rgb_glob} / {args.depth_glob})")
        items = list(zip(rgbs, deps))

    if args.limit:
        items = items[:args.limit]
    os.makedirs(args.out, exist_ok=True)
    for n, (rp, dp) in enumerate(items):
        image = _imread_rgb(rp)
        depth = _imread_depth(dp, units)
        if image.shape[:2] != depth.shape:
            raise SystemExit(
                f"frame {n}: color {image.shape[:2]} vs depth "
                f"{depth.shape} size mismatch (register/rescale the "
                "recording first)")
        np.savez(os.path.join(args.out, f"frame_{n:06d}.npz"),
                 image=image, depth=depth, K=K)
    print(f"wrote {len(items)} frames -> {args.out}")
    return len(items)
