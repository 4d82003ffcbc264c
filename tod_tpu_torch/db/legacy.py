"""Reference-era cv::Mat attachments, decoded and encoded without cv2
(tod_tpu/db/legacy.py).

A reference-era database (object_recognition_core's trained models and
capture observations) stores its binary attachments as core's
``Document::set_attachment<cv::Mat>`` writes them: an OpenCV FileStorage
document holding a named matrix map (YAML or XML, zlib-deflated on the
wire), observation imagery as PNG (or JPEG), and in older exports a raw
``rows, cols, type, data`` header. :func:`decode_legacy_mat` sniffs and
decodes each of them into a numpy array, as the reference does through
cv2, so that such a database loads as it stands (``Document.decode_array``
falls back to it) or is rewritten once (``python -m tod_tpu_torch.cli
migrate``). :func:`encode_legacy_mat` writes core's format, byte for byte
the text cv2's FileStorage writes.

The FileStorage reader is this module's own: it reads the
``!!opencv-matrix`` (and ``!!opencv-nd-matrix``) maps of a YAML document
(``%YAML 1.2`` as OpenCV 5 writes it, ``%YAML:1.0`` as older OpenCV did)
and the ``type_id="opencv-matrix"`` elements of an XML one. PNG goes
through ``utils/png.py``, JPEG through ``utils/jpeg.py`` (both as
``cv2.imdecode(..., IMREAD_UNCHANGED)``).

Kept as the reference has them: a 3-channel PNG or JPEG comes back RGB (cv2
decodes BGR and the reference converts), a 4-channel one in cv2's BGRA
order.
"""

from __future__ import annotations

import io
import math
import re
import struct
import warnings
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, List, Optional

import numpy as np

from tod_tpu_torch.utils.jpeg import JpegError, decode_jpeg
from tod_tpu_torch.utils.png import PngError, decode_png

# cv::Mat depth code -> numpy dtype (CV_8U..CV_64F)
_CV_DEPTH_TO_DTYPE = {
    0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
    4: np.int32, 5: np.float32, 6: np.float64,
}
# FileStorage's ``dt`` letters
_DT_TO_DTYPE = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
                "i": np.int32, "f": np.float32, "d": np.float64}
_DTYPE_TO_DT = {np.dtype(v): k for k, v in _DT_TO_DTYPE.items()}
_WRAP_MARGIN = 71          # FileStorage's flow-sequence line width
_FLOW_INDENT = 7           # a matrix's wrapped ``data`` lines


class LegacyDecodeError(ValueError):
    """Raised when bytes match none of the known legacy attachment formats."""


def _try_inflate(data: bytes) -> Optional[bytes]:
    """Undo the zlib/gzip deflate core's attachment streams apply (raw
    deflate, zlib-wrapped, and gzip-wrapped all appear in the wild)."""
    for wbits in (zlib.MAX_WBITS, -zlib.MAX_WBITS, zlib.MAX_WBITS | 16):
        try:
            return zlib.decompress(data, wbits)
        except zlib.error:
            continue
    return None


def _matrix(dt: str, data: str, sep: str, shape: List[int]) -> np.ndarray:
    """A FileStorage matrix: ``dt`` as ``"f"`` or ``"3f"``, its data text
    (values split by ``sep``; ``.Nan``, ``.Inf`` and ``-.Inf`` for the
    specials) and its (rows, cols) or nd sizes. Floats parse as doubles
    and round to the matrix's type, as cv2's reader does."""
    dt = dt.strip().strip('"').strip("'")
    m = re.fullmatch(r"(\d*)([ucwsifd])", dt)
    if m is None:
        raise LegacyDecodeError(f"FileStorage matrix type {dt!r} is not "
                                "supported")
    channels = int(m.group(1) or 1)
    dtype = np.dtype(_DT_TO_DTYPE[m.group(2)])
    text = re.sub(r"\.(nan|inf)", r"\1", data, flags=re.I)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        try:
            values = np.fromstring(text, sep=sep, dtype=np.int64
                                   if dtype.kind in "iu" else np.float64)
        except (ValueError, DeprecationWarning) as err:
            raise LegacyDecodeError("FileStorage matrix data does not "
                                    "parse") from err
    count = int(np.prod(shape)) * channels
    if len(values) != count:
        raise LegacyDecodeError(f"FileStorage matrix holds {len(values)} "
                                f"values, its header says {count}")
    return values.astype(dtype).reshape(shape + ([channels] if channels > 1
                                                 else []))


def _yaml_matrices(text: str) -> Dict[str, np.ndarray]:
    """The top-level ``!!opencv-matrix`` / ``!!opencv-nd-matrix`` maps of a
    FileStorage YAML document (other top-level entries are skipped, as
    cv2's ``FileNode.mat()`` gives None for them)."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("%", "---", "..."))]
    blocks: List[List[str]] = []
    for ln in lines:
        if ln.strip() == "" or ln.lstrip().startswith("#"):
            continue
        if ln[0] not in " \t":
            blocks.append([ln])
        elif blocks:
            blocks[-1].append(ln)
    out: Dict[str, np.ndarray] = {}
    for block in blocks:
        head = re.match(r"""\s*("[^"]*"|'[^']*'|[^:]+):\s*(.*)$""", block[0])
        if head is None:
            raise LegacyDecodeError("FileStorage failed to parse stream")
        name = head.group(1).strip().strip("\"'")
        tag = head.group(2).strip()
        if tag.startswith("!!opencv-matrix"):
            nd = False
        elif tag.startswith("!!opencv-nd-matrix"):
            nd = True
        else:
            continue
        body = "\n".join([tag[len("!!opencv-nd-matrix" if nd
                                  else "!!opencv-matrix"):]] + block[1:])
        fields = {}
        for key in ("rows", "cols", "dt"):
            m = re.search(rf"\b{key}:\s*([^\s,}}]+)", body)
            if m:
                fields[key] = m.group(1)
        data = re.search(r"\bdata:\s*\[(.*?)\]", body, re.S)
        sizes = re.search(r"\bsizes:\s*\[(.*?)\]", body, re.S)
        if "dt" not in fields or data is None:
            raise LegacyDecodeError("FileStorage failed to parse stream")
        if nd:
            if sizes is None:
                raise LegacyDecodeError("FileStorage failed to parse stream")
            shape = [int(s) for s in sizes.group(1).split(",") if s.strip()]
        else:
            if "rows" not in fields or "cols" not in fields:
                raise LegacyDecodeError("FileStorage failed to parse stream")
            shape = [int(fields["rows"]), int(fields["cols"])]
        if 0 in shape:
            continue                      # cv2 reads an empty Mat as None
        out[name] = _matrix(fields["dt"], data.group(1), ",", shape)
    return out


def _xml_matrices(text: str) -> Dict[str, np.ndarray]:
    """The ``type_id="opencv-matrix"`` (and nd) children of a FileStorage
    XML document's ``<opencv_storage>``."""
    try:
        root = ET.fromstring(text)
    except ET.ParseError as err:
        raise LegacyDecodeError("FileStorage failed to parse stream") from err
    out: Dict[str, np.ndarray] = {}
    for node in root:
        kind = node.get("type_id")
        if kind not in ("opencv-matrix", "opencv-nd-matrix"):
            continue
        get = {child.tag: (child.text or "") for child in node}
        if kind == "opencv-nd-matrix":
            shape = [int(s) for s in get.get("sizes", "").split()]
        else:
            shape = [int(get.get("rows", 0)), int(get.get("cols", 0))]
        if 0 in shape or not shape:
            continue
        out[node.tag] = _matrix(get.get("dt", ""), get.get("data", ""), " ",
                                shape)
    return out


def _decode_filestorage(text: str) -> Dict[str, np.ndarray]:
    """Parse an OpenCV FileStorage YAML/XML document into {name: array}."""
    stripped = text.lstrip()
    mats = (_xml_matrices(stripped) if stripped.startswith("<?xml")
            else _yaml_matrices(stripped))
    if not mats:
        raise LegacyDecodeError("FileStorage stream holds no matrices")
    return mats


def _decode_raw_header(data: bytes) -> np.ndarray:
    """Raw binary export: int32 rows, int32 cols, int32 type, then the
    contiguous pixel data (mat.step * rows bytes)."""
    if len(data) < 12:
        raise LegacyDecodeError("too short for a raw cv::Mat header")
    rows, cols, mtype = struct.unpack("<iii", data[:12])
    depth, channels = mtype & 7, (mtype >> 3) + 1
    dtype = _CV_DEPTH_TO_DTYPE.get(depth)
    if dtype is None or not (0 < rows < 10 ** 8) or not (0 < cols < 10 ** 8) \
            or not (1 <= channels <= 512):
        raise LegacyDecodeError("implausible raw cv::Mat header")
    need = rows * cols * channels * np.dtype(dtype).itemsize
    if len(data) - 12 < need:
        raise LegacyDecodeError("raw cv::Mat data truncated")
    arr = np.frombuffer(data[12:12 + need], dtype=dtype).reshape(
        rows, cols, channels)
    return arr[..., 0] if channels == 1 else arr


def decode_legacy_mat(data: bytes, prefer: str = "data") -> np.ndarray:
    """Decode one legacy attachment blob into a numpy array.

    Sniffing order: npy (already native), PNG/JPEG imagery, deflated or
    plain FileStorage YAML/XML (core's cv::Mat serialization; the matrix
    map's ``prefer`` key wins, else the single matrix present), raw
    rows/cols/type binary."""
    if data[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if data[:2] == b"\xff\xd8" or data[:8] == b"\x89PNG\r\n\x1a\n":
        jpeg = data[:2] == b"\xff\xd8"
        try:
            arr = decode_jpeg(data) if jpeg else decode_png(data)
        except (JpegError, PngError) as err:
            raise LegacyDecodeError(
                f"{'JPEG' if jpeg else 'PNG'} blob does not decode: {err}") \
                from err
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = np.ascontiguousarray(arr[..., ::-1])  # BGR -> RGB
        return arr
    candidates = [data]
    inflated = _try_inflate(data)
    if inflated is not None:
        candidates.insert(0, inflated)
    for blob in candidates:
        head = blob[:64].lstrip()
        if head.startswith(b"%YAML") or head.startswith(b"<?xml"):
            mats = _decode_filestorage(blob.decode("utf-8", "replace"))
            if prefer in mats:
                return mats[prefer]
            if len(mats) == 1:
                return next(iter(mats.values()))
            raise LegacyDecodeError(
                f"FileStorage map has keys {sorted(mats)}; none is "
                f"{prefer!r} and the choice is ambiguous")
    for blob in candidates:
        try:
            return _decode_raw_header(blob)
        except LegacyDecodeError:
            continue
    raise LegacyDecodeError("unrecognized legacy attachment format")


def _format_value(value, dtype: np.dtype) -> str:
    """One matrix entry as FileStorage writes it: integers as ``%d``;
    floats that are int32 integers as ``%d.``, others as ``%.9g`` (f32) or
    ``%.17g`` (f64), and ``.Nan``, ``.Inf``, ``-.Inf``."""
    if dtype.kind in "iu":
        return str(int(value))
    v = float(value)
    if math.isnan(v):
        return ".Nan"
    if math.isinf(v):
        return ".Inf" if v > 0 else "-.Inf"
    if -2 ** 31 <= v < 2 ** 31 and v == int(v):
        return f"{int(v)}."
    return ("%.9g" if dtype == np.float32 else "%.17g") % v


def encode_legacy_mat(array: np.ndarray, name: str = "data",
                      compress: bool = True) -> bytes:
    """Produce bytes in core's cv::Mat attachment format (FileStorage YAML
    of a one-entry matrix map, zlib-deflated): the text cv2's FileStorage
    writes for ``array`` (1-D arrays as one row; a 3-D array's last axis
    as its channels)."""
    arr = np.asarray(array)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim not in (2, 3) or arr.dtype not in _DTYPE_TO_DT:
        raise ValueError(f"cannot write a cv::Mat of shape {arr.shape} and "
                         f"dtype {arr.dtype}")
    channels = arr.shape[2] if arr.ndim == 3 else 1
    dt = _DTYPE_TO_DT[arr.dtype]
    dt = f'"{channels}{dt}"' if channels > 1 else dt
    lines = ["%YAML 1.2", "---", f"{name}: !!opencv-matrix",
             f"   rows: {arr.shape[0]}", f"   cols: {arr.shape[1]}",
             f"   dt: {dt}"]
    line = "   data: ["
    values = arr.reshape(-1)
    for i, value in enumerate(values.tolist()):
        text = _format_value(value, arr.dtype)
        if i:
            line += ","
        if len(line) + len(text) > _WRAP_MARGIN \
                and len(line) + len(text) - _FLOW_INDENT > 10:
            lines.append(line)
            line = " " * _FLOW_INDENT + text
        else:
            line += " " + text
    line += " ]" if values.size else "]"
    lines.append(line)
    raw = ("\n".join(lines) + "\n").encode()
    return zlib.compress(raw) if compress else raw
