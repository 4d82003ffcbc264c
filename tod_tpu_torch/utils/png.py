"""PNG decoding and encoding on the standard library's ``zlib``, without
cv2.

The reference reads and writes PNG through cv2 (``cv2.imdecode`` in
tod_tpu/db/legacy.py and tools/ingest_frames.py, ``cv2.imwrite`` in its
visualize hooks). This module gives the same pixels: :func:`decode_png`
returns what ``cv2.imdecode(data, IMREAD_UNCHANGED)`` returns (or, with
``color=True``, what ``IMREAD_COLOR`` returns), channels in cv2's order
(BGR, BGRA); :func:`encode_png` writes an array as ``cv2.imwrite`` would
store it, so that ``cv2.imread`` of the file gives the array back.

cv2's rules, read off ``cv2.imdecode`` (OpenCV 5.0):

- gray of 1, 2 or 4 bits is scaled to 8 bits (x255, x85, x17); gray keeps
  one channel and ignores a ``tRNS`` key;
- palette images expand to BGR, or BGRA when a ``tRNS`` chunk is present;
- RGB with a ``tRNS`` key gains an alpha channel (0 where a pixel equals
  the key, full elsewhere);
- gray with alpha becomes BGRA, its gray copied to three channels;
- ``IMREAD_COLOR`` gives three 8-bit channels: gray is copied, alpha is
  dropped and 16-bit samples keep their high byte (``v >> 8``), and the
  image is turned upright by the EXIF orientation of an ``eXIf`` chunk
  (``utils/exif.py``; ``IMREAD_UNCHANGED`` keeps the stored pixels).

Every filter type and Adam7 interlacing decode. Everything runs on the
host.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from tod_tpu_torch.utils.exif import apply_orientation, orientation

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Adam7 passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ZLIB_LEVEL = 1             # cv2's IMWRITE_PNG_COMPRESSION default
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


class PngError(ValueError):
    """Raised on bytes that are not a PNG this module can decode."""


def _chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    if data[:8] != SIGNATURE:
        raise PngError("not a PNG (bad signature)")
    out, pos = [], 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PngError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise PngError(f"PNG chunk {kind!r} fails its CRC")
        out.append((kind, body))
        pos += 12 + length
        if kind == b"IEND":
            return out
    raise PngError("PNG ends without an IEND chunk")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG filters of ``h`` rows of ``stride`` bytes (each
    row led by its filter byte). Sub, Average and Paeth depend on the
    pixel to the left, Up, Average and Paeth on the row above, so the
    pixels are reconstructed by anti-diagonals: every pixel of one
    diagonal needs only the two before it. The image is stored skewed
    (row y shifted right by y pixels), which makes each diagonal a column
    slice."""
    if raw.size != h * (stride + 1):
        raise PngError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise PngError(f"unknown PNG filter type {int(kinds.max())}")
    n = stride // bpp
    filt = rows[:, 1:].reshape(h, n, bpp).astype(np.int16)
    if not kinds.any():
        return rows[:, 1:].copy()
    # skewed planes: column d + 2 of row y + 1 holds pixel (y, d - y); row 0
    # and the two leading columns are the zeros that precede the image
    width = h + n + 2
    skew_f = np.zeros((h + 1, width, bpp), np.int16)
    for y in range(h):
        skew_f[y + 1, y + 2:y + 2 + n] = filt[y]
    out = np.zeros_like(skew_f)
    kind = kinds.astype(np.int16)[:, None]
    masks = [kind == k for k in range(1, 5)]
    for d in range(h + n - 1):
        top = min(h, d + 1)                     # rows 0..top-1 have x >= 0
        col = d + 2
        a = out[1:top + 1, col - 1]             # left
        b = out[0:top, col - 1]                 # above
        c = out[0:top, col - 2]                 # above left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        m = [mk[:top] for mk in masks]
        pred = np.select(m, [a, b, (a + b) >> 1, paeth], 0)
        out[1:top + 1, col] = (skew_f[1:top + 1, col] + pred) & 255
    pix = np.empty((h, n, bpp), np.uint8)
    for y in range(h):
        pix[y] = out[y + 1, y + 2:y + 2 + n]
    return pix.reshape(h, stride)


def _samples(rows: np.ndarray, w: int, channels: int,
             depth: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, w, channels) samples (uint8, or
    uint16 from big-endian 16-bit data)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, w, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _decode_pixels(idat: bytes, w: int, h: int, channels: int, depth: int,
                   interlaced: bool) -> np.ndarray:
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as err:
        raise PngError(f"PNG image data does not inflate: {err}") from err
    bits_pp = channels * depth
    bpp = max(1, bits_pp // 8)
    if not interlaced:
        stride = (w * bits_pp + 7) // 8
        return _samples(_unfilter(raw, h, stride, bpp), w, channels, depth)
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (w - x0 + dx - 1) // dx if w > x0 else 0
        ph = (h - y0 + dy - 1) // dy if h > y0 else 0
        if pw == 0 or ph == 0:
            continue
        stride = (pw * bits_pp + 7) // 8
        size = ph * (stride + 1)
        sub = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(sub, pw, channels, depth)
        pos += size
    if pos != raw.size:
        raise PngError("interlaced PNG image data has the wrong size")
    return out


def decode_png(data: bytes, color: bool = False) -> np.ndarray:
    """The pixels of a PNG as ``cv2.imdecode`` gives them:
    ``IMREAD_UNCHANGED`` by default ((H, W) gray, (H, W, 3) BGR or
    (H, W, 4) BGRA; uint8 or uint16), ``IMREAD_COLOR`` with ``color``
    ((H, W, 3) uint8 BGR, the EXIF orientation applied). Raises
    :class:`PngError` on anything else."""
    chunks = _chunks(bytes(data))
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise PngError("PNG does not start with an IHDR chunk")
    w, h, depth, ctype, method, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PngError(f"PNG colour type {ctype} at bit depth {depth} is "
                       "not valid")
    if method != 0 or filt != 0 or interlace not in (0, 1) or not w or not h:
        raise PngError("PNG header names an unknown method or an empty "
                       "image")
    extra: Dict[bytes, bytes] = {}
    idat = []
    for kind, body in chunks[1:]:
        if kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS"):
            extra[kind] = body
    if not idat:
        raise PngError("PNG has no image data")
    channels = _CHANNELS[ctype]
    pix = _decode_pixels(b"".join(idat), w, h, channels, depth,
                         interlace == 1)
    full = 65535 if depth == 16 else 255
    if ctype == 0:
        gray = pix[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        img = gray
    elif ctype == 3:
        plte = np.frombuffer(extra.get(b"PLTE", b""), np.uint8).reshape(-1, 3)
        idx = pix[..., 0]
        if not len(plte) or idx.max() >= len(plte):
            raise PngError("PNG palette index is out of the palette")
        img = plte[idx][..., ::-1]
        if b"tRNS" in extra:
            alpha = np.full(len(plte), 255, np.uint8)
            trns = np.frombuffer(extra[b"tRNS"], np.uint8)[:len(plte)]
            alpha[:len(trns)] = trns
            img = np.concatenate([img, alpha[idx][..., None]], -1)
    elif ctype == 2:
        img = pix[..., ::-1]
        if b"tRNS" in extra and len(extra[b"tRNS"]) == 6:
            key = np.asarray(struct.unpack(">HHH", extra[b"tRNS"]))
            hit = (pix.astype(np.int64) == key).all(-1)
            alpha = np.where(hit, 0, full).astype(pix.dtype)
            img = np.concatenate([img, alpha[..., None]], -1)
    elif ctype == 4:
        img = np.concatenate([np.repeat(pix[..., :1], 3, -1), pix[..., 1:]],
                             -1)
    else:
        img = np.concatenate([pix[..., 2::-1], pix[..., 3:]], -1)
    if color:
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        img = img[..., :3]
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        img = apply_orientation(img, orientation(data))
    return np.ascontiguousarray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of ``image`` as ``cv2.imencode('.png', image)`` would store
    it: (H, W) uint8 or uint16 gray, or (H, W, 3) uint8 in cv2's BGR order
    (the file holds RGB). Rows are unfiltered, deflated at cv2's default
    zlib level."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, img.dtype.itemsize * 8
        rows = img.astype(">u2") if depth == 16 else img
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        ctype, depth = 2, 8
        rows = img[..., ::-1]
    else:
        raise PngError(f"cannot write a PNG of shape {img.shape} and dtype "
                       f"{img.dtype} (8-bit gray or BGR, 16-bit gray)")
    h, w = img.shape[:2]
    body = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body], 1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """``cv2.imwrite(path, image)`` for the arrays :func:`encode_png`
    takes."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str, color: bool = False) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED or IMREAD_COLOR)`` of a PNG
    file (:func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), color=color)
