"""EXIF orientation as ``cv2.imread``/``cv2.imdecode`` apply it (host only).

cv2 reads the orientation tag (0x0112) of a file's EXIF block, a JPEG's
APP1 ``Exif\\0\\0`` segment or a PNG's ``eXIf`` chunk (a TIFF header of
either byte order, then IFD0), and under ``IMREAD_COLOR`` turns the decoded
pixels upright (OpenCV's ``ExifTransform``); ``IMREAD_UNCHANGED`` keeps
them as stored. A missing, unreadable or out-of-range tag leaves the image
as it is.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

ORIENTATION_TAG = 0x0112


def tiff_orientation(tiff: bytes) -> int:
    """The orientation (1-8) in a TIFF-structured EXIF block, or 1."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(end + "H", tiff[2:4])[0] != 42:
        return 1
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    count = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, kind = struct.unpack(end + "HH", tiff[at:at + 4])
        if tag == ORIENTATION_TAG and kind == 3:      # SHORT
            value = struct.unpack(end + "H", tiff[at + 8:at + 10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def jpeg_exif(data: bytes) -> Optional[bytes]:
    """The TIFF block of a JPEG's first APP1 ``Exif\\0\\0`` segment."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:                # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):        # image data: no more headers
            return None
        size = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + size]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + size
    return None


def png_exif(data: bytes) -> Optional[bytes]:
    """The body of a PNG's first ``eXIf`` chunk (cv2 reads one after the
    image data too)."""
    pos = 8
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IEND":
            return None
        if kind == b"eXIf":
            return data[pos + 8:pos + 8 + size]
        pos += 12 + size
    return None


def orientation(data: bytes) -> int:
    """The EXIF orientation of a JPEG or PNG file's bytes (1 if none)."""
    if data[:2] == b"\xff\xd8":
        tiff = jpeg_exif(data)
    elif data[:8] == b"\x89PNG\r\n\x1a\n":
        tiff = png_exif(data)
    else:
        tiff = None
    return tiff_orientation(tiff) if tiff else 1


def apply_orientation(image: np.ndarray, value: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: the stored pixels turned upright for
    orientation ``value`` (2 flips columns, 3 both, 4 rows; 5-8 transpose
    first, then 6 flips columns, 7 both, 8 rows)."""
    img = image
    if value >= 5:
        img = np.swapaxes(img, 0, 1)
    if value in (2, 3, 6, 7):
        img = img[:, ::-1]
    if value in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
