"""EXIF orientation (tod_tpu_torch/utils/exif.py) against cv2: PNG
(``eXIf`` chunk) and JPEG (APP1 ``Exif``) files of every orientation, in
both byte orders, read by ``decode_png`` / ``decode_jpeg`` under both
flags and by the ingest tool's colour read, which must equal the
reference tool's (``tools/ingest_frames.py``: ``cv2.imread(...,
IMREAD_COLOR)`` turns a rotated file upright)."""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from tod_tpu_torch.utils import exif, ingest
from tod_tpu_torch.utils.jpeg import decode_jpeg
from tod_tpu_torch.utils.png import decode_png

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import ingest_frames  # noqa: E402


def _tiff(value: int, little: bool) -> bytes:
    e = "<" if little else ">"
    head = (b"II" if little else b"MM") + struct.pack(e + "HI", 42, 8)
    ifd = (struct.pack(e + "H", 2)
           + struct.pack(e + "HHIHH", 0x010F, 3, 1, 7, 0)     # another tag
           + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
           + struct.pack(e + "I", 0))
    return head + ifd


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _files(value: int, little: bool, gray: bool = False):
    rng = np.random.default_rng(value * 2 + little)
    shape = (16, 24) if gray else (16, 24, 3)
    img = rng.integers(0, 255, shape, np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    jpg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1] \
        .tobytes()
    t = _tiff(value, little)
    end = png.index(b"IEND") - 4
    return {
        "png": png[:33] + _chunk(b"eXIf", t) + png[33:],
        "png_late": png[:end] + _chunk(b"eXIf", t) + png[end:],
        "jpeg": (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(t) + 8)
                 + b"Exif\x00\x00" + t + jpg[2:]),
    }


def _cv2(data: bytes, flag: int) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


@pytest.mark.parametrize("little", [True, False])
@pytest.mark.parametrize("value", list(range(0, 10)))
def test_decoders_apply_orientation_as_cv2(value, little):
    """Orientations 1-8 turn the ``IMREAD_COLOR`` read; 0 and 9 (out of
    range) and ``IMREAD_UNCHANGED`` keep the stored pixels."""
    for gray in (False, True):
        for kind, data in _files(value, little, gray).items():
            decode = decode_jpeg if kind == "jpeg" else decode_png
            assert exif.orientation(data) == (value if 1 <= value <= 8
                                              else 1)
            for flag, color in ((cv2.IMREAD_UNCHANGED, False),
                                (cv2.IMREAD_COLOR, True)):
                ref = _cv2(data, flag)
                got = decode(data, color=color)
                assert got.shape == ref.shape, (kind, gray, color)
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("value", [3, 6, 8])
def test_ingest_color_read_matches_reference_tool(tmp_path, kind, value):
    """The ingest tool's colour read of a rotated file equals the
    reference tool's; a PNG's failed before the port applied EXIF (it
    kept the stored 16 x 24 pixels where cv2 turns them to 24 x 16)."""
    path = tmp_path / f"color.{kind}"
    path.write_bytes(_files(value, True)[kind])
    ref = ingest_frames._imread_rgb(str(path))
    got = ingest._imread_rgb(str(path))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_depth_read_keeps_the_stored_pixels(tmp_path):
    """The depth image is read ``IMREAD_UNCHANGED``: a rotation tag does
    not turn it, in either tool."""
    depth = np.arange(16 * 24, dtype=np.uint16).reshape(16, 24) * 7
    png = cv2.imencode(".png", depth)[1].tobytes()
    path = tmp_path / "depth.png"
    path.write_bytes(png[:33] + _chunk(b"eXIf", _tiff(6, True)) + png[33:])
    ref = ingest_frames._imread_depth(str(path), 1000.0)
    got = ingest._imread_depth(str(path), 1000.0)
    assert got.shape == (16, 24)
    np.testing.assert_array_equal(got, ref)


def test_malformed_exif_is_ignored():
    """A block that is not TIFF, or whose IFD runs off its end, leaves
    the image as it is, as cv2 does."""
    img = np.random.default_rng(5).integers(0, 255, (16, 24, 3), np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    for bad in (b"XX*\x00\x08\x00\x00\x00", b"II*\x00\xff\x00\x00\x00",
                _tiff(6, True)[:14]):
        assert exif.tiff_orientation(bad) == 1
        data = png[:33] + _chunk(b"eXIf", bad) + png[33:]
        np.testing.assert_array_equal(decode_png(data, color=True),
                                      _cv2(data, cv2.IMREAD_COLOR))
