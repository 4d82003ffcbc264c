"""The port's PNG reader and writer (tod_tpu_torch/utils/png.py) against
cv2, which the reference decodes and writes PNG with: every colour type and
bit depth, every filter, Adam7, palette and tRNS transparency, cv2's own
files, and the ``IMREAD_UNCHANGED`` / ``IMREAD_COLOR`` read modes."""

import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from tod_tpu_torch.utils import png as tpng

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp, rng):
    """Each row of (h, stride) bytes under a random filter type."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        kind = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) // 2,
                _paeth(left, prior, upleft)][kind]
        out.append(bytes([kind]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _pack(samples, depth):
    """(h, w*ch) samples -> (h, stride) bytes at ``depth`` bits."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(
            samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(samples.shape[0], -1).astype(np.uint8),
                       axis=1)


def make_png(samples, ctype, depth, rng, interlace=False, plte=None,
             trns=None):
    """A PNG of (h, w, ch) samples, rows filtered at random."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        parts = []
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                parts.append(_filter_rows(
                    _pack(sub.reshape(sub.shape[0], -1), depth), bpp, rng))
        raw = b"".join(parts)
    else:
        raw = _filter_rows(_pack(samples.reshape(h, -1), depth), bpp, rng)
    extra = b""
    if plte is not None:
        extra += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        extra += _chunk(b"tRNS", trns)
    return (tpng.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def _cv2(data, mode):
    return cv2.imdecode(np.frombuffer(data, np.uint8), mode)


def _assert_as_cv2(data):
    for color, mode in ((False, cv2.IMREAD_UNCHANGED),
                        (True, cv2.IMREAD_COLOR)):
        want = _cv2(data, mode)
        got = tpng.decode_png(data, color=color)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            color, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


CASES = [(ctype, depth) for ctype, depths in tpng._DEPTHS.items()
         for depth in depths]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_decodes_every_colour_type_and_depth_as_cv2(ctype, depth, interlace):
    """Random samples, every filter, odd sizes (Adam7 passes of every
    width, empty passes included), as both of cv2's read modes."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in ((1, 1), (3, 5), (13, 17), (33, 9)):
        plte = None
        if ctype == 3:
            n = int(rng.integers(1, 1 << depth)) + 1
            plte = rng.integers(0, 256, (n, 3))
            samples = rng.integers(0, n, (h, w, 1))
        else:
            samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
        _assert_as_cv2(make_png(samples, ctype, depth, rng, interlace,
                                plte))


@pytest.mark.parametrize("ctype,depth", [(3, 8), (3, 2), (2, 8), (2, 16),
                                         (0, 8), (0, 16), (0, 4)])
def test_trns_transparency_as_cv2(ctype, depth):
    """A palette's tRNS adds alpha (entries past it opaque); an RGB key
    adds alpha where a pixel equals it; a gray key is ignored."""
    rng = np.random.default_rng(depth)
    h, w = 6, 7
    if ctype == 3:
        n = min(6, 1 << depth)
        plte = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (h, w, 1))
        trns = bytes(rng.integers(0, 256, n - 1).astype(np.uint8))
    else:
        plte = None
        samples = rng.integers(0, 4, (h, w, CHANNELS[ctype]))
        trns = struct.pack(">" + "H" * CHANNELS[ctype],
                           *samples[0, 0].tolist())
    _assert_as_cv2(make_png(samples, ctype, depth, rng, plte=plte,
                            trns=trns))


@pytest.mark.parametrize("level,strategy", [(1, 0), (3, 0), (9, 0), (1, 1),
                                            (6, 3)])
def test_decodes_cv2_files(level, strategy):
    """What cv2 writes (its adaptive filters, its zlib settings) for
    every array it is given in the reference: BGR, BGRA, 8 and 16-bit
    gray, a VGA frame and tiny ones."""
    rng = np.random.default_rng(level)
    params = [cv2.IMWRITE_PNG_COMPRESSION, level,
              cv2.IMWRITE_PNG_STRATEGY, strategy]
    frame = rng.integers(0, 256, (480, 640, 3), np.uint8)
    frame[100:200] = 40
    for img in (frame, frame[..., 0], frame[:7, :5],
                rng.integers(0, 256, (9, 11, 4), np.uint8),
                rng.integers(0, 65536, (31, 29), np.uint16),
                rng.integers(0, 65536, (4, 6, 3), np.uint16)):
        ok, data = cv2.imencode(".png", img, params)
        assert ok
        _assert_as_cv2(data.tobytes())


def test_color_mode_keeps_the_high_byte_of_16_bit():
    """IMREAD_COLOR's 16 -> 8 rule, on every 16-bit value."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    data = cv2.imencode(".png", v)[1].tobytes()
    got = tpng.decode_png(data, color=True)
    np.testing.assert_array_equal(got[..., 0], (v >> 8).astype(np.uint8))
    _assert_as_cv2(data)


@pytest.mark.parametrize("kind", ["gray8", "bgr", "gray16", "gray8_1ch"])
def test_writer_round_trips_through_cv2(kind, tmp_path):
    """encode_png / write_png give what cv2.imencode / imwrite store:
    cv2.imread of the file is the array (a BGR array's file holds RGB)."""
    rng = np.random.default_rng(5)
    img = {"gray8": rng.integers(0, 256, (37, 41), np.uint8),
           "bgr": rng.integers(0, 256, (37, 41, 3), np.uint8),
           "gray16": rng.integers(0, 65536, (37, 41), np.uint16),
           "gray8_1ch": rng.integers(0, 256, (5, 3, 1), np.uint8)}[kind]
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    path = str(tmp_path / "x.png")
    tpng.write_png(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  want)
    np.testing.assert_array_equal(tpng.read_png(path), want)
    ref = str(tmp_path / "ref.png")
    cv2.imwrite(ref, img)
    np.testing.assert_array_equal(tpng.read_png(ref), want)
    np.testing.assert_array_equal(tpng.read_png(path, color=True),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_writer_refuses_what_it_cannot_write():
    for bad in (np.zeros((2, 2), np.float32), np.zeros((2, 2, 4), np.uint8),
                np.zeros((2, 2, 3), np.uint16), np.zeros(4, np.uint8)):
        with pytest.raises(tpng.PngError):
            tpng.encode_png(bad)


def test_malformed_pngs_raise_png_error():
    good = tpng.encode_png(np.arange(12, dtype=np.uint8).reshape(3, 4))
    bad_crc = bytearray(good)
    bad_crc[30] ^= 1                          # inside IHDR's body
    for data in (b"not a png at all", good[:-12], bytes(bad_crc),
                 good[:8] + good[33:]):
        with pytest.raises(tpng.PngError):
            tpng.decode_png(data)
    rng = np.random.default_rng(0)
    wide = make_png(rng.integers(0, 4, (2, 3, 1)), 3, 8, rng,
                    plte=np.zeros((2, 3), np.int64))
    with pytest.raises(tpng.PngError, match="palette"):
        tpng.decode_png(wide)


NO_CV2 = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
from tod_tpu_torch.utils import png
img = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)
assert np.array_equal(png.decode_png(png.encode_png(img)), img)
print("OK")
"""


def test_reads_and_writes_without_cv2():
    out = subprocess.run([sys.executable, "-c", NO_CV2], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
