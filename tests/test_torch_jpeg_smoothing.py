"""The port's JPEG decoder (tod_tpu_torch/utils/jpeg.py) on progressive
files whose last scans are missing, which libjpeg-turbo block-smooths
(``jdcoefct.c decompress_smooth_data``), bit for bit against
``cv2.imdecode`` under ``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``: every
prefix of the scans of cv2's progressive files at every sampling it
writes and gray, at sizes off the MCU grid; two subsets that are not
prefixes (no DC refinement; no chroma refinements); the legacy DB's
decoder of both packages on the same blobs; and the same cuts without
their EOI, which both refuse."""

import struct

import cv2
import numpy as np
import pytest

from tod_tpu.db import legacy as rleg
from tod_tpu_torch.db import legacy as tleg
from tod_tpu_torch.utils.jpeg import JpegError, decode_jpeg

SAMPLINGS = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "gray": None,
}
# 47 x 61 as in the first reading of the fault; the others off the MCU
# grid: 17 x 23 has two iMCU rows with one block row in the last (4:2:0
# and 4:4:0 luma), 61 x 3 one block column, 33 x 61 two chroma block
# columns at 4:1:1
SIZES = [(47, 61), (17, 23), (33, 61), (61, 3)]


def _image(rng, h, w, channels=3):
    """Smooth content plus noise: every coefficient band is used."""
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, channels)) \
        .astype(np.float32)
    up = cv2.resize(base, (w, h)).reshape(h, w, channels)
    img = np.clip(up + rng.normal(0, 8, (h, w, channels)), 0, 255)
    return img.astype(np.uint8)[..., 0] if channels == 1 \
        else img.astype(np.uint8)


def progressive_file(sampling: str, h: int, w: int, seed: int = 0,
                     quality: int = 90) -> bytes:
    """cv2's progressive encoding of a seeded image."""
    rng = np.random.default_rng(seed)
    img = _image(rng, h, w, 1 if sampling == "gray" else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if SAMPLINGS[sampling] is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def scan_units(data: bytes):
    """``(header, units)``: the bytes before the first scan's tables, and
    each scan with the marker segments (its Huffman tables) before it,
    so that ``header + b"".join(units) + EOI`` is the file."""
    pos, start, units, header = 2, None, [], None
    while data[pos + 1] != 0xD9:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        size = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker in (0xC4, 0xDA) and start is None:
            start = pos
            header = data[:pos] if header is None else header
        pos += 2 + size
        if marker == 0xDA:              # the entropy-coded data
            while not (data[pos] == 0xFF and data[pos + 1] != 0
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            units.append(data[start:pos])
            start = None
    assert header + b"".join(units) + b"\xff\xd9" == data
    return header, units


def cut(data: bytes, keep, eoi: bool = True) -> bytes:
    """The file with only the scans ``keep`` (indices), closed by EOI."""
    header, units = scan_units(data)
    body = header + b"".join(units[i] for i in keep)
    return body + b"\xff\xd9" if eoi else body


def _same_as_cv2(data: bytes) -> None:
    for flag, color in ((cv2.IMREAD_UNCHANGED, False),
                        (cv2.IMREAD_COLOR, True)):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        assert ref is not None
        got = decode_jpeg(data, color=color)
        assert got.dtype == np.uint8 and got.shape == ref.shape, color
        np.testing.assert_array_equal(got, ref)


def _legacy_same(data: bytes) -> None:
    ref = rleg.decode_legacy_mat(data)
    got = tleg.decode_legacy_mat(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_every_prefix_matches_cv2(sampling, size):
    """Every cut after k scans (k = 1 .. all but one) decodes to cv2's
    pixels, in both packages' legacy decoders too; the complete file
    (not smoothed) as well."""
    data = progressive_file(sampling, *size)
    n = len(scan_units(data)[1])
    assert n == (6 if sampling == "gray" else 10)
    for k in range(1, n + 1):
        blob = cut(data, range(k))
        _same_as_cv2(blob)
        _legacy_same(blob)


@pytest.mark.parametrize("sampling", ["444", "420", "411"])
def test_subsets_that_are_not_prefixes(sampling):
    """All scans but the DC refinement (the seventh), and all but the two
    chroma refinements (the eighth and ninth: chroma stays one bit short,
    each estimate capped at 1)."""
    for size in SIZES:
        data = progressive_file(sampling, *size, seed=1)
        for drop in ({6}, {7, 8}):
            blob = cut(data, [i for i in range(10) if i not in drop])
            _same_as_cv2(blob)
            _legacy_same(blob)


def test_gray_subset_without_dc_refinement():
    for size in SIZES:
        data = progressive_file("gray", *size, seed=2)
        blob = cut(data, [0, 1, 2, 3, 5])
        _same_as_cv2(blob)
        _legacy_same(blob)


@pytest.mark.parametrize("sampling", ["420", "gray"])
def test_cuts_without_eoi_fail_in_both(sampling):
    """Without its EOI a cut is refused by cv2 (None) and by both legacy
    decoders, and ``decode_jpeg`` raises."""
    data = progressive_file(sampling, 47, 61)
    n = len(scan_units(data)[1])
    for k in range(1, n):
        blob = cut(data, range(k), eoi=False)
        assert cv2.imdecode(np.frombuffer(blob, np.uint8),
                            cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(JpegError):
            decode_jpeg(blob)
        with pytest.raises(rleg.LegacyDecodeError):
            rleg.decode_legacy_mat(blob)
        with pytest.raises(tleg.LegacyDecodeError):
            tleg.decode_legacy_mat(blob)


def test_quality_and_restart_intervals():
    """Coarser quantisers (q 50, estimates past the one-bit cap) and a
    restart interval every MCU, at VGA-like content widths."""
    for quality in (50, 98):
        data = progressive_file("420", 40, 160, seed=3, quality=quality)
        for k in (1, 2, 5, 9):
            _same_as_cv2(cut(data, range(k)))
    rng = np.random.default_rng(4)
    ok, buf = cv2.imencode(".jpg", _image(rng, 33, 61), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    assert ok
    for k in range(1, 10):
        _same_as_cv2(cut(buf.tobytes(), range(k)))


def test_no_error_names_smoothing():
    """No ``JpegError`` message of the module names block smoothing: it
    is decoded, not refused."""
    import inspect

    from tod_tpu_torch.utils import jpeg

    src = inspect.getsource(jpeg)
    for line in src.splitlines():
        if "JpegError(" in line:
            assert "smooth" not in line
