"""The port's JPEG decoder (tod_tpu_torch/utils/jpeg.py) bit for bit
against ``cv2.imdecode`` (libjpeg-turbo) under ``IMREAD_UNCHANGED`` and
``IMREAD_COLOR``: sequential and progressive files cv2 writes at every
sampling it offers, sizes off the MCU grid, restart intervals, gray,
16-bit quantisation tables, SOF1, Adobe and RGB colour transforms, fill
bytes; the bench's scene at 480 x 640; and the kinds it refuses by name."""

import struct
import time

import cv2
import numpy as np
import pytest

from tod_tpu_torch.utils.jpeg import JpegError, decode_jpeg

SAMPLINGS = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
SIZES = [(16, 16), (17, 23), (33, 61), (8, 9), (1, 1), (2, 5), (61, 3)]


def _image(rng, h, w, channels=3):
    """Smooth content plus noise: every coefficient band is used."""
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, channels)) \
        .astype(np.float32)
    up = cv2.resize(base, (w, h)).reshape(h, w, channels)
    img = np.clip(up + rng.normal(0, 8, (h, w, channels)), 0, 255)
    return img.astype(np.uint8)[..., 0] if channels == 1 \
        else img.astype(np.uint8)


def _same_as_cv2(data: bytes) -> None:
    for flag, color in ((cv2.IMREAD_UNCHANGED, False),
                        (cv2.IMREAD_COLOR, True)):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = decode_jpeg(data, color=color)
        assert got.dtype == np.uint8 and got.shape == ref.shape, color
        np.testing.assert_array_equal(got, ref)


def _encode(img, **kw) -> bytes:
    params = []
    for key, value in kw.items():
        params += [getattr(cv2, "IMWRITE_JPEG_" + key.upper()), value]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _segment(data: bytes, marker: int):
    """(start, end) of the first segment with ``marker``."""
    at = data.index(bytes([0xFF, marker]))
    size = struct.unpack(">H", data[at + 2:at + 4])[0]
    return at, at + 2 + size


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_colour_files_match_cv2(sampling, progressive):
    """Every sampling cv2 writes, at seven sizes (one pixel, sizes off
    the MCU grid), two qualities, some with restart intervals."""
    rng = np.random.default_rng(int(sampling) * 2 + progressive)
    for h, w in SIZES:
        for quality in (50, 95):
            kw = dict(quality=quality, progressive=progressive,
                      sampling_factor=SAMPLINGS[sampling])
            if rng.random() < 0.4:
                kw["rst_interval"] = int(rng.integers(1, 5))
            _same_as_cv2(_encode(_image(rng, h, w), **kw))


@pytest.mark.parametrize("progressive", [0, 1])
def test_gray_files_match_cv2(progressive):
    """A one-component file: gray under IMREAD_UNCHANGED, copied to three
    channels under IMREAD_COLOR."""
    rng = np.random.default_rng(3 + progressive)
    for h, w in SIZES:
        _same_as_cv2(_encode(_image(rng, h, w, 1), quality=90,
                             progressive=progressive))


def test_restart_every_mcu_and_optimised_tables():
    """A restart marker after every MCU, Huffman tables optimised for the
    image (other code lengths than the standard tables)."""
    rng = np.random.default_rng(11)
    img = _image(rng, 40, 56)
    _same_as_cv2(_encode(img, rst_interval=1, optimize=1))
    _same_as_cv2(_encode(img, quality=100, optimize=1,
                         sampling_factor=SAMPLINGS["420"]))


def test_sixteen_bit_tables_sof1_and_fill_bytes():
    """The same data with its quantisation tables rewritten as 16-bit
    entries, its SOF0 relabelled SOF1 (extended sequential) and fill
    bytes before a marker decode as cv2 decodes them."""
    rng = np.random.default_rng(12)
    data = _encode(_image(rng, 24, 40), quality=75)
    a, b = _segment(data, 0xDB)
    body, tables = data[a + 4:b], b""
    at = 0
    while at < len(body):
        tq = body[at] & 15
        vals = np.frombuffer(body[at + 1:at + 65], np.uint8)
        tables += bytes([0x10 | tq]) + vals.astype(">u2").tobytes()
        at += 65
    wide = data[:a] + b"\xff\xdb" + struct.pack(">H", len(tables) + 2) \
        + tables + data[b:]
    _same_as_cv2(wide)
    sof = wide.index(b"\xff\xc0")
    _same_as_cv2(wide[:sof] + b"\xff\xc1" + wide[sof + 2:])
    dht = wide.index(b"\xff\xc4")
    _same_as_cv2(wide[:dht] + b"\xff\xff\xff" + wide[dht:])


def _adobe(transform: int) -> bytes:
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return b"\xff\xee" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("transform", [0, 1, 2])
def test_adobe_transform_matches_cv2(transform):
    """Without a JFIF marker, an Adobe APP14 transform of 0 means RGB
    samples (no colour conversion), 1 (and any other value) YCbCr."""
    rng = np.random.default_rng(20 + transform)
    data = _encode(_image(rng, 19, 27), quality=85,
                   sampling_factor=SAMPLINGS["444"])
    a, b = _segment(data, 0xE0)
    _same_as_cv2(data[:a] + _adobe(transform) + data[b:])


def test_component_ids_rgb_match_cv2():
    """With neither marker, component ids 'R', 'G', 'B' mean RGB."""
    rng = np.random.default_rng(30)
    data = _encode(_image(rng, 16, 16), sampling_factor=SAMPLINGS["444"])
    a, b = _segment(data, 0xE0)
    data = data[:a] + data[b:]
    sof = data.index(b"\xff\xc0")
    frame = bytearray(data)
    for i, cid in enumerate(b"RGB"):
        frame[sof + 10 + 3 * i] = cid
    sos = frame.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        frame[sos + 5 + 2 * i] = cid
    _same_as_cv2(bytes(frame))


def test_bench_scene_at_vga():
    """The bench's scene 0 (the smoke fixture's) as q95 4:2:0, its
    progressive and its 4:4:4 encodings; each decodes in a few tenths of
    a second on a host core."""
    frame = np.load("tests/data/torch_smoke_fixture.npz")["images"][0]
    bgr = np.ascontiguousarray(frame[..., ::-1])
    for kw in (dict(sampling_factor=SAMPLINGS["420"]),
               dict(sampling_factor=SAMPLINGS["420"], progressive=1),
               dict(sampling_factor=SAMPLINGS["444"])):
        data = _encode(bgr, quality=95, **kw)
        t0 = time.perf_counter()
        decode_jpeg(data)
        assert time.perf_counter() - t0 < 10.0
        _same_as_cv2(data)


def test_complete_progressive_file_is_not_smoothed():
    """libjpeg block-smooths a progressive image only while some of its
    low coefficients are unrefined; cv2's complete files decode exactly
    (the tests above). One that ends after its first scans cv2 decodes
    smoothed, and so does this decoder (``tests/test_torch_jpeg_smoothing.py``
    covers every cut)."""
    rng = np.random.default_rng(40)
    data = _encode(_image(rng, 32, 32), quality=90, progressive=1)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) >= 6
    cut = data[:scans[3]] + b"\xff\xd9"
    assert cv2.imdecode(np.frombuffer(cut, np.uint8),
                        cv2.IMREAD_UNCHANGED) is not None
    _same_as_cv2(cut)


@pytest.mark.parametrize("marker,name", [
    (0xC9, "arithmetic"), (0xCA, "arithmetic"), (0xC3, "lossless"),
    (0xC5, "hierarchical")])
def test_unsupported_frames_are_refused_by_name(marker, name):
    data = _encode(np.zeros((8, 8, 3), np.uint8))
    sof = data.index(b"\xff\xc0")
    with pytest.raises(JpegError, match=name):
        decode_jpeg(data[:sof] + bytes([0xFF, marker]) + data[sof + 2:])


def test_precision_and_components_are_refused_by_name():
    data = bytearray(_encode(np.zeros((8, 8, 3), np.uint8)))
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(JpegError, match="12-bit"):
        decode_jpeg(bytes(twelve))
    # a 4-component (CMYK) frame header
    body = struct.pack(">BHHB", 8, 8, 8, 4) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(4))
    cmyk = bytes(data[:sof]) + b"\xff\xc0" + struct.pack(
        ">H", len(body) + 2) + body + b"\xff\xd9"
    with pytest.raises(JpegError, match="CMYK"):
        decode_jpeg(cmyk)


def test_truncated_and_corrupt_streams_raise():
    """A stream cut inside its scan: cv2 5.0 returns None (libjpeg's
    premature-end warning is an error there), this decoder raises naming
    it. A stream with no image data or no SOI fails in both."""
    rng = np.random.default_rng(50)
    data = _encode(_image(rng, 64, 64), quality=95)
    for cut in (data[:len(data) * 2 // 3], data[:-40]):
        assert cv2.imdecode(np.frombuffer(cut, np.uint8),
                            cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(JpegError, match="ends before"):
            decode_jpeg(cut)
    for bad in (b"\xff\xd8\xff\xd9", b"not a jpeg", data[:20]):
        assert cv2.imdecode(np.frombuffer(bad, np.uint8),
                            cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(JpegError):
            decode_jpeg(bad)
