"""A JPEG decoder giving ``cv2.imdecode``'s pixels bit for bit (host only,
numpy and the standard library).

cv2 decodes JPEG with libjpeg-turbo at its defaults, and this module
follows libjpeg-turbo's own code paths so that every pixel is the same:

- Huffman decoding through a 16-bit lookahead table a Huffman table (one
  lookup a symbol, its extra bits from the same 40-bit window);
- sequential (SOF0, SOF1) and progressive (SOF2) scans: spectral
  selection, end-of-band runs and successive-approximation refinement,
  restart intervals;
- the ``JDCT_ISLOW`` integer inverse DCT (``jidctint.c``; libjpeg-turbo's
  SIMD versions are bit-equal to it), its 10-bit range limit;
- libjpeg-turbo's upsampling, fancy by default: the ``h2v1`` and ``h2v2``
  triangle filters and ``h1v2``, each with its rounding bias and its edge
  replication, box filters for other integral factors (and for a
  component two samples wide or less);
- ``jdcolor.c``'s fixed-point YCbCr->RGB tables (``SCALEBITS`` 16), or
  none for an Adobe ``transform=0`` (or ``R``,``G``,``B`` ids) file.

A progressive file whose low coefficients are not all refined would be
block-smoothed by libjpeg (``decompress_smooth_data``); this module
raises :class:`JpegError` for it, as for arithmetic coding (SOF9-11),
lossless and hierarchical frames, 12-bit samples, 2- and 4-component
(CMYK/YCCK) images, and a stream that ends before its scans do (libjpeg
pads such a stream with zeros and warns).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from tod_tpu_torch.utils.exif import apply_orientation, orientation


class JpegError(ValueError):
    """A JPEG stream this decoder cannot decode as cv2 would."""


# jpeg_natural_order: zigzag index -> raster index in the 8x8 block
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

_UNSUPPORTED = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}


def _lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 16-bit lookahead table: entry ``(length << 8) | symbol`` for every
    16-bit window that starts with a code, 0 where none does."""
    table = np.zeros(1 << 16, np.int32)
    code, at = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise JpegError("Huffman table has too many codes")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[at]
            code += 1
            at += 1
        code <<= 1
    return table.tolist()


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None
        self.coef: List[int] = []
        self.bits = [-1] * 64     # libjpeg's coef_bits: -1 never seen


class _Frame:
    def __init__(self, body: bytes, progressive: bool):
        if len(body) < 6:
            raise JpegError("SOF segment is too short")
        precision, self.height, self.width, n = struct.unpack(
            ">BHHB", body[:6])
        if precision != 8:
            raise JpegError(f"{precision}-bit samples are not supported "
                            "(8-bit only)")
        if self.height == 0:
            raise JpegError("a height given by a DNL marker is not "
                            "supported")
        if self.width == 0:
            raise JpegError("JPEG frame has zero width")
        if n not in (1, 3):
            raise JpegError(f"{n}-component JPEG (CMYK/YCCK or other) is "
                            "not supported")
        if len(body) < 6 + 3 * n:
            raise JpegError("SOF segment is too short")
        self.progressive = progressive
        self.comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise JpegError("bad sampling factor or table id")
            self.comps.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            c.dw = -(-self.width * c.h // self.hmax)     # downsampled size
            c.dh = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v   # padded blocks
            c.coef = [0] * (c.bw * c.bh * 64)


def _segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos``: its restart intervals, each
    with stuffed zero bytes removed, and the position of the marker that
    ends it."""
    segs = []
    start = pos
    n = len(data)
    while True:
        at = data.find(b"\xff", pos)
        if at < 0 or at + 1 >= n:
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, n
        nxt = data[at + 1]
        if nxt == 0x00:
            pos = at + 2
        elif nxt == 0xFF:
            pos = at + 1
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:at].replace(b"\xff\x00", b"\xff"))
            start = pos = at + 2
        else:
            segs.append(data[start:at].replace(b"\xff\x00", b"\xff"))
            return segs, at


class _Bits:
    """A restart interval's bits as 40-bit windows, one a byte."""

    def __init__(self, seg: bytes):
        b = np.frombuffer(seg + bytes(8), np.uint8).astype(np.int64)
        n = len(seg) + 1
        self.win = ((b[0:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16)
                    | (b[3:n + 3] << 8) | b[4:n + 4]).tolist()
        self.nbits = 8 * len(seg)


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Scan:
    """One scan's decoding state over its restart intervals: the bit
    position, the DC predictors and the end-of-band run."""

    def __init__(self, segs: List[bytes], interval: int, n_comps: int):
        self.segs = segs
        self.interval = interval
        self.seg = 0
        self.bits = _Bits(segs[0])
        self.pos = 0
        self.preds = [0] * n_comps
        self.eobrun = 0

    def restart(self) -> None:
        self.check()
        self.seg += 1
        if self.seg >= len(self.segs):
            raise JpegError("JPEG stream ends before its scan does")
        self.bits = _Bits(self.segs[self.seg])
        self.pos = 0
        self.preds = [0] * len(self.preds)
        self.eobrun = 0

    def check(self) -> None:
        if self.pos > self.bits.nbits:
            raise JpegError("JPEG stream ends before its scan does "
                            "(truncated or corrupt data)")

    def get(self, n: int) -> int:
        pos = self.pos
        w = self.bits.win[pos >> 3]
        self.pos = pos + n
        return (w >> (40 - (pos & 7) - n)) & ((1 << n) - 1)

    def symbol(self, lut: List[int]) -> int:
        pos = self.pos
        e = lut[(self.bits.win[pos >> 3] >> (24 - (pos & 7))) & 0xFFFF]
        if not e:
            raise JpegError("corrupt JPEG data: no Huffman code matches")
        self.pos = pos + (e >> 8)
        return e & 0xFF


def _block_sequential(win, pos, dclut, aclut, coef, base, pred):
    """One sequential block: the DC difference, then run/size AC symbols,
    each symbol and its extra bits read from one window."""
    w = win[pos >> 3]
    o = pos & 7
    e = dclut[(w >> (24 - o)) & 0xFFFF]
    if not e:
        raise JpegError("corrupt JPEG data: no Huffman code matches")
    ln = e >> 8
    s = e & 0xFF
    if s:
        v = (w >> (40 - o - ln - s)) & ((1 << s) - 1)
        if v < (1 << (s - 1)):
            v -= (1 << s) - 1
        pred += v
    pos += ln + s
    coef[base] = pred
    k = 1
    zz = ZIGZAG
    while k < 64:
        w = win[pos >> 3]
        o = pos & 7
        e = aclut[(w >> (24 - o)) & 0xFFFF]
        if not e:
            raise JpegError("corrupt JPEG data: no Huffman code matches")
        ln = e >> 8
        s = e & 15
        if s:
            k += (e >> 4) & 15
            v = (w >> (40 - o - ln - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            coef[base + zz[k]] = v
            pos += ln + s
            k += 1
        else:
            pos += ln
            if (e & 0xF0) == 0xF0:
                k += 16
            else:
                break
    return pos, pred


def _decode_scan(frame: _Frame, body: bytes, data: bytes, pos: int,
                 quant: Dict[int, np.ndarray], dc: Dict[int, List[int]],
                 ac: Dict[int, List[int]], interval: int) -> int:
    """Decode one SOS segment's scan into the frame's coefficients;
    returns the position after its entropy-coded data."""
    n = body[0]
    if len(body) < 4 + 2 * n or not 1 <= n <= 4:
        raise JpegError("bad SOS segment")
    by_id = {c.id: c for c in frame.comps}
    comps, tables = [], []
    for i in range(n):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise JpegError("SOS names a component the frame lacks")
        comps.append(by_id[cid])
        tables.append((t >> 4, t & 15))
    ss, se, a = body[1 + 2 * n:4 + 2 * n]
    ah, al = a >> 4, a & 15
    for c in comps:           # libjpeg latches a table at its first scan
        if c.quant is None:
            if c.tq not in quant:
                raise JpegError("component's quantisation table is missing")
            c.quant = quant[c.tq]
    segs, end = _segments(data, pos)
    scan = _Scan(segs, interval, n)
    units = _mcus(frame, comps)

    if not frame.progressive:             # Ss, Se, Ah, Al unused
        luts = []
        for dt, at in tables:
            if dt not in dc or at not in ac:
                raise JpegError("scan uses an undefined Huffman table")
            luts.append((dc[dt], ac[at]))

        def block(i, base):
            scan.pos, scan.preds[i] = _block_sequential(
                scan.bits.win, scan.pos, *luts[i], comps[i].coef, base,
                scan.preds[i])

        _walk(scan, units, block)
        return end

    # progressive: validate as libjpeg does
    if ss == 0:
        if se != 0:
            raise JpegError("bad progressive DC scan")
    else:
        if se < ss or se > 63 or n != 1:
            raise JpegError("bad progressive AC scan")
    if al > 13 or (ah and ah - 1 != al):
        raise JpegError("bad successive-approximation bits")
    for c in comps:
        for k in range(ss, se + 1):
            c.bits[k] = al
    if ss == 0:
        luts = [dc.get(dt) for dt, _ in tables]
        if not ah and any(t is None for t in luts):
            raise JpegError("scan uses an undefined Huffman table")

        def block(i, base):
            coef = comps[i].coef
            if ah:                        # one refinement bit a block
                if scan.get(1):
                    coef[base] |= 1 << al
                return
            s = scan.symbol(luts[i])
            scan.preds[i] += _extend(scan.get(s), s) if s else 0
            coef[base] = scan.preds[i] << al
    else:
        lut = ac.get(tables[0][1])
        if lut is None:
            raise JpegError("scan uses an undefined Huffman table")
        step = _ac_refine if ah else _ac_first
        coef = comps[0].coef

        def block(i, base):
            step(scan, lut, coef, base, ss, se, al)

    _walk(scan, units, block)
    return end


def _ac_first(st: _Scan, lut, coef, base, ss, se, al) -> None:
    if st.eobrun:
        st.eobrun -= 1
        return
    k = ss
    while k <= se:
        rs = st.symbol(lut)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise JpegError("corrupt JPEG data: coefficient index")
            coef[base + ZIGZAG[k]] = _extend(st.get(s), s) * (1 << al)
        elif r == 15:
            k += 15
        else:
            st.eobrun = (1 << r) - 1
            if r:
                st.eobrun += st.get(r)
            return
        k += 1


def _ac_refine(st: _Scan, lut, coef, base, ss, se, al) -> None:
    p1, m1 = 1 << al, -1 << al
    k = ss
    if not st.eobrun:
        while k <= se:
            rs = st.symbol(lut)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if st.get(1) else m1
            elif r != 15:
                st.eobrun = 1 << r
                if r:
                    st.eobrun += st.get(r)
                break
            while k <= se:
                z = base + ZIGZAG[k]
                if coef[z]:
                    if st.get(1) and not coef[z] & p1:
                        coef[z] += p1 if coef[z] >= 0 else m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise JpegError("corrupt JPEG data: coefficient index")
                coef[base + ZIGZAG[k]] = s
            k += 1
    if st.eobrun:
        while k <= se:
            z = base + ZIGZAG[k]
            if coef[z] and st.get(1) and not coef[z] & p1:
                coef[z] += p1 if coef[z] >= 0 else m1
            k += 1
        st.eobrun -= 1


def _mcus(frame: _Frame, comps) -> List[List[Tuple[int, int]]]:
    """A scan's blocks in MCU order, each MCU a list of (component in the
    scan, offset of the block's coefficients): interleaved, each
    component's v x h blocks an MCU over the frame's MCU grid; one
    component, its own blocks in raster order."""
    if len(comps) == 1:
        c = comps[0]
        return [[(0, (by * c.bw + bx) * 64)] for by in range(-(-c.dh // 8))
                for bx in range(-(-c.dw // 8))]
    return [[(i, ((my * c.v + by) * c.bw + mx * c.h + bx) * 64)
             for i, c in enumerate(comps)
             for by in range(c.v) for bx in range(c.h)]
            for my in range(frame.mcuy) for mx in range(frame.mcux)]


def _walk(scan: _Scan, units, block) -> None:
    """``block(i, base)`` for every block of the scan, restarting every
    ``scan.interval`` MCUs."""
    try:
        for u, unit in enumerate(units):
            if scan.interval and u and u % scan.interval == 0:
                scan.restart()
            for i, base in unit:
                block(i, base)
    except IndexError:
        raise JpegError("JPEG stream ends before its scan does "
                        "(truncated or corrupt data)") from None
    scan.check()


# -- jidctint.c jpeg_idct_islow ----------------------------------------------

def _idct_1d(x, shift: int):
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0 = t0 * 2446                              # FIX_0_298631336
    t1 = t1 * 16819                             # FIX_2_053119869
    t2 = t2 * 25172                             # FIX_3_072711026
    t3 = t3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_plane(c: _Component) -> np.ndarray:
    """The component's samples: every block dequantised and inverse
    transformed (pass 1 down the columns, pass 2 along the rows), then
    range-limited, cropped to the component's size."""
    coef = np.asarray(c.coef, np.int64).reshape(-1, 8, 8)
    coef = coef * c.quant.reshape(1, 8, 8)
    ws = np.stack(_idct_1d([coef[:, k, :] for k in range(8)], 11), 1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), 2)
    out = out & 1023                      # RANGE_MASK, then the table
    out = np.where(out >= 512, out - 1024, out) + 128
    pix = np.clip(out, 0, 255).astype(np.uint8)
    plane = pix.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
        c.bh * 8, c.bw * 8)
    return plane[:c.dh, :c.dw]


# -- jdsample.c ----------------------------------------------------------------

def _up_h2v1(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out.astype(np.uint8)


def _up_h1v2(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out.astype(np.uint8)


def _up_h2v2(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    h, w = x.shape
    out = np.empty((2 * h, 2 * w), np.int32)
    for v, far in ((0, above), (1, below)):
        col = 3 * x + far                         # the column sums
        last = np.concatenate([col[:, :1], col[:, :-1]], 1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        row = np.empty((h, 2 * w), np.int32)
        row[:, 0::2] = (3 * col + last + 8) >> 4
        row[:, 1::2] = (3 * col + nxt + 7) >> 4
        row[:, 0] = (4 * col[:, 0] + 8) >> 4
        row[:, -1] = (4 * col[:, -1] + 7) >> 4
        out[v::2] = row
    return out.astype(np.uint8)


def _upsample(frame: _Frame, c: _Component, plane: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's upsampler for the component (``jinit_upsampler``
    with fancy upsampling on), cropped to the image."""
    fh, fv = frame.hmax // c.h, frame.vmax // c.v
    if frame.hmax % c.h or frame.vmax % c.v:
        raise JpegError("fractional sampling factors are not supported")
    if fh == 1 and fv == 1:
        out = plane
    elif fh == 2 and fv == 1 and c.dw > 2:
        out = _up_h2v1(plane)
    elif fh == 1 and fv == 2:
        out = _up_h1v2(plane)
    elif fh == 2 and fv == 2 and c.dw > 2:
        out = _up_h2v2(plane)
    else:
        out = np.repeat(np.repeat(plane, fv, 0), fh, 1)
    return out[:frame.height, :frame.width]


# -- jdcolor.c -----------------------------------------------------------------

def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _YCC
    yy = y.astype(np.int64)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


# -- markers -------------------------------------------------------------------

def _color_transform(frame: _Frame, jfif: bool,
                     adobe: Optional[int]) -> str:
    """libjpeg's guess of a 3-component file's colour space
    (``default_decompress_parms``)."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = [c.id for c in frame.comps]
    return "rgb" if ids == [82, 71, 66] else "ycc"


def _smoothing_needed(frame: _Frame) -> bool:
    """libjpeg-turbo's ``smoothing_ok``: would it block-smooth this
    progressive image (some of coefficients 1-9 not fully refined)?"""
    useful = False
    for c in frame.comps:
        q = c.quant.reshape(-1)
        if any(q[i] == 0 for i in (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)):
            return False
        if c.bits[0] < 0:
            return False
        if any(c.bits[k] != 0 for k in range(1, 10)):   # zigzag order
            useful = True
    return useful


def decode_jpeg(data: bytes, color: bool = False) -> np.ndarray:
    """The pixels of a JPEG as ``cv2.imdecode`` gives them:
    ``IMREAD_UNCHANGED`` by default ((H, W) for a gray file, (H, W, 3)
    BGR for a colour one), ``IMREAD_COLOR`` with ``color`` ((H, W, 3) BGR,
    gray replicated, the EXIF orientation applied). Raises
    :class:`JpegError` on what it does not decode."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG stream (no SOI marker)")
    frame: Optional[_Frame] = None
    quant: Dict[int, np.ndarray] = {}
    dc: Dict[int, List[int]] = {}
    ac: Dict[int, List[int]] = {}
    interval = 0
    jfif, adobe = False, None
    pos, n = 2, len(data)
    scanned = False
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1                      # libjpeg skips junk (warns)
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if scanned:
                break                     # no EOI: libjpeg warns only
            raise JpegError("JPEG stream ends before its image data")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                # EOI
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > n:
            raise JpegError("JPEG stream ends inside a marker segment")
        size = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + size]
        if size < 2 or len(body) != size - 2:
            raise JpegError("JPEG stream ends inside a marker segment")
        pos += size
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise JpegError("JPEG stream has two frames")
            frame = _Frame(body, marker == 0xC2)
        elif marker in _UNSUPPORTED:
            raise JpegError(f"{_UNSUPPORTED[marker]} JPEG is not supported")
        elif marker == 0xC4:              # DHT
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 15
                counts = body[at + 1:at + 17]
                total = sum(counts)
                symbols = body[at + 17:at + 17 + total]
                if len(counts) != 16 or len(symbols) != total or tc > 1:
                    raise JpegError("bad DHT segment")
                (ac if tc else dc)[th] = _lut(counts, symbols)
                at += 17 + total
        elif marker == 0xDB:              # DQT
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                width = 2 if pq else 1
                raw = body[at + 1:at + 1 + 64 * width]
                if len(raw) != 64 * width or tq > 3:
                    raise JpegError("bad DQT segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                at += 1 + 64 * width
        elif marker == 0xDD:              # DRI
            interval = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:              # SOS
            if frame is None:
                raise JpegError("scan before the frame header")
            pos = _decode_scan(frame, body, data, pos, quant, dc, ac,
                               interval)
            scanned = True
        elif marker == 0xDC:
            raise JpegError("DNL marker is not supported")
    if frame is None or not scanned:
        raise JpegError("JPEG stream has no image data")
    for c in frame.comps:
        if c.quant is None:
            raise JpegError("component was never scanned")
    if frame.progressive and _smoothing_needed(frame):
        raise JpegError("progressive JPEG with unrefined coefficients "
                        "(libjpeg would block-smooth it): not supported")
    planes = [_upsample(frame, c, _idct_plane(c)) for c in frame.comps]
    if len(planes) == 1:
        img = planes[0]
        if color:
            img = np.repeat(img[..., None], 3, -1)
    elif _color_transform(frame, jfif, adobe) == "rgb":
        img = np.stack(planes[::-1], -1)
    else:
        img = _ycc_to_bgr(*planes)
    if color:
        img = apply_orientation(img, orientation(data))
    return np.ascontiguousarray(img)
