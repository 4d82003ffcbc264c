"""The host C library's float32 ``atan2f``, computed on any device.

The reference's keypoint and gradient orientations are XLA's ``atan2``,
which its CPU backend lowers to a call of the C library's ``atan2f`` by
name (``tod_tpu/ops/orb.py:163``, ``tod_tpu/ops/sift.py:105``). So the
reference's angle is whatever the host's libm gives. The premise of this
module: that libm is glibc's (2.36, x86-64), whose ``atan2f`` is fdlibm's
(``sysdeps/ieee754/flt-32/e_atan2f.c`` and ``s_atanf.c``): every float32
operation rounded on its own, no fused multiply-add (glibc builds no FMA
variant of it). ``tests/test_torch_libm.py`` holds the port against the
host's libm and fails first on a host with another one.

:func:`atan2f_torch` transcribes that C code into PyTorch elementwise ops
(each rounded once on the CPU and on the card). :func:`atan2f` is the
wrapper the features call: kernel L1 (``csrc/libm_f32.cu``) on a CUDA
tensor, the plain version on a CPU tensor.

The 2D-only path's P3P and refinement call three more of the C library's
float functions by name in the compiled reference (``cosf``, ``powf`` and
``sincosf``; ``tools/fit_sift_order.py --libm``). On glibc 2.36 (x86-64)
these are ifuncs (``objdump -T libm.so.6``: ``iD``) that pick their FMA
builds on a CPU with FMA: the optimized-routines code (``s_cosf.c``,
``s_sincosf.c`` over ``sincosf.h``, ``e_powf.c``), computed in double with
tables (``__sincosf_table``, ``__inv_pio4``, ``__powf_log2_data``,
``__exp2f_data``). :func:`cosf_torch`, :func:`sincosf_torch` and
:func:`powf_torch` transcribe those FMA builds as read off the object code
of this host's ``libm.so.6`` (x86-64 with FMA and AVX-512): the tables'
doubles are copied below as hex, and every place where GCC contracted a
multiply-add into ``vfmadd``/``vfnmadd`` is a :func:`fma_f64` here (an
emulated double FMA) and ``__fma_rn`` on the card
(``csrc/libm_f32.cuh``); every other double operation is rounded on its
own. Its log-ratios and weights take XLA's own inline ``log``
(:func:`log_xla_torch`, read off the compiled IR), and its roots
:func:`sqrt_rn` (PyTorch's CPU ``sqrt`` is not correctly rounded). A
host with another libm, or without FMA, gives the reference other bits:
``tests/test_torch_libm.py`` fails first there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels


def _f32(value: float) -> float:
    """A decimal literal of the C source as its float32 (the compiler's
    rounding; the comments beside the literals give other bits for some)."""
    return float(np.float32(value))


# s_atanf.c: atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo
ATANHI = tuple(map(_f32, (4.6364760399e-01, 7.8539812565e-01,
                          9.8279368877e-01, 1.5707962513e+00)))
ATANLO = tuple(map(_f32, (5.0121582440e-09, 3.7748947079e-08,
                          3.4473217170e-08, 7.5497894159e-08)))
AT = tuple(map(_f32, (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
                      -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
                      6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
                      -3.6531571299e-02, 1.6285819933e-02)))
# e_atan2f.c
PI_O_4 = _f32(7.8539818525e-01)
PI_O_2 = _f32(1.5707963705e+00)
PI = _f32(3.1415927410e+00)
PI_LO = _f32(-8.7422776573e-08)
# |y/x| above 2^CUT takes pi/2 without dividing (glibc: 60; fdlibm's later
# float code: 26). Both give the same bits: past 2^25 atanf returns
# atanhi[3] + atanlo[3], which rounds to pi/2 + pi_lo / 2 as well, and on
# the x < 0 side pi - (z - pi_lo) rounds to pi for every z < 2^-26.
CUT = 60


def _atanf_abs(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``atanf`` of a non-negative, non-NaN float32 ``x``."""
    ix = x.view(torch.int32)
    one = 1.0
    # argument reduction, by the bit pattern's range: id -1 (|x| < 7/16)
    # keeps x; 0: (2x - 1) / (2 + x); 1: (x - 1) / (x + 1); 2: (x - 1.5) /
    # (1 + 1.5 x); 3: -1 / x
    ident = torch.where(
        ix < 0x3ee00000, -1, torch.where(
            ix < 0x3f300000, 0, torch.where(
                ix < 0x3f980000, 1, torch.where(ix < 0x401c0000, 2, 3))))
    red = torch.where(
        ident == 0, (2.0 * x - one) / (2.0 + x), torch.where(
            ident == 1, (x - one) / (x + one), torch.where(
                ident == 2, (x - 1.5) / (one + 1.5 * x), -1.0 / x)))
    xr = torch.where(ident < 0, x, red)
    z = xr * xr
    w = z * z
    a = AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (
        a[8] + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))
    poly = xr * (s1 + s2)
    row = ident.clamp(min=0)
    hi = torch.tensor(ATANHI, dtype=torch.float32, device=x.device)[row]
    lo = torch.tensor(ATANLO, dtype=torch.float32, device=x.device)[row]
    out = torch.where(ident < 0, xr - poly, hi - ((poly - lo) - xr))
    out = torch.where(ix < 0x31000000, x, out)         # |x| < 2^-29: x
    inf_hi = torch.tensor(ATANHI[3], dtype=torch.float32, device=x.device)
    return torch.where(ix >= 0x4c000000, inf_hi + ATANLO[3], out)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def atan2f_torch(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atan2f(y, x)`` elementwise, bit for bit, in plain
    PyTorch: the plain version of kernel L1. ``y`` and ``x`` are float32
    tensors of one shape."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7fffffff, hy & 0x7fffffff
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)      # 2 * sign(x) + sign(y)
    k = (iy - ix) >> 23
    z = _atanf_abs((y / x).abs())
    z = torch.where(k > CUT, _const(PI_O_2, x) + 0.5 * PI_LO, z)
    z = torch.where((hx < 0) & (k < -CUT), _const(0.0, x), z)
    pi, pi_lo = _const(PI, x), _const(PI_LO, x)
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    # x == 1: atanf(y), its sign kept
    at_y = _atanf_abs(y.abs())
    out = torch.where(hx == 0x3f800000,
                      torch.where(hy < 0, -at_y, at_y), out)
    quadrant = torch.stack([_const(v, x) for v in (0.0, -0.0, PI, -PI)])
    diagonal = torch.stack([_const(v, x) for v in (
        PI_O_4, -PI_O_4, _f32(3.0 * PI_O_4), _f32(-3.0 * PI_O_4))])
    half_pi = torch.where(hy < 0, _const(-PI_O_2, x), _const(PI_O_2, x))
    mi = m.long()
    # y == +-0: +-0 toward x > 0, +-pi toward x < 0 (y keeps its sign)
    out = torch.where(iy == 0, torch.where(m < 2, y, quadrant[mi]), out)
    out = torch.where((ix == 0) & (iy != 0), half_pi, out)
    x_inf, y_inf = ix == 0x7f800000, iy == 0x7f800000
    out = torch.where(x_inf & (iy != 0),
                      torch.where(y_inf, diagonal[mi], quadrant[mi]), out)
    out = torch.where(y_inf & ~x_inf, half_pi, out)
    return torch.where((ix > 0x7f800000) | (iy > 0x7f800000), x + y, out)


# ---------------------------------------------------------------------------
# glibc 2.36's FMA builds of cosf, sincosf and powf (x86-64)
# ---------------------------------------------------------------------------

_H = float.fromhex


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """``(p, e)`` with ``p = a * b`` rounded and ``p + e == a * b`` exactly
    (Dekker's product over Veltkamp's split; f64, no overflow)."""
    p = a * b
    ca, cb = a * 134217729.0, b * 134217729.0       # 2^27 + 1
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _add_odd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y`` rounded to odd (an inexact sum with an even last bit moves
    one ulp toward its TwoSum error), f64."""
    s = x + y
    back = s - x
    err = (x - (s - back)) + (y - back)
    bits = s.view(torch.int64)
    step = torch.where((err != 0) & ((bits & 1) == 0),
                       torch.where((err > 0) == (s > 0), 1, -1), 0)
    return (bits + step).view(torch.float64)


def fma_f64(a: torch.Tensor, b, c) -> torch.Tensor:
    """f64 ``a * b + c`` rounded once (x86's ``vfmadd...sd``, CUDA's
    ``__fma_rn``), on any device: Boldo and Melquiond's emulation, the
    exact product's error and ``c``'s TwoSum error added with rounding to
    odd, then one rounding to nearest. Exact for the finite operands of
    this module's functions (no overflow of the split, no underflow of
    the product's error)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    c = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    uh, ul = _two_prod(a, b)
    th = c + uh
    back = th - c
    tl = (c - (th - back)) + (uh - back)
    return th + _add_odd(tl, ul)


def _table(values, like: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=like.device)


# __sincosf_table[0] (sincosf.h's sincos_t, in this build's field order:
# sign[4], hpi_inv (2/pi * 2^24), hpi, c0, c1, s1, c2, s2, c3, s3, c4);
# table 1 is table 0 with the cosine coefficients negated
SINCOS_SIGN = (1.0, -1.0, -1.0, 1.0)
HPI_INV = _H("0x1.45f306dc9c883p+23")
HPI = _H("0x1.921fb54442d18p+0")
COS_C = tuple(map(_H, ("0x1.0000000000000p+0", "-0x1.ffffffd0c621cp-2",
                       "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
                       "0x1.99343027bf8c3p-16")))            # c0 .. c4
SIN_S = tuple(map(_H, ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                       "-0x1.994eb3774cf24p-13")))           # s1 .. s3
# __inv_pio4: 4/pi in 24 overlapping 32-bit words; pi / 2^62
INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44,
            0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757,
            0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
            0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c,
            0x95993c43, 0x993c4390, 0x3c439041)
PI63 = _H("0x1.921fb54442d18p-62")


def _abstop12(ix: torch.Tensor) -> torch.Tensor:
    return (ix >> 20) & 0x7ff


def _sin_poly(xs: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """sincosf.h's sine polynomial of the signed reduced ``xs`` (``x2`` its
    square), contracted as the FMA build contracts it."""
    s1p = fma_f64(x2, SIN_S[2], SIN_S[1])
    x3 = x2 * xs
    x7 = x2 * x3
    s = fma_f64(x3, SIN_S[0], xs)
    return fma_f64(s1p, x7, s)


def _cos_poly(x2: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """sincosf.h's cosine polynomial of ``x2``; ``neg`` picks table 1 (the
    coefficients negated)."""
    c = [torch.where(neg, -v, v) for v in
         (torch.tensor(v, dtype=torch.float64, device=x2.device)
          for v in COS_C)]
    x4 = x2 * x2
    c1p = fma_f64(x2, c[1], c[0])
    c2p = fma_f64(x2, c[4], c[3])
    x6 = x2 * x4
    cc = fma_f64(x4, c[2], c1p)
    return fma_f64(c2p, x6, cc)


def _reduce_large(ix: torch.Tensor):
    """sincosf.h's ``reduce_large`` for |x| >= 120: ``(x mod pi/2, n)``
    from the mantissa times 4/pi in integer arithmetic (int64 with
    wraparound for the C code's uint64)."""
    ix = ix.to(torch.int64) & 0xffffffff
    tab = _table(INV_PIO4, ix, torch.int64)
    j = (ix >> 26) & 15
    shift = (ix >> 23) & 7
    m = ((ix & 0x7fffff) | 0x800000) << shift
    res0 = (m * tab[j]) & 0xffffffff
    res1 = m * tab[j + 4]
    res2 = m * tab[j + 8]
    res0 = ((res2 >> 32) & 0xffffffff) | (res0 << 32)
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * PI63, n.to(torch.int32)


def _reduced(x: torch.Tensor):
    """The reduction of every branch at once: ``(xr, n, sign_n, top)``,
    ``xr`` the reduced f64 argument, ``n`` the quadrant, ``sign_n`` the
    quadrant with the sign folded in (large arguments), ``top`` the
    abstop12 that picks the branch."""
    ix = x.view(torch.int32)
    top = _abstop12(ix)
    xd = x.to(torch.float64)
    # reduce_fast (|x| < 120): n = (int(x hpi_inv) + 2^23) >> 24, then the
    # contracted x - n hpi
    fast = top < 0x42f
    r = torch.where(fast, xd * HPI_INV, torch.zeros_like(xd))
    n_fast = (r.to(torch.int32) + 0x800000) >> 24
    xr_fast = fma_f64(-n_fast.to(torch.float64), HPI, xd)
    xr_large, n_large = _reduce_large(ix)
    sign = (ix >> 31) & 1
    xr = torch.where(fast, xr_fast, xr_large)
    n = torch.where(fast, n_fast, n_large)
    sign_n = torch.where(fast, n_fast, n_large + sign)
    return xd, xr, n, sign_n, top


def sincosf_torch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """glibc's FMA build of ``sincosf(x)`` (float32) elementwise, bit for
    bit: ``(sin, cos)``. ``sinf`` and ``cosf`` round as its two outputs."""
    xd, xr, n, sign_n, top = _reduced(x)
    small = top < 0x3f4                              # |x| < pi/4
    tiny = top < 0x398                               # |x| < 2^-12
    sgn = _table(SINCOS_SIGN, x)[(sign_n & 3).long()]
    xs = torch.where(small, xd, xr * sgn)
    xb = torch.where(small, xd, xr)
    x2 = xb * xb
    neg = ~small & ((sign_n & 2) != 0)
    sp = _sin_poly(xs, x2)
    cp = _cos_poly(x2, neg)
    odd = ~small & ((n & 1) != 0)
    s = torch.where(odd, cp, sp).to(torch.float32)
    c = torch.where(odd, sp, cp).to(torch.float32)
    s = torch.where(tiny, x, s)
    c = torch.where(tiny, torch.ones_like(x), c)
    bad = top >= 0x7f8                               # inf, NaN
    nan = torch.full_like(x, float("nan"))
    return torch.where(bad, nan, s), torch.where(bad, nan, c)


def cosf_torch(x: torch.Tensor) -> torch.Tensor:
    """glibc's FMA build of ``cosf(x)`` elementwise, bit for bit."""
    return sincosf_torch(x)[1]


# __powf_log2_data (POWF_LOG2_TABLE_BITS 4): invc, logc (log2(c)), then the
# polynomial A[0..4]; __exp2f_data (EXP2F_TABLE_BITS 5): 2^(i/32) as bits
# less i << 47, the shift 0x1.8p52 / 32 and the polynomial C[0..2]
POWF_INVC = tuple(map(_H, (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0000000000000p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1")))
POWF_LOGC = tuple(map(_H, (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2")))
POWF_A = tuple(map(_H, ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
                        "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
                        "0x1.71547652ab82bp+0")))
EXP2F_T = (0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
           0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
           0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
           0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
           0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
           0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
           0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
           0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
           0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
           0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
           0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
EXP2F_SHIFT = _H("0x1.8p+47")
EXP2F_C = tuple(map(_H, ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                         "0x1.62e42ff0c52d6p-1")))
POWF_OFLOW = _H("0x1.fffffffd1d571p+6")      # ylogx above: +-inf


def _checkint(iy: torch.Tensor) -> torch.Tensor:
    """e_powf.c's ``checkint``: 0 not an integer, 1 odd, 2 even."""
    e = (iy >> 23) & 0xff
    sh = (0x7f + 23 - e).clamp(0, 31)
    frac = (iy & ((1 << sh) - 1)) != 0
    odd = (iy & (1 << sh)) != 0
    return torch.where(e < 0x7f, 0, torch.where(
        e > 0x7f + 23, 2, torch.where(frac, 0, torch.where(odd, 1, 2))))


def powf_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """glibc's FMA build of ``powf(x, y)`` (float32) elementwise, bit for
    bit (``x`` and ``y`` of one shape): log2(x) from a 16-entry table and
    a degree-5 polynomial in double, times y, then exp2 from a 32-entry
    table; the special cases as e_powf.c orders them."""
    ix = x.view(torch.int32).to(torch.int64) & 0xffffffff
    iy = y.view(torch.int32).to(torch.int64) & 0xffffffff
    neg_x = ix >= 0x80000000
    yint = _checkint(iy)
    sign_bias = torch.where(neg_x & (yint == 1), 0x10000, 0)
    ax = ix & 0x7fffffff
    # subnormal |x|: normalised through x * 2^23, the exponent taken back
    sub = (ax < 0x00800000) & (ax != 0)
    scaled = (x.abs() * 8388608.0).view(torch.int32).to(torch.int64)
    ax = torch.where(sub, (scaled & 0x7fffffff) - (23 << 23), ax)
    # log2_inline
    tmp = ax - 0x3f330000
    i = ((tmp >> 19) & 15).long()
    top = tmp & 0xff800000
    iz = (ax - top) & 0xffffffff
    k = top.to(torch.int32) >> 23
    invc, logc = _table(POWF_INVC, x)[i], _table(POWF_LOGC, x)[i]
    z = iz.to(torch.int32).view(torch.float32).to(torch.float64)
    r = fma_f64(z, invc, -1.0)
    y0 = k.to(torch.float64) + logc
    r2 = r * r
    ya = fma_f64(r, POWF_A[0], POWF_A[1])
    p = fma_f64(r, POWF_A[2], POWF_A[3])
    r4 = r2 * r2
    q = fma_f64(r, POWF_A[4], y0)
    q = fma_f64(r2, p, q)
    logx = fma_f64(ya, r4, q)
    ylogx = y.to(torch.float64) * logx
    # exp2_inline
    kd = ylogx + EXP2F_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - EXP2F_SHIFT
    rr = ylogx - kd
    t = _table(EXP2F_T, x, torch.int64)[(ki & 31).long()]
    t = t + ((ki + sign_bias) << 47)
    s = t.view(torch.float64)
    zz = fma_f64(rr, EXP2F_C[0], EXP2F_C[1])
    rr2 = rr * rr
    yy = fma_f64(rr, EXP2F_C[2], 1.0)
    yy = fma_f64(zz, rr2, yy)
    out = (yy * s).to(torch.float32)
    # |y log2 x| >= 126: overflow, underflow, the may-underflow band
    signed = lambda v: torch.where(sign_bias != 0, -v, v)   # noqa: E731
    big = ((ylogx.view(torch.int64) >> 47) & 0xffff) > 0x80be
    out = torch.where(big & (ylogx > POWF_OFLOW),
                      signed(torch.full_like(x, float("inf"))), out)
    out = torch.where(big & (ylogx <= -150.0),
                      signed(torch.zeros_like(x)), out)
    out = torch.where(big & (ylogx > -150.0) & (ylogx < -149.0),
                      signed(torch.full_like(x, 1e-45)), out)
    # the special operands, in e_powf.c's order of precedence (last wins)
    nan = torch.full_like(x, float("nan"))
    out = torch.where(neg_x & (yint == 0), nan, out)   # x < 0, y not integral
    x_zin = ((2 * ix - 1) & 0xffffffff) >= 2 * 0x7f800000 - 1
    x2 = x * x
    x2 = torch.where(neg_x & (yint == 1), -x2, x2)
    out = torch.where(x_zin, torch.where(iy >= 0x80000000, 1.0 / x2, x2),
                      out)
    y_zin = ((2 * iy - 1) & 0xffffffff) >= 2 * 0x7f800000 - 1
    ay2, ax2 = (2 * iy) & 0xffffffff, (2 * ix) & 0xffffffff
    yspec = torch.where(
        ax2 > 2 * 0x7f800000, x + y, torch.where(
            ay2 > 2 * 0x7f800000, x + y, torch.where(
                ax2 == 2 * 0x3f800000, torch.ones_like(x), torch.where(
                    (ax2 < 2 * 0x3f800000) == (iy < 0x80000000),
                    torch.zeros_like(x), y * y))))
    out = torch.where(y_zin, yspec, out)
    out = torch.where(y_zin & (ix == 0x3f800000), torch.ones_like(x), out)
    return torch.where(ay2 == 0, torch.ones_like(x), out)  # y = +-0


# XLA's own float32 log (jax 0.9.0's CPU backend inlines it: Eigen's plog,
# Cephes' polynomial in three interleaved Horner chains), read off the
# optimised LLVM IR of ``jax.jit(jnp.log)``: the mantissa in [sqrt(1/2),
# sqrt(2)), every single-use product feeding a sum contracted into an FMA
# by LLVM's backend; its constants as float32 hex
XLOG_SQRTHF = _H("0x1.6a09e6p-1")
XLOG_P = tuple(map(_H, (
    "0x1.204376p-4", "-0x1.d7a37p-4", "0x1.de4a34p-4",      # chain 0
    "-0x1.fcba9ep-4", "0x1.23d37ep-3", "-0x1.555ca0p-3",    # chain 1
    "0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.555554p-2")))   # chain 2
XLOG_Q1 = _H("-0x1.bd0106p-13")
XLOG_Q2 = _H("0x1.63p-1")
FLT_MIN = _H("0x1p-126")


def log_xla_torch(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of float32 as XLA's CPU backend compiles it (its own
    inline log, not the C library's ``logf``): arguments below FLT_MIN
    taken as FLT_MIN, zeros and subnormals give -inf (the runtime treats
    subnormal operands as zero), +inf +inf, negatives and NaN a NaN;
    every float operation rounded as the compiled code rounds it. The plain
    version of kernel L4's log."""
    from tod_tpu_torch.ops.image import fma_f32

    k = lambda v: torch.tensor(v, dtype=torch.float32,   # noqa: E731
                               device=x.device)
    xc = torch.where((x <= FLT_MIN) | torch.isnan(x), k(FLT_MIN), x)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & -2139095041) | 0x3f000000).view(torch.float32)
    below = m < XLOG_SQRTHF
    e = (1.0 + e) - torch.where(below, k(1.0), k(0.0))
    z = (m - 1.0) + torch.where(below, m, k(0.0))
    z2 = z * z
    z3 = z2 * z
    p = XLOG_P
    c0 = fma_f32(fma_f32(z, k(p[0]), k(p[1])), z, k(p[2]))
    c1 = fma_f32(fma_f32(z, k(p[3]), k(p[4])), z, k(p[5]))
    c2 = fma_f32(fma_f32(z, k(p[6]), k(p[7])), z, k(p[8]))
    y = fma_f32(fma_f32(c0, z3, c1), z3, c2)
    y = fma_f32(y, z3, k(XLOG_Q1) * e)
    r = fma_f32(k(-0.5), z2, z) + y
    r = fma_f32(k(XLOG_Q2), e, r)
    r = torch.where((x < 0) | torch.isnan(x), k(float("nan")), r)
    # the runtime treats subnormal operands as zero: -inf from -FLT_MIN to
    # FLT_MIN, zeros included
    r = torch.where(torch.abs(x) < FLT_MIN, k(-float("inf")), r)
    return torch.where(x == float("inf"), x, r)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 or float64 tensor on
    every device (IEEE's, the host's ``sqrtss``/``sqrtsd``, the card's
    ``sqrt``). PyTorch's CPU ``sqrt`` is not (its vectorised float32 and
    float64 loops miss in ~0.5 % and ~0.8 % of random arguments): on a CPU
    tensor its result is moved to the neighbour whose half-way points
    bracket the root, tested exactly (float32: the midpoints squared in
    float64; float64: the residual ``x - s^2`` by Dekker's product). On a
    CUDA tensor PyTorch's ``sqrt`` is IEEE's already."""
    s = torch.sqrt(x)
    if x.device.type != "cpu":
        return s
    fix = (x > 0) & torch.isfinite(x)
    if x.dtype == torch.float32:
        inf = torch.full((), float("inf"), dtype=x.dtype)
        up, dn = torch.nextafter(s, inf), torch.nextafter(s, -inf)
        xd, sd = x.double(), s.double()
        m_up = (sd + up.double()) * 0.5
        m_dn = (sd + dn.double()) * 0.5
        s_fix = torch.where(m_up * m_up < xd, up,
                            torch.where(m_dn * m_dn > xd, dn, s))
        return torch.where(fix, s_fix, s)
    if x.dtype != torch.float64:
        raise TypeError(f"sqrt_rn takes float32 or float64, got {x.dtype}")
    inf = torch.full((), float("inf"), dtype=x.dtype)
    p, e = _two_prod(s, s)
    r = (x - p) - e                                     # x - s^2
    u = torch.nextafter(s, inf) - s                     # s's ulp above
    half = u * u * 0.25
    s_fix = torch.where(r > s * u + half, s + u,
                        torch.where(r < -s * u + half,
                                    torch.nextafter(s, -inf), s))
    return torch.where(fix, s_fix, s)


def _checked(y: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if y.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"atan2f takes float32, got {y.dtype}, {x.dtype}")
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"atan2f: y {tuple(y.shape)} on {y.device} and x "
                         f"{tuple(x.shape)} on {x.device} differ")
    return y.contiguous(), x.contiguous()


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The host libm's ``atan2f(y, x)`` elementwise: kernel L1 on a CUDA
    tensor (one launch, counted in ``atan2f.launches``; a failed launch
    raises), :func:`atan2f_torch` on a CPU tensor."""
    y, x = _checked(y, x)
    if x.device.type == "cpu":
        return atan2f_torch(y, x)
    if x.device.type != "cuda":
        raise ValueError(f"no atan2f path for {x.device}")
    out = torch.empty_like(x)
    if out.numel():
        kernels.call("libm_f32", "tod_atan2f",
                     [y.data_ptr(), x.data_ptr(), out.data_ptr()],
                     [out.numel()],
                     torch.cuda.current_stream(x.device).cuda_stream)
        atan2f.launches += 1
    return out


atan2f.launches = 0


def libm_f32(fn: int, x: torch.Tensor, y=None):
    """Kernel L4 (``tod_libm_f32``, built with L1) on a CUDA tensor:
    ``fn`` 0 ``cosf(x)``, 1 ``(sinf(x), cosf(x))``, 2 ``powf(x, y)``, 3
    XLA's ``log(x)``; one launch, counted in ``libm_f32.launches`` (a
    failed launch raises). The named wrappers below call it."""
    x = x.contiguous()
    if y is not None:
        y, x = _checked(y.contiguous(), x)
    elif x.dtype != torch.float32:
        raise TypeError(f"libm_f32 takes float32, got {x.dtype}")
    out = torch.empty_like(x)
    out2 = torch.empty_like(x) if fn == 1 else None
    if out.numel():
        kernels.call("libm_f32", "tod_libm_f32",
                     [x.data_ptr(), 0 if y is None else y.data_ptr(),
                      out.data_ptr(), 0 if out2 is None else out2.data_ptr()],
                     [fn, out.numel()],
                     torch.cuda.current_stream(x.device).cuda_stream)
        libm_f32.launches += 1
    return (out, out2) if fn == 1 else out


libm_f32.launches = 0


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no libm path for {x.device}")
    return True


def cosf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` elementwise: the kernel on a CUDA tensor,
    :func:`cosf_torch` on a CPU tensor."""
    return libm_f32(0, x) if _route(x) else cosf_torch(x)


def sincosf(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """glibc's ``sincosf`` elementwise, ``(sin, cos)``: the kernel on a
    CUDA tensor, :func:`sincosf_torch` on a CPU tensor."""
    return libm_f32(1, x) if _route(x) else sincosf_torch(x)


def powf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """glibc's ``powf`` elementwise (one shape): the kernel on a CUDA
    tensor, :func:`powf_torch` on a CPU tensor."""
    if _route(x):
        return libm_f32(2, x, y)
    y, x = _checked(y, x)
    return powf_torch(x, y)


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's inline ``log`` elementwise: the kernel on a CUDA tensor,
    :func:`log_xla_torch` on a CPU tensor."""
    return libm_f32(3, x) if _route(x) else log_xla_torch(x)


def acosf(x: torch.Tensor) -> torch.Tensor:
    """``jnp.arccos`` of float32 as XLA's CPU backend compiles it
    (``chlo.acos``): ``atan2f(sqrt((1 - x) * (1 + x)), x)``, each operation
    rounded on its own, ``atan2f`` the C library's (kernel L1 on a CUDA
    tensor)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return atan2f(sqrt_rn((one - x) * (one + x)), x)
