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
