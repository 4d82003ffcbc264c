"""Perspective-n-Point: batched P3P minimal solver + Gauss-Newton refinement
(tod_tpu/geometry/pnp.py).

The 2D-only detection path's geometry: Grunert's P3P reduced to a quartic
solved in closed form (Ferrari) with a Newton polish for f32 stability,
then a Newton polish of the three distances; accepted poses are refined by
fixed-iteration Gauss-Newton on the reprojection error. Every function
works elementwise over any leading axes (objects x hypotheses x
candidates), where the reference vmaps one sample.

Conventions match the 3D path: poses are model -> camera, x_cam = R @ X + T;
pixels are x = K @ x_cam (pinhole, no distortion).

One set of bits on every device: the P3P distances are kernel P1
(``csrc/p3p.cu``) on a card and :func:`p3p_distances_torch` on the CPU,
the same float operations in the same order (glibc's ``powf`` and ``cosf``
and XLA's ``arccos`` form from ``ops/libm.py``); the Horn fit is
``kabsch(fixed=True)``. The refinement sums in fixed orders
(``transforms.pairwise_sum``, three-term products as
``transforms.mat_vec``) and takes ``sincosf`` from ``ops/libm.py``. Both
solve through :func:`lu_solve` (``geometry/lapack.py``): LAPACK's
``sgetrf`` and ``strsm`` as ``jnp.linalg.solve`` runs them on the
reference host, bit for bit.

Against the compiled reference, P3P holds its bits through the side
lengths (the reduce's FMA chain), the cosines, the four normalised
quartic coefficients (:func:`quartic_normalized`), Ferrari's solution
(:func:`ferrari_roots`, XLA's ``rsqrt`` as the reference host's
``rsqrtps`` and two Newton steps, ``ops/rsqrtps.py``), the six polishes
of the roots (:func:`polish_step`), the first distances and their eight
Newton steps (:func:`_cosine_law`): XLA's fusions with LLVM's
contractions, read off by ``tools/fit_p3p_fusions.py``. The Horn fit
folds P3P's unit weights and contracts multiply-adds in fusions the port
does not transcribe yet (ROADMAP queue C), so candidates agree with the
reference's within 1 mm, not bit for bit (``tests/test_torch_pnp.py``).
So does the refinement (its residual in ``jax.jacfwd``'s program, the
batched dots of ``J^T J``). Host waits: none. The reference
differentiates its
residual with ``jax.jacfwd``; the port writes the Jacobian out (at
``delta = 0`` both are the same function).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.geometry.lapack import lu_solve
from tod_tpu_torch.geometry.transforms import (dot3, kabsch, matmul3,
                                               pairwise_sum)
from tod_tpu_torch.ops import libm
from tod_tpu_torch.ops.image import fma_f32
from tod_tpu_torch.ops.rsqrtps import rsqrt_xla, rsqrtps_table


def _c(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device. A tensor divisor keeps a
    division true on a card (PyTorch's CUDA division by a Python number
    multiplies by its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: +-1, the zero itself, NaN for NaN (``torch.sign``
    gives 0 for NaN)."""
    return torch.where(x > 0, _c(1.0, x), torch.where(x < 0, _c(-1.0, x), x))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return _sign(x) * libm.powf(torch.abs(x),
                                torch.full_like(x, 1.0 / 3.0))


def solve_quartic(c4, c3, c2, c1, c0, polish_iters: int = 6,
                  normalized: Optional[Tuple[torch.Tensor, ...]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 (elementwise over
    any batch shape). Returns ``(roots (..., 4), valid (..., 4))``.

    Ferrari: depress with x = y - c3/(4 c4); factor via the resolvent
    cubic's largest real root (Cardano, or its trigonometric form when the
    cubic has three real roots); Newton-polish each root on the original
    quartic. Every operation in the reference's order, rounded on its own:
    a general solver (P3P takes :func:`ferrari_roots` and
    :func:`polish_step`, the compiled reference's rounding). ``normalized``,
    when given, is ``(c3/c4, c2/c4, c1/c4, c0/c4)`` as computed elsewhere
    (:func:`quartic_normalized`)."""
    def div(x, v):
        return x / _c(v, x)

    a, b, c, d = normalized if normalized is not None else (
        c3 / c4, c2 / c4, c1 / c4, c0 / c4)
    # depressed quartic y^4 + p y^2 + q y + r
    p = b - div(3.0 * a * a, 8.0)
    q = c - div(a * b, 2.0) + div(a * a * a, 8.0)
    r = (d - div(a * c, 4.0) + div(a * a * b, 16.0)
         - div(3.0 * a * a * a * a, 256.0))

    # resolvent cubic m^3 + A m^2 + B m + C = 0, Cardano
    A = p
    B = div(p * p, 4.0) - r
    C = div(-q * q, 8.0)
    Q = div(3.0 * B - A * A, 9.0)
    R = div(9.0 * A * B - 27.0 * C - 2.0 * (A * (A * A)), 54.0)
    Q3 = Q * (Q * Q)
    D = Q3 + R * R
    sqrtD = libm.sqrt_rn(torch.clamp_min(D, 0.0))
    m_pos = _cbrt(R + sqrtD) + _cbrt(R - sqrtD) - div(A, 3.0)
    theta = libm.acosf(torch.clamp(
        R / libm.sqrt_rn(torch.clamp_min(-Q3, 1e-30)), -1.0, 1.0))
    m_neg = 2.0 * libm.sqrt_rn(torch.clamp_min(-Q, 0.0)) \
        * libm.cosf(div(theta, 3.0)) - div(A, 3.0)
    m = torch.where(D >= 0, m_pos, m_neg)
    m = torch.clamp_min(m, 1e-12)

    # (y^2 + s y + t0)(y^2 - s y + t1), s = sqrt(2m)
    s = libm.sqrt_rn(2.0 * m)
    t0 = div(p, 2.0) + m - q / (2.0 * s)
    t1 = div(p, 2.0) + m + q / (2.0 * s)
    d0 = s * s - 4.0 * t0
    d1 = s * s - 4.0 * t1
    sq0 = libm.sqrt_rn(torch.clamp_min(d0, 0.0))
    sq1 = libm.sqrt_rn(torch.clamp_min(d1, 0.0))
    ys = torch.stack([div(-s + sq0, 2.0), div(-s - sq0, 2.0),
                      div(s + sq1, 2.0), div(s - sq1, 2.0)], dim=-1)
    valid = torch.stack([d0 >= 0, d0 >= 0, d1 >= 0, d1 >= 0], dim=-1)
    roots = ys - div(a, 4.0)[..., None]

    k4, k3, k2, k1, k0 = (x[..., None] for x in (c4, c3, c2, c1, c0))
    one = torch.ones((), dtype=roots.dtype, device=roots.device)
    for _ in range(polish_iters):
        f = (((k4 * roots + k3) * roots + k2) * roots + k1) * roots + k0
        fp = ((4.0 * k4 * roots + 3.0 * k3) * roots + 2.0 * k2) * roots + k1
        roots = roots - f / torch.where(torch.abs(fp) > 1e-12, fp, one)
    return roots, valid


class P3PSolutions(NamedTuple):
    R: torch.Tensor       # (..., 8, 3, 3) model -> camera candidate poses
    T: torch.Tensor       # (..., 8, 3)
    valid: torch.Tensor   # (..., 8)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return libm.sqrt_rn(dot3(x, x))


def _side(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(u - v)`` of (..., 3) points as the compiled
    reference reduces it: one FMA chain from the first square,
    ``sqrt(fma(d2, d2, fma(d1, d1, d0 d0)))`` (its object code,
    ``tools/fit_p3p_order.py``)."""
    d = u - v
    return libm.sqrt_rn(fma_f32(d[..., 2], d[..., 2], fma_f32(
        d[..., 1], d[..., 1], d[..., 0] * d[..., 0])))


def _cosine_law(s: torch.Tensor, ca, cb, cg, a2, b2, c2) -> torch.Tensor:
    """The three cosine-law residuals ``x^2 + y^2 - 2 x y cos - side^2``
    of distances ``s`` (..., 3), as the compiled reference's Newton step
    contracts them: ``fma(-(2 x y), cos, fma(x, x, y y)) - side^2``."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([
        fma_f32(-((x * 2.0) * y), cos, fma_f32(x, x, y * y)) - side
        for x, y, cos, side in ((s2, s3, ca, a2), (s1, s3, cb, b2),
                                (s1, s2, cg, c2))], dim=-1)


def quartic_coefficients(Ar, Br, ca, cb, cg) -> Tuple[torch.Tensor, ...]:
    """P3P's quartic in v = s3/s1, ``(C4, C3, C2, C1, C0)``, from the side
    ratios ``Ar`` = a^2/b^2, ``Br`` = c^2/b^2 and the cosines: the
    reference's expressions left to right, every operation rounded on its
    own (the compiled reference contracts multiply-adds here: P3P parts
    from it at this stage, ROADMAP queue C)."""
    C4 = (Ar * Ar - 2 * Ar * Br - 2 * Ar + Br * Br
          - 4 * Br * ca * ca + 2 * Br + 1)
    C3 = (-4 * Ar * Ar * cb + 8 * Ar * Br * cb + 4 * Ar * ca * cg
          + 4 * Ar * cb - 4 * Br * Br * cb + 8 * Br * ca * ca * cb
          + 4 * Br * ca * cg - 4 * Br * cb - 4 * ca * cg)
    C2 = (4 * Ar * Ar * cb * cb + 2 * Ar * Ar - 8 * Ar * Br * cb * cb
          - 4 * Ar * Br - 8 * Ar * ca * cb * cg - 4 * Ar * cg * cg
          + 4 * Br * Br * cb * cb + 2 * Br * Br - 4 * Br * ca * ca
          - 8 * Br * ca * cb * cg + 4 * ca * ca + 4 * cg * cg - 2)
    C1 = (-4 * Ar * Ar * cb + 8 * Ar * Br * cb + 4 * Ar * ca * cg
          + 8 * Ar * cb * cg * cg - 4 * Ar * cb - 4 * Br * Br * cb
          + 4 * Br * ca * cg + 4 * Br * cb - 4 * ca * cg)
    C0 = (Ar * Ar - 2 * Ar * Br - 4 * Ar * cg * cg + 2 * Ar
          + Br * Br - 2 * Br + 1)
    return C4, C3, C2, C1, C0


def quartic_normalized(Ar, Br, ca, cb, cg) -> Tuple[torch.Tensor, ...]:
    """``solve_quartic``'s first line, ``(C3/C4, C2/C4, C1/C4, C0/C4)``, as
    the compiled reference computes it: four fusions, each recomputing C4
    with its own contractions (LLVM folds a product with one use into the
    add or subtract that takes it, after its canonicalisation of negations
    and operand order; read off by ``tools/fit_p3p_fusions.py``), every
    multiply-add :func:`fma_f32`, the same on every device."""
    F = fma_f32
    A2, B2 = Ar + Ar, Br + Br
    A4, B4, A8, B8 = Ar * 4, Br * 4, Ar * 8, Br * 8
    c4 = ca * 4
    head = F(Ar, Ar, -(A2 * Br)) - A2            # Ar Ar - 2 Ar Br - 2 Ar
    den1 = (B2 + F(-(B4 * ca), ca, F(Br, Br, head))) + 1
    den2 = (B2 + (F(Br, Br, head) - B4 * ca * ca)) + 1
    den0 = (B2 + F(-(B4 * ca), ca, Br * Br + head)) + 1
    tail = -(A4 * Ar * cb)                       # -4 Ar Ar cb
    n3 = F(-c4, cg, F(-B4, cb, F(B4 * ca, cg, F(B8 * ca * ca, cb, F(
        -(B4 * Br), cb, F(A4, cb, F(A4 * ca, cg, F(A8 * Br, cb, tail))))))))
    n2 = F(cg * 4, cg, F(c4, ca, F(-(B8 * ca * cb), cg, F(B2, Br, F(
        B4 * Br * cb, cb, F(-(A4 * cg), cg, F(-(A8 * ca * cb), cg, F(
            -A4, Br, F(-(A8 * Br * cb), cb, F(A2, Ar, A4 * Ar * cb * cb))))
    ))) - B4 * ca * ca))) - 2
    n1 = F(-c4, cg, F(B4, cb, F(B4 * ca, cg, F(-(B4 * Br), cb, F(-A4, cb, F(
        A8 * cb * cg, cg, F(A4 * ca, cg, F(A8 * Br, cb, tail))))))))
    n0 = ((Br * Br + (A2 + F(-(A4 * cg), cg, F(Ar, Ar, -(A2 * Br))))) - B2) + 1
    return n3 / den1, n2 / den2, n1 / den1, n0 / den0


def _fma_c(a, value: float, c):
    """``fma(a, value, c)`` with a float32 constant."""
    return fma_f32(a, _c(value, a).expand_as(a), c)


def ferrari_roots(n3, n2, n1, n0) -> torch.Tensor:
    """Ferrari's four roots (..., 4) of the monic quartic ``y^4 + n3 y^3 +
    n2 y^2 + n1 y + n0`` (:func:`quartic_normalized`'s coefficients),
    before the polishes, as the compiled reference's fusions round them
    (read off by ``tools/fit_p3p_fusions.py``): divisions by constants are
    products by their float32 reciprocals, a product with one use fused
    into the add that takes it, the resolvent's ``arccos`` of ``R /
    sqrt(-Q^3)`` a product by :func:`rsqrt_xla`, ``R + sqrtD`` contracted
    in the cube roots' arguments and not in their signs, and each of the
    four roots a region of its own (``s^2 - 4 t`` an FMA there)."""
    F = fma_f32
    a, b, c, d = n3, n2, n1, n0
    # the depressed quartic y^4 + p y^2 + q y + r
    a3a = (a * 3.0) * a
    p = _fma_c(-a3a, 0.125, b)
    pp = p * p
    q = _fma_c((a * a) * a, 0.125, _fma_c(-(a * b), 0.5, c))
    r = _fma_c(-((a3a * a) * a), 0.00390625, _fma_c(
        (a * a) * b, 0.0625, _fma_c(-(a * c), 0.25, d)))
    # the resolvent cubic m^3 + p m^2 + B m + C, Cardano's Q, R and D
    B = _fma_c(pp, 0.25, -r)
    Q = _fma_c(B, 3.0, -pp) * _c(1.0 / 9.0, p)
    Rn = F(p * 9.0, B, (q * q) * 3.375) - (pp * p) * 2.0
    R = Rn * _c(1.0 / 54.0, p)
    QQ = Q * Q
    D = F(QQ, Q, R * R)
    zero = _c(0.0, p)
    sqrt_d = libm.sqrt_rn(torch.maximum(D, zero))
    sqrt_mq = libm.sqrt_rn(torch.maximum(-Q, zero))
    theta = libm.acosf(torch.clamp(R * rsqrt_xla(torch.maximum(
        -(QQ * Q), _c(1e-30, p))), -1.0, 1.0))
    third = _c(1.0 / 3.0, p)
    cube = [libm.powf(torch.abs(_fma_c(Rn, 1.0 / 54.0, sd)),
                      torch.full_like(p, 1.0 / 3.0))
            for sd in (sqrt_d, -sqrt_d)]
    m_pos = F(_sign(sqrt_d + R), cube[0], _sign(R - sqrt_d) * cube[1])
    m_neg = (sqrt_mq * 2.0) * libm.cosf(theta * third)
    m = torch.clamp_min(F(-p, third.expand_as(p),
                          torch.where(D >= 0, m_pos, m_neg)), 1e-12)
    # (y^2 + s y + t0)(y^2 - s y + t1), s = sqrt(2 m)
    s = libm.sqrt_rn(m * 2.0)
    q2s = q / (s * 2.0)
    h = _fma_c(p, 0.5, m)
    sq0 = libm.sqrt_rn(torch.maximum(F(s, s, -((h - q2s) * 4.0)), zero))
    sq1 = libm.sqrt_rn(torch.maximum(F(s, s, -((q2s + h) * 4.0)), zero))
    half = _c(0.5, p)
    ys = torch.stack([(sq0 - s) * half, (-s - sq0) * half,
                      (s + sq1) * half, (s - sq1) * half], dim=-1)
    return _fma_c(-a[..., None].expand_as(ys), 0.25, ys)


def polish_step(x: torch.Tensor, Ar, Br, ca, cb, cg) -> torch.Tensor:
    """One Newton polish of P3P's quartic roots ``x`` (..., 4): ``f / fp``
    of the quartic in ``v`` from the side ratios and cosines (..., 1), as
    the compiled reference's polish fusion recomputes its coefficients
    and contracts Horner's steps (read off by
    ``tools/fit_p3p_fusions.py``); ``fp`` taken as 1 where ``|fp| <=
    1e-12``."""
    F = fma_f32
    A2, A4, A8 = Ar * 2.0, Ar * 4.0, Ar * 8.0
    B2, B4 = Br * 2.0, Br * 4.0
    BB = Br * Br
    head = F(Ar, Ar, -(A2 * Br))                 # Ar Ar - 2 Ar Br
    B4ca = B4 * ca
    B4caca = B4ca * ca
    C4 = (B2 + ((BB + (head - A2)) - B4caca)) + 1.0
    A8Brcb = (A8 * Br) * cb
    # C3 and C1 share -4 Ar Ar cb + 8 Ar Br cb + 4 Ar ca cg
    c31 = F(A4 * ca, cg, A8Brcb - (A4 * Ar) * cb)
    A4cb = A4 * cb
    B4Brcb = (B4 * Br) * cb
    B8ca = (Br * 8.0) * ca
    B4cacg = B4ca * cg
    B4cb = B4 * cb
    ca4 = ca * 4.0
    ca4cg = ca4 * cg
    C3 = ((B4cacg + F(B8ca * ca, cb, (A4cb + c31) - B4Brcb)) - B4cb) - ca4cg
    A4cgcg = (A4 * cg) * cg
    c2 = F(-A4, Br, F(-A8Brcb, cb, F(A2, Ar, ((A4 * Ar) * cb) * cb)))
    c2 = F(B4Brcb, cb, F(-((A8 * ca) * cb), cg, c2) - A4cgcg)
    c2 = F(-(B8ca * cb), cg, F(B2, Br, c2) - B4caca)
    C2 = F(cg * 4.0, cg, F(ca4, ca, c2)) - 2.0
    C1 = ((B4cb + (B4cacg + ((F((A8 * cb) * cg, cg, c31) - A4cb)
                             - B4Brcb))) - ca4cg)
    C0 = (((BB + (A2 + (head - A4cgcg))) - B2) + 1.0)
    f = F(F(F(F(C4, x, C3), x, C2), x, C1), x, C0)
    fp = F(F(F(C4 * 4.0, x, C3 * 3.0), x, C2 * 2.0), x, C1)
    one = _c(1.0, x)
    return f / torch.where(torch.abs(fp) > 1e-12, fp, one)


def p3p_distances_torch(bearings: torch.Tensor, points: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel P1: for samples of ``bearings`` (..., 3,
    3) unit camera-frame rays and ``points`` (..., 3, 3) model points, the
    8 candidates' camera distances ``s`` (..., 8, 3) (4 quartic roots x 2
    back-substitution branches, each polished by 8 Newton steps) and their
    validity (..., 8): positive, finite, and solving the cosine-law system
    within 1e-4 of the largest squared side."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    a = _side(p2, p3)                      # opposite P1
    b = _side(p1, p3)                      # opposite P2
    c = _side(p1, p2)                      # opposite P3
    ca = dot3(f2, f3)                      # cosine of the angle facing a
    cb = dot3(f1, f3)
    cg = dot3(f1, f2)

    a2, b2, c2 = a * a, b * b, c * c
    # the quartic in v = s3/s1 with Ar = a^2/b^2, Br = c^2/b^2 (the
    # resultant of the two ratio equations)
    Ar = a2 / b2
    Br = c2 / b2

    # Ferrari's roots and six Newton polishes of them, as compiled
    v = ferrari_roots(*quartic_normalized(Ar, Br, ca, cb, cg))  # (..., 4)
    ratios = [x[..., None] for x in (Ar, Br, ca, cb, cg)]
    for _ in range(6):
        v = v - polish_step(v, *ratios)
    ca, cb, cg = ca[..., None], cb[..., None], cg[..., None]
    a2, b2, c2, Br = a2[..., None], b2[..., None], c2[..., None], Br[..., None]

    # s1 from side b: s1^2 (1 + v^2 - 2 v cos_b) = b^2, as compiled:
    # fma(-v, 2 cb, fma(v, v, 1))
    one = torch.ones_like(v)
    g = torch.clamp_min(fma_f32(-v, (cb * 2.0).expand_as(v),
                                fma_f32(v, v, one)), 1e-12)
    s1 = libm.sqrt_rn(b2 / g)
    # u = s2/s1 from side c; both branches are candidates (8 in all)
    disc = torch.clamp_min(cg * cg - fma_f32(-Br.expand_as(g), g, one), 0.0)
    sq = libm.sqrt_rn(disc)
    u = torch.cat([cg + sq, cg - sq], dim=-1)           # (..., 8)
    v8 = torch.cat([v, v], dim=-1)
    s1 = torch.cat([s1, s1], dim=-1)
    s = torch.stack([s1, u * s1, v8 * s1], dim=-1)      # (..., 8, 3)

    # Newton on the distances against the cosine-law system
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    eye9 = torch.eye(3, dtype=s.dtype, device=s.device) * _c(1e-9, s)
    for _ in range(8):
        s1_, s2_, s3_ = s[..., 0], s[..., 1], s[..., 2]
        F = _cosine_law(s, ca, cb, cg, a2, b2, c2)
        z = torch.zeros_like(s1_)
        # + 1e-9 I: the off-diagonal entries + 0, as the reference adds it
        J = torch.stack([
            torch.stack([z, 2 * s2_ - 2 * s3_ * ca,
                         2 * s3_ - 2 * s2_ * ca], -1),
            torch.stack([2 * s1_ - 2 * s3_ * cb, z,
                         2 * s3_ - 2 * s1_ * cb], -1),
            torch.stack([2 * s1_ - 2 * s2_ * cg,
                         2 * s2_ - 2 * s1_ * cg, z], -1)], dim=-2) + eye9
        delta = lu_solve(J, F)
        fin = torch.isfinite(delta).all(-1, keepdim=True)
        s = s - torch.where(fin, delta, zero)

    # post-polish validity: positive depths + the system actually solved
    res = _cosine_law(s, ca, cb, cg, a2, b2, c2)
    scale = torch.maximum(torch.maximum(a2, b2), c2)
    solved = (torch.abs(res) < 1e-4 * scale[..., None]).all(-1)
    ok = (s > 0).all(-1) & solved & torch.isfinite(s).all(-1)
    return s, ok


def p3p_distances(bearings: torch.Tensor, points: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`p3p_distances_torch`'s ``(s (..., 8, 3), ok (..., 8))``:
    kernel P1 on CUDA tensors (one launch, counted in
    ``p3p_distances.launches``; a failed launch raises), the plain version
    on CPU tensors."""
    if bearings.dtype != torch.float32 or points.dtype != torch.float32:
        raise TypeError(f"p3p takes float32, got {bearings.dtype}, "
                        f"{points.dtype}")
    if bearings.shape != points.shape or bearings.shape[-2:] != (3, 3) \
            or bearings.device != points.device:
        raise ValueError(f"p3p: bearings {tuple(bearings.shape)} on "
                         f"{bearings.device}, points {tuple(points.shape)} "
                         f"on {points.device}")
    if bearings.device.type == "cpu":
        return p3p_distances_torch(bearings, points)
    if bearings.device.type != "cuda":
        raise ValueError(f"no p3p path for {bearings.device}")
    lead = bearings.shape[:-2]
    s = torch.empty(lead + (8, 3), dtype=torch.float32,
                    device=bearings.device)
    ok = torch.empty(lead + (8,), dtype=torch.uint8, device=bearings.device)
    n = s.numel() // 24
    if n:
        # held by name until the launch: a freed copy's memory would take
        # the next copy
        bearings, points = bearings.contiguous(), points.contiguous()
        table = rsqrtps_table(bearings.device)
        kernels.call("p3p", "tod_p3p",
                     [bearings.data_ptr(), points.data_ptr(),
                      table.data_ptr(), s.data_ptr(), ok.data_ptr()], [n],
                     torch.cuda.current_stream(bearings.device).cuda_stream)
        p3p_distances.launches += 1
    return s, ok.bool()


p3p_distances.launches = 0


def p3p(bearings: torch.Tensor, points: torch.Tensor,
        trace: Optional[dict] = None) -> P3PSolutions:
    """Grunert's P3P: ``bearings`` (..., 3, 3) unit camera-frame rays,
    ``points`` (..., 3, 3) model-frame 3D points. Returns 8 candidate
    poses per sample (4 quartic roots x 2 back-substitution branches;
    duplicates and spurious candidates are masked by the post-polish
    residual gate): :func:`p3p_distances`, then Horn's fit of the camera
    points to the model points. ``trace``, when given, receives the
    distances and their validity (``p3p_s``, ``p3p_ok``)."""
    s, ok = p3p_distances(bearings, points)
    if trace is not None:
        trace.update(p3p_s=s, p3p_ok=ok)
    # camera-frame points -> Horn's absolute orientation to the model points
    f = bearings[..., None, :, :]                       # (..., 1, 3, 3)
    cam = s[..., :, :, None] * f                        # (..., 8, 3, 3)
    world = points[..., None, :, :].expand_as(cam)
    fit = kabsch(world, cam, torch.ones(cam.shape[:-1], dtype=cam.dtype,
                                        device=cam.device), fixed=True)
    return P3PSolutions(R=fit.R, T=fit.T, valid=ok & fit.ok)


def rotate(R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``X @ R^T`` for (..., N, 3) points and (..., 3, 3) poses (leading
    axes broadcast): each coordinate ``fma(x2, r2, fma(x1, r1, x0 r0))``
    as the compiled reference's product (``detection2d.rotate_points``'
    form, :func:`fma_f32`), the same on every device."""
    Rr = R[..., None, :, :]
    x0, x1, x2 = X[..., 0], X[..., 1], X[..., 2]
    return torch.stack([
        fma_f32(x2, Rr[..., j, 2], fma_f32(x1, Rr[..., j, 1],
                                           x0 * Rr[..., j, 0]))
        for j in range(3)], -1)


def project(R: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
            X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project model points ``X`` (..., N, 3) by poses (..., 3, 3) /
    (..., 3) (leading axes broadcast): ((..., N, 2) pixels, (..., N)
    in-front mask). Off the 2D path (its consensus is
    ``detection2d.reprojection_error``), kept differentiable for the tests'
    ``torch.func.jacfwd`` of the reference's residual: ``torch.matmul``."""
    cam = torch.matmul(X, R.transpose(-1, -2)) + T[..., None, :]
    z = cam[..., 2]
    zc = torch.where(torch.abs(z) > 1e-9, z,
                     torch.full((), 1e-9, dtype=z.dtype, device=z.device))
    u = K[0, 0] * cam[..., 0] / zc + K[0, 2]
    v = K[1, 1] * cam[..., 1] / zc + K[1, 2]
    return torch.stack([u, v], dim=-1), z > 1e-6


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], dim=-2)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Exponential map of (..., 3) rotation vectors (``sincosf`` of the
    angle, as the compiled reference calls it; ``kx @ kx`` by
    :func:`matmul3`)."""
    th = _norm(w) + 1e-12
    kx = skew(w / th[..., None])
    sin, cos = libm.sincosf(th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + sin[..., None, None] * kx \
        + (1.0 - cos[..., None, None]) * matmul3(kx, kx)


def reprojection_jacobian(R: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
                          X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted reprojection residual of pose (R, T) and its Jacobian
    with respect to the update ``delta = (omega, t)`` at ``delta = 0``,
    where the updated pose is ``(I + [omega]x + [omega]x^2 / 2) R`` and
    ``T + t`` (the reference's ``rot_smooth``). Returns ``(r (..., N, 2),
    J (..., N, 2, 6))``: row 0 the u residual, row 1 the v residual."""
    y = rotate(R, X)                                    # R X, (..., N, 3)
    cam = y + T[..., None, :]
    x_, y_, z = cam[..., 0], cam[..., 1], cam[..., 2]
    live = torch.abs(z) > 1e-9
    zc = torch.where(live, z, torch.full((), 1e-9, dtype=z.dtype,
                                         device=z.device))
    fx, fy = K[0, 0], K[1, 1]
    u = fx * x_ / zc + K[0, 2]
    v = fy * y_ / zc + K[1, 2]
    r = torch.stack([(u - uv[..., 0]) * w, (v - uv[..., 1]) * w], dim=-1)
    # d(u, v)/d cam: the clamp of z has no derivative where it binds
    dz = live.to(z.dtype)
    a = fx / zc * w
    b = fy / zc * w
    c = -fx * x_ / (zc * zc) * dz * w
    d = -fy * y_ / (zc * zc) * dz * w
    # d cam / d omega = -[R X]x, d cam / d t = I
    y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
    zero = torch.zeros_like(a)
    ju = torch.stack([c * y1, a * y2 - c * y0, -a * y1, a, zero, c], -1)
    jv = torch.stack([d * y1 - b * y2, -d * y0, b * y0, zero, b, d], -1)
    return r, torch.stack([ju, jv], dim=-2)


def _per_object(lead: tuple, *ts: Tuple[torch.Tensor, tuple]):
    """The (..., N, c) tensors ``ts`` (each with its tail ``(N, c)``) as
    contiguous float32 rows once an object, and the poses an object: the
    trailing leading axes of ``lead`` over which every tensor of ``ts``
    has size 1 are the poses that share an object's rows."""
    batches = [(1,) * (len(lead) + len(tail) - t.dim()) + tuple(t.shape[
        :t.dim() - len(tail)]) for t, tail in ts]
    k = max(max((i + 1 for i, b in enumerate(batch) if b != 1), default=0)
            for batch in batches)
    rows = [t.to(torch.float32).reshape(batch[:k] + tail).expand(
        lead[:k] + tail).reshape((-1,) + tail).contiguous()
        for (t, tail), batch in zip(ts, batches)]
    return rows, math.prod(lead[k:])


def gauss_newton_pose(R0: torch.Tensor, T0: torch.Tensor, K: torch.Tensor,
                      X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
                      iters: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine poses by fixed-iteration Gauss-Newton on the weighted
    reprojection error. ``R0`` (..., 3, 3), ``T0`` (..., 3); ``X`` (..., N,
    3) model points, ``uv`` (..., N, 2) observed pixels, ``w`` (..., N)
    weights (0 masks a row out), leading axes broadcast. Returns (R, T):
    kernel P2 (``csrc/gauss_newton.cu``, one launch a call, counted in
    ``gauss_newton_pose.launches``; a failed launch raises) on CUDA
    tensors, :func:`gauss_newton_pose_torch` on CPU tensors. P2 takes any
    N, and reads ``X`` and ``uv`` once an object: the poses that share
    them (where their leading axes are 1) are not given copies."""
    if R0.device.type == "cpu":
        return gauss_newton_pose_torch(R0, T0, K, X, uv, w, iters)
    if R0.device.type != "cuda":
        raise ValueError(f"no Gauss-Newton path for {R0.device}")
    n = X.shape[-2]
    lead = torch.broadcast_shapes(R0.shape[:-2], T0.shape[:-1],
                                  X.shape[:-2], uv.shape[:-2], w.shape[:-1])

    def flat(t: torch.Tensor, tail) -> torch.Tensor:
        return t.to(torch.float32).expand(lead + tail).reshape(
            (-1,) + tail).contiguous()

    r0, t0, ws = flat(R0, (3, 3)), flat(T0, (3,)), flat(w, (n,))
    (xs, us), per_object = _per_object(tuple(lead), (X, (n, 3)),
                                       (uv, (n, 2)))
    R, T = torch.empty_like(r0), torch.empty_like(t0)
    if r0.shape[0]:
        k = K.to(device=R0.device, dtype=torch.float32).contiguous()
        kernels.call("gauss_newton", "tod_gauss_newton",
                     [r0.data_ptr(), t0.data_ptr(), k.data_ptr(),
                      xs.data_ptr(), us.data_ptr(), ws.data_ptr(),
                      R.data_ptr(), T.data_ptr()],
                     [r0.shape[0], n, per_object, iters],
                     torch.cuda.current_stream(R0.device).cuda_stream)
        gauss_newton_pose.launches += 1
    return R.reshape(lead + (3, 3)), T.reshape(lead + (3,))


gauss_newton_pose.launches = 0


def gauss_newton_pose_torch(R0: torch.Tensor, T0: torch.Tensor,
                            K: torch.Tensor, X: torch.Tensor,
                            uv: torch.Tensor, w: torch.Tensor,
                            iters: int = 5
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel P2 (:func:`gauss_newton_pose`): ``J^T
    J`` and ``J^T r`` sum their 2N rows in ``transforms.pairwise_sum``'s
    order, the step is :func:`lu_solve`'s, and the update
    :func:`matmul3`'s: the same bits on every device."""
    R, T = R0, T0
    eye6 = 1e-6 * torch.eye(6, dtype=R0.dtype, device=R0.device)
    zero = torch.zeros((), dtype=R0.dtype, device=R0.device)
    for _ in range(iters):
        r, J = reprojection_jacobian(R, T, K, X, uv, w)
        J = J.flatten(-3, -2)                            # (..., 2N, 6)
        H = pairwise_sum(J[..., :, :, None] * J[..., :, None, :], -3) + eye6
        g = pairwise_sum(J * r.flatten(-2)[..., None], -2)
        delta = -lu_solve(H, g)
        ok = torch.isfinite(delta).all(-1, keepdim=True)
        delta = torch.where(ok, delta, zero)
        R = matmul3(rodrigues(delta[..., :3]), R)
        T = T + delta[..., 3:]
    return R, T


__all__ = ["P3PSolutions", "gauss_newton_pose",
           "gauss_newton_pose_torch", "lu_solve", "p3p", "p3p_distances",
           "p3p_distances_torch", "project", "quartic_coefficients",
           "quartic_normalized",
           "reprojection_jacobian", "rodrigues", "rotate", "skew",
           "solve_quartic"]
