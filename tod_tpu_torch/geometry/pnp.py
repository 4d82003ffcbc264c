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

Host waits: none. The 3x3 Newton step of P3P is solved in closed form
(cofactors), the 6x6 Gauss-Newton step with ``torch.linalg.solve_ex``
without its error check, and the Gauss-Newton Jacobian is written out
analytically (the reference differentiates its residual with
``jax.jacfwd``; at ``delta = 0`` both are the same function).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tod_tpu_torch.geometry.transforms import _adjugate_t3, _det3, kabsch


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def solve_quartic(c4, c3, c2, c1, c0, polish_iters: int = 6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 (elementwise over
    any batch shape). Returns ``(roots (..., 4), valid (..., 4))``.

    Ferrari: depress with x = y - c3/(4 c4); factor via the resolvent
    cubic's largest real root (Cardano, or its trigonometric form when the
    cubic has three real roots); Newton-polish each root on the original
    quartic."""
    a = c3 / c4
    b = c2 / c4
    c = c1 / c4
    d = c0 / c4
    # depressed quartic y^4 + p y^2 + q y + r
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a * a * a / 8.0
    r = (d - a * c / 4.0 + a * a * b / 16.0
         - 3.0 * a * a * a * a / 256.0)

    # resolvent cubic m^3 + A m^2 + B m + C = 0, Cardano
    A = p
    B = p * p / 4.0 - r
    C = -q * q / 8.0
    Q = (3.0 * B - A * A) / 9.0
    R = (9.0 * A * B - 27.0 * C - 2.0 * (A * (A * A))) / 54.0
    Q3 = Q * (Q * Q)
    D = Q3 + R * R
    sqrtD = torch.sqrt(torch.clamp_min(D, 0.0))
    m_pos = _cbrt(R + sqrtD) + _cbrt(R - sqrtD) - A / 3.0
    theta = torch.arccos(torch.clamp(
        R / torch.sqrt(torch.clamp_min(-Q3, 1e-30)), -1.0, 1.0))
    m_neg = 2.0 * torch.sqrt(torch.clamp_min(-Q, 0.0)) \
        * torch.cos(theta / 3.0) - A / 3.0
    m = torch.where(D >= 0, m_pos, m_neg)
    m = torch.clamp_min(m, 1e-12)

    # (y^2 + s y + t0)(y^2 - s y + t1), s = sqrt(2m)
    s = torch.sqrt(2.0 * m)
    t0 = p / 2.0 + m - q / (2.0 * s)
    t1 = p / 2.0 + m + q / (2.0 * s)
    d0 = s * s - 4.0 * t0
    d1 = s * s - 4.0 * t1
    sq0 = torch.sqrt(torch.clamp_min(d0, 0.0))
    sq1 = torch.sqrt(torch.clamp_min(d1, 0.0))
    ys = torch.stack([(-s + sq0) / 2.0, (-s - sq0) / 2.0,
                      (s + sq1) / 2.0, (s - sq1) / 2.0], dim=-1)
    valid = torch.stack([d0 >= 0, d0 >= 0, d1 >= 0, d1 >= 0], dim=-1)
    roots = ys - (a / 4.0)[..., None]

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
    return torch.sqrt((x * x).sum(-1))


def _solve3(J: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """J^-1 F for (..., 3, 3) J and (..., 3) F by cofactors (no host wait);
    a singular J gives non-finite entries, as an LU solve does."""
    adj_t = _adjugate_t3(J)                      # inv(J)^T det(J)
    return torch.einsum("...ji,...j->...i", adj_t, F) / _det3(J)[..., None]


def _cosine_law(s: torch.Tensor, ca, cb, cg, a2, b2, c2) -> torch.Tensor:
    """The three cosine-law residuals of distances ``s`` (..., 3)."""
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([
        s2 * s2 + s3 * s3 - 2 * s2 * s3 * ca - a2,
        s1 * s1 + s3 * s3 - 2 * s1 * s3 * cb - b2,
        s1 * s1 + s2 * s2 - 2 * s1 * s2 * cg - c2], dim=-1)


def p3p(bearings: torch.Tensor, points: torch.Tensor) -> P3PSolutions:
    """Grunert's P3P: ``bearings`` (..., 3, 3) unit camera-frame rays,
    ``points`` (..., 3, 3) model-frame 3D points. Returns 8 candidate
    poses per sample (4 quartic roots x 2 back-substitution branches;
    duplicates and spurious candidates are masked by the post-polish
    residual gate)."""
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    a = _norm(p2 - p3)                     # opposite P1
    b = _norm(p1 - p3)                     # opposite P2
    c = _norm(p1 - p2)                     # opposite P3
    ca = (f2 * f3).sum(-1)                 # cosine of the angle facing a
    cb = (f1 * f3).sum(-1)
    cg = (f1 * f2).sum(-1)

    a2, b2, c2 = a * a, b * b, c * c
    # the quartic in v = s3/s1 with Ar = a^2/b^2, Br = c^2/b^2 (the
    # resultant of the two ratio equations)
    Ar = a2 / b2
    Br = c2 / b2
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

    v, _ = solve_quartic(C4, C3, C2, C1, C0)            # (..., 4)
    ca, cb, cg = ca[..., None], cb[..., None], cg[..., None]
    a2, b2, c2, Br = a2[..., None], b2[..., None], c2[..., None], Br[..., None]

    # s1 from side b: s1^2 (1 + v^2 - 2 v cos_b) = b^2
    g = torch.clamp_min(1.0 + v * v - 2.0 * v * cb, 1e-12)
    s1 = torch.sqrt(b2 / g)
    # u = s2/s1 from side c; both branches are candidates (8 in all)
    disc = torch.clamp_min(cg * cg - (1.0 - Br * g), 0.0)
    sq = torch.sqrt(disc)
    u = torch.cat([cg + sq, cg - sq], dim=-1)           # (..., 8)
    v8 = torch.cat([v, v], dim=-1)
    s1 = torch.cat([s1, s1], dim=-1)
    s = torch.stack([s1, u * s1, v8 * s1], dim=-1)      # (..., 8, 3)

    # Newton on the distances against the cosine-law system
    eye = 1e-9 * torch.eye(3, dtype=s.dtype, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    for _ in range(8):
        s1_, s2_, s3_ = s[..., 0], s[..., 1], s[..., 2]
        F = _cosine_law(s, ca, cb, cg, a2, b2, c2)
        z = torch.zeros_like(s1_)
        J = torch.stack([
            torch.stack([z, 2 * s2_ - 2 * s3_ * ca,
                         2 * s3_ - 2 * s2_ * ca], -1),
            torch.stack([2 * s1_ - 2 * s3_ * cb, z,
                         2 * s3_ - 2 * s1_ * cb], -1),
            torch.stack([2 * s1_ - 2 * s2_ * cg,
                         2 * s2_ - 2 * s1_ * cg, z], -1)], dim=-2) + eye
        delta = _solve3(J, F)
        fin = torch.isfinite(delta).all(-1, keepdim=True)
        s = s - torch.where(fin, delta, zero)

    # post-polish validity: positive depths + the system actually solved
    res = _cosine_law(s, ca, cb, cg, a2, b2, c2)
    scale = torch.maximum(torch.maximum(a2, b2), c2)
    solved = (torch.abs(res) < 1e-4 * scale[..., None]).all(-1)
    ok = (s > 0).all(-1) & solved & torch.isfinite(s).all(-1)

    # camera-frame points -> Horn's absolute orientation to the model points
    f = bearings[..., None, :, :]                       # (..., 1, 3, 3)
    cam = s[..., :, :, None] * f                        # (..., 8, 3, 3)
    world = points[..., None, :, :].expand_as(cam)
    fit = kabsch(world, cam, torch.ones(cam.shape[:-1], dtype=cam.dtype,
                                        device=cam.device))
    return P3PSolutions(R=fit.R, T=fit.T, valid=ok & fit.ok)


def project(R: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
            X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project model points ``X`` (..., N, 3) by poses (..., 3, 3) /
    (..., 3) (leading axes broadcast): ((..., N, 2) pixels, (..., N)
    in-front mask)."""
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
    """Exponential map of (..., 3) rotation vectors."""
    th = _norm(w) + 1e-12
    kx = skew(w / th[..., None])
    th = th[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * kx + (1.0 - torch.cos(th)) * (kx @ kx)


def reprojection_jacobian(R: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
                          X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted reprojection residual of pose (R, T) and its Jacobian
    with respect to the update ``delta = (omega, t)`` at ``delta = 0``,
    where the updated pose is ``(I + [omega]x + [omega]x^2 / 2) R`` and
    ``T + t`` (the reference's ``rot_smooth``). Returns ``(r (..., N, 2),
    J (..., N, 2, 6))``: row 0 the u residual, row 1 the v residual."""
    y = torch.matmul(X, R.transpose(-1, -2))            # R X, (..., N, 3)
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


def gauss_newton_pose(R0: torch.Tensor, T0: torch.Tensor, K: torch.Tensor,
                      X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
                      iters: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine poses by fixed-iteration Gauss-Newton on the weighted
    reprojection error. ``R0`` (..., 3, 3), ``T0`` (..., 3); ``X`` (..., N,
    3) model points, ``uv`` (..., N, 2) observed pixels, ``w`` (..., N)
    weights (0 masks a row out), leading axes broadcast. Returns (R, T)."""
    R, T = R0, T0
    eye6 = 1e-6 * torch.eye(6, dtype=R0.dtype, device=R0.device)
    zero = torch.zeros((), dtype=R0.dtype, device=R0.device)
    for _ in range(iters):
        r, J = reprojection_jacobian(R, T, K, X, uv, w)
        J = J.flatten(-3, -2)                            # (..., 2N, 6)
        H = J.transpose(-1, -2) @ J + eye6
        g = (J.transpose(-1, -2) @ r.flatten(-2)[..., None])[..., 0]
        delta = -torch.linalg.solve_ex(H, g[..., None],
                                       check_errors=False)[0][..., 0]
        ok = torch.isfinite(delta).all(-1, keepdim=True)
        delta = torch.where(ok, delta, zero)
        R = rodrigues(delta[..., :3]) @ R
        T = T + delta[..., 3:]
    return R, T


__all__ = ["P3PSolutions", "gauss_newton_pose", "p3p", "project",
           "reprojection_jacobian", "rodrigues", "skew", "solve_quartic"]
