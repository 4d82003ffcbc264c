"""Rigid-transform estimation (tod_tpu/geometry/transforms.py).

The RANSAC model fits (R, T) with R @ query + T ~= training (camera ->
object frame); the emitted pose is its inverse (object -> camera). Rotations
come from Horn's unit-quaternion closed form with a branch-free Newton
iteration on the characteristic quartic, written out in the reference's
operation order so that both packages round alike.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tod_tpu_torch.ops.image import fma_f32


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _adjugate_t3(m: torch.Tensor) -> torch.Tensor:
    """Transposed adjugate (cofactor matrix) of a 3x3: inv(m)^T * det(m)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack([
        torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], -1),
        torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], -1),
        torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], -1),
    ], -2)


def polar_rotation(H: torch.Tensor, n_iter: int = 9
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthogonal polar factor of (..., 3, 3) via scaled Newton iteration.
    Returns ``(R, ok)``; ``ok`` flags well-conditioned inputs with
    det(H) > 0."""
    det_h = _det3(H)
    norm = torch.sqrt((H * H).sum((-2, -1), keepdim=True)) + 1e-30
    ok = det_h > 1e-9 * (norm[..., 0, 0] ** 3 + 1e-30)
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape)
    X = torch.where(ok[..., None, None], H / norm, eye)
    for _ in range(n_iter):
        mu = torch.abs(_det3(X)) ** (-1.0 / 3.0)
        Xs = X * mu[..., None, None]
        X = 0.5 * (Xs + _adjugate_t3(Xs) / _det3(Xs)[..., None, None])
    return X, ok


_FIRST_ROW = tuple((0, j) for j in range(4))
_ALL_MINORS = tuple((i, j) for j in range(4) for i in range(4))
_index_cache: dict = {}


def _minors3(m: torch.Tensor, pairs) -> torch.Tensor:
    """(..., P) determinants of the 3x3 submatrices of (..., 4, 4) ``m``
    without row i and column j, for each (i, j) in ``pairs``: one gather
    and one batched determinant (index tensors cached per device, so no
    host copy per call)."""
    key = (m.device, pairs)
    if key not in _index_cache:
        rows = [[r for r in range(4) if r != i] for i, _ in pairs]
        cols = [[c for c in range(4) if c != j] for _, j in pairs]
        _index_cache[key] = (torch.tensor(rows, device=m.device)[:, :, None],
                             torch.tensor(cols, device=m.device)[:, None, :])
    rows, cols = _index_cache[key]
    return _det3(m[..., rows, cols])


def _det4(m: torch.Tensor) -> torch.Tensor:
    """Branch-free 4x4 determinant by cofactor expansion on the first row."""
    minor = _minors3(m, _FIRST_ROW)
    return (m[..., 0, 0] * minor[..., 0] - m[..., 0, 1] * minor[..., 1]
            + m[..., 0, 2] * minor[..., 2] - m[..., 0, 3] * minor[..., 3])


def _adjugate4(m: torch.Tensor) -> torch.Tensor:
    """Classical adjugate of a (..., 4, 4): adj(m) @ m = det(m) I, i.e.
    adj[..., j, i] is the (i, j) cofactor."""
    key = (m.device, "signs")
    if key not in _index_cache:
        _index_cache[key] = torch.tensor(
            [1.0 if (i + j) % 2 == 0 else -1.0 for i, j in _ALL_MINORS],
            device=m.device)
    cof = _minors3(m, _ALL_MINORS) * _index_cache[key]
    return cof.unflatten(-1, (4, 4))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix, (...,4) -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def horn_rotation(S: torch.Tensor, n_newton: int = 12
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rotation R (R q ~= t) from S = sum_i w_i q~_i t~_i^T by
    Horn's quaternion method: Newton from above on the largest root of the
    characteristic quartic, the eigenvector read off the adjugate of
    (N - lambda I). Exact for rank-2 correlations. Returns (R, ok)."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
    ], -2)
    c2 = -2.0 * (S * S).sum((-2, -1))
    c1 = -8.0 * _det3(S)
    c0 = _det4(N)
    lam = torch.sqrt((N * N).sum((-2, -1))) + 1e-30
    tiny = torch.full((), 1e-30, dtype=S.dtype, device=S.device)
    for _ in range(n_newton):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(torch.abs(dp) > 1e-30, dp, tiny)
    A = N - lam[..., None, None] * torch.eye(4, dtype=S.dtype, device=S.device)
    adj = _adjugate4(A)
    col_norm_sq = (adj * adj).sum(-2)                       # (..., 4)
    pick = torch.argmax(col_norm_sq, -1)
    v = torch.take_along_dim(adj, pick[..., None, None].expand(
        *pick.shape, 4, 1), -1)[..., 0]                      # (..., 4)
    v_norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    norm_n = torch.sqrt((N * N).sum((-2, -1))) + 1e-30
    ok = (v_norm[..., 0] > 1e-12 * norm_n) & (lam > 0)
    q = v / torch.where(v_norm > 0, v_norm, torch.ones_like(v_norm))
    R = quat_to_mat(q)
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(R.shape)
    return torch.where(ok[..., None, None], R, eye), ok


class RigidFit(NamedTuple):
    R: torch.Tensor    # (..., 3, 3) with R @ query + T ~= training
    T: torch.Tensor    # (..., 3)
    ok: torch.Tensor   # (...,) bool — enough weight + well-posed rotation


def kabsch(query: torch.Tensor, training: torch.Tensor,
           weights: torch.Tensor) -> RigidFit:
    """Weighted rigid fit R @ query + T ~= training (Horn 1987).
    ``query``/``training``: (..., N, 3); ``weights``: (..., N) >= 0."""
    w = weights[..., None].to(torch.float32)
    wsum = w.sum(-2) + 1e-30                      # (..., 1)
    cq = (w * query).sum(-2) / wsum               # (..., 3)
    ct = (w * training).sum(-2) / wsum
    qc = (query - cq[..., None, :]) * w
    tc = training - ct[..., None, :]
    S = torch.einsum("...ni,...nj->...ij", qc, tc)
    R, ok = horn_rotation(S)
    T = ct - torch.einsum("...ij,...j->...i", R, cq)
    enough = weights.to(torch.float32).sum(-1) >= 3.0
    return RigidFit(R=R, T=T, ok=ok & enough)


def apply_rt(R: torch.Tensor, T: torch.Tensor,
             points: torch.Tensor) -> torch.Tensor:
    """R @ p + T for (..., N, 3) points with broadcasting pose dims, summed
    in the reference's order (column 0, then 1, then 2)."""
    p0, p1, p2 = points[..., None, 0], points[..., None, 1], points[..., None, 2]
    r = R[..., None, :, :]
    out = r[..., 0] * p0 + r[..., 1] * p1 + r[..., 2] * p2
    return out + T[..., None, :]


def invert_pose(R: torch.Tensor, T: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R_out = R^T, T_out = -R_out @ T."""
    R_out = R.transpose(-1, -2)
    return R_out, -torch.einsum("...ij,...j->...i", R_out, T)


def camera_to_world(R: torch.Tensor, T: torch.Tensor,
                    points: torch.Tensor) -> torch.Tensor:
    """world = (x - T) @ R for (K, 3) camera-frame points
    (training.cpp:175-195), summed as the compiled reference's CPU dot of
    shape (K, 3) x (3, 3) sums (read off its results): in rows below
    ``K // 8 * 8``, columns 0 and 1 as ``(d0 r0 + d1 r1) + d2 r2`` with
    every operation rounded and column 2 as the fused chain
    ``fma(d2, r2, fma(d1, r1, d0 r0))``; the tail rows use the chain in
    every column. Bit-equal to ``jax.jit`` from K = 40 on (the trainer's K
    is its feature count); below, XLA's small-dot code orders some rows
    otherwise."""
    d = points.to(torch.float32) - T.reshape(1, 3).to(torch.float32)
    R = R.to(torch.float32)
    d0, d1, d2 = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    chain = fma_f32(d2, R[2], fma_f32(d1, R[1], d0 * R[0]))
    split = (d0 * R[0] + d1 * R[1]) + d2 * R[2]
    body = torch.arange(d.shape[0], device=d.device)[:, None] \
        < d.shape[0] // 8 * 8
    column = torch.arange(3, device=d.device)[None, :] < 2
    return torch.where(body & column, split, chain)
