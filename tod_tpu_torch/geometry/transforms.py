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
from tod_tpu_torch.ops.libm import sqrt_rn


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


def pairwise_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.sum(dim)`` in one fixed order on every device: the two halves
    added elementwise, an odd last row carried, until one row is left (each
    an elementwise add, rounded alike on the CPU and the card). ``dim`` may
    be a tuple of trailing dims, flattened first."""
    if isinstance(dim, tuple):
        first, last = (d % x.dim() for d in (dim[0], dim[-1]))
        x, dim = x.flatten(first, last), first
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        pair = x[:half] + x[half:2 * half]
        x = torch.cat([pair, x[2 * half:]]) if x.shape[0] % 2 else pair
    return x[0]


def dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) dot products as ``(u0 v0 + u1 v1) + u2 v2``, every
    operation rounded, the same on every device."""
    return (u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]) \
        + u[..., 2] * v[..., 2]


def cross3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) cross products, each entry two products and a difference."""
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for (..., 3, 3) matrices, each entry ``(a0 b0 + a1 b1) +
    a2 b2`` with every operation rounded (:func:`mat_vec`'s order), the
    same on every device."""
    return (A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :]) \
        + A[..., :, 2:3] * B[..., 2:3, :]


def horn_rotation(S: torch.Tensor, n_newton: int = 12, fixed: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rotation R (R q ~= t) from S = sum_i w_i q~_i t~_i^T by
    Horn's quaternion method: Newton from above on the largest root of the
    characteristic quartic, the eigenvector read off the adjugate of
    (N - lambda I). Exact for rank-2 correlations. Returns (R, ok).
    ``fixed`` takes every sum in :func:`pairwise_sum`'s order and every
    root correctly rounded (``ops/libm.py sqrt_rn``), so that the bits do
    not depend on the device."""
    total = pairwise_sum if fixed else (lambda x, d: x.sum(d))
    sqrt = sqrt_rn if fixed else torch.sqrt
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
    ], -2)
    c2 = -2.0 * total(S * S, (-2, -1))
    c1 = -8.0 * _det3(S)
    c0 = _det4(N)
    lam = sqrt(total(N * N, (-2, -1))) + 1e-30
    tiny = torch.full((), 1e-30, dtype=S.dtype, device=S.device)
    for _ in range(n_newton):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(torch.abs(dp) > 1e-30, dp, tiny)
    A = N - lam[..., None, None] * torch.eye(4, dtype=S.dtype, device=S.device)
    adj = _adjugate4(A)
    col_norm_sq = total(adj * adj, -2)                      # (..., 4)
    pick = torch.argmax(col_norm_sq, -1)
    v = torch.take_along_dim(adj, pick[..., None, None].expand(
        *pick.shape, 4, 1), -1)[..., 0]                      # (..., 4)
    v_norm = sqrt(total(v * v, -1))[..., None]
    norm_n = sqrt(total(N * N, (-2, -1))) + 1e-30
    ok = (v_norm[..., 0] > 1e-12 * norm_n) & (lam > 0)
    q = v / torch.where(v_norm > 0, v_norm, torch.ones_like(v_norm))
    R = quat_to_mat(q)
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(R.shape)
    return torch.where(ok[..., None, None], R, eye), ok


class RigidFit(NamedTuple):
    R: torch.Tensor    # (..., 3, 3) with R @ query + T ~= training
    T: torch.Tensor    # (..., 3)
    ok: torch.Tensor   # (...,) bool — enough weight + well-posed rotation


FIXED_ORDER_MIN = 4   # CUDA sums of this many rows and more: row_sum


def row_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.sum(dim)``; on a CUDA tensor of at least ``FIXED_ORDER_MIN``
    rows along ``dim``, in one fixed pairwise order (the two halves added
    elementwise, an odd last row carried), so that each sum is the same
    however many rows share the call: CUDA's reduction kernels and batched
    products split a long reduction by the whole tensor's shape (measured
    on the H100 for sums over 192 and 384 rows), and the sharded paths run
    an object's fit in smaller batches than one device does. Sums of three
    rows (the triples' fits) came out the same at every batch measured and
    keep the library's order; so do CPU tensors, whose sums are already
    independent of the other rows (the parity tests hold their results)."""
    if not x.is_cuda or x.shape[dim] < FIXED_ORDER_MIN:
        return x.sum(dim)
    return pairwise_sum(x, dim)


def kabsch(query: torch.Tensor, training: torch.Tensor,
           weights: torch.Tensor, fixed: bool = False) -> RigidFit:
    """Weighted rigid fit R @ query + T ~= training (Horn 1987).
    ``query``/``training``: (..., N, 3); ``weights``: (..., N) >= 0. The
    sums over N go through :func:`row_sum`; with ``fixed`` every sum and
    product goes through :func:`pairwise_sum` and :func:`mat_vec`'s order
    on every device (P3P's candidate fits: the same bits on the CPU and the
    card)."""
    total = pairwise_sum if fixed else row_sum
    w = weights[..., None].to(torch.float32)
    wsum = total(w, -2) + 1e-30                   # (..., 1)
    cq = total(w * query, -2) / wsum              # (..., 3)
    ct = total(w * training, -2) / wsum
    qc = (query - cq[..., None, :]) * w
    tc = training - ct[..., None, :]
    if fixed or (qc.is_cuda and qc.shape[-2] >= FIXED_ORDER_MIN):
        S = total(qc[..., :, None] * tc[..., None, :], -3)
    else:
        S = torch.einsum("...ni,...nj->...ij", qc, tc)
    R, ok = horn_rotation(S, fixed=fixed)
    T = ct - (dot3(R, cq[..., None, :]) if fixed else mat_vec(R, cq))
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


def mat_vec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` for (..., 3, 3) and (..., 3). On a CUDA tensor the three
    terms are summed elementwise in one fixed order (column 0, then 1,
    then 2), as :func:`apply_rt` does, so that an object's fit cannot
    depend on how many objects share the call (cuBLAS may take another
    path for a batch of one matrix than for several). CPU tensors keep the
    library's product, which the parity tests hold to the reference."""
    if not R.is_cuda:
        return torch.einsum("...ij,...j->...i", R, v)
    return dot3(R, v[..., None, :])


def invert_pose(R: torch.Tensor, T: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R_out = R^T, T_out = -R_out @ T (:func:`mat_vec`)."""
    R_out = R.transpose(-1, -2)
    return R_out, -mat_vec(R_out, T)


def _split_rows(k: int, views: int) -> int:
    """How many leading rows of a (k, 3) x (3, 3) dot the compiled
    reference's CPU code sums with columns 0 and 1 split (read off
    ``jax.jit`` at every k from 1 to 69 and at 600, 1000 and 1003, one view
    and vmapped over 2-8): the 8-row blocks from k = 40 on; below, none
    under 16 rows, the 8-row blocks when ``k % 8 < 4``, and at 36-39 rows
    the blocks for one view but none in a vmapped batch of several."""
    body = k // 8 * 8
    if k >= 40:
        return body
    if k < 16 or (k % 8 >= 4 and (k < 32 or views > 1)):
        return 0
    return body


def camera_to_world(R: torch.Tensor, T: torch.Tensor,
                    points: torch.Tensor, views: int = 1) -> torch.Tensor:
    """world = (x - T) @ R for (K, 3) camera-frame points
    (training.cpp:175-195), summed as the compiled reference's CPU dot of
    shape (K, 3) x (3, 3) sums: in its split rows (:func:`_split_rows`;
    ``views`` is the size of the vmapped view batch the reference's
    training step runs the view in), columns 0 and 1 as
    ``(d0 r0 + d1 r1) + d2 r2`` with every operation rounded; every other
    entry as the fused chain ``fma(d2, r2, fma(d1, r1, d0 r0))``.
    Bit-equal to ``jax.jit`` at every K."""
    d = points.to(torch.float32) - T.reshape(1, 3).to(torch.float32)
    R = R.to(torch.float32)
    d0, d1, d2 = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    chain = fma_f32(d2, R[2], fma_f32(d1, R[1], d0 * R[0]))
    split = (d0 * R[0] + d1 * R[1]) + d2 * R[2]
    body = torch.arange(d.shape[0], device=d.device)[:, None] \
        < _split_rows(d.shape[0], views)
    column = torch.arange(3, device=d.device)[None, :] < 2
    return torch.where(body & column, split, chain)
