"""2D-only detection: P3P graph-RANSAC from 2D keypoints + 3D model points
(tod_tpu/geometry/detection2d.py).

When a frame has no depth, poses come from batched Grunert P3P hypotheses
(``geometry/pnp.py``) scored by reprojection consensus, refined by
fixed-iteration Gauss-Newton, with the same multi-instance
keypoint-invalidation loop as the 3D path. Differences from the 3D path
(inherent to missing depth): the sampling graph gates on pixel and model
separation and on one global scale ratio instead of 3D consistency;
inliers are reprojection consensus (``pixel_error`` px); no clique
certificate.

Every function takes a leading object axis A: a frame's objects run as a
batch, in chunks of ``OBJECT_CHUNK`` (the reference maps them 8 at a
time).
The noise is the reference's: instance round ``i`` of object ``o`` draws
from ``split(split(key, n_objects)[o], max_instances)[i]``
(``ransac.ThreefryNoise`` with ``segmented=False``), all objects' draws of
a round in one call (one launch of kernel N1 on a card). Every step rounds
alike on the CPU and the card: sums in fixed orders
(three-term dots left to right, the reference's reduces over the matches
as ``ops/reduce.py tree_sum``), no
library product or reduction of floats, XLA's ``log`` and the C library's
``cosf``, ``sincosf`` and ``atan2f`` from ``ops/libm.py`` (kernel L4 on a
card), correctly rounded roots, divisions by tensors (PyTorch's CUDA
division by a Python number multiplies by its reciprocal), and P3P
through kernel P1 or its plain twin. The consensus (every candidate's
inlier count, the top 8, the model normal, the mirrors and their counts)
and the refinement's recounts and truncated SSE are kernel R1 on a card
(``csrc/consensus.cu``: two launches a round's consensus, three its
refinement; M1's and M2's device code inside it) and their plain versions
on the CPU; the reprojection, the model covariance, the mirror and the
SSE are the compiled reference's bits. No step inside a round waits for
the host: the histogram is a ``scatter_add_`` into 64 bins, the 3x3
eigenvector is LAPACK's ``ssyevd`` (``geometry/lapack.py``, the
reference's ``eigh`` bit for bit), the solves are LAPACK's LU
(``pnp.lu_solve``). :func:`detect_frame_2d` reads one number set back
before the rounds, which objects can be accepted at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch import kernels
from tod_tpu_torch.geometry.adjacency import (ObjectMatches,
                                              count_unique_query_indices)
from tod_tpu_torch.geometry.detection import cluster_matches
from tod_tpu_torch.geometry.lapack import smallest_eigenvector_torch
from tod_tpu_torch.geometry.pnp import gauss_newton_pose, p3p, skew
from tod_tpu_torch.geometry.ransac import (ObjectDetections, ThreefryNoise,
                                           _rows, consistency_log_weights,
                                           sample_triples)
from tod_tpu_torch.geometry.transforms import dot3
from tod_tpu_torch.ops import libm
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.image import fma_f32
from tod_tpu_torch.ops.reduce import tree_sum
from tod_tpu_torch.utils.profiling import StageTimer

PIXEL_SEP_SQ = 20.0 * 20.0     # same sample-separation rule as the 3D path
MIN_TRAIN_SEP = 0.01           # meters: avoid near-degenerate P3P triples
N_BINS = 64                    # the scale histogram's bins
N_REFINE = 8                   # top hypotheses refined (and their mirrors)
# objects a batch: a chunk's consensus holds ~160 * OBJECT_CHUNK *
# n_hypotheses * M bytes (2.7 GB at 32 x 512 x 1024)
OBJECT_CHUNK = 32
# log(1.4) of the f32 1.4, rounded to f32, as the reference computes it
LOG_SCALE_GATE = float(np.float32(math.log(float(np.float32(1.4)))))


@dataclasses.dataclass(frozen=True)
class Pnp2dConfig:
    """Same fields and defaults as the reference's Pnp2dConfig."""

    n_hypotheses: int = 256
    min_inliers: int = 8
    pixel_error: float = 4.0   # reprojection inlier threshold (px)
    max_instances: int = 3
    refine_iters: int = 5
    # the scale histogram spans log(f / z) for z in [z_min, z_max] meters
    z_min: float = 0.25
    z_max: float = 5.0


def bearings(query_xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., M, 2) pixels -> (..., M, 3) unit camera-frame rays."""
    x = (query_xy[..., 0] - K[0, 2]) / K[0, 0]
    y = (query_xy[..., 1] - K[1, 2]) / K[1, 1]
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return rays / libm.sqrt_rn((x * x + y * y) + 1.0)[..., None]


def _sq_dists(a: torch.Tensor) -> torch.Tensor:
    """(..., M, D) -> (..., M, M) squared distances ``|a|^2 + |b|^2 - 2
    a.b`` as the compiled reference's ``adjacency.pairwise_sq_dists``
    rounds them (read off by trying orders against ``jax.jit``): the
    squares and the dot each one fused multiply-add chain over D in order
    (:func:`fma_f32`), the same bits on every device."""
    cols = a.unbind(-1)
    sq = cols[0] * cols[0]
    dot = cols[0][..., :, None] * cols[0][..., None, :]
    for c in cols[1:]:
        sq = fma_f32(c, c, sq)
        dot = fma_f32(c[..., :, None], c[..., None, :], dot)
    d = sq[..., :, None] + sq[..., None, :] - 2.0 * dot
    return torch.clamp_min(d, 0.0)


def pair_geometry(m: ObjectMatches
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per object, every pair's squared pixel distance, squared model
    distance and log scale ratio ``log(dpix / dmodel)``: (A, M, M) each."""
    dpix2 = _sq_dists(m.query_xy)
    dtrain2 = _sq_dists(m.train_pts)
    log_r = 0.5 * (libm.log_xla(torch.clamp_min(dpix2, 1e-12))
                   - libm.log_xla(torch.clamp_min(dtrain2, 1e-12)))
    return dpix2, dtrain2, log_r


def scale_range(K: torch.Tensor, cfg: Pnp2dConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The histogram's range ``(log(f / z_max), log(f / z_min))``, f the
    mean focal length of ``K``."""
    f = 0.5 * (K[0, 0] + K[1, 1])
    z = torch.stack([torch.full((), v, dtype=f.dtype, device=f.device)
                     for v in (cfg.z_max, cfg.z_min)])
    return libm.log_xla(f / z).unbind()


def scale_histogram(log_r: torch.Tensor, in_range: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(A, N_BINS) int32 counts of the ``in_range`` pairs' log ratios over
    [lo, hi): one ``scatter_add_`` (no host wait)."""
    bins = torch.clamp(((log_r - lo) / (hi - lo) * N_BINS).to(torch.int32),
                       0, N_BINS - 1)
    idx = torch.where(in_range, bins, 0).flatten(1).long()
    counts = torch.zeros((log_r.shape[0], N_BINS), dtype=torch.int32,
                         device=log_r.device)
    return counts.scatter_add_(1, idx, in_range.flatten(1).to(torch.int32))


def sampling_graph(dpix2: torch.Tensor, dtrain2: torch.Tensor,
                   log_r: torch.Tensor, valid: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampling graph: pairs far apart in pixels and on the model whose
    log scale ratio lies within log(1.4) of the histogram's mode (correct
    matches share one pixel/model scale f/z; junk pairs scatter). Pairs
    outside [lo, hi) do not vote. Returns ``(adj (A, M, M) bool, counts
    (A, N_BINS))``."""
    n = valid.shape[-1]
    not_diag = ~torch.eye(n, dtype=torch.bool, device=valid.device)
    base = ((dpix2 > PIXEL_SEP_SQ) & (dtrain2 > MIN_TRAIN_SEP ** 2)
            & valid[:, :, None] & valid[:, None, :] & not_diag)
    in_range = base & (log_r >= lo) & (log_r < hi)
    counts = scale_histogram(log_r, in_range, lo, hi)
    peak = torch.argmax(counts, dim=-1)
    center = lo + (peak.to(torch.float32) + 0.5) / N_BINS * (hi - lo)
    adj = base & (torch.abs(log_r - center[:, None, None]) < LOG_SCALE_GATE)
    return adj, counts


def rotate_points(R: torch.Tensor, T: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """``R X + T`` of every object's points under each of its poses: ``R``
    (A, H, 3, 3), ``T`` (A, H, 3), ``X`` (A, M, 3) -> (A, H, 3, M). Each
    coordinate is the reference's compiled ``X @ R.T + T``:
    ``fma(x2, r2, fma(x1, r1, x0 * r0)) + t``, with :func:`fma_f32`, so its
    bits depend neither on the device nor on how many objects share the
    call (a batched library product rounds by its own kernel's order)."""
    xs = X.transpose(1, 2)[:, None]                     # (A, 1, 3, M)
    cam = torch.empty(R.shape[:2] + X.shape[2:] + X.shape[1:2],
                      dtype=torch.float32, device=X.device)
    for j in range(3):      # one row at a time bounds the f64 temporaries
        r = R[:, :, j, :, None]                         # (A, H, 3, 1)
        acc = xs[:, :, 0] * r[:, :, 0]
        acc = fma_f32(xs[:, :, 1], r[:, :, 1], acc)
        cam[:, :, j] = fma_f32(xs[:, :, 2], r[:, :, 2], acc).add_(
            T[:, :, j, None])
    return cam


def reprojection_error(R: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
                       X: torch.Tensor, xy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared reprojection error and in-front mask of every object's
    points under each of its poses: ``R`` (A, H, 3, 3), ``T`` (A, H, 3),
    ``X`` (A, M, 3), ``xy`` (A, M, 2) -> (A, H, M) each. The camera
    coordinates come from :func:`rotate_points`, the rest in place in its
    output; the squares summed as the compiled reference's reduce over
    (u, v) contracts them, ``fma(dv, dv, du du)``."""
    x, y, z = rotate_points(R, T, X).unbind(2)
    front = z > 1e-6
    zc = torch.where(torch.abs(z) > 1e-9, z,
                     torch.full((), 1e-9, dtype=z.dtype, device=z.device))
    # (f x / z + c) - observed, as the reference rounds it
    du = x.mul_(K[0, 0]).div_(zc).add_(K[0, 2]).sub_(xy[:, None, :, 0])
    dv = y.mul_(K[1, 1]).div_(zc).add_(K[1, 2]).sub_(xy[:, None, :, 1])
    return fma_f32(dv, dv, du.square_()), front


def count_inliers(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                  thr2: float) -> torch.Tensor:
    """(A, H, M) reprojection inliers: valid, in front, error < thr2."""
    err2, front = reprojection_error(R, T, K, m.train_pts, m.query_xy)
    return valid[:, None, :] & front & (err2 < thr2)


def truncated_sse(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                  thr2: float) -> torch.Tensor:
    """(A, H) sum over valid matches of min(err2, 4 thr2) (4 thr2 behind
    the camera): separates the planar two-fold ambiguity's branches."""
    err2, front = reprojection_error(R, T, K, m.train_pts, m.query_xy)
    cap = torch.full((), 4.0 * thr2, dtype=err2.dtype, device=err2.device)
    err2 = torch.where(front, err2, cap)
    return tree_sum(torch.where(valid[:, None, :], torch.minimum(err2, cap),
                                0.0), -1)


def sym3_smallest_vector_torch(cov: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel M2: the unit eigenvector of the smallest
    eigenvalue of symmetric float32 (..., 3, 3) matrices, as the reference
    takes it (``jnp.linalg.eigh(cov)[1][:, 0]``) bit for bit and sign for
    sign: LAPACK's ``ssyevd`` on the symmetrised matrix,
    ``geometry/lapack.py smallest_eigenvector_torch``."""
    return smallest_eigenvector_torch(cov)


def sym3_smallest_vector(cov: torch.Tensor) -> torch.Tensor:
    """:func:`sym3_smallest_vector_torch` of float32 (..., 3, 3) matrices:
    kernel M2 (``csrc/mirror.cu tod_sym3_smallest``, a thread a matrix) on
    a CUDA tensor, one launch counted in ``sym3_smallest_vector.launches``
    (a failed launch raises); the plain version on a CPU tensor."""
    if cov.dtype != torch.float32 or cov.shape[-2:] != (3, 3):
        raise ValueError(f"sym3_smallest_vector takes float32 (..., 3, 3), "
                         f"got {cov.dtype} {tuple(cov.shape)}")
    if cov.device.type == "cpu":
        return sym3_smallest_vector_torch(cov)
    if cov.device.type != "cuda":
        raise ValueError(f"no sym3_smallest_vector path for {cov.device}")
    cov = cov.contiguous()
    out = torch.empty(cov.shape[:-1], dtype=cov.dtype, device=cov.device)
    if out.numel():
        kernels.call("mirror", "tod_sym3_smallest",
                     [cov.data_ptr(), out.data_ptr()], [out.numel() // 3],
                     torch.cuda.current_stream(cov.device).cuda_stream)
        sym3_smallest_vector.launches += 1
    return out


sym3_smallest_vector.launches = 0


def model_covariance(train_pts: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """(A, 3, 3) covariance of each object's valid model points as the
    compiled reference rounds ``((ctr - mean) * valid).T @ (ctr - mean)``:
    the mean a reduce (``ops/reduce.py tree_sum``) divided by the count,
    the product XLA's emitted dot loop, one fused multiply-add chain over
    the matches from +0 (:func:`fma_f32`)."""
    ctr = torch.where(valid[..., None], train_pts, 0.0)
    nvalid = torch.clamp_min(valid.sum(-1), 1)
    mean = tree_sum(ctr, 1) / nvalid[:, None]
    d = ctr - mean[:, None, :]
    w = d * valid[..., None]
    cov = torch.zeros(d.shape[:1] + (3, 3), dtype=d.dtype, device=d.device)
    for k in range(d.shape[1]):
        cov = fma_f32(w[:, k, :, None], d[:, k, None, :], cov)
    return cov


def model_normal(train_pts: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """(A, 3) smallest-variance direction of each object's valid model
    points (the normal of a planar model): ``eigh``'s column 0 of
    :func:`model_covariance`, as the reference takes it, sign too."""
    return sym3_smallest_vector(model_covariance(train_pts, valid))


def _dot3_chain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) dots as XLA's row-major gemv loop: ``fma(u2, v2, fma(u1,
    v1, u0 v0))``."""
    return fma_f32(u[..., 2], v[..., 2],
                   fma_f32(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))


def _matmul3_chain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for (..., 3, 3) matrices as XLA's emitted batched dot: each
    entry ``fma(a_i2, b_2j, fma(a_i1, b_1j, a_i0 b_0j))``."""
    return fma_f32(A[..., :, 2:3], B[..., 2:3, :],
                   fma_f32(A[..., :, 1:2], B[..., 1:2, :],
                           A[..., :, 0:1] * B[..., 0:1, :]))


def mirror_poses_torch(R: torch.Tensor, T: torch.Tensor,
                       n_model: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel M1. The planar two-fold ambiguity's
    other branch: the model normal reflected about the viewing ray (IPPE's
    second solution). ``R`` (A, H, 3, 3), ``T`` (A, H, 3), ``n_model`` (A,
    3). The result does not depend on the normal's sign.

    Rounded as the compiled reference's fusions (read off their object
    code, ``tools/fit_mirror_fusions.py``): ``R @ n``, ``ax @ ax`` and ``Q
    @ R`` fused multiply-add chains (:func:`_dot3_chain`,
    :func:`_matmul3_chain`), the two norms' squares a chain, the two dots
    ``n_c . v`` and ``n_c . n_ref`` unfused (``transforms.dot3``: XLA's
    column-major gemv), ``n_ref``'s x and y ``fma(2 d, v, -n_c)`` and its
    z unfused (the loop vectoriser's shuffle parts that product from its
    subtraction), each cross-product entry ``fma(a, b, -(c d))``, ``Q =
    fma(1 - cos, ax ax, eye + sin ax)``; ``atan2f`` and ``sincosf`` from
    ``ops/libm.py``."""
    n_c = _dot3_chain(R, n_model[:, None, None, :])
    t_norm = libm.sqrt_rn(_dot3_chain(T, T))[..., None]
    v = T / torch.clamp_min(t_norm, 1e-9)
    d2 = (dot3(n_c, v) * 2.0)[..., None]
    n_ref = torch.cat([fma_f32(d2, v[..., :2], -n_c[..., :2]),
                       d2 * v[..., 2:] - n_c[..., 2:]], -1)
    axis = torch.stack([
        fma_f32(n_c[..., i], n_ref[..., j], -(n_c[..., k] * n_ref[..., l]))
        for i, j, k, l in ((1, 2, 2, 1), (2, 0, 0, 2), (0, 1, 1, 0))], -1)
    s = libm.sqrt_rn(_dot3_chain(axis, axis))
    c = torch.clamp(dot3(n_c, n_ref), -1.0, 1.0)
    ax = skew(axis / torch.clamp_min(s, 1e-9)[..., None])
    sin, cos = libm.sincosf(libm.atan2f(s, c))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Q = fma_f32((1.0 - cos)[..., None, None].expand_as(ax),
                _matmul3_chain(ax, ax), eye + sin[..., None, None] * ax)
    Q = torch.where((s > 1e-6)[..., None, None], Q, eye)
    return _matmul3_chain(Q, R), T


def mirror_poses(R: torch.Tensor, T: torch.Tensor, n_model: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mirror_poses_torch` of float32 ``R`` (A, H, 3, 3), ``T`` (A,
    H, 3) and ``n_model`` (A, 3): kernel M1 (``csrc/mirror.cu
    tod_mirror_poses``, a thread a pose) on CUDA tensors, one launch
    counted in ``mirror_poses.launches`` (a failed launch raises); the
    plain version on CPU tensors."""
    if R.dim() != 4 or R.shape[2:] != (3, 3) or T.shape != R.shape[:3] \
            or n_model.shape != (R.shape[0], 3) or any(
                x.dtype != torch.float32 for x in (R, T, n_model)) \
            or not R.device == T.device == n_model.device:
        raise ValueError(f"mirror_poses: R {tuple(R.shape)} {R.dtype} on "
                         f"{R.device}, T {tuple(T.shape)} {T.dtype} on "
                         f"{T.device}, n_model {tuple(n_model.shape)} "
                         f"{n_model.dtype} on {n_model.device}")
    if R.device.type == "cpu":
        return mirror_poses_torch(R, T, n_model)
    if R.device.type != "cuda":
        raise ValueError(f"no mirror_poses path for {R.device}")
    n_a, n_h = R.shape[:2]
    R, T, n_model = R.contiguous(), T.contiguous(), n_model.contiguous()
    r_out, t_out = torch.empty_like(R), torch.empty_like(T)
    if n_a * n_h:
        kernels.call("mirror", "tod_mirror_poses",
                     [R.data_ptr(), T.data_ptr(), n_model.data_ptr(),
                      r_out.data_ptr(), t_out.data_ptr()], [n_a * n_h, n_h],
                     torch.cuda.current_stream(R.device).cuda_stream)
        mirror_poses.launches += 1
    return r_out, t_out


mirror_poses.launches = 0


# ---- kernel R1: the reprojection consensus (csrc/consensus.cu) ----------

class Selection(NamedTuple):
    """A round's seeds and mirrors (:func:`consensus_select`): the stable
    top ``N_REFINE`` counts ``top_n`` (A, 8) int32 at ``top`` (A, 8)
    int64, the 8 seeds then their mirrors ``R`` (A, 16, 3, 3) and ``T``
    (A, 16, 3), their inliers (A, 16, M) and counts (A, 16) int32 (a
    seed's only where its pose is valid, a mirror's only where its seed
    counts 3 or more), and the model ``normal`` (A, 3)."""

    top_n: torch.Tensor
    top: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    inliers: torch.Tensor
    counts: torch.Tensor
    normal: torch.Tensor


def _check_consensus(R, T, K, m: ObjectMatches, valid, what: str) -> str:
    """The device type of a consensus call, after checking its arguments:
    float32 poses (A, H, 3, 3) and (A, H, 3), points (A, M, 3), pixels
    (A, M, 2), bool ``valid`` (A, M), all on one device."""
    n_a, n_m = valid.shape
    shapes = (R.dim() == 4 and R.shape[0] == n_a and R.shape[2:] == (3, 3)
              and T.shape == R.shape[:3] and K.shape == (3, 3)
              and m.train_pts.shape == (n_a, n_m, 3)
              and m.query_xy.shape == (n_a, n_m, 2))
    floats = all(x.dtype == torch.float32
                 for x in (R, T, K, m.train_pts, m.query_xy))
    devices = {x.device for x in (R, T, K, m.train_pts, m.query_xy, valid)}
    if not (shapes and floats and valid.dtype == torch.bool
            and len(devices) == 1):
        raise ValueError(f"{what}: R {tuple(R.shape)} {R.dtype}, T "
                         f"{tuple(T.shape)}, K {tuple(K.shape)}, points "
                         f"{tuple(m.train_pts.shape)}, pixels "
                         f"{tuple(m.query_xy.shape)}, valid "
                         f"{tuple(valid.shape)} {valid.dtype} on "
                         f"{sorted(map(str, devices))}")
    kind = R.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {what} path for {R.device}")
    return kind


def _float_bits(x: float) -> int:
    """The bits of ``x`` rounded to float32, as a C int."""
    return int(np.float32(x).view(np.int32))


def consensus_kernel(entry: str, pointers: Sequence[int],
                     ints: Sequence[int], device: torch.device) -> None:
    """One launch of kernel R1's C entry ``entry`` (``csrc/consensus.cu``)
    on ``device``'s current stream, counted in
    ``consensus_kernel.launches``; a failed build or launch raises."""
    kernels.call("consensus", entry, pointers, ints,
                 torch.cuda.current_stream(device).cuda_stream)
    consensus_kernel.launches += 1


consensus_kernel.launches = 0


def consensus_counts_torch(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                           pose_ok: torch.Tensor, thr2: float
                           ) -> torch.Tensor:
    """The plain version of R1's counts: (A, H) int32 inliers of each
    pose (:func:`count_inliers`), 0 where ``pose_ok`` (A, H) is False."""
    inl = count_inliers(R, T, K, m, valid, thr2) & pose_ok[..., None]
    return inl.sum(-1, dtype=torch.int32)


def consensus_counts(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                     pose_ok: torch.Tensor, thr2: float) -> torch.Tensor:
    """:func:`consensus_counts_torch`: kernel R1's counts mode on CUDA
    tensors (a block a (tile of 128 poses, object), the object's points
    staged in shared memory, no (A, H, M) tensor), one launch; the plain
    version on CPU tensors."""
    if _check_consensus(R, T, K, m, valid, "consensus_counts") == "cpu":
        return consensus_counts_torch(R, T, K, m, valid, pose_ok, thr2)
    n_a, n_h = R.shape[:2]
    args = [x.contiguous() for x in (R, T, m.train_pts, m.query_xy, valid,
                                     pose_ok.to(torch.bool), K)]
    counts = torch.empty((n_a, n_h), dtype=torch.int32, device=R.device)
    if counts.numel():
        consensus_kernel("tod_consensus_counts",
                         [x.data_ptr() for x in args] + [counts.data_ptr()],
                         [n_a, n_h, valid.shape[1], _float_bits(thr2)],
                         R.device)
    return counts


def consensus_select_torch(counts: torch.Tensor, R, T, K, m: ObjectMatches,
                           valid: torch.Tensor, pose_ok: torch.Tensor,
                           thr2: float) -> Selection:
    """The plain version of R1's selection: :func:`stable_topk`, the model
    normal (:func:`model_covariance`, then LAPACK's ``ssyevd``), M1's
    :func:`mirror_poses_torch` of the 8 seeds and :func:`count_inliers`
    of the 16 poses."""
    top_n, top = stable_topk(counts, N_REFINE)
    r_top, t_top = _rows(R, top), _rows(T, top)
    normal = sym3_smallest_vector_torch(model_covariance(m.train_pts, valid))
    r_mir, t_mir = mirror_poses_torch(r_top, t_top, normal)
    r_all, t_all = torch.cat([r_top, r_mir], 1), torch.cat([t_top, t_mir], 1)
    keep = torch.cat([_rows(pose_ok, top), top_n >= 3], 1)
    inl = count_inliers(r_all, t_all, K, m, valid, thr2) & keep[..., None]
    return Selection(top_n, top, r_all, t_all, inl,
                     inl.sum(-1, dtype=torch.int32), normal)


def consensus_select(counts: torch.Tensor, R, T, K, m: ObjectMatches,
                     valid: torch.Tensor, pose_ok: torch.Tensor,
                     thr2: float) -> Selection:
    """:func:`consensus_select_torch` from :func:`consensus_counts`' (A, H)
    int32 ``counts`` (H >= 8): kernel R1's selection mode on CUDA tensors
    (a block an object: the top 8, the model normal by M2's device code,
    M1's mirrors, the 16 poses' inliers), one launch; the plain version
    on CPU tensors."""
    if _check_consensus(R, T, K, m, valid, "consensus_select") == "cpu":
        return consensus_select_torch(counts, R, T, K, m, valid, pose_ok,
                                      thr2)
    n_a, n_h = R.shape[:2]
    n_m = valid.shape[1]
    if counts.shape != (n_a, n_h) or counts.dtype != torch.int32 \
            or n_h < N_REFINE:
        raise ValueError(f"consensus_select: counts {tuple(counts.shape)} "
                         f"{counts.dtype} for {n_h} poses")
    args = [x.contiguous() for x in (counts, R, T, m.train_pts, m.query_xy,
                                     valid, pose_ok.to(torch.bool), K)]
    dev = R.device
    top = torch.empty((n_a, N_REFINE), dtype=torch.int64, device=dev)
    top_n = torch.empty((n_a, N_REFINE), dtype=torch.int32, device=dev)
    r_all = torch.empty((n_a, 2 * N_REFINE, 3, 3), device=dev)
    t_all = torch.empty((n_a, 2 * N_REFINE, 3), device=dev)
    inl = torch.empty((n_a, 2 * N_REFINE, n_m), dtype=torch.bool, device=dev)
    n_in = torch.empty((n_a, 2 * N_REFINE), dtype=torch.int32, device=dev)
    normal = torch.empty((n_a, 3), device=dev)
    outs = (top, top_n, r_all, t_all, inl, n_in, normal)
    if n_a:
        consensus_kernel("tod_consensus_select",
                         [x.data_ptr() for x in args + list(outs)],
                         [n_a, n_h, n_m, _float_bits(thr2)], dev)
    return Selection(top_n, top, r_all, t_all, inl, n_in, normal)


def _consensus_poses(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                     thr2: float, want_masks: bool):
    """Kernel R1's masks-and-SSE mode (a warp a pose): the (A, H, M) inlier
    masks and (A, H) int32 counts where ``want_masks``, else the (A, H)
    truncated SSE; one launch."""
    n_a, n_h = R.shape[:2]
    n_m = valid.shape[1]
    args = [x.contiguous() for x in (R, T, m.train_pts, m.query_xy, valid,
                                     K)]
    dev = R.device
    masks = counts = sse = None
    if want_masks:
        masks = torch.empty((n_a, n_h, n_m), dtype=torch.bool, device=dev)
        counts = torch.empty((n_a, n_h), dtype=torch.int32, device=dev)
    else:
        sse = torch.empty((n_a, n_h), device=dev)
    ptrs = [0 if x is None else x.data_ptr() for x in (masks, counts, sse)]
    if n_a * n_h:
        consensus_kernel("tod_consensus_masks",
                         [x.data_ptr() for x in args] + ptrs,
                         [n_a, n_h, n_m, _float_bits(thr2),
                          _float_bits(4.0 * thr2)], dev)
    return (masks, counts) if want_masks else sse


def consensus_masks(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                    thr2: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(count_inliers(...), its (A, H) int32 counts)``: kernel R1's
    masks mode on CUDA tensors, one launch; the plain version on CPU
    tensors."""
    if _check_consensus(R, T, K, m, valid, "consensus_masks") == "cpu":
        inl = count_inliers(R, T, K, m, valid, thr2)
        return inl, inl.sum(-1, dtype=torch.int32)
    return _consensus_poses(R, T, K, m, valid, thr2, True)


def consensus_sse(R, T, K, m: ObjectMatches, valid: torch.Tensor,
                  thr2: float) -> torch.Tensor:
    """:func:`truncated_sse`: kernel R1's SSE mode on CUDA tensors (a warp
    a pose, the terms summed in ``tree_sum``'s order), one launch; the
    plain version on CPU tensors."""
    if _check_consensus(R, T, K, m, valid, "consensus_sse") == "cpu":
        return truncated_sse(R, T, K, m, valid, thr2)
    return _consensus_poses(R, T, K, m, valid, thr2, False)


def _stages(timer: Optional[StageTimer], prefix: str):
    """``stage(name)``: ``timer``'s stage ``prefix + name``, or no-op."""
    if timer is None:
        return lambda name: contextlib.nullcontext()
    return lambda name: timer.stage(prefix + name)


def ransac_round_2d(gumbel: torch.Tensor, m: ObjectMatches, K: torch.Tensor,
                    valid: torch.Tensor, cfg: Pnp2dConfig, stage=None,
                    trace: Optional[dict] = None):
    """One P3P-RANSAC round for A objects. ``gumbel``: (A, 3, n_hypotheses,
    M), the round's draws. Returns ``(R (A,3,3), T (A,3), inliers (A,M),
    n_unique (A,), found (A,))``. ``stage(name)``, when given, is a context
    around each step (graph, sampling, p3p, consensus, refinement);
    ``trace``, when given, receives every stage's output by name (to hold
    one device's round against another's)."""
    stage = stage or _stages(None, "")
    keep = trace.update if trace is not None else (lambda **kw: None)
    thr2 = cfg.pixel_error ** 2
    with stage("graph"):
        dpix2, dtrain2, log_r = pair_geometry(m)
        lo, hi = scale_range(K, cfg)
        adj, counts = sampling_graph(dpix2, dtrain2, log_r, valid, lo, hi)
        keep(log_r=log_r, adj=adj, scale_counts=counts)
        del dpix2, dtrain2, log_r
        logw = consistency_log_weights(adj, valid)
    with stage("sampling"):
        (v1, v2, v3), samp_ok = sample_triples(gumbel, adj, valid, logw)
        keep(logw=logw, triples=torch.stack([v1, v2, v3], -1),
             samp_ok=samp_ok)
        del adj
    with stage("p3p"):
        idx3 = torch.stack([v1, v2, v3], dim=-1)        # (A, B, 3)
        b = idx3.shape[1]
        flat3 = idx3.flatten(1)
        sols = p3p(_rows(bearings(m.query_xy, K), flat3).unflatten(1, (b, 3)),
                   _rows(m.train_pts, flat3).unflatten(1, (b, 3)),
                   trace)
        keep(p3p_R=sols.R, p3p_T=sols.T, p3p_valid=sols.valid)

    with stage("consensus"):
        # the counts of every candidate pose (A, B * 8), then the top
        # N_REFINE (ties to the lower index, as top_k) and their mirrored
        # poses with the 16 poses' inliers: kernel R1, two launches on a
        # card; each refined twice, the winner by truncated SSE among the
        # valid candidates within 85 % of the best count
        r_c, t_c = sols.R.flatten(1, 2), sols.T.flatten(1, 2)
        pose_ok = (sols.valid & samp_ok[..., None]).flatten(1)
        flat = consensus_counts(r_c, t_c, K, m, valid, pose_ok, thr2)
        sel = consensus_select(flat, r_c, t_c, K, m, valid, pose_ok, thr2)
        keep(counts=flat, top_n=sel.top_n, top=sel.top,
             model_normal=sel.normal, mirror_R=sel.R[:, N_REFINE:],
             mirror_T=sel.T[:, N_REFINE:],
             mirror_inliers=sel.inliers[:, N_REFINE:])
        seed_ok = sel.top_n >= 3
    with stage("refinement"):
        return _refine_and_choose(sel.R, sel.T, sel.inliers,
                                  torch.cat([seed_ok, seed_ok], 1), m, K,
                                  valid, cfg, keep)


def _refine_and_choose(r_all, t_all, inl_all, ok_all, m: ObjectMatches,
                       K: torch.Tensor, valid: torch.Tensor,
                       cfg: Pnp2dConfig, keep=lambda **kw: None):
    """Two Gauss-Newton passes per candidate (kept if they lose no
    inliers), then the winner: the least truncated SSE among the valid
    candidates within 85 % of the best inlier count."""
    n_a = valid.shape[0]
    dev = valid.device
    thr2 = cfg.pixel_error ** 2
    X, xy = m.train_pts[:, None], m.query_xy[:, None]
    r1, t1 = gauss_newton_pose(r_all, t_all, K, X, xy, inl_all.float(),
                               iters=cfg.refine_iters)
    inl1, _ = consensus_masks(r1, t1, K, m, valid, thr2)
    r2, t2 = gauss_newton_pose(r1, t1, K, X, xy, inl1.float(),
                               iters=cfg.refine_iters)
    inl2, n2 = consensus_masks(r2, t2, K, m, valid, thr2)
    better = n2 >= inl_all.sum(-1, dtype=torch.int32)
    r_ref = torch.where(better[..., None, None], r2, r_all)
    t_ref = torch.where(better[..., None], t2, t_all)
    inl_ref = torch.where(better[..., None], inl2, inl_all) & ok_all[..., None]
    sse = consensus_sse(r_ref, t_ref, K, m, valid, thr2)
    keep(refined_R=r_ref, refined_T=t_ref, refined_inliers=inl_ref, sse=sse)

    n_ref_in = inl_ref.sum(-1)                           # (A, 2 N_REFINE)
    n_best = n_ref_in.amax(-1, keepdim=True)
    contender = ok_all & (n_ref_in.to(torch.float32)
                          >= 0.85 * n_best.to(torch.float32))
    inf = torch.full((), torch.inf, dtype=sse.dtype, device=dev)
    win = torch.argmin(torch.where(contender, sse, inf), dim=-1)
    ar = torch.arange(n_a, device=dev)
    found = ok_all[ar, win] & (n_ref_in[ar, win] >= 3)
    inliers = inl_ref[ar, win] & found[:, None]
    n_unique = count_unique_query_indices(m.query_idx, inliers)
    return (r_ref[ar, win], t_ref[ar, win], inliers,
            torch.where(found, n_unique, 0), found)


def invalidate_keypoints(valid: torch.Tensor, query_idx: torch.Tensor,
                         inliers: torch.Tensor, accept: torch.Tensor
                         ) -> torch.Tensor:
    """Where a pose is accepted, drop every match that shares a keypoint
    with one of its inliers (no degree pruning on the 2D path)."""
    shares = ((query_idx[:, :, None] == query_idx[:, None, :])
              & inliers[:, None, :]).any(-1)
    return torch.where(accept[:, None], valid & ~shares, valid)


def _instance_round(gumbel: torch.Tensor, m: ObjectMatches, K: torch.Tensor,
                    valid: torch.Tensor, cfg: Pnp2dConfig, stage=None):
    """One round of the multi-instance loop: the round's pose, and the
    valid mask with an accepted pose's keypoints invalidated."""
    R, T, inliers, n_unique, found = ransac_round_2d(gumbel, m, K, valid, cfg,
                                                     stage)
    accept = found & (n_unique >= cfg.min_inliers)
    valid = invalidate_keypoints(valid, m.query_idx, inliers, accept)
    return valid, (R, T, n_unique, accept)


def _detections(rounds: Sequence[Tuple]) -> ObjectDetections:
    """(A, I, ...) detections from the rounds' (R, T, n_unique, accept); the
    2D path has no 3D residual or clique statistic (zeros)."""
    rs, ts, counts, accepted = (torch.stack(x, 1) for x in zip(*rounds))
    return ObjectDetections(R=rs, T=ts, n_inliers=counts, accepted=accepted,
                            rms_residual=torch.zeros_like(ts[..., 0]),
                            clique_size=torch.zeros_like(counts))


def detect_object_instances_2d(gumbels: Sequence[torch.Tensor],
                               m: ObjectMatches, K: torch.Tensor,
                               cfg: Pnp2dConfig) -> ObjectDetections:
    """The multi-instance loop (GuessGenerator.cpp:192-231 semantics), one
    round per entry of ``gumbels`` (each (A, 3, n_hypotheses, M)): accept
    a pose with >= min_inliers unique keypoints, invalidate those
    keypoints' matches, repeat."""
    valid = m.valid
    rounds: List[Tuple] = []
    for g in gumbels:
        valid, out = _instance_round(g, m, K, valid, cfg)
        rounds.append(out)
    return _detections(rounds)


def _slice(m: ObjectMatches, rows) -> ObjectMatches:
    return ObjectMatches(*(x[rows] for x in m))


def detect_frame_2d(noise: ThreefryNoise, obj_idx: torch.Tensor,
                    dist: torch.Tensor, valid: torch.Tensor,
                    train_pts: torch.Tensor, query_xy: torch.Tensor,
                    K: torch.Tensor, object_ids: torch.Tensor,
                    max_matches: int, cfg: Pnp2dConfig,
                    timer: Optional[StageTimer] = None) -> ObjectDetections:
    """Cluster flat (Q, k) matches per object (the 3D path's
    ``cluster_matches`` with a zero query-point placeholder) and run the 2D
    pose search for each of the ``object_ids`` (A,): (A, max_instances,
    ...) detections. ``noise`` is the frame's key path; round ``i`` draws
    every searched object's noise in one call.

    The objects run in chunks of ``OBJECT_CHUNK``, beside the round's
    noise (12 * n_hypotheses * M bytes an object). An object whose valid
    matches cover fewer than ``min_inliers`` distinct keypoints, which no
    round can accept, is not searched (one host read; the others keep
    their own keys): its rows hold no accept, zero inliers and the
    identity pose.

    ``timer`` (a ``utils.profiling.StageTimer``) splits the frame into
    clustering and, per round ``i``, ``round{i} noise``, ``graph``,
    ``sampling``, ``p3p``, ``consensus`` and ``refinement``."""
    q = obj_idx.shape[0]
    dev = dist.device
    with _stages(timer, "")("clustering"):
        clustered = cluster_matches(
            obj_idx, dist, valid, train_pts,
            torch.zeros((q, 3), dtype=torch.float32, device=dev),
            query_xy, object_ids, max_matches)
        n_objects = object_ids.shape[0]
        run = np.arange(n_objects)
        if n_objects:
            reach = count_unique_query_indices(clustered.query_idx,
                                               clustered.valid)
            run = np.nonzero(reach.cpu().numpy() >= cfg.min_inliers)[0]
        n_run, mcap = len(run), clustered.valid.shape[1]
        m_run = _slice(clustered, torch.from_numpy(run).to(dev))
    K = K.to(device=dev, dtype=torch.float32)
    state = m_run.valid
    chunks = [slice(c, c + OBJECT_CHUNK)
              for c in range(0, n_run, OBJECT_CHUNK)]
    rounds: List[Tuple] = []
    for i in range(cfg.max_instances):
        stage = _stages(timer, f"round{i} ")
        with stage("noise"):
            gumbel = noise(f"round{i}", (n_objects, 3, cfg.n_hypotheses,
                                         mcap), rows=run)
        outs, states = [], []
        for c in chunks:
            st, out = _instance_round(gumbel[c], _slice(m_run, c), K,
                                      state[c], cfg, stage)
            states.append(st)
            outs.append(out)
        if chunks:
            state = torch.cat(states)
            rounds.append(tuple(torch.cat(x) for x in zip(*outs)))
    det = _detections(rounds) if rounds else None

    eye = torch.eye(3, device=dev)
    full = ObjectDetections(
        R=eye.repeat(n_objects, cfg.max_instances, 1, 1),
        T=torch.zeros((n_objects, cfg.max_instances, 3), device=dev),
        n_inliers=torch.zeros((n_objects, cfg.max_instances),
                              dtype=torch.int64, device=dev),
        accepted=torch.zeros((n_objects, cfg.max_instances),
                             dtype=torch.bool, device=dev),
        rms_residual=torch.zeros((n_objects, cfg.max_instances), device=dev),
        clique_size=torch.zeros((n_objects, cfg.max_instances),
                                dtype=torch.int64, device=dev))
    if det is None:
        return full
    if n_run == n_objects:
        return det
    rows = torch.from_numpy(run).to(dev)
    return ObjectDetections(*(f.index_copy(0, rows, d)
                              for f, d in zip(full, det)))


__all__ = ["LOG_SCALE_GATE", "MIN_TRAIN_SEP", "N_BINS", "N_REFINE",
           "OBJECT_CHUNK", "Selection", "consensus_counts",
           "consensus_counts_torch", "consensus_kernel", "consensus_masks",
           "consensus_select", "consensus_select_torch", "consensus_sse",
           "model_covariance",
           "PIXEL_SEP_SQ", "Pnp2dConfig", "bearings", "count_inliers",
           "detect_frame_2d", "detect_object_instances_2d",
           "invalidate_keypoints", "mirror_poses", "mirror_poses_torch",
           "model_normal", "pair_geometry", "ransac_round_2d",
           "reprojection_error", "rotate_points", "sampling_graph",
           "scale_histogram", "scale_range", "sym3_smallest_vector",
           "sym3_smallest_vector_torch", "truncated_sse"]
