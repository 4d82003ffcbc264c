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
a round in one call (one launch of kernel N1 on a card). No step inside a
round waits for the host: the histogram is a ``scatter_add_`` into 64
bins, the 3x3 eigenvector is closed-form, the solves are closed-form or
``solve_ex``. :func:`detect_frame_2d` reads one number set back before the
rounds, which objects can be accepted at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.adjacency import (ObjectMatches,
                                              count_unique_query_indices,
                                              pairwise_sq_dists)
from tod_tpu_torch.geometry.detection import cluster_matches
from tod_tpu_torch.geometry.pnp import gauss_newton_pose, p3p, skew
from tod_tpu_torch.geometry.ransac import (ObjectDetections, ThreefryNoise,
                                           _rows, consistency_log_weights,
                                           sample_triples)
from tod_tpu_torch.geometry.transforms import _det3
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.image import fma_f32
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
    return rays / torch.sqrt((rays * rays).sum(-1, keepdim=True))


def pair_geometry(m: ObjectMatches
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per object, every pair's squared pixel distance, squared model
    distance and log scale ratio ``log(dpix / dmodel)``: (A, M, M) each."""
    xy0 = torch.cat([m.query_xy, torch.zeros_like(m.query_xy[..., :1])], -1)
    dpix2 = pairwise_sq_dists(xy0)
    dtrain2 = pairwise_sq_dists(m.train_pts)
    log_r = 0.5 * (torch.log(torch.clamp_min(dpix2, 1e-12))
                   - torch.log(torch.clamp_min(dtrain2, 1e-12)))
    return dpix2, dtrain2, log_r


def scale_range(K: torch.Tensor, cfg: Pnp2dConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The histogram's range ``(log(f / z_max), log(f / z_min))``, f the
    mean focal length of ``K``."""
    f = 0.5 * (K[0, 0] + K[1, 1])
    return torch.log(f / cfg.z_max), torch.log(f / cfg.z_min)


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
    output."""
    x, y, z = rotate_points(R, T, X).unbind(2)
    front = z > 1e-6
    zc = torch.where(torch.abs(z) > 1e-9, z,
                     torch.full((), 1e-9, dtype=z.dtype, device=z.device))
    # (f x / z + c) - observed, as the reference rounds it
    du = x.mul_(K[0, 0]).div_(zc).add_(K[0, 2]).sub_(xy[:, None, :, 0])
    dv = y.mul_(K[1, 1]).div_(zc).add_(K[1, 2]).sub_(xy[:, None, :, 1])
    return du.square_().add_(dv.square_()), front


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
    return torch.where(valid[:, None, :], torch.minimum(err2, cap),
                       0.0).sum(-1)


def _sym3_smallest_vector(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    matrices, in closed form (no host wait, unlike ``torch.linalg.eigh`` on
    a card): the eigenvalue by the trigonometric solution of the
    characteristic cubic, the vector as the largest cross product of two
    rows of ``cov - lambda I``. Computed in float64; the sign is
    arbitrary, as an eigensolver's is."""
    c = cov.to(torch.float64)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    q = (c[..., 0, 0] + c[..., 1, 1] + c[..., 2, 2]) / 3.0
    off = c[..., 0, 1] ** 2 + c[..., 0, 2] ** 2 + c[..., 1, 2] ** 2
    p2 = ((c[..., 0, 0] - q) ** 2 + (c[..., 1, 1] - q) ** 2
          + (c[..., 2, 2] - q) ** 2 + 2.0 * off)
    p = torch.sqrt(p2 / 6.0)
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    b = (c - q[..., None, None] * eye) / safe_p[..., None, None]
    half_det = torch.clamp(_det3(b) / 2.0, -1.0, 1.0)
    phi = torch.arccos(half_det) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # the smallest
    a = c - lam[..., None, None] * eye
    r0, r1, r2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = (cands * cands).sum(-1)
    best = torch.argmax(norms, dim=-1)
    vec = torch.take_along_dim(cands, best[..., None, None], -2)[..., 0, :]
    length = torch.sqrt(torch.take_along_dim(norms, best[..., None], -1))
    # an isotropic or rank-0 matrix: every direction is an eigenvector
    e0 = torch.zeros_like(vec)
    e0[..., 0] = 1.0
    vec = torch.where(length > 0, vec / torch.where(
        length > 0, length, torch.ones_like(length)), e0)
    return vec.to(cov.dtype)


def model_normal(train_pts: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """(A, 3) smallest-variance direction of each object's valid model
    points (the normal of a planar model), up to sign."""
    ctr = torch.where(valid[..., None], train_pts, 0.0)
    nvalid = torch.clamp_min(valid.sum(-1), 1)
    mean = ctr.sum(1) / nvalid[:, None]
    d = ctr - mean[:, None, :]
    cov = torch.einsum("ami,amj->aij", d * valid[..., None], d)
    return _sym3_smallest_vector(cov)


def mirror_poses(R: torch.Tensor, T: torch.Tensor, n_model: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The planar two-fold ambiguity's other branch: the model normal
    reflected about the viewing ray (IPPE's second solution). ``R`` (A, H,
    3, 3), ``T`` (A, H, 3), ``n_model`` (A, 3). The result does not depend
    on the normal's sign."""
    n_c = torch.einsum("ahij,aj->ahi", R, n_model)
    t_norm = torch.sqrt((T * T).sum(-1, keepdim=True))
    v = T / torch.clamp_min(t_norm, 1e-9)
    n_ref = 2.0 * (n_c * v).sum(-1, keepdim=True) * v - n_c
    axis = torch.linalg.cross(n_c, n_ref)
    s = torch.sqrt((axis * axis).sum(-1))
    c = torch.clamp((n_c * n_ref).sum(-1), -1.0, 1.0)
    ax = skew(axis / torch.clamp_min(s, 1e-9)[..., None])
    ang = torch.atan2(s, c)[..., None, None]
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Q = eye + torch.sin(ang) * ax + (1.0 - torch.cos(ang)) * (ax @ ax)
    Q = torch.where((s > 1e-6)[..., None, None], Q, eye)
    return Q @ R, T


def _stages(timer: Optional[StageTimer], prefix: str):
    """``stage(name)``: ``timer``'s stage ``prefix + name``, or no-op."""
    if timer is None:
        return lambda name: contextlib.nullcontext()
    return lambda name: timer.stage(prefix + name)


def ransac_round_2d(gumbel: torch.Tensor, m: ObjectMatches, K: torch.Tensor,
                    valid: torch.Tensor, cfg: Pnp2dConfig, stage=None):
    """One P3P-RANSAC round for A objects. ``gumbel``: (A, 3, n_hypotheses,
    M), the round's draws. Returns ``(R (A,3,3), T (A,3), inliers (A,M),
    n_unique (A,), found (A,))``. ``stage(name)``, when given, is a context
    around each step (graph, sampling, p3p, consensus, refinement)."""
    stage = stage or _stages(None, "")
    thr2 = cfg.pixel_error ** 2
    with stage("graph"):
        dpix2, dtrain2, log_r = pair_geometry(m)
        lo, hi = scale_range(K, cfg)
        adj, _ = sampling_graph(dpix2, dtrain2, log_r, valid, lo, hi)
        del dpix2, dtrain2, log_r
        logw = consistency_log_weights(adj, valid)
    with stage("sampling"):
        (v1, v2, v3), samp_ok = sample_triples(gumbel, adj, valid, logw)
        del adj
    with stage("p3p"):
        idx3 = torch.stack([v1, v2, v3], dim=-1)        # (A, B, 3)
        b = idx3.shape[1]
        flat3 = idx3.flatten(1)
        sols = p3p(_rows(bearings(m.query_xy, K), flat3).unflatten(1, (b, 3)),
                   _rows(m.train_pts, flat3).unflatten(1, (b, 3)))

    with stage("consensus"):
        # reprojection consensus of every candidate pose, (A, B * 8, M)
        r_c, t_c = sols.R.flatten(1, 2), sols.T.flatten(1, 2)
        inl = count_inliers(r_c, t_c, K, m, valid, thr2)
        inl &= (sols.valid & samp_ok[..., None]).flatten(1)[..., None]
        flat = inl.sum(-1)                               # (A, B * 8)

        # the top N_REFINE by count (ties to the lower index, as top_k) and
        # their mirrored poses, each refined twice; the winner by truncated
        # SSE among the valid candidates within 85 % of the best count
        top_n, top = stable_topk(flat, N_REFINE)
        r_top, t_top = _rows(r_c, top), _rows(t_c, top)
        inl_top = _rows(inl, top)
        del inl
        seed_ok = top_n >= 3
        r_mir, t_mir = mirror_poses(r_top, t_top,
                                    model_normal(m.train_pts, valid))
        inl_mir = count_inliers(r_mir, t_mir, K, m, valid, thr2) \
            & seed_ok[..., None]
    with stage("refinement"):
        return _refine_and_choose(
            torch.cat([r_top, r_mir], 1), torch.cat([t_top, t_mir], 1),
            torch.cat([inl_top, inl_mir], 1),
            torch.cat([seed_ok, seed_ok], 1), m, K, valid, cfg)


def _refine_and_choose(r_all, t_all, inl_all, ok_all, m: ObjectMatches,
                       K: torch.Tensor, valid: torch.Tensor,
                       cfg: Pnp2dConfig):
    """Two Gauss-Newton passes per candidate (kept if they lose no
    inliers), then the winner: the least truncated SSE among the valid
    candidates within 85 % of the best inlier count."""
    n_a = valid.shape[0]
    dev = valid.device
    thr2 = cfg.pixel_error ** 2
    X, xy = m.train_pts[:, None], m.query_xy[:, None]
    r1, t1 = gauss_newton_pose(r_all, t_all, K, X, xy, inl_all.float(),
                               iters=cfg.refine_iters)
    inl1 = count_inliers(r1, t1, K, m, valid, thr2)
    r2, t2 = gauss_newton_pose(r1, t1, K, X, xy, inl1.float(),
                               iters=cfg.refine_iters)
    inl2 = count_inliers(r2, t2, K, m, valid, thr2)
    better = inl2.sum(-1) >= inl_all.sum(-1)
    r_ref = torch.where(better[..., None, None], r2, r_all)
    t_ref = torch.where(better[..., None], t2, t_all)
    inl_ref = torch.where(better[..., None], inl2, inl_all) & ok_all[..., None]
    sse = truncated_sse(r_ref, t_ref, K, m, valid, thr2)

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
           "OBJECT_CHUNK",
           "PIXEL_SEP_SQ", "Pnp2dConfig", "bearings", "count_inliers",
           "detect_frame_2d", "detect_object_instances_2d",
           "invalidate_keypoints", "mirror_poses",
           "model_normal", "pair_geometry", "ransac_round_2d",
           "reprojection_error", "rotate_points", "sampling_graph",
           "scale_histogram", "scale_range", "truncated_sse"]
