"""Graph-constrained RANSAC with clique certification, batched over objects.

Port of tod_tpu/geometry/ransac.py. Every function takes a leading object
axis A (one frame's objects run as one batch). The reference draws its
Gumbel noise from ``jax.random`` inside the sampler; here the noise is an
argument, (A, 3, n, M) for one round of ``n`` hypotheses over ``M`` matches,
drawn by a callback. The main path's callback, :class:`ThreefryNoise`,
follows the reference's key path and draws its very threefry bits
(``utils/prng.py``; on a card, kernel N1 draws each call's noise in one
launch); a test may hand in any other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.adjacency import (AdjacencyGraphs, ObjectMatches,
                                              count_unique_query_indices,
                                              invalidate_query_indices)
from tod_tpu_torch.geometry.transforms import (RigidFit, apply_rt,
                                               invert_pose, kabsch, row_sum)
from tod_tpu_torch.ops import libm
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.utils import prng

CLIQUE_STAT_STEPS = 16   # growth budget of the per-pose clique statistic


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Same fields and defaults as the reference's RansacConfig."""

    n_hypotheses: int = 1024
    min_inliers: int = 8
    sensor_error: float = 0.01
    max_instances: int = 5
    clique_minimal_size: int = 7
    n_clique_checked: int = 64
    max_refine_iters: int = 8
    use_residual_test: bool = True
    weighted_sampling: bool = True
    tight_final_fit: bool = False
    continuation_hypotheses: int = 0
    # the reference's choice between its while_loop and a fixed-trip masked
    # loop (identical results); the port always runs the masked loop
    fixed_refine_loop: bool = False

    def round_hypotheses(self, i: int) -> int:
        """Hypotheses drawn in instance round ``i`` (continuation rounds use
        the lean budget when it is set)."""
        cont = self.continuation_hypotheses
        if i > 0 and cont and cont < self.n_hypotheses \
                and self.max_instances > 1:
            return cont
        return self.n_hypotheses


NoiseFn = Callable[[str, Tuple[int, ...]], torch.Tensor]


class ThreefryNoise:
    """The reference's Gumbel draws for one frame, from the frame's key
    (the ``sub`` of ``self._key, sub = split(self._key)``); called with a
    stage name ("tier1", "round0", "round1", ...) and a shape (A, 3, n, M).

    Segmented paths (``detect_frame_segmented`` and ``_gathered``):
    ``key_act, key_det = split(key)``; tier 1 draws object ``a``'s triple
    from ``split(key_act, A)[a]``, instance round ``i`` from
    ``split(split(key_det, A)[a], max_instances)[i]``. The global path hands
    the key straight to ``detect_objects``: ``key_det = key``, no tier 1.
    A triple key ``k`` gives one ``gumbel(split(k, 3)[v], (n, M))`` per
    vertex ``v``. The keys are split on the host; each call draws all
    (A, 3) Gumbel arrays on ``device`` with one :func:`prng.gumbel` (one
    launch of kernel N1 on a card)."""

    def __init__(self, key: np.ndarray, max_instances: int, segmented: bool,
                 device: torch.device | str):
        if segmented:
            self.key_act, self.key_det = prng.split(key)
        else:
            self.key_act, self.key_det = None, key
        self.max_instances = max_instances
        self.device = torch.device(device)

    def keys(self, stage: str, n_obj: int) -> np.ndarray:
        """(A, 3, 2): each object's three vertex keys at ``stage``."""
        if stage == "tier1":
            if self.key_act is None:
                raise ValueError("the global-kNN path has no tier 1")
            per_object = prng.split(self.key_act, n_obj)
        else:
            i = int(stage[len("round"):])
            per_object = prng.split(prng.split(self.key_det, n_obj),
                                    self.max_instances)[:, i]
        return prng.split(per_object, 3)

    def __call__(self, stage: str, shape: Tuple[int, ...],
                 rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """The draws of ``shape``; with ``rows``, only those objects' of the
        ``shape[0]`` (each keeps its own key), (len(rows), 3, n, M)."""
        n_obj, _, n, m = shape
        keys = self.keys(stage, n_obj)
        return prng.gumbel(keys if rows is None else keys[rows], (n, m),
                           self.device)


class BatchNoise:
    """The draws of B frames whose objects lie stacked on one axis (frame
    b's A objects at rows b*A to (b+1)*A - 1, as the batched geometry stacks
    them): each frame's rows come down its own :class:`ThreefryNoise` key
    path, all of them from one :func:`prng.gumbel` (one launch of kernel N1
    a call on a card, however many frames)."""

    def __init__(self, frames: Sequence[ThreefryNoise]):
        self.frames = list(frames)
        self.device = self.frames[0].device

    def __call__(self, stage: str, shape: Tuple[int, ...]) -> torch.Tensor:
        n_obj, _, n, m = shape
        per_frame = n_obj // len(self.frames)
        keys = np.concatenate([f.keys(stage, per_frame) for f in self.frames])
        return prng.gumbel(keys, (n, m), self.device)


class RansacRound(NamedTuple):
    R: torch.Tensor            # (A,3,3) object->camera
    T: torch.Tensor            # (A,3)
    inliers: torch.Tensor      # (A,M) bool
    n_unique: torch.Tensor     # (A,) int64 unique query keypoints
    found: torch.Tensor        # (A,) bool
    rms_residual: torch.Tensor  # (A,) f32
    clique_size: torch.Tensor   # (A,) int64


class SeedPose(NamedTuple):
    """Tracked-pose hypotheses, one per object: each object's last ACCEPTED
    pose (object -> camera, as ObjectDetections stores it). It enters every
    tier-2 round's pool as one more candidate under the unchanged
    acceptance contract, so a stale seed is never accepted on trust."""

    R: torch.Tensor    # (A,3,3) object->camera
    T: torch.Tensor    # (A,3)
    ok: torch.Tensor   # (A,) bool: False = no seed (results as without)


class ObjectDetections(NamedTuple):
    """Fixed-capacity multi-instance detections, (A or O, I, ...)."""

    R: torch.Tensor            # (...,I,3,3) object->camera
    T: torch.Tensor            # (...,I,3)
    n_inliers: torch.Tensor    # (...,I) int64 unique-keypoint inliers
    accepted: torch.Tensor     # (...,I) bool
    rms_residual: torch.Tensor  # (...,I) f32
    clique_size: torch.Tensor   # (...,I) int64


def _rows(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[a, idx[a, j]] for (A, M, ...) ``mat`` and (A, J) ``idx``."""
    a = torch.arange(mat.shape[0], device=mat.device)[:, None]
    return mat[a, idx]


def _sq_residual(r: torch.Tensor, t: torch.Tensor, q: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    d = apply_rt(r, t, q) - target
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def consistency_log_weights(sample_adj: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """log(1 + [A^3 1]_v): 3-path counts in the valid sample graph. The
    counts (up to M^3, past f32's 2^24 in a dense graph of a few hundred
    matches) are formed exactly in f64, whatever the product's order or
    batch, then taken to f32 as the reference holds them, and through XLA's
    ``log`` of ``1 + count`` (``libm.log_xla``): the reference's
    ``jnp.log1p`` of a count compiles to that (held on 200,000 counts to
    10^9, ``tests/test_torch_libm.py``), the same bits on every device."""
    a = (sample_adj & valid[..., :, None]
         & valid[..., None, :]).to(torch.float64)
    v = valid.to(torch.float64)[..., None]
    counts = (a @ (a @ (a @ v)))[..., 0].to(torch.float32)
    return libm.log_xla(1.0 + counts)


def _masked_weighted_argmax(g: torch.Tensor, mask: torch.Tensor,
                            logw: torch.Tensor):
    neg_inf = torch.full((), -torch.inf, device=g.device)
    score = torch.where(mask, g + logw, neg_inf)
    return torch.argmax(score, dim=-1), mask.any(-1)


def sample_triples(gumbel: torch.Tensor, sample_adj: torch.Tensor,
                   valid: torch.Tensor, logw=None):
    """Draw sample-adjacency 3-cliques: v1 over valid, v2 over N(v1), v3 over
    N(v1) & N(v2), each the argmax of Gumbel noise (+ log-weights).
    ``gumbel``: (A, 3, n, M). Returns ``((v1, v2, v3) (A, n), ok (A, n))``."""
    n_obj, _, n, m = gumbel.shape
    lw = (torch.zeros((n_obj, 1, m), device=gumbel.device) if logw is None
          else logw[:, None, :])
    m1 = valid[:, None, :].expand(n_obj, n, m)
    v1, ok1 = _masked_weighted_argmax(gumbel[:, 0], m1, lw)
    m2 = _rows(sample_adj, v1) & valid[:, None, :]
    v2, ok2 = _masked_weighted_argmax(gumbel[:, 1], m2, lw)
    m3 = m2 & _rows(sample_adj, v2)
    v3, ok3 = _masked_weighted_argmax(gumbel[:, 2], m3, lw)
    return (v1, v2, v3), ok1 & ok2 & ok3


def _greedy_clique_size(adj: torch.Tensor, cand: torch.Tensor,
                        need: int) -> torch.Tensor:
    """Grow a clique greedily (max degree within the candidates first) for
    ``need`` steps. ``adj``: (A,M,M) bool; ``cand``: (A,B,M) bool. Returns
    sizes (A,B). Degrees are integer counts, exact in f32."""
    adj_f = adj.float()
    size = torch.zeros(cand.shape[:-1], dtype=torch.int64, device=cand.device)
    minus_one = torch.full((), -1.0, device=cand.device)
    for _ in range(need):
        deg = cand.float() @ adj_f                              # (A,B,M)
        pick = torch.argmax(torch.where(cand, deg, minus_one), dim=-1)
        size = size + cand.any(-1)
        cand = cand & _rows(adj, pick)
    return size


def propose_and_count(gumbel: torch.Tensor, matches: ObjectMatches,
                      graphs: AdjacencyGraphs, valid: torch.Tensor,
                      sigma: float, use_residual_test: bool = True,
                      weighted: bool = True):
    """Draw graph-constrained triples, fit Horn poses and count each
    hypothesis's inliers (common physical neighbours passing the residual
    test). Returns ``(fit (A,B), inlier (A,B,M) bool, n_in (A,B))``."""
    m_cap = valid.shape[-1]
    q, t = matches.query_pts, matches.train_pts
    logw = consistency_log_weights(graphs.sample, valid) if weighted else None
    (v1, v2, v3), samp_ok = sample_triples(gumbel, graphs.sample, valid, logw)
    idx3 = torch.stack([v1, v2, v3], dim=-1)                    # (A,B,3)
    fit = kabsch(_rows(q, idx3.flatten(1)).unflatten(1, idx3.shape[1:]),
                 _rows(t, idx3.flatten(1)).unflatten(1, idx3.shape[1:]),
                 torch.ones(idx3.shape, device=q.device))
    onehot = torch.zeros(v1.shape + (m_cap,), dtype=torch.bool,
                         device=q.device)
    for v in (v1, v2, v3):
        onehot.scatter_(-1, v[..., None], True)
    valid_b = valid[:, None, :]
    possible = ((_rows(graphs.physical, v1) & _rows(graphs.physical, v2)
                 & _rows(graphs.physical, v3) & valid_b)
                | (onehot & valid_b))
    if use_residual_test:
        res = _sq_residual(fit.R, fit.T, q[:, None], t[:, None])  # (A,B,M)
        possible = possible & (res < sigma * sigma)
    inlier = possible & (samp_ok & fit.ok)[..., None]
    return fit, inlier, inlier.sum(-1)


def presence_score(gumbel: torch.Tensor, matches: ObjectMatches,
                   graphs: AdjacencyGraphs, sensor_error: float
                   ) -> torch.Tensor:
    """Tier-1 activation score: the best hypothesis inlier count of a lean
    single-round RANSAC (no certificate, no refinement). (A,)."""
    _, _, n_in = propose_and_count(gumbel, matches, graphs, graphs.valid,
                                   sensor_error)
    return n_in.amax(-1)


def _seed_hypothesis(seed: SeedPose, q: torch.Tensor, t: torch.Tensor,
                     valid: torch.Tensor, sigma: float):
    """The seed as a hypothesis in the fit convention (camera -> object),
    polished by one refit on its strict-sigma inliers. Returns ``(R (A,3,3),
    T (A,3), inliers (A,M))``; an ``ok=False`` seed has no inliers."""
    r_s, t_s = invert_pose(seed.R, seed.T)
    in_0 = valid & (_sq_residual(r_s, t_s, q, t) < sigma * sigma) \
        & seed.ok[:, None]
    fit_p = kabsch(q, t, in_0.float())
    r_p = torch.where(fit_p.ok[:, None, None], fit_p.R, r_s)
    t_p = torch.where(fit_p.ok[:, None], fit_p.T, t_s)
    in_s = valid & (_sq_residual(r_p, t_p, q, t) < sigma * sigma) \
        & seed.ok[:, None]
    return r_p, t_p, in_s


def ransac_round(gumbel: torch.Tensor, matches: ObjectMatches,
                 graphs: AdjacencyGraphs, valid: torch.Tensor,
                 cfg: RansacConfig,
                 seed: Optional[SeedPose] = None) -> RansacRound:
    """One full RANSAC + refinement on the current valid-match mask; the
    best pose in the output convention (object -> camera). ``seed`` puts
    one tracked-pose hypothesis FIRST in the pool (score ties resolve to
    it); it consumes no noise, and an ``ok=False`` seed leaves the results
    identical to no seed."""
    q, t = matches.query_pts, matches.train_pts
    sigma = cfg.sensor_error
    dev = q.device
    fit, inlier, n_in = propose_and_count(
        gumbel, matches, graphs, valid, sigma,
        use_residual_test=cfg.use_residual_test,
        weighted=cfg.weighted_sampling)
    if seed is not None:
        r_p, t_p, in_s = _seed_hypothesis(seed, q, t, valid, sigma)
        fit = RigidFit(R=torch.cat([r_p[:, None], fit.R], 1),
                       T=torch.cat([t_p[:, None], fit.T], 1),
                       ok=torch.cat([seed.ok[:, None], fit.ok], 1))
        inlier = torch.cat([in_s[:, None], inlier], 1)
        n_in = torch.cat([in_s.sum(-1, keepdim=True), n_in], 1)
    b = n_in.shape[-1]

    # --- clique certification on the top hypotheses -----------------------
    minimal = cfg.clique_minimal_size
    top_n, top_idx = stable_topk(n_in, min(cfg.n_clique_checked, b))
    samp_deg = (graphs.sample & valid[:, None, :]).sum(-1)      # (A,M)
    filtered = _rows(inlier, top_idx) & (samp_deg >= minimal)[:, None, :]
    certified = _greedy_clique_size(graphs.sample, filtered,
                                    minimal + 1) > minimal
    zero = torch.zeros((), dtype=top_n.dtype, device=dev)
    checked = torch.where(top_n <= minimal, top_n,
                          torch.where(certified, top_n, zero))
    score = torch.clamp_max(n_in, minimal).scatter(-1, top_idx, checked)
    if seed is not None:
        # an uncertified seed keeps min(n, minimal) instead of 0, as an
        # uncertified sampled draw does (acceptance is unchanged)
        seed_cert = _greedy_clique_size(
            graphs.sample, (in_s & (samp_deg >= minimal))[:, None],
            minimal + 1)[:, 0] > minimal
        n_s = n_in[:, 0]
        score[:, 0] = torch.where((n_s <= minimal) | seed_cert, n_s,
                                  torch.clamp_max(n_s, minimal))
    best = torch.argmax(score, dim=-1)                          # (A,)
    found = score.gather(-1, best[:, None])[:, 0] > 0
    ar = torch.arange(q.shape[0], device=dev)
    r_c, t_c, inl = fit.R[ar, best], fit.T[ar, best], inlier[ar, best]

    # --- refinement: refit + absorb extra inliers, masked per object -------
    # (the reference's while_loop exits once every trip is a no-op; the
    # host check costs one sync a trip and saves the no-op trips' launches)
    thresh = torch.full(found.shape, sigma * sigma, dtype=torch.float32,
                        device=dev)
    do_final = torch.zeros_like(found)
    done = torch.zeros_like(found)
    for _ in range(cfg.max_refine_iters):
        if bool(done.all()):
            break
        fit_c = kabsch(q, t, inl.float())
        r_n = torch.where(fit_c.ok[:, None, None], fit_c.R, r_c)
        t_n = torch.where(fit_c.ok[:, None], fit_c.T, t_c)
        res = _sq_residual(r_n, t_n, q, t)
        extra = valid & ~inl & (res < thresh[:, None])
        no_extra = ~extra.any(-1)
        run = ~done
        r_c = torch.where(run[:, None, None], r_n, r_c)
        t_c = torch.where(run[:, None], t_n, t_c)
        inl = torch.where(run[:, None], inl | extra, inl)
        thresh = torch.where(run & no_extra & ~do_final, thresh * 4.0, thresh)
        done = torch.where(run, do_final, done)
        do_final = do_final | (run & no_extra)

    if cfg.tight_final_fit:
        inl_t = valid & (_sq_residual(r_c, t_c, q, t) < sigma * sigma)
        fit_t = kabsch(q, t, inl_t.float())
        r_c = torch.where(fit_t.ok[:, None, None], fit_t.R, r_c)
        t_c = torch.where(fit_t.ok[:, None], fit_t.T, t_c)

    n_unique = count_unique_query_indices(matches.query_idx,
                                          inl & found[:, None])
    r_out, t_out = invert_pose(r_c, t_c)

    # --- per-pose quality statistics (confidence v2 components) ------------
    inl_fin = inl & found[:, None]
    res_fin = _sq_residual(r_c, t_c, q, t)
    n_fin = inl_fin.sum(-1)
    rms = torch.sqrt(row_sum(torch.where(inl_fin, res_fin, 0.0), -1)
                     / torch.clamp_min(n_fin, 1))
    csize = _greedy_clique_size(graphs.sample, inl_fin[:, None],
                                CLIQUE_STAT_STEPS)[:, 0]
    eye = torch.eye(3, device=dev).expand_as(r_out)
    return RansacRound(
        R=torch.where(found[:, None, None], r_out, eye),
        T=torch.where(found[:, None], t_out, torch.zeros_like(t_out)),
        inliers=inl_fin,
        n_unique=torch.where(found, n_unique, 0),
        found=found,
        rms_residual=torch.where(found, rms, 0.0),
        clique_size=torch.where(found, csize, 0))


def detect_object_instances(gumbels: Sequence[torch.Tensor],
                            matches: ObjectMatches, graphs: AdjacencyGraphs,
                            cfg: RansacConfig,
                            seed: Optional[SeedPose] = None
                            ) -> ObjectDetections:
    """The repeated-RANSAC multi-instance loop: run a round, accept the pose
    if it has >= ``min_inliers`` unique query keypoints, invalidate those
    keypoints' matches, repeat; one round per entry of ``gumbels``. As in
    the reference, a failed round masks only itself. ``seed`` enters every
    round (once its instance is found, its keypoints are invalidated and
    later entries score ~0)."""
    valid = graphs.valid
    rounds: List[RansacRound] = []
    accepts: List[torch.Tensor] = []
    for g in gumbels:
        rnd = ransac_round(g, matches, graphs, valid, cfg, seed)
        accept = rnd.found & (rnd.n_unique >= cfg.min_inliers)
        valid = torch.where(
            accept[:, None],
            invalidate_query_indices(valid, graphs.sample, matches.query_idx,
                                     rnd.inliers),
            valid)
        rounds.append(rnd)
        accepts.append(accept)
    return ObjectDetections(
        R=torch.stack([r.R for r in rounds], 1),
        T=torch.stack([r.T for r in rounds], 1),
        n_inliers=torch.stack([r.n_unique for r in rounds], 1),
        accepted=torch.stack(accepts, 1),
        rms_residual=torch.stack([r.rms_residual for r in rounds], 1),
        clique_size=torch.stack([r.clique_size for r in rounds], 1))


__all__ = ["BatchNoise", "CLIQUE_STAT_STEPS", "NoiseFn", "ObjectDetections",
           "RansacConfig", "RansacRound", "RigidFit", "SeedPose",
           "ThreefryNoise",
           "consistency_log_weights", "detect_object_instances",
           "presence_score", "propose_and_count", "ransac_round",
           "sample_triples"]
