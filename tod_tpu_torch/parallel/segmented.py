"""Object-sharded segmented matching and the sharded serving step
(tod_tpu/parallel/segmented.py).

The catalog's OBJECT axis splits over the mesh's ``'db'`` axis: shard
``s`` owns objects ``s, s + n, s + 2n, ...`` (round-robin, whole objects
only, so no per-object reduction crosses shards), packed as its own
``SegmentedDb`` (ORB) or ``SegmentedDbF`` (SIFT) and placed on the devices
of its mesh column. Short shards are padded with empty objects, whose rows
never match; they are ``None`` in the id list. The full object axis is
shard-major: shard 0's objects, then shard 1's.

:func:`sharded_object_top1` runs B1 (B3) on every shard and gathers the
(Q, O) columns. :func:`serving_step_sharded` runs one frame per stream as
the single-device segmented paths do (``geometry/detection.py``), with the
work split over the shards:

- matching on each shard, gathered (full sweep); or, coarse->fine, the
  coarse B1 (B3) on each shard's subsampled objects, the slab chosen from
  the gathered columns, each shard's gathered B2 (B4) on the slab ids it
  owns (the rest are holes), and the minimum of the shards' packed
  (distance, row) keys, which is the single-device slab exactly;
- tier 1 on each shard's positional slice of the objects it scores, with
  that slice of the tier-1 keys ``split(key_act, n_pre)``; the scores
  gathered; the single-device activation cut (``activation_cut``, not the
  reference sharded step's ``where(force_act, inf, scores)``: the
  reference's two serving paths disagree when ``track_width > 0``, and
  the port holds the single-device one);
- tier 2 on each shard's slice of the active set, with its slice of
  ``split(key_det, n_active)``; the detections gathered and scattered to
  the full object axis.

Each shard's noise comes from kernel N1 (``utils/prng.py gumbel``) on the
shard's device. The geometry arrays (points, object starts, spans) are
small beside the descriptors and are replicated on every device, as the
reference replicates them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tod_tpu_torch.geometry.adjacency import fill_adjacency
from tod_tpu_torch.geometry.detection import (activation_cut,
                                              build_object_stores,
                                              detect_objects, median_level,
                                              prescreen_scores,
                                              scatter_detections)
from tod_tpu_torch.geometry.ransac import (ObjectDetections, SeedPose,
                                           ThreefryNoise, presence_score)
from tod_tpu_torch.models.fused import (coarse_queries, load_db, match_full,
                                        slab_from_coarse)
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.ops.segmented import (DB_CHUNK, ROW_BITS, ROW_MASK,
                                         SegmentedDb, object_top1_gathered,
                                         pack_segmented)
from tod_tpu_torch.ops.segmented_l2 import (DB_CHUNK as L2_DB_CHUNK,
                                            SegmentedDbF,
                                            object_top1_l2_gathered_sq,
                                            pack_segmented_l2, to_l2)
from tod_tpu_torch.parallel.mesh import (Mesh, all_gather, min_over,
                                         split_even)
from tod_tpu_torch.types import TodModel
from tod_tpu_torch.utils import prng


@dataclass
class ShardedDb:
    """A catalog packed object by object over the mesh's ``'db'`` axis:
    ``at(i, s)`` is shard ``s`` on ``mesh.device(i, s)`` (one copy a
    device); every shard holds ``o_local`` object slots."""

    grid: Tuple[Tuple[SegmentedDb | SegmentedDbF, ...], ...]
    o_local: int
    _geometry: Dict[torch.device, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False)

    def at(self, i: int, s: int) -> SegmentedDb | SegmentedDbF:
        return self.grid[i][s]

    @property
    def n_shards(self) -> int:
        return len(self.grid[0])

    @property
    def n_objects(self) -> int:
        return self.o_local * self.n_shards

    @property
    def shards(self) -> Tuple[SegmentedDb | SegmentedDbF, ...]:
        return self.grid[0]

    def nbytes(self) -> int:
        """Bytes of one copy of every shard."""
        return sum(db.nbytes() for db in self.shards)

    def geometry(self, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(points, obj_start, spans)`` of the whole shard-major catalog
        on ``device``, shard ``s``'s rows after shard ``s - 1``'s (built
        once a device)."""
        if device not in self._geometry:
            offsets = np.cumsum([0] + [db.points.shape[0]
                                       for db in self.shards[:-1]])
            self._geometry[device] = (
                all_gather([db.points for db in self.shards], device),
                all_gather([db.obj_start + int(o) for db, o in
                            zip(self.shards, offsets)], device),
                all_gather([db.spans for db in self.shards], device))
        return self._geometry[device]


def _pack_sharded(models: Sequence[TodModel], mesh: Mesh, pack,
                  empty: np.ndarray, db_chunk: int
                  ) -> Tuple[ShardedDb, List[Optional[str]]]:
    n_db = mesh.shape["db"]
    per = [list(models[s::n_db]) for s in range(n_db)]
    o_max = max((len(p) for p in per), default=0)
    ids: List[Optional[str]] = []
    hosts = []
    for p in per:
        ids += [m.object_id for m in p] + [None] * (o_max - len(p))
        p += [TodModel("", empty, np.zeros((0, 3), np.float32))
              for _ in range(o_max - len(p))]
        hosts.append(pack(p, db_chunk, device="cpu"))
    placed: Dict[Tuple[int, torch.device], object] = {}
    for row in mesh.devices:
        for s, dev in enumerate(row):
            if (s, dev) not in placed:
                placed[(s, dev)] = load_db(None, hosts[s], dev)
    grid = tuple(tuple(placed[(s, dev)] for s, dev in enumerate(row))
                 for row in mesh.devices)
    return ShardedDb(grid, o_max), ids


def pack_segmented_sharded(models: Sequence[TodModel], mesh: Mesh,
                           db_chunk: int = DB_CHUNK
                           ) -> Tuple[ShardedDb, List[Optional[str]]]:
    """Pack ORB models round-robin into ``mesh.shape['db']`` shards of
    equal object count (:func:`ops.segmented.pack_segmented` each, on the
    host, then placed). Returns ``(ShardedDb, object ids in shard-major
    order)``, ``None`` for a padding slot."""
    return _pack_sharded(models, mesh, pack_segmented,
                         np.zeros((0, 32), np.uint8), db_chunk)


def pack_segmented_l2_sharded(models: Sequence[TodModel], mesh: Mesh,
                              db_chunk: Optional[int] = None
                              ) -> Tuple[ShardedDb, List[Optional[str]]]:
    """:func:`pack_segmented_sharded` for float-descriptor (SIFT) models,
    each shard a ``SegmentedDbF``."""
    return _pack_sharded(models, mesh, pack_segmented_l2,
                         np.zeros((0, 128), np.float32),
                         L2_DB_CHUNK if db_chunk is None else db_chunk)


def stacked_max_chunks(sdb: ShardedDb) -> int:
    """The most chunks any object spans on any shard, the shards' rows
    padded to the longest shard's (the static grid bound of the
    reference's gathered kernel under ``shard_map``; the port's B2 and B4
    take the selection as it is)."""
    total = max(db.points.shape[0] for db in sdb.shards) \
        // sdb.shards[0].db_chunk
    out = 0
    for db in sdb.shards:
        bounds = np.concatenate([np.asarray(db.starts_host, np.int64)
                                 // db.db_chunk, [total]])
        out = max(out, int(np.max(np.diff(bounds))))
    return out


def sharded_object_top1(mesh: Mesh, query: torch.Tensor, sdb: ShardedDb
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(query, object) nearest rows over an object-sharded DB:
    ``query`` (Q, 32) uint8 for a Hamming DB or (Q, 128) int8 for an L2
    one, Q divisible by the data axis. Returns ``(dist (Q, O), row (Q,
    O))`` in shard-major object order, on the mesh's first device: the
    single-device kernel's columns over that order."""
    per = split_even(query.shape[0], mesh.shape["data"],
                     "queries over 'data'")
    dist, rows = [], []
    for i in range(mesh.shape["data"]):
        q = query[i * per:(i + 1) * per]
        parts = [match_full(q.to(dev, non_blocking=True), sdb.at(i, s))
                 for s, dev in enumerate(mesh.devices[i])]
        home = mesh.device(i, 0)
        dist.append(all_gather([d for d, _ in parts], home, dim=1))
        rows.append(all_gather([r for _, r in parts], home, dim=1))
    return all_gather(dist, mesh.first), all_gather(rows, mesh.first)


class _ShardDraws:
    """A shard's slice of a frame's noise: rows ``lo..`` of the ``n_total``
    objects of each stage on the frame's key path (``ThreefryNoise``),
    drawn on the shard's device (one N1 launch a call on a card)."""

    def __init__(self, noise: ThreefryNoise, n_total: int, lo: int,
                 device: torch.device):
        self.noise, self.n_total, self.lo = noise, n_total, lo
        self.device = device

    def __call__(self, stage: str, shape: Tuple[int, ...]) -> torch.Tensor:
        keys = self.noise.keys(stage, self.n_total)
        return prng.gumbel(keys[self.lo:self.lo + shape[0]], shape[2:],
                           self.device)


def _fine_slab(mesh: Mesh, i: int, dsc: torch.Tensor, sdb: ShardedDb,
               sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact (Q, C) slab of ``sel`` (shard-major ids, -1 holes): each
    shard's gathered kernel (B2, or B4) on the ids it owns, holes
    elsewhere, merged by the minimum of the packed ``dist << 18 | row``
    keys (a hole's key is above every real one)."""
    home = mesh.device(i, 0)
    owner = torch.div(sel, sdb.o_local, rounding_mode="floor")
    keys = []
    for s, dev in enumerate(mesh.devices[i]):
        local = torch.where(owner == s, sel % sdb.o_local, -1).to(
            device=dev, dtype=torch.int32)
        q = dsc.to(dev, non_blocking=True)
        db = sdb.at(i, s)
        if isinstance(db, SegmentedDb):
            d, r = object_top1_gathered(q, db, local)
            keys.append((d.to(torch.int32) << ROW_BITS) | r)
        else:
            d_sq, r = object_top1_l2_gathered_sq(q, db, local)
            keys.append((d_sq.to(torch.int64) << ROW_BITS) | r)
    key = min_over(keys, home)
    if isinstance(sdb.shards[0], SegmentedDb):
        return (key >> ROW_BITS).to(torch.float32), key & ROW_MASK
    return (to_l2((key >> ROW_BITS).to(torch.int32)),
            (key & ROW_MASK).to(torch.int32))


def _per_shard(mesh: Mesh, i: int, *tensors):
    """Each of ``tensors`` on each device of data row ``i`` (one copy a
    distinct device): a list, one tuple a shard."""
    out, cache = [], {}
    for dev in mesh.devices[i]:
        if dev not in cache:
            cache[dev] = tuple(None if t is None else
                               t.to(dev, non_blocking=True) for t in tensors)
        out.append(cache[dev])
    return out


def _serve_frame(mesh: Mesh, cfg, i: int, key: np.ndarray,
                 frame: Tuple[torch.Tensor, ...], sdb: ShardedDb,
                 cdb: Optional[ShardedDb], tracked, explore,
                 seeds: Optional[SeedPose]):
    """One frame on data row ``i``: ``(detections (O, I, ...), the slab's
    coarse prefix or None)`` on ``mesh.device(i, 0)``."""
    act, guess = cfg.activation, cfg.guess
    n_db = mesh.shape["db"]
    home = mesh.device(i, 0)
    xy, qp, ok, dsc = (t.to(home, non_blocking=True) for t in frame)
    noise = ThreefryNoise(key, guess.ransac.max_instances, True, home)
    points, obj_start, spans = sdb.geometry(home)
    n_objects = sdb.n_objects
    sel = force = force_act = None
    if cdb is not None:
        dsc_c, ok_c = coarse_queries(dsc, ok, cfg)
        dist_c = all_gather(
            [match_full(dsc_c.to(dev, non_blocking=True), cdb.at(i, s))[0]
             for s, dev in enumerate(mesh.devices[i])], home, dim=1)
        sel, force, force_act = slab_from_coarse(
            dist_c, ok_c, cfg,
            None if tracked is None else tracked.to(home),
            None if explore is None else explore.to(home))
        axis_n = sel.shape[0]
        split_even(axis_n, n_db, "fine_width over 'db'")
        d, r = _fine_slab(mesh, i, dsc, sdb, sel)
        sel_safe = sel.clamp_min(0).long()
        obj_start, spans = obj_start[sel_safe], spans[sel_safe]
        if seeds is not None:
            seeds = SeedPose(R=seeds.R.to(home)[sel_safe],
                             T=seeds.T.to(home)[sel_safe],
                             ok=seeds.ok.to(home)[sel_safe] & (sel >= 0))
    else:
        parts = [match_full(dsc.to(dev, non_blocking=True), sdb.at(i, s))
                 for s, dev in enumerate(mesh.devices[i])]
        d = all_gather([p[0] for p in parts], home, dim=1)
        r = all_gather([p[1] for p in parts], home, dim=1)
        axis_n = n_objects
    level = median_level(d)
    n_active = min(guess.max_active_objects, axis_n)
    per_active = split_even(n_active, n_db, "max_active_objects over 'db'")
    n_forced = cfg.track_width + cfg.explore_width if force is not None \
        else 0
    n_pre = (min(act.prescreen + n_forced, axis_n) if act.prescreen > 0
             else axis_n)
    per_pre = split_even(n_pre, n_db, "prescreen + reserved slots over 'db'")
    if n_pre < axis_n:
        pre = prescreen_scores(d, level, ok, cfg.radius, act.prescreen_top)
        if force is not None:
            pre = torch.where(force, torch.full((), torch.inf, device=home),
                              pre)
        pre_ids = stable_topk(pre, n_pre)[1]
    else:
        pre_ids = torch.arange(axis_n, device=home)
    shards = _per_shard(mesh, i, d, r, ok, qp, xy, points, obj_start, spans,
                        level)

    # ---- tier 1: each shard scores its positional slice of pre_ids -------
    scores_loc = []
    for s, (d_s, r_s, ok_s, qp_s, xy_s, pts_s, start_s, spans_s,
            level_s) in enumerate(shards):
        dev = mesh.device(i, s)
        ids = pre_ids[s * per_pre:(s + 1) * per_pre].to(dev)
        stores = build_object_stores(d_s, r_s, ok_s, qp_s, xy_s, pts_s,
                                     start_s, ids, act.m_cap, cfg.radius,
                                     level_s)
        graphs = fill_adjacency(stores, spans_s[ids], guess.sensor_error)
        g1 = _ShardDraws(noise, n_pre, s * per_pre, dev)(
            "tier1", (per_pre, 3, act.n_hypotheses, act.m_cap))
        scores_loc.append(presence_score(g1, stores, graphs,
                                         guess.sensor_error))
    scores_pre = all_gather(scores_loc, home)
    scores = torch.zeros(axis_n, dtype=scores_pre.dtype, device=home)
    scores.scatter_(0, pre_ids, scores_pre)
    active = activation_cut(scores, n_active, act, force_act)

    # ---- tier 2: each shard runs its slice of the active set -------------
    seeds_s = _per_shard(mesh, i, *(seeds or (None,) * 3))
    dets = []
    for s, (d_s, r_s, ok_s, qp_s, xy_s, pts_s, start_s, spans_s,
            level_s) in enumerate(shards):
        dev = mesh.device(i, s)
        ids = active[s * per_active:(s + 1) * per_active].to(dev)
        stores = build_object_stores(
            d_s, r_s, ok_s, qp_s, xy_s, pts_s, start_s, ids,
            guess.max_matches_per_object, cfg.radius, level_s)
        a_safe = ids.clamp_min(0)
        my_seeds = None
        if seeds is not None:
            sr, st, so = seeds_s[s]
            my_seeds = SeedPose(R=sr[a_safe], T=st[a_safe],
                                ok=so[a_safe] & (ids >= 0))
        dets.append(detect_objects(
            _ShardDraws(noise, n_active, s * per_active, dev), stores,
            spans_s[a_safe], guess, my_seeds))
    det = ObjectDetections(*(all_gather(list(f), home)
                             for f in zip(*dets)))
    out = scatter_detections(det, active, axis_n)
    if sel is None:
        return out, None
    n_coarse = axis_n - (cfg.track_width if tracked is not None else 0) \
        - (cfg.explore_width if explore is not None else 0)
    return scatter_detections(out, sel, n_objects), sel[:n_coarse]


def serving_step_sharded(mesh: Mesh, cfg):
    """The sharded segmented serving step for ``cfg`` (a segmented
    ``FusedDetectorConfig``): returns ``step(keys, xy, qp, ok, dsc, sdb,
    cdb=None, tracked=None, explore=None, seeds=None)``.

    ``keys`` (B, 2) uint32, one frame key a stream (``split(key)``'s
    ``sub``); ``xy`` (B, Qp, 2), ``qp`` (B, Qp, 3), ``ok`` (B, Qp),
    ``dsc`` (B, Qp, 32) uint8 or (B, Qp, 128) int8: each stream's
    compacted queries; B divisible by the data axis (stream ``b`` on data
    row ``b // (B / n_data)``). ``sdb`` a :class:`ShardedDb`; with
    ``cfg.coarse_stride > 0`` also ``cdb``, its stride-subsampled
    companion packed with the same split. With ``track_width`` /
    ``explore_width``: ``tracked`` (B, track_width) / ``explore`` (B,
    explore_width) int32 ids (-1 = empty), and with ``track_width`` the
    seeds, a ``SeedPose`` on the full object axis ((B, O, ...)).

    Returns ``ObjectDetections (B, O, I, ...)`` on the mesh's first
    device, and with ``track_width > 0`` also the slabs' coarse prefixes
    (B, C - reserved), the caller's needy-first eviction input. Each
    stream's detections equal the single-device coarse->fine (or full
    sweep) path's on the shard-major object order, given the same key."""
    coarse = cfg.coarse_stride > 0
    if (cfg.track_width or cfg.explore_width) and not coarse:
        raise ValueError("track_width/explore_width are coarse->fine slab "
                         "features; they require coarse_stride > 0")
    return functools.partial(_serving_step, mesh, cfg)


def _serving_step(mesh: Mesh, cfg, keys, xy, qp, ok, dsc, sdb: ShardedDb,
                  cdb: Optional[ShardedDb] = None, tracked=None,
                  explore=None, seeds: Optional[SeedPose] = None):
    coarse = cfg.coarse_stride > 0
    if coarse != (cdb is not None):
        raise ValueError("the coarse DB goes with coarse_stride > 0 only")
    if (tracked is not None) != (coarse and cfg.track_width > 0) \
            or (explore is not None) != (coarse and cfg.explore_width > 0) \
            or (seeds is not None) != (tracked is not None):
        raise ValueError("tracked and seeds go with track_width > 0, "
                         "explore with explore_width > 0")
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    per = split_even(keys.shape[0], mesh.shape["data"], "frames over 'data'")
    outs = []
    for b in range(keys.shape[0]):
        outs.append(_serve_frame(
            mesh, cfg, b // per, keys[b], (xy[b], qp[b], ok[b], dsc[b]),
            sdb, cdb, None if tracked is None else tracked[b],
            None if explore is None else explore[b],
            None if seeds is None else SeedPose(*(x[b] for x in seeds))))
    det = ObjectDetections(*(torch.stack([x.to(mesh.first) for x in f])
                             for f in zip(*(o[0] for o in outs))))
    if tracked is None:
        return det
    return det, torch.stack([o[1].to(mesh.first) for o in outs])
