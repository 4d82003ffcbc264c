#!/usr/bin/env python
"""Write tests/data/torch_a13_fixture.npz, the depthless (2D-only) reference
of chip_smoke.py phase 9a.

Runs with the JAX package on the CPU, after make_torch_cells_fixture.py:

    JAX_PLATFORMS=cpu python tools/make_torch_a13_fixture.py

It writes the same 100-object smoke catalog (tod_tpu_torch/utils/
smoke_catalog.py) into a FilesystemDb with the reference's ``write_model``
and the smoke fixture's two frames as ``.npz`` files with ``depth =
np.zeros((0, 0))`` (image and K kept), and runs ``conf/detection.ork``
unchanged through the reference's ``build_pipeline_from_ork`` and
``Scheduler`` (``db`` and ``source1.path`` overridden; the GuessGenerator's
seed is the .ork's default, 0): every frame takes the reference's 2D-only
path (``GuessGenerator._process_2d``). The frames' MatchSets must equal the
cells fixture's (the features do not read depth). Per frame the file holds

- every accepted 2D pose (``acc_*``: frame, object id, instance, R, T and
  the unique-inlier count), the instance read off the same
  ``detect_frame_2d`` call replayed with the cell's key;
- each catalog object's round-0 ``found`` and ``n_unique``
  (``round0_found``, ``round0_unique``: (frames, objects), the catalog in
  the graph's object order, ``object_ids``);
- for each accepted object its round-0 triples (``triples_frame``,
  ``triples_object``, ``triples``: (n, 3, n_hypotheses) int16, the
  reference's ``sample_triples`` on that round's graph and key).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ORK = os.path.join(ROOT, "conf", "detection.ork")
COLLECTION = "object_recognition"
SEED = 0                   # the GuessGenerator's default seed


def round0(key, m, K, valid, cfg):
    """Round 0 of the reference's ``ransac_round_2d`` for one object:
    (found, n_unique, (v1, v2, v3)). The triples come from the reference's
    own graph lines (tod_tpu/geometry/detection2d.py:76-111) and its
    ``sample_triples``, on the same key, so they are the round's draws."""
    import jax.numpy as jnp

    from tod_tpu.geometry.adjacency import pairwise_sq_dists
    from tod_tpu.geometry.detection2d import (MIN_TRAIN_SEP, PIXEL_SEP_SQ,
                                              ransac_round_2d)
    from tod_tpu.geometry.ransac import (consistency_log_weights,
                                         sample_triples)

    mcap = valid.shape[0]
    dpix2 = pairwise_sq_dists(
        jnp.concatenate([m.query_xy, jnp.zeros_like(m.query_xy[:, :1])], -1))
    dtrain2 = pairwise_sq_dists(m.train_pts)
    base = ((dpix2 > PIXEL_SEP_SQ) & (dtrain2 > MIN_TRAIN_SEP ** 2)
            & valid[:, None] & valid[None, :] & ~jnp.eye(mcap, dtype=bool))
    log_r = 0.5 * (jnp.log(jnp.maximum(dpix2, 1e-12))
                   - jnp.log(jnp.maximum(dtrain2, 1e-12)))
    n_bins = 64
    f = 0.5 * (K[0, 0] + K[1, 1])
    lo, hi = jnp.log(f / cfg.z_max), jnp.log(f / cfg.z_min)
    in_range = base & (log_r >= lo) & (log_r < hi)
    bins = jnp.clip(((log_r - lo) / (hi - lo) * n_bins).astype(jnp.int32),
                    0, n_bins - 1)
    counts = jnp.zeros(n_bins, jnp.int32).at[
        jnp.where(in_range, bins, 0)].add(in_range.astype(jnp.int32))
    peak = jnp.argmax(counts)
    center = lo + (peak.astype(jnp.float32) + 0.5) / n_bins * (hi - lo)
    adj = base & (jnp.abs(log_r - center) < jnp.log(1.4))
    logw = consistency_log_weights(adj, valid)
    triples, _ = sample_triples(key, adj, valid, cfg.n_hypotheses, logw=logw)
    _, _, _, n_unique, found = ransac_round_2d(key, m, K, valid, cfg)
    return found, n_unique, jnp.stack(triples)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data = os.path.join(ROOT, "tests", "data")
    ap.add_argument("--smoke", default=os.path.join(
        data, "torch_smoke_fixture.npz"))
    ap.add_argument("--cells", default=os.path.join(
        data, "torch_cells_fixture.npz"))
    ap.add_argument("--out", default=os.path.join(
        data, "torch_a13_fixture.npz"))
    ap.add_argument("--objects", type=int, default=100,
                    help="catalog size (smaller ones rehearse chip_smoke.py "
                         "on a CPU; the MatchSet check needs a cells fixture "
                         "made at the same size)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tod_tpu.cells.guess import _jitted_detect_2d
    from tod_tpu.db import FilesystemDb, write_model
    from tod_tpu.geometry.detection import cluster_matches
    from tod_tpu.geometry.detection2d import Pnp2dConfig
    from tod_tpu.pipeline.ork import build_pipeline_from_ork
    from tod_tpu.pipeline.scheduler import Scheduler
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    fx = np.load(args.smoke)
    cx = np.load(args.cells)
    model_ids = [str(s) for s in fx["model_ids"]]
    ids, arrays = smoke_catalog(
        model_ids, [(fx[f"desc{i}"], fx[f"points{i}"])
                    for i in range(len(model_ids))], n_objects=args.objects)
    out = {"ork": np.asarray(os.path.relpath(ORK, ROOT)),
           "seed": np.asarray(SEED, np.int32)}
    with tempfile.TemporaryDirectory() as tmp:
        db_params = {"type": "filesystem", "root": os.path.join(tmp, "db"),
                     "collection": COLLECTION}
        db = FilesystemDb(db_params["root"], COLLECTION)
        for oid, (desc, pts) in zip(ids, arrays):
            write_model(db, oid, desc, pts)
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        n_frames = len(fx["images"])
        for f in range(n_frames):
            np.savez(os.path.join(frames, f"frame{f}.npz"),
                     image=fx["images"][f], depth=np.zeros((0, 0)),
                     K=fx["K"])
        print(f"catalog: {len(ids)} objects; {n_frames} depthless frames",
              flush=True)

        pipeline = build_pipeline_from_ork(ORK, {
            "source1": {"path": frames, "loop": False},
            "pipeline1": {"db": db_params}})
        sched = Scheduler(pipeline.plasm)
        det = pipeline.cells["pipeline1"]
        key = jax.random.PRNGKey(SEED)
        acc, r0_found, r0_unique, trip = [], [], [], []
        for f in range(n_frames):
            t0 = time.time()
            sched.execute_iteration()
            guess = det.guess_generator
            found = guess.outputs["pose_results"]
            m = guess.inputs["matches"]
            for name in ("dist", "train_idx", "obj_idx", "local_idx",
                         "valid"):
                if not np.array_equal(getattr(m, name),
                                      cx[f"match_{name}"][f]):
                    raise SystemExit(f"frame {f}: MatchSet.{name} differs "
                                     "from the cells fixture's")
            object_ids = list(guess.inputs["object_ids"])
            kp_valid = np.asarray(guess.inputs["keypoints"].valid)
            kp_xy = np.asarray(guess.inputs["keypoints"].xy, np.float32)
            valid = m.valid & kp_valid[:, None]
            K = np.asarray(guess.inputs["K"], np.float32)
            rcfg = guess._cfg.ransac
            cfg = Pnp2dConfig(n_hypotheses=min(rcfg.n_hypotheses, 512),
                              min_inliers=rcfg.min_inliers,
                              max_instances=rcfg.max_instances)
            max_matches = guess._cfg.max_matches_per_object
            key, sub = jax.random.split(key)
            n_obj = len(object_ids)
            flat = (jnp.asarray(m.obj_idx), jnp.asarray(m.dist),
                    jnp.asarray(valid), jnp.asarray(
                        guess.inputs["matches_3d"]), jnp.asarray(kp_xy))
            replay = _jitted_detect_2d(cfg, max_matches)(
                sub, *flat, jnp.asarray(K),
                jnp.arange(n_obj, dtype=jnp.int32))
            r, t, n, a = (np.asarray(x) for x in (
                replay.R, replay.T, replay.n_inliers, replay.accepted))
            pairs = [(o, i) for o in range(n_obj) for i in range(a.shape[1])
                     if a[o, i]]
            same = (len(pairs) == len(found) and all(
                object_ids[o] == p.object_id
                and np.array_equal(r[o, i], p.R) and np.array_equal(t[o, i],
                                                                    p.T)
                for (o, i), p in zip(pairs, found)))
            if not same:
                raise SystemExit(f"frame {f}: the replayed detect_frame_2d "
                                 "differs from the graph's poses")
            acc += [(f, object_ids[o], i, r[o, i], t[o, i], n[o, i])
                    for o, i in pairs]

            clustered = jax.jit(cluster_matches, static_argnums=7)(
                flat[0], flat[1], flat[2], flat[3],
                jnp.zeros((len(kp_xy), 3), jnp.float32), flat[4],
                jnp.arange(n_obj, dtype=jnp.int32), max_matches)
            keys = jnp.stack([jax.random.split(k, cfg.max_instances)[0]
                              for k in jax.random.split(sub, n_obj)])
            one = jax.jit(functools.partial(round0, K=jnp.asarray(K),
                                            cfg=cfg))
            res = jax.lax.map(lambda a: one(a[0], a[1], valid=a[1].valid),
                              (keys, clustered), batch_size=8)
            r0_found.append(np.asarray(res[0]))
            r0_unique.append(np.asarray(res[1], np.int32))
            for o in sorted({o for o, _ in pairs}):
                trip.append((f, object_ids[o],
                             np.asarray(res[2][o], np.int16)))
            print(f"frame {f}: {time.time() - t0:.0f}s; "
                  f"{[(p.object_id, int(p.confidence)) for p in found]}; "
                  f"round 0 found {int(r0_found[-1].sum())} of {n_obj}",
                  flush=True)
        print(sched.timing_report(), flush=True)

    out.update({
        "object_ids": np.asarray(object_ids),
        "acc_frame": np.asarray([a[0] for a in acc], np.int32),
        "acc_ids": np.asarray([a[1] for a in acc]),
        "acc_instance": np.asarray([a[2] for a in acc], np.int32),
        "acc_R": np.asarray([a[3] for a in acc], np.float32).reshape(-1, 3, 3),
        "acc_T": np.asarray([a[4] for a in acc], np.float32).reshape(-1, 3),
        "acc_inliers": np.asarray([a[5] for a in acc], np.int32),
        "round0_found": np.stack(r0_found),
        "round0_unique": np.stack(r0_unique),
        "triples_frame": np.asarray([t[0] for t in trip], np.int32),
        "triples_object": np.asarray([t[1] for t in trip]),
        "triples": np.stack([t[2] for t in trip]),
        "config_json": np.asarray(json.dumps(
            {"n_hypotheses": cfg.n_hypotheses, "min_inliers": cfg.min_inliers,
             "max_instances": cfg.max_instances,
             "max_matches_per_object": max_matches})),
    })
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e3:.0f} KB)")


if __name__ == "__main__":
    main()
