"""Shared helpers of the tests that hold tod_tpu_torch against tod_tpu.

The reference draws its RANSAC noise from ``jax.random`` inside its
samplers; the port takes the noise as an argument. These helpers rebuild
the reference's key path and hand the port the very Gumbel draws the
reference makes, as numpy arrays. :func:`build_world` trains the small
two-object world that the slice tests of both serving paths share.
"""

import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

WORLD_IDS = ["slice_alpha", "slice_beta"]


def gumbel_triple(key, n: int, m: int) -> np.ndarray:
    """(3, n, m): the draws of the reference's ``sample_triples(key, ...,
    n)`` over ``m`` matches (one per sampled vertex)."""
    return np.stack([np.asarray(jax.random.gumbel(k, (n, m), jnp.float32))
                     for k in jax.random.split(key, 3)])


def gumbel_batch(keys, n: int, m: int) -> torch.Tensor:
    """(A, 3, n, m) for a batch of per-object keys."""
    return torch.from_numpy(np.stack([gumbel_triple(k, n, m) for k in keys]))


class JaxReplayNoise:
    """The port's noise callback, replaying the reference's draws for one
    ``detect_frame_segmented(key, ...)`` call: the tier-1 keys are
    ``split(key_act, n_pre)``, the tier-2 keys ``split(key_det, n_active)``
    and, per object, ``split(., max_instances)`` over the instance rounds."""

    def __init__(self, key, max_instances: int):
        self.key_act, self.key_det = jax.random.split(key)
        self.max_instances = max_instances

    def __call__(self, stage, shape):
        n_obj, _, n, m = shape
        if stage == "tier1":
            keys = jax.random.split(self.key_act, n_obj)
        else:
            i = int(stage[len("round"):])
            keys = [jax.random.split(k, self.max_instances)[i]
                    for k in jax.random.split(self.key_det, n_obj)]
        return gumbel_batch(keys, n, m)


class JaxReplayNoiseGlobal(JaxReplayNoise):
    """The port's noise callback for one ``detect_frame_from_matches(key,
    ...)`` call of the global-kNN path: the key goes straight to
    ``detect_objects``, which splits it into ``n_active`` per-object keys,
    each split per instance round. There is no tier 1 and no
    ``key_act``/``key_det`` split."""

    def __init__(self, key, max_instances: int):
        self.key_act, self.key_det = None, key
        self.max_instances = max_instances

    def __call__(self, stage, shape):
        if stage == "tier1":
            raise AssertionError("the global-kNN path has no tier 1")
        return super().__call__(stage, shape)


def build_world(collection: str):
    """Two objects trained with the reference's TodTrainer (as test_e2e.py
    does) and joined by two seeded fillers (tod_tpu_torch.utils.
    smoke_catalog), and one frame that shows both at seeded poses. Returns
    ``dict(ids, arrays, image, depth, poses)``: the catalog's ids and
    (descriptors, points), the frame and the ground-truth poses in
    ``WORLD_IDS`` order."""
    from tod_tpu.db import InMemoryDb, insert_observation, \
        load_models_for_objects
    from tod_tpu.models import TodTrainer
    from tod_tpu.utils.synthetic import (SyntheticObject, compose_scene,
                                         facing_pose, turntable_observations)
    from tod_tpu_torch.utils.smoke_catalog import smoke_catalog

    InMemoryDb.reset_shared()
    db = InMemoryDb.shared(collection)
    objects = []
    for i, oid in enumerate(WORLD_IDS):
        obj = SyntheticObject.make(oid, seed=10 + i)
        objects.append(obj)
        for obs in turntable_observations(obj, n_views=8):
            insert_observation(db, oid, obs["frame_number"], obs["image"],
                               obs["depth"], obs["mask"], obs["K"], obs["R"],
                               obs["T"])
        TodTrainer("trainer", object_id=oid, json_db=json.dumps(
            {"type": "mem", "collection": collection}),
            json_feature_params=json.dumps(
                {"type": "ORB", "n_features": 800, "n_levels": 3,
                 "scale_factor": 1.2})).process()
    trained = load_models_for_objects(db, "all")
    InMemoryDb.reset_shared()
    ids, arrays = smoke_catalog(
        [m.object_id for m in trained],
        [(np.asarray(m.descriptors), np.asarray(m.points, np.float32)
          .reshape(-1, 3)) for m in trained], n_objects=4)
    # scene seed 7: the reference's own poses sit within 1.1 degrees of the
    # ground truth here (at seed 5 its 20-inlier plane pose is 3.8 degrees
    # off, so no port could meet the 2 degree bound there)
    rng = np.random.default_rng(7)
    poses = [facing_pose(rng, z=0.7), facing_pose(rng, z=0.95)]
    poses[0][1][0] = -0.16
    poses[1][1][0] = 0.18
    image, depth = compose_scene(objects, poses)
    return dict(ids=ids, arrays=arrays, image=image, depth=depth,
                poses=poses)


def frame_keys(seed: int, n_frames: int):
    """The keys the reference FusedDetector(seed=...) hands its geometry
    stage on each of its first ``n_frames`` frames."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_frames):
        key, sub = jax.random.split(key)
        out.append(sub)
    return out


def pose_errors(R_a, T_a, R_b, T_b):
    """(translation distance m, rotation angle degrees) between poses."""
    dt = float(np.linalg.norm(np.asarray(T_a) - np.asarray(T_b)))
    dR = np.asarray(R_a) @ np.asarray(R_b).T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return dt, float(ang)
