"""Shared helpers of the tests that hold tod_tpu_torch against tod_tpu.

The reference draws its RANSAC noise from ``jax.random`` inside its
samplers; the port takes the noise as an argument. These helpers rebuild
the reference's key path and hand the port the very Gumbel draws the
reference makes, as numpy arrays.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp


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
