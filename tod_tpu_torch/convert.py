"""Carry the reference's state into the port: its segmented and flat
(global-kNN) DB arrays, its trained models and its detector configuration.

Inputs are plain numpy arrays and dicts (what ``jax.device_get`` and
``dataclasses.asdict`` give), so this module needs nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from tod_tpu_torch.geometry.detection import ActivationConfig, GuessConfig
from tod_tpu_torch.geometry.ransac import RansacConfig
from tod_tpu_torch.models.fused import (FusedDetectorConfig, ModelDb,
                                        model_db_from_arrays)
from tod_tpu_torch.ops.segmented import SegmentedDb, db_from_arrays
from tod_tpu_torch.ops.segmented_l2 import SegmentedDbF, db_f_from_arrays
from tod_tpu_torch.types import TodModel


def _chunk_size(arrays: Mapping[str, np.ndarray], n_pad: int) -> int:
    """The reference DB's chunk size, from its chunk table."""
    n_chunks = max(int(np.asarray(arrays["chunk_obj"]).shape[0]), 1)
    if n_pad % n_chunks:
        raise ValueError(f"{n_pad} rows do not split into {n_chunks} chunks")
    return n_pad // n_chunks


def segmented_db_from_jax(arrays: Mapping[str, np.ndarray],
                          device: torch.device | str = "cuda") -> SegmentedDb:
    """The port's DB from the reference ``SegmentedDb`` fields as numpy:
    ``bits_t`` (256, N_pad) int8 unpacked bits, ``pop``, ``points``,
    ``obj_start``, ``n_rows``, ``spans``, ``chunk_obj``, ``chunk_base``.
    Rows are re-packed to bytes; the chunk tables only fix the chunk size
    (the port's kernel walks each object's real rows instead)."""
    bits_t = np.asarray(arrays["bits_t"])
    desc = np.packbits(bits_t.T.astype(np.uint8), axis=1, bitorder="little")
    return db_from_arrays(desc, arrays["points"], arrays["obj_start"],
                          arrays["n_rows"], arrays["spans"],
                          _chunk_size(arrays, bits_t.shape[1]), device)


def segmented_db_f_from_jax(arrays: Mapping[str, np.ndarray],
                            device: torch.device | str = "cuda"
                            ) -> SegmentedDbF:
    """The port's SIFT DB from the reference ``SegmentedDbF`` fields as
    numpy: ``vecs_t`` (128, N_pad) int8, ``norm_sq``, ``points``,
    ``obj_start``, ``n_rows``, ``spans``, ``chunk_obj``, ``chunk_base``.
    Rows are transposed back to row-major; the norms are recomputed (and
    equal the reference's ``norm_sq``)."""
    vecs_t = np.asarray(arrays["vecs_t"])
    return db_f_from_arrays(vecs_t.T, arrays["points"], arrays["obj_start"],
                            arrays["n_rows"], arrays["spans"],
                            _chunk_size(arrays, vecs_t.shape[1]), device)


def model_db_from_jax(arrays: Mapping[str, np.ndarray],
                      device: torch.device | str = "cuda") -> ModelDb:
    """The port's flat DB from the reference ``ModelDb`` fields as numpy:
    ``descriptors`` (N_pad, 32) uint8, ``points``, ``obj_of_row``,
    ``n_valid`` and ``spans`` (``bits_t`` and ``popcounts``, the TPU
    kernel's operands, are not needed: the port keeps the packed rows)."""
    return model_db_from_arrays(arrays["descriptors"], arrays["points"],
                                arrays["obj_of_row"], int(arrays["n_valid"]),
                                arrays["spans"], device)


def models_from_numpy(object_ids: Sequence[str],
                      descriptors: Sequence[np.ndarray],
                      points: Sequence[np.ndarray]) -> list:
    """Model holders from the model DB's attachments: per object the
    descriptors ((N, 32) u8 for ORB; (N, 128) f32, or int8 when already
    quantised, for SIFT) and points (N, 3) or (1, N, 3) f32."""
    out = []
    for oid, d, p in zip(object_ids, descriptors, points, strict=True):
        d = np.asarray(d)
        if d.dtype not in (np.uint8, np.int8, np.float32):
            raise ValueError(f"model {oid}: descriptors of dtype {d.dtype}")
        out.append(TodModel(str(oid), np.ascontiguousarray(d),
                            np.asarray(p, np.float32).reshape(-1, 3)))
    return out


def config_from_dict(d: Mapping) -> FusedDetectorConfig:
    """``FusedDetectorConfig`` from ``dataclasses.asdict`` of the
    reference's config (nested dicts for ``guess``, ``guess.ransac`` and
    ``activation``)."""
    d: Dict = dict(d)
    guess = dict(d.pop("guess", {}))
    ransac = RansacConfig(**guess.pop("ransac", {}))
    d["guess"] = GuessConfig(ransac=ransac, **guess)
    d["activation"] = ActivationConfig(**d.pop("activation", {}))
    if d.get("bucket_grid") is not None:
        d["bucket_grid"] = tuple(d["bucket_grid"])
    names = {f.name for f in dataclasses.fields(FusedDetectorConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown config fields: {sorted(unknown)}")
    return FusedDetectorConfig(**d)
