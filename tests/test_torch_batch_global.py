"""Batched detection on the global-kNN path: tod_tpu_torch against
tod_tpu on the CPU, as test_torch_batch.py holds the segmented paths (its
module docstring states the contract): each batched row against the
reference's compiled per-frame stages with ``keys[b]`` (the key goes
straight to the geometry, no tier 1) and against the port's per-frame
path, bit for bit; the batched keypoints against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tod_tpu.geometry.detection import GuessConfig
from tod_tpu.geometry.ransac import RansacConfig
from tod_tpu.models import FusedDetectorConfig
from tod_tpu.models.fused import geom_db as jgeom_db
from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.models import fused as tfused
from test_torch_batch import (B, RANSAC, _equal, _keys, _pair, _row, _same,
                              _stacked_frames, smoke)  # noqa: F401

torch.set_num_threads(1)


def _global():
    """test_torch_global.py's cut of the global-kNN point: 3 of the 6
    objects active, so the scatter back runs."""
    return FusedDetectorConfig(
        n_features=1500, pipeline="global", db_chunk=2048, k_matches=8,
        radius=50.0,
        guess=GuessConfig(ransac=RansacConfig(**dict(
            RANSAC, n_hypotheses=512, continuation_hypotheses=0,
            tight_final_fit=False)),
            max_matches_per_object=512, max_active_objects=3),
        min_quality=150.0)


def test_batch_global(smoke):
    cfg = _global()
    jd, td = _pair(smoke, cfg)
    frames, stacked = _stacked_frames(td, smoke)
    kps, batch = td.detect_batch_raw(*stacked)
    assert kps.xy.shape == (B, cfg.n_features, 2)
    s1, s2, s3 = jd._stages
    keys = _keys()
    gap = 0.0
    for b, (image, depth) in enumerate(smoke["frames"]):
        k_j, desc_j, qp_j = s1(*jd.prepare_frame(image, depth, smoke["K"]))
        np.testing.assert_array_equal(kps.xy[b].numpy(), np.asarray(k_j.xy))
        dist, rows = s2(desc_j, jd.db)
        det_j = s3(jnp.asarray(keys[b]), k_j.xy, k_j.valid, dist, rows, qp_j,
                   jgeom_db(jd.db))
        row = _row(batch, b)
        gap = max(gap, _same(row, det_j, cfg.min_quality,
                             f"global frame {b}"))
        _equal(row, _port_global_frame(td, frames[b], keys[b])[1])
    print(f"global: largest R/T gap {gap:.3g}")


def _port_global_frame(td, frame, key):
    kps, desc, qp = tfused.stage_features(*frame, td.config)
    dist, rows = tfused.match_against_db(desc, td.db, td.config)
    noise = ThreefryNoise(key, td.config.guess.ransac.max_instances, False,
                          "cpu")
    return kps, tfused.stage_geometry(noise, kps.xy, kps.valid, dist, rows,
                                      qp, tfused.geom_db(td.db), td.config)
