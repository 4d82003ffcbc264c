"""The port at 720x1280 (RealSense D4xx) against the compiled reference:
the trainer's batched step on two masked views, and one ``FusedDetector``
frame at the bench's operating point with the reference's RANSAC draws
handed to the port (``torch_parity.JaxReplayNoise``).

The camera is VGA's focal length doubled, centred (``K720``). The views
and the scene are rendered by both packages' renderers and must be equal;
the pyramid runs inside the whole compiled programs here, where XLA may
fuse it otherwise than a lone resize. Contracts: descriptors, world points
and masks of the step bit for bit; the compacted queries (keypoints, 3D
points, descriptors) bit for bit, the detections' accepts, counts and
cliques equal, gated poses within 1e-5.
"""

import dataclasses
import os

import numpy as np
import torch

import jax.numpy as jnp

import bench
from tod_tpu.cells.trainer import _jitted_train_views
from tod_tpu.db.models import TodModel as JaxModel
from tod_tpu.models import FusedDetector
from tod_tpu.utils import synthetic as jsyn
from tod_tpu_torch import convert
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.models import fused as tfused
from tod_tpu_torch.ops import depth as tdepth
from tod_tpu_torch.ops import image as timage
from tod_tpu_torch.parallel import train as ttrain
from tod_tpu_torch.utils import synthetic as tsyn
from tod_tpu_torch.utils.camera_sizes import (HW720 as HW, K720, bench_object,
                                              bench_scenes, views_720p)
from tod_tpu_torch.utils.smoke_catalog import smoke_catalog
from test_torch_geometry import _pose_close
from torch_parity import JaxReplayNoise, frame_keys

torch.set_num_threads(1)

N_FEATURES = 600            # the trainer's ORB (bench.build_db)
SEED = 0


def _views(syn):
    """The 720p capture plan's first two views of bench object 0
    (bench.make_obj), by frame number."""
    return views_720p(syn, bench_object(syn, 0))[:2]


def test_train_views_step_matches_compiled_reference():
    views = _views(jsyn)
    for a, b in zip(views, _views(tsyn)):
        for name in ("image", "depth", "mask"):
            np.testing.assert_array_equal(b[name], a[name], name)
    images = np.stack([o["image"] for o in views])
    masks = np.stack([o["mask"] for o in views])
    depths = np.stack([o["depth"] for o in views])
    cams = [np.stack([np.asarray(o[k], np.float32).reshape(shape)
                      for o in views])
            for k, shape in (("K", (3, 3)), ("R", (3, 3)), ("T", (3,)))]
    run = _jitted_train_views("ORB", N_FEATURES, 3, 1.2, 20.0, HW, True,
                              False)
    d_j, w_j, v_j = (np.asarray(a) for a in run(
        jnp.asarray(images), jnp.asarray(masks), jnp.asarray(depths),
        *(jnp.asarray(c) for c in cams)))
    im = torch.from_numpy(images)
    grays = torch.stack([timage.rgb_to_gray_fused(i) for i in im])
    dep = torch.stack([tdepth.rescale_depth(torch.from_numpy(d), HW)
                       for d in depths])
    d_t, w_t, v_t = ttrain.train_views_step(
        grays, torch.from_numpy(masks), dep,
        *(torch.from_numpy(c) for c in cams), n_features=N_FEATURES)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    assert v_j.sum() > 800


def _scene(syn):
    """bench.py build_scenes' first scene (objects 0-2, poses from rng 7)
    at 720x1280."""
    objects = [bench_object(syn, i) for i in range(3)]
    return bench_scenes(syn, objects, 1, hw=HW, K=K720)[0]


def test_detect_matches_reference_with_its_draws():
    """The smoke fixture's three trained models (every 4th row, so that the
    CPU runs it in seconds) and three seeded fillers, served at bench.py
    build_config's operating point gated at 156."""
    image, depth = _scene(jsyn)
    image_t, depth_t = _scene(tsyn)
    np.testing.assert_array_equal(image_t, image)
    np.testing.assert_array_equal(depth_t, depth)
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_smoke_fixture.npz"))
    real = [(fx[f"desc{i}"][::4], fx[f"points{i}"][::4]) for i in range(3)]
    ids, arrays = smoke_catalog([str(s) for s in fx["model_ids"]], real,
                                n_objects=6)
    cfg = dataclasses.replace(bench.build_config(5000), min_quality=156.0)
    jd = FusedDetector([JaxModel(i, d, p) for i, (d, p) in
                        zip(ids, arrays)], cfg, seed=SEED)
    td = tfused.FusedDetector(
        convert.models_from_numpy(ids, [d for d, _ in arrays],
                                  [p for _, p in arrays]),
        convert.config_from_dict(dataclasses.asdict(cfg)), seed=SEED,
        device="cpu")
    frame_j = jd.prepare_frame(image, depth, K720)
    frame_t = td.prepare_frame(image, depth, K720)
    np.testing.assert_array_equal(frame_t[0].numpy(), np.asarray(frame_j[0]))
    ref = jd._stages[0](*frame_j)
    port = tfused.stage_features_compact(*frame_t, td.config)
    for name, a, b in zip(("xy", "qp", "dsc", "ok"), ref, port):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert int(port[3].sum()) > 1500
    td.noise = JaxReplayNoise(frame_keys(SEED, 1)[0],
                              cfg.guess.ransac.max_instances)
    _, det_j = jd.detect_raw(*frame_j)
    _, det_t = td.detect_raw(*frame_t)
    for name in ("accepted", "n_inliers", "clique_size"):
        np.testing.assert_array_equal(getattr(det_t, name).numpy(),
                                      np.asarray(getattr(det_j, name)), name)
    assert int(np.asarray(det_j.accepted).sum()) >= 3
    gated = lambda det: td.poses(det)  # noqa: E731
    want = gated(tran.ObjectDetections(
        *(torch.from_numpy(np.array(a)) for a in det_j)))
    got = gated(det_t)
    assert [(r.object_id, r.confidence) for r in got] == \
        [(r.object_id, r.confidence) for r in want]
    for a, b in zip(got, want):
        _pose_close(a.R, a.T, b.R, b.T)
