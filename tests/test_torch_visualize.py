"""The visualize overlays on the port (tod_tpu_torch/utils/visualize.py,
cells/viz.py and the cells' visualize hooks) against the reference's cv2
drawing (tod_tpu/utils/visualize.py, cells/viz.py, the GuessGenerator's and
Trainer's hooks) on the CPU, pixel for pixel: seeded keypoints, clusters,
pose axes and labels, clipped at the borders too; the PoseDrawer, cluster
and training-view PNGs from the same inputs; and the detector's PoseDrawer
subgraph on both pipelines, which changes no detection."""

import glob
import json
import os
import string
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import tod_tpu.cells as rc
from tod_tpu.cells.types import PoseResult as RefPoseResult
from tod_tpu.cells.viz import PoseDrawer as RefPoseDrawer
from tod_tpu.utils import visualize as rviz
import tod_tpu_torch.cells as tc
import tod_tpu_torch.db as tdb
from tod_tpu_torch.cells.types import PoseResult
from tod_tpu_torch.cells.viz import PoseDrawer
from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
from tod_tpu_torch.utils import png as tpng
from tod_tpu_torch.utils import visualize as tviz
from test_torch_cells import (CELLS_ORK, CPU, SEGMENTED_ORK,  # noqa: F401
                              _native_library, frames_dir, fx, graph_inputs,
                              model_db, views)
from test_torch_serving_ork import inputs as sift_inputs  # noqa: F401

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])


@pytest.fixture(autouse=True)
def _reset_port_dbs():
    tdb.InMemoryDb.reset_shared()
    yield
    tdb.InMemoryDb.reset_shared()


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _image(rng, h, w, gray):
    shape = (h, w) if gray else (h, w, 3)
    return rng.integers(0, 256, shape, np.uint8)


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


@pytest.mark.parametrize("seed", range(8))
def test_keypoints_and_clusters_match_reference(seed):
    """Radius-3 circles at rounded centres (half-way points among them),
    some off the image, a later cluster's colour over an earlier one."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 120)), int(rng.integers(20, 160))
    img = _image(rng, h, w, seed % 2 == 0)
    n = int(rng.integers(0, 60))
    xy = rng.uniform(-10, [w + 10, h + 10], (n, 2))
    xy[: n // 3] = np.round(xy[: n // 3]) + 0.5
    valid = rng.random(n) < 0.8
    clusters = rng.integers(0, 30, n)
    _same(tviz.draw_keypoints(img, xy, valid),
          rviz.draw_keypoints(img, xy, valid))
    _same(tviz.draw_keypoints(img, xy, color=(1, 2, 3), radius=5),
          rviz.draw_keypoints(img, xy, color=(1, 2, 3), radius=5))
    _same(tviz.draw_clusters(img, xy, clusters, valid),
          rviz.draw_clusters(img, xy, clusters, valid))
    _same(tviz.draw_clusters(img, xy, clusters),
          rviz.draw_clusters(img, xy, clusters))


@pytest.mark.parametrize("seed", range(8))
def test_thick_lines_match_cv2(seed):
    """cv2.line of thickness 2: inside the image, crossing its borders,
    wholly outside and of length 0-3."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        h, w = int(rng.integers(10, 120)), int(rng.integers(10, 160))
        a = tuple(int(v) for v in rng.integers(-60, [w + 60, h + 60]))
        b = tuple(int(v) for v in rng.integers(-60, [w + 60, h + 60]))
        if rng.random() < 0.25:
            b = (a[0] + int(rng.integers(-3, 4)),
                 a[1] + int(rng.integers(-3, 4)))
        img = _image(rng, h, w, False)
        want = img.copy()
        cv2.line(want, a, b, (0, 0, 255), 2)
        got = img.copy()
        tviz._thick_line(got, a, b, (0, 0, 255), 2)
        _same(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_labels_match_cv2(seed):
    """cv2.putText(FONT_HERSHEY_SIMPLEX, 0.5, thickness 1): random
    printable labels and colours at random origins, cut by every border."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        text = "".join(rng.choice(list(string.printable[:95]),
                                  int(rng.integers(1, 16))))
        h, w = int(rng.integers(8, 80)), int(rng.integers(8, 200))
        img = _image(rng, h, w, False)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        org = (int(rng.integers(-80, w + 5)), int(rng.integers(-10, h + 15)))
        want = img.copy()
        cv2.putText(want, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        got = img.copy()
        tviz.put_text(got, text, org, color)
        _same(got, want)


def test_non_ascii_label_is_a_known_gap():
    """Control characters draw as ``?`` in both; cv2 5 draws other
    Unicode characters from its own font, which the port does not carry:
    it draws ``?`` for them (ROADMAP queue C)."""
    img = np.zeros((30, 60, 3), np.uint8)
    for text, same in (("a\tb", True), ("é", False)):
        want = img.copy()
        cv2.putText(want, text, (5, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
        got = img.copy()
        tviz.put_text(got, text, (5, 20), (255, 255, 255))
        assert np.array_equal(got, want) == same
    qm = img.copy()
    tviz.put_text(qm, "?", (5, 20), (255, 255, 255))
    _same(got, qm)


def _poses(rng, n, cls):
    out = []
    for i in range(n):
        T = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.2, 1.5)])
        out.append(cls(R=_rotation(rng), T=T, object_id=f"obj{i:03d}",
                       confidence=float(rng.integers(8, 400))))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_pose_axes_and_detections_match_reference(seed):
    """Axes of random poses (some behind the camera, some projecting far
    off the image) and their labels over a VGA frame."""
    rng = np.random.default_rng(seed)
    img = _image(rng, 480, 640, seed % 3 == 0)
    for r in _poses(rng, 6, RefPoseResult):
        _same(tviz.draw_pose_axes(img, K, r.R, r.T),
              rviz.draw_pose_axes(img, K, r.R, r.T))
        _same(tviz.draw_pose_axes(img, K, r.R, r.T, axis_len=0.5,
                                  thickness=3),
              rviz.draw_pose_axes(img, K, r.R, r.T, axis_len=0.5,
                                  thickness=3))
    poses = _poses(rng, 12, RefPoseResult)
    _same(tviz.draw_detections(img, K, poses),
          rviz.draw_detections(img, K, poses))


NO_CV2 = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
from tod_tpu_torch.cells.types import PoseResult
from tod_tpu_torch.utils import visualize as v
img = np.zeros((48, 64, 3), np.uint8)
K = np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]])
out = v.draw_keypoints(img, np.array([[10.0, 10.0], [70.0, 5.0]]))
out = v.draw_clusters(out, np.array([[20.0, 20.0]]), np.array([3]))
out = v.draw_detections(out, K, [PoseResult(R=np.eye(3), T=np.array(
    [0.0, 0.0, 0.5]), object_id="obj", confidence=12)])
print("OK", int(out.sum() > 0))
"""


def test_draws_without_cv2():
    out = subprocess.run([sys.executable, "-c", NO_CV2], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK 1"


# ---- the cells' PNGs ---------------------------------------------------------

def test_pose_drawer_writes_the_reference_png(tmp_path):
    """Each package's PoseDrawer over the same frames, keypoints and
    poses: the same PNG pixels, and its image_out."""
    rng = np.random.default_rng(3)

    class Kps:
        def __init__(self, xy, valid):
            self.xy, self.valid = xy, valid

    for cell_cls, prefix, pose_cls in (
            (RefPoseDrawer, "ref", RefPoseResult),
            (PoseDrawer, "port", PoseResult)):
        rng = np.random.default_rng(3)
        cell = cell_cls("d", prefix=str(tmp_path / prefix))
        cell.ensure_configured()
        for f in range(3):
            cell.inputs["image"] = _image(rng, 120, 160, f == 1)
            cell.inputs["K_image"] = np.array([[150.0, 0, 80], [0, 150, 60],
                                               [0, 0, 1]])
            xy = rng.uniform(-5, 165, (40, 2))
            cell.inputs["keypoints"] = None if f == 2 else Kps(
                xy, rng.random(40) < 0.7)
            cell.inputs["pose_results"] = _poses(rng, 2 * f, pose_cls)
            cell.process()
    for f in range(1, 4):
        want = cv2.imread(str(tmp_path / f"ref_poses_{f:04d}.png"),
                          cv2.IMREAD_UNCHANGED)
        path = str(tmp_path / f"port_poses_{f:04d}.png")
        _same(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
        _same(tpng.read_png(path), want)


def test_guess_generator_cluster_pngs(graph_inputs, tmp_path):  # noqa: F811
    """The port's GuessGenerator with a visualize prefix writes the
    reference hook's cluster PNG (its own code, run on the same inputs)
    for each depth frame, none on a depthless frame, and the same
    detections as without visualize."""
    prefix = str(tmp_path / "g")

    def run(**kw):
        g = tc.GuessGenerator("g", n_ransac_iterations=256, min_inliers=8,
                              max_instances=3, seed=3, **CPU, **kw)
        g.ensure_configured()
        out = []
        for frame in graph_inputs + [dict(graph_inputs[0], points3d=np.zeros(
                (0, 0, 3), np.float32))]:
            g.inputs.update(frame)
            g.process()
            out.append(g.outputs["pose_results"])
        return out

    plain, drawn = run(), run(visualize=prefix)
    for a, b in zip(plain, drawn):
        assert [(r.object_id, r.confidence) for r in a] == \
            [(r.object_id, r.confidence) for r in b]
        for ra, rb in zip(a, b):
            _same(ra.R, rb.R)
            _same(ra.T, rb.T)
    pngs = sorted(glob.glob(prefix + "_clusters_*.png"))
    assert [os.path.basename(p) for p in pngs] == [
        f"g_clusters_{i:04d}.png" for i in range(1, len(graph_inputs) + 1)]
    for path, frame in zip(pngs, graph_inputs):
        kps, matches = frame["keypoints"], frame["matches"]
        kp_xy = np.asarray(kps.xy, np.float32)
        flat_valid = matches.valid.any(axis=1) & np.asarray(kps.valid)
        cluster = np.where(matches.valid, matches.obj_idx, -1).max(axis=1)
        want = rviz.draw_clusters(frame["image"], kp_xy[flat_valid],
                                  cluster[flat_valid])
        ref_path = str(tmp_path / "ref.png")
        cv2.imwrite(ref_path, want)
        _same(tpng.read_png(path), cv2.imread(ref_path,
                                              cv2.IMREAD_UNCHANGED))


def test_trainer_view_pngs_match_reference(views, tmp_path):  # noqa: F811
    """Each package's Trainer with a visualize prefix over the same four
    views: the same ``<prefix>_<object>_v<nn>.png`` pixels."""
    feat = json.dumps({"type": "ORB", "n_features": 300})
    for pkg, trainer, kw in ((rc, rc.Trainer, {}), (tc, tc.Trainer, CPU)):
        mod = __import__(pkg.__name__.split(".")[0] + ".db",
                         fromlist=["InMemoryDb"])
        params = {"type": "mem", "collection": "viz_train"}
        db = mod.InMemoryDb.shared(params["collection"])
        for o in views:
            mod.insert_observation(db, "obj000", o.frame_number, o.image,
                                   o.depth, o.mask, o.K, o.R, o.T)
        cell = trainer("t", visualize=str(tmp_path / pkg.__name__),
                       json_feature_params=feat, **kw)
        cell.inputs["json_db"] = json.dumps(params)
        cell.inputs["object_id"] = "obj000"
        cell.ensure_configured()
        cell.process()
    want = sorted(glob.glob(str(tmp_path / "tod_tpu.cells_obj000_v*.png")))
    got = sorted(glob.glob(str(tmp_path / "tod_tpu_torch.cells_obj000_v*.png")))
    assert len(want) == len(got) == 4
    for a, b in zip(got, want):
        _same(tpng.read_png(a), cv2.imread(b, cv2.IMREAD_UNCHANGED))


def _graph(ork, over, prefix, n_frames=2):
    """A port graph's pose results over ``n_frames``, and with ``prefix``
    the PoseDrawer's image of each frame."""
    if prefix:
        over = {**over, "pipeline1": {**over["pipeline1"],
                                      "visualize": prefix}}
    pipeline = build_pipeline_from_ork(ork, over)
    s = Scheduler(pipeline.plasm)
    results, drawn = [], []
    for _ in range(n_frames):
        s.execute_iteration()
        det = pipeline.cells["pipeline1"]
        results.append(list(det.outputs["pose_results"]))
        if prefix:
            drawer = det.pose_drawer
            drawn.append((drawer.outputs["image_out"],
                          dict(drawer.inputs.items())))
    return results, drawn


def _check_visualized(ork, over, tmp_path, keypoints: bool):
    """The graph with a visualize prefix: the same detections as without
    it, bit for bit; one PNG a frame, equal to the reference's drawing
    functions over that frame's image, keypoints and poses."""
    plain, _ = _graph(ork, over, None)
    prefix = str(tmp_path / "viz")
    seen, drawn = _graph(ork, over, prefix)
    for a, b in zip(plain, seen):
        assert [(r.object_id, r.confidence) for r in a] == \
            [(r.object_id, r.confidence) for r in b]
        for ra, rb in zip(a, b):
            _same(ra.R, rb.R)
            _same(ra.T, rb.T)
    assert any(seen), "no pose accepted"
    pngs = sorted(glob.glob(prefix + "_poses_*.png"))
    assert len(pngs) == len(drawn)
    for path, (image_out, ins), results in zip(pngs, drawn, seen):
        kps = ins["keypoints"]
        assert (kps is not None) == keypoints
        want = ins["image"]
        if kps is not None:
            want = rviz.draw_keypoints(want, np.asarray(kps.xy)[
                np.asarray(kps.valid)])
        want = rviz.draw_detections(want, np.asarray(ins["K_image"],
                                                     np.float64), results)
        _same(image_out, want)
        _same(tpng.read_png(path)[..., ::-1], want)


@pytest.mark.parametrize("text,keypoints", [(CELLS_ORK, True),
                                            (SEGMENTED_ORK, False)],
                         ids=["cells", "segmented"])
def test_detector_visualize_subgraph(text, keypoints, model_db,  # noqa: F811
                                     frames_dir, tmp_path):
    path = tmp_path / "detection.ork"
    path.write_text(text)
    _check_visualized(str(path), {
        "source1": {"path": frames_dir, "loop": False},
        "pipeline1": {"db": model_db, **CPU}}, tmp_path, keypoints)


def test_sift_serving_visualize_subgraph(sift_inputs, tmp_path):  # noqa: F811
    _check_visualized(sift_inputs["ork"], {
        **sift_inputs["over"], "pipeline1": {
            **sift_inputs["over"]["pipeline1"], **CPU}}, tmp_path, False)
