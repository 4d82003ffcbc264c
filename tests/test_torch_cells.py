"""The cells and the two BlackBoxes (ROADMAP A12b): tod_tpu_torch against
tod_tpu on the CPU.

The inputs are the smoke fixture's (tests/data/torch_smoke_fixture.npz: the
bench's objects 0-2 trained by the reference, 63,588 rows, and two 640x480
frames) and the training fixture's views (tests/data/torch_train_fixture.npz),
at small feature counts. Contracts:

- FeatureDescriptor: keypoints bit for bit (Harris responses within
  test_torch_features.py's bound, angles within ``ANGLE_ATOL``), ORB
  descriptors bit for bit, SIFT
  descriptors within ``DESC_ATOL`` (queue C of ROADMAP.md);
- RescaledRegisteredDepth and DepthTo3d: bit for bit against the
  reference's eager cells (NaN where invalid);
- DescriptorMatcher: every field of the MatchSet, the matched 3D points,
  the ids and spans bit for bit (ORB on kernel B5's twin); SIFT rows,
  validity and objects exactly, distances within ``L2_RTOL``;
- GuessGenerator and TodDetector (both pipelines), from the same inputs or
  the same .ork text in each package: the same accepted object ids, in the
  same order, each pose within ``POSE_TOL`` (meters, degrees) of the
  reference's;
- TodTrainer: the model documents it writes equal to the reference's, bit
  for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import tod_tpu.cells as rc
import tod_tpu.db as rdb
from tod_tpu.models import TodDetector as RefTodDetector
from tod_tpu.models import TodTrainer as RefTodTrainer
from tod_tpu.pipeline import Scheduler as RefScheduler
from tod_tpu.pipeline import build_pipeline_from_ork as ref_build
import tod_tpu_torch.cells as tc
import tod_tpu_torch.db as tdb
from tod_tpu_torch.models import TodDetector, TodTrainer
from tod_tpu_torch.pipeline import Scheduler, build_pipeline_from_ork
from tod_tpu_torch.types import fixture_observations
from test_torch_sift import DESC_ATOL
from torch_parity import native_library

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
SMOKE = os.path.join(DATA, "torch_smoke_fixture.npz")
TRAIN = os.path.join(DATA, "torch_train_fixture.npz")
POSE_TOL = (1e-4, 0.05)     # meters, degrees
POSE_TOL_2D = (0.01, 2.0)   # the 2D-only path's end-to-end contract
L2_RTOL = 1e-5              # the f32 product's order (ROADMAP queue C)
ANGLE_ATOL = 4.8e-7         # two ulps at pi: XLA's atan2 (ROADMAP queue C)
N_FEATURES = 800
CPU = {"device": "cpu"}


@pytest.fixture(scope="session", autouse=True)
def _native_library():
    """The reference's Plasm sorts through tod_tpu.native: build it
    safely."""
    native_library()


@pytest.fixture(autouse=True)
def _reset_port_dbs():
    tdb.InMemoryDb.reset_shared()
    yield
    tdb.InMemoryDb.reset_shared()


@pytest.fixture(scope="module")
def fx():
    return np.load(SMOKE)


@pytest.fixture(scope="module")
def model_db(fx, tmp_path_factory):
    """The three trained models in one FilesystemDb (written by the
    reference; both packages read it): its parameters."""
    root = str(tmp_path_factory.mktemp("cells_db"))
    db = rdb.FilesystemDb(root)
    for i, oid in enumerate(fx["model_ids"]):
        rdb.write_model(db, str(oid), fx[f"desc{i}"], fx[f"points{i}"])
    return {"type": "filesystem", "root": root}


def _feature_json(kind="ORB", n=N_FEATURES):
    return json.dumps({"type": kind, "n_features": n, "n_levels": 3,
                       "scale_factor": 1.2})


def pose_gap(a, b):
    """(meters, degrees) between two poses, the angle from the Frobenius
    gap of the rotations in f64 (``2 asin(|Ra - Rb| / 2 sqrt 2)``, well
    conditioned near 0, where the trace formula of f32 matrices is not)."""
    dt = float(np.linalg.norm(np.float64(a.T) - np.float64(b.T)))
    gap = np.linalg.norm(np.float64(a.R) - np.float64(b.R))
    return dt, float(np.degrees(2 * np.arcsin(min(1.0, gap / 8 ** 0.5))))


def _same_poses(got, want):
    """The same accepted ids in the same order, with the same inlier
    counts, poses within POSE_TOL."""
    assert [r.object_id for r in got] == [r.object_id for r in want]
    for a, b in zip(got, want):
        dt, ang = pose_gap(a, b)
        assert dt < POSE_TOL[0] and ang < POSE_TOL[1], (a.object_id, dt, ang)
        assert a.confidence == b.confidence


# ---- feature and depth cells -------------------------------------------------

@pytest.mark.parametrize("kind", ["ORB", "SIFT"])
def test_feature_descriptor_matches_reference(fx, kind):
    feat = _feature_json(kind, 500)
    out = []
    for cell in (rc.FeatureDescriptor("f", json_feature_params=feat),
                 tc.FeatureDescriptor("f", json_feature_params=feat, **CPU)):
        cell.ensure_configured()
        cell.inputs["image"] = fx["images"][0]
        cell.process()
        out.append((cell.outputs["keypoints"], cell.outputs["descriptors"]))
    (rk, rd), (pk, pd) = out
    for name in ("xy", "level", "valid"):
        np.testing.assert_array_equal(getattr(pk, name),
                                      np.asarray(getattr(rk, name)), name)
    # XLA's atan2 is 1 ulp off the library's in ~15 % of inputs (ROADMAP
    # queue C): angles within two ulps at pi
    np.testing.assert_allclose(pk.angle, np.asarray(rk.angle), rtol=0,
                               atol=ANGLE_ATOL)
    # responses carry the Harris rounding bound of test_torch_features.py
    r = np.asarray(rk.response)
    fin = np.isfinite(r)
    np.testing.assert_allclose(pk.response[fin], r[fin], rtol=0,
                               atol=1e-4 * np.abs(r[fin]).max())
    assert pd.dtype == rd.dtype and pd.shape == rd.shape
    if kind == "ORB":
        np.testing.assert_array_equal(pd, rd)
    else:
        np.testing.assert_allclose(pd, rd, rtol=0, atol=DESC_ATOL)


@pytest.mark.parametrize("case", ["u16", "float", "rescaled"])
def test_depth_cells_match_reference_eager(fx, case):
    """The eager reference divides millimeters by 1000; so do the port's
    depth cells, bit for bit, through the rescale and the back-projection."""
    image = fx["images"][0]
    depth = fx["depths"][0]
    if case == "float":
        depth = depth.astype(np.float32) / np.float32(1000)
        depth[::7, ::5] = np.nan
    elif case == "rescaled":
        depth = depth[::2, ::2]
    got = []
    for pkg, kw in ((rc, {}), (tc, CPU)):
        dm = pkg.RescaledRegisteredDepth("d", **kw)
        dm.inputs["image"] = image
        dm.inputs["depth_in"] = depth
        dm.process()
        cloud = pkg.DepthTo3d("c", **kw)
        cloud.inputs["depth"] = dm.outputs["depth"]
        cloud.inputs["K"] = fx["K"]
        cloud.process()
        got.append((dm.outputs["depth"], cloud.outputs["points3d"]))
    for a, b in zip(got[1], got[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- DescriptorMatcher ------------------------------------------------------

def _small_models(fx, kind, seed=0):
    """Three models of a few hundred rows each, and queries: rows of them
    with bits flipped (ORB) or noise added (SIFT), and random rows."""
    rng = np.random.default_rng(seed)
    models, queries = [], []
    for i in range(3):
        n = (300, 450, 200)[i]
        pts = fx[f"points{i}"][:n]
        if kind == "ORB":
            desc = fx[f"desc{i}"][:n]
            q = desc[rng.choice(n, 60, replace=False)].copy()
            q ^= (rng.random(q.shape) < 0.04).astype(np.uint8) \
                << rng.integers(0, 8, q.shape).astype(np.uint8)
        else:
            desc = rng.random((n, 128), dtype=np.float32)
            desc /= np.linalg.norm(desc, axis=1, keepdims=True)
            q = desc[rng.choice(n, 60, replace=False)] \
                + rng.normal(0, 0.02, (60, 128)).astype(np.float32)
        models.append((f"m{i}", desc, pts))
        queries.append(q)
    extra = (rng.integers(0, 256, (40, 32), dtype=np.uint8) if kind == "ORB"
             else rng.random((40, 128), dtype=np.float32))
    queries.append(extra)
    return models, np.concatenate(queries)


def _matchers(models, search, collection="matcher"):
    out = []
    for pkg, kw in ((rdb, {}), (tdb, CPU)):
        db = pkg.InMemoryDb.shared(collection)
        for oid, d, p in models:
            pkg.write_model(db, oid, d, p)
    for cells, kw in ((rc, {}), (tc, CPU)):
        m = cells.DescriptorMatcher(
            "m", search_json_params=json.dumps(search),
            json_db=json.dumps({"type": "mem", "collection": collection}),
            **kw)
        m.ensure_configured()
        out.append(m)
    return out


def _run_matchers(matchers, query):
    outs = []
    for m in matchers:
        m.inputs["descriptors"] = query
        m.process()
        outs.append(dict(m.outputs.items()))
    return outs


@pytest.mark.parametrize("search", [
    {"type": "LSH", "radius": 60},
    {"type": "LSH", "radius": 0},
    {"type": "LSH", "radius": 35, "ratio": 0.8, "use_ratio": True, "k": 8},
    {"type": "BruteForce", "radius": 20, "k": 1}],
    ids=["radius60", "noradius", "ratio-k8", "k1"])
def test_descriptor_matcher_orb_bit_for_bit(fx, search):
    models, query = _small_models(fx, "ORB")
    ref, mine = _run_matchers(_matchers(models, search), query)
    for name in ("dist", "train_idx", "obj_idx", "local_idx", "valid"):
        a, b = getattr(mine["matches"], name), getattr(ref["matches"], name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    np.testing.assert_array_equal(mine["matches_3d"], ref["matches_3d"])
    assert mine["object_ids"] == ref["object_ids"]
    assert mine["spans"] == ref["spans"]
    valid = mine["matches"].valid
    assert valid.any() and (valid.all() == (search["radius"] == 0))


def test_descriptor_matcher_sift(fx):
    models, query = _small_models(fx, "SIFT")
    ref, mine = _run_matchers(
        _matchers(models, {"type": "L2", "radius": 0.5}), query)
    for name in ("train_idx", "obj_idx", "local_idx", "valid"):
        np.testing.assert_array_equal(getattr(mine["matches"], name),
                                      getattr(ref["matches"], name), name)
    np.testing.assert_allclose(mine["matches"].dist, ref["matches"].dist,
                               rtol=L2_RTOL, atol=0)
    np.testing.assert_array_equal(mine["matches_3d"], ref["matches_3d"])
    assert mine["matches"].valid[:, 0].sum() >= 150


def test_descriptor_matcher_empty_db():
    mine = _run_matchers(_matchers([], {"type": "LSH", "radius": 35},
                                   "empty"),
                         np.zeros((7, 32), np.uint8))
    for name in ("dist", "train_idx", "obj_idx", "local_idx", "valid"):
        np.testing.assert_array_equal(getattr(mine[1]["matches"], name),
                                      getattr(mine[0]["matches"], name))
    assert mine[1]["object_ids"] == []


# ---- GuessGenerator ---------------------------------------------------------

@pytest.fixture(scope="module")
def graph_inputs(fx, model_db):
    """The reference's feature, matcher and depth cells on both frames: the
    GuessGenerator's inputs, frame by frame."""
    feat = rc.FeatureDescriptor("f", json_feature_params=_feature_json())
    feat.ensure_configured()
    match = rc.DescriptorMatcher(
        "m", search_json_params=json.dumps({"type": "LSH", "radius": 35}),
        json_db=json.dumps(model_db))
    match.ensure_configured()
    frames = []
    for f in range(len(fx["images"])):
        feat.inputs["image"] = fx["images"][f]
        feat.process()
        match.inputs["descriptors"] = feat.outputs["descriptors"]
        match.process()
        dm = rc.RescaledRegisteredDepth("d")
        dm.inputs["image"] = fx["images"][f]
        dm.inputs["depth_in"] = fx["depths"][f]
        dm.process()
        cloud = rc.DepthTo3d("c")
        cloud.inputs["depth"] = dm.outputs["depth"]
        cloud.inputs["K"] = fx["K"]
        cloud.process()
        frames.append(dict(
            keypoints=feat.outputs["keypoints"],
            points3d=cloud.outputs["points3d"], K=fx["K"],
            image=fx["images"][f], **{k: match.outputs[k] for k in (
                "matches", "matches_3d", "object_ids", "spans")}))
    return frames


def _guess(cells, frames, **kw):
    g = cells.GuessGenerator("g", n_ransac_iterations=256, min_inliers=8,
                             max_instances=3, seed=3, **kw)
    g.ensure_configured()
    out = []
    for frame in frames:
        g.inputs.update(frame)
        g.process()
        out.append(g.outputs["pose_results"])
    return out


def test_guess_generator_matches_reference_two_frames(graph_inputs):
    """The same seed over two frames in a row: the port splits the
    reference's key each frame and draws its noise, so it accepts the same
    objects with the same inlier counts, poses within POSE_TOL."""
    want = _guess(rc, graph_inputs)
    got = _guess(tc, graph_inputs, **CPU)
    for g, w in zip(got, want):
        _same_poses(g, w)
    assert {r.object_id for r in got[0]} >= {"obj000", "obj001", "obj002"}


def test_guess_generator_depthless_frames(graph_inputs):
    """No cloud and no K: no poses, as in the reference. No cloud with K:
    the 2D-only path (the reference's ``_process_2d``), two frames in a row
    from the same seed: the reference cell's accepted objects and instances
    in the same order with the same unique-inlier counts, poses within
    ``POSE_TOL_2D`` (the 2D path's f32 P3P and Gauss-Newton round apart
    more than the 3D path's Horn fits; ROADMAP queue C)."""
    frames = [dict(f, points3d=np.zeros((0, 0, 3), np.float32))
              for f in graph_inputs]
    g = tc.GuessGenerator("g", **CPU)
    g.ensure_configured()
    g.inputs.update(dict(frames[0], K=None))
    g.process()
    assert g.outputs["pose_results"] == []
    want = _guess(rc, frames)
    got = _guess(tc, frames, **CPU)
    for a_frame, b_frame in zip(got, want):
        assert [(r.object_id, r.confidence) for r in a_frame] == \
            [(r.object_id, r.confidence) for r in b_frame]
        for a, b in zip(a_frame, b_frame):
            dt, ang = pose_gap(a, b)
            assert dt < POSE_TOL_2D[0] and ang < POSE_TOL_2D[1], \
                (a.object_id, dt, ang)
    assert {r.object_id for r in got[0]} == {"obj000", "obj001", "obj002"}
    assert max(r.confidence for r in got[0]) >= 100


# ---- TodDetector, both pipelines, and the .ork path ---------------------

CELLS_ORK = """
source1:
  type: OpenNI
  module: object_recognition_core.io.source
pipeline1:
  type: TodDetector
  module: object_recognition_tod
  inputs: [source1]
  parameters:
    object_ids: "all"
    feature: {type: ORB, n_features: 800, n_levels: 3, scale_factor: 1.2}
    descriptor: {type: ORB}
    search: {type: LSH, radius: 35, ratio: 0.8}
    n_ransac_iterations: 256
    min_inliers: 8
    sensor_error: 0.01
"""

SEGMENTED_ORK = CELLS_ORK.replace(
    "    n_ransac_iterations: 256", """    pipeline: segmented
    q_cap: 512
    bucket_grid: '6x8'
    n_ransac_iterations: 256
    max_instances: 2
    max_matches_per_object: 192
    activation_m_cap: 96
    activation_hypotheses: 128
    activation_prescreen: 2
    min_quality: 156""").replace("radius: 35", "radius: 50")


@pytest.fixture(scope="module")
def frames_dir(fx, tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for f in range(len(fx["images"])):
        np.savez(d / f"frame{f}.npz", image=fx["images"][f],
                 depth=fx["depths"][f], K=fx["K"])
    return str(d)


@pytest.mark.parametrize("text", [CELLS_ORK, SEGMENTED_ORK],
                         ids=["cells", "segmented"])
def test_tod_detector_ork_matches_reference(text, model_db, frames_dir,
                                            tmp_path):
    """The same .ork text through each package's build_pipeline_from_ork
    and Scheduler, two frames: the same poses."""
    path = tmp_path / "detection.ork"
    path.write_text(text)
    over = {"source1": {"path": frames_dir, "loop": False},
            "pipeline1": {"db": model_db}}
    results = []
    for build, sched, extra in ((ref_build, RefScheduler, {}),
                                (build_pipeline_from_ork, Scheduler, CPU)):
        pipeline = build(str(path), {**over, "pipeline1": {
            **over["pipeline1"], **extra}})
        s = sched(pipeline.plasm)
        frames = []
        for _ in range(2):
            s.execute_iteration()
            frames.append(pipeline.cells["pipeline1"].outputs[
                "pose_results"])
        results.append(frames)
        assert "2 iterations" in s.timing_report()
    for got, want in zip(results[1], results[0]):
        _same_poses(got, want)
        assert got, "no pose accepted"
        assert all(r.db_params == model_db for r in got)


def test_tod_detector_ork_depthless_matches_reference(model_db, fx,
                                                     tmp_path):
    """The slice as a whole: the same .ork text through each package's
    graph over the two frames with their depth removed (each frame an
    empty depth and K): the 2D-only path in both, the same accepted objects
    and instances with the same unique-inlier counts, poses within
    ``POSE_TOL_2D``."""
    frames = tmp_path / "frames"
    frames.mkdir()
    for f in range(len(fx["images"])):
        np.savez(frames / f"frame{f}.npz", image=fx["images"][f],
                 depth=np.zeros((0, 0)), K=fx["K"])
    path = tmp_path / "detection.ork"
    path.write_text(CELLS_ORK)
    results = []
    for build, sched, extra in ((ref_build, RefScheduler, {}),
                                (build_pipeline_from_ork, Scheduler, CPU)):
        pipeline = build(str(path), {
            "source1": {"path": str(frames), "loop": False},
            "pipeline1": {"db": model_db, **extra}})
        s = sched(pipeline.plasm)
        out = []
        for _ in range(2):
            s.execute_iteration()
            out.append(pipeline.cells["pipeline1"].outputs["pose_results"])
        results.append(out)
    for got, want in zip(results[1], results[0]):
        assert [(r.object_id, r.confidence) for r in got] == \
            [(r.object_id, r.confidence) for r in want]
        for a, b in zip(got, want):
            dt, ang = pose_gap(a, b)
            assert dt < POSE_TOL_2D[0] and ang < POSE_TOL_2D[1], \
                (a.object_id, dt, ang)
    assert "obj001" in {r.object_id for r in results[1][0]}


def test_tod_detector_cells_blackbox_wiring(model_db, fx):
    """The BlackBox built directly, as the reference's API builds it: the
    same inner cells and forwards, every computing cell on its device."""
    kw = dict(json_db=json.dumps(model_db),
              search=json.dumps({"type": "LSH", "radius": 35}),
              json_feature_params=_feature_json())
    mine, ref = TodDetector("d", **kw, **CPU), RefTodDetector("d", **kw)
    assert sorted(mine._cells) == sorted(ref._cells)
    assert sorted(mine.params.keys()) == sorted(
        list(ref.params.keys()) + ["device"])
    assert TodDetector("d").params["device"] == "cuda"
    mine.ensure_configured()
    devices = {c.name: c.params["device"] for c in mine.plasm.cells
               if "device" in c.params}
    assert set(devices.values()) == {"cpu"} and len(devices) == 5


def test_unported_options_raise():
    """The options that once raised as not ported now configure:
    ``visualize`` (test_torch_visualize.py) adds the PoseDrawer to the
    detector and configures the Trainer, and the cells take sub-pixel
    keypoints."""
    det = TodDetector("d", visualize=True, **CPU)
    assert "pose_drawer" in det._cells
    assert det._cells["pose_drawer"].params["prefix"] == "/tmp/tod_tpu_viz"
    # sub-pixel keypoints are ported (test_torch_subpixel.py): the cells
    # take them
    feat = tc.FeatureDescriptor("f", json_feature_params=json.dumps(
        {"type": "ORB", "subpixel": True}), **CPU)
    feat.ensure_configured()
    assert feat._settings["subpixel"] is True
    seg = tc.SegmentedDetector("s", json_feature_params=json.dumps(
        {"type": "ORB", "subpixel": True}), **CPU)
    seg.ensure_configured()
    assert seg._detector.config.subpixel is True
    trainer = tc.Trainer("t", visualize=True, **CPU)
    trainer.ensure_configured()
    trainer.inputs["object_id"] = "obj000"
    assert trainer._view_sink().args[0] == "/tmp/tod_tpu_train"


# ---- TodTrainer ----------------------------------------------------------

@pytest.fixture(scope="module")
def views():
    """Four of object 0's training views."""
    return fixture_observations(np.load(TRAIN), 0)[::15]


@pytest.mark.parametrize("dedup", [0, 8])
def test_tod_trainer_writes_the_reference_model(views, dedup):
    """Each package's TodTrainer over the same observations in its own DB:
    the model documents written are equal, bit for bit."""
    feat = _feature_json("ORB", 300)
    docs = []
    for pkg, trainer, kw in ((rdb, RefTodTrainer, {}),
                             (tdb, TodTrainer, CPU)):
        params = {"type": "mem", "collection": f"train{dedup}"}
        db = pkg.InMemoryDb.shared(params["collection"])
        for o in views:
            pkg.insert_observation(db, "obj000", o.frame_number, o.image,
                                   o.depth, o.mask, o.K, o.R, o.T)
        t = trainer("t", object_id="obj000", json_db=json.dumps(params),
                    json_feature_params=feat, dedup_hamming=dedup, **kw)
        t.process()
        docs.append(db.load(t.outputs["document_id"]))
    ref, mine = docs
    assert mine.fields == ref.fields
    assert sorted(mine.attachments) == sorted(ref.attachments)
    for name, want in ref.attachments.items():
        got = mine.attachments[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert ref.attachments["descriptors"].shape[0] > 100


def test_model_writer_replaces_and_reader_loads(tmp_path):
    """ModelWriter keeps one model per (object, method); ModelReader and
    ModelReaderIterative load it back, as the reference's do."""
    params = json.dumps({"type": "filesystem", "root": str(tmp_path)})
    ids = []
    for n in (5, 3):
        filler = tc.ModelFiller("f")
        filler.inputs["descriptors"] = np.full((n, 32), n, np.uint8)
        filler.inputs["points"] = np.zeros((1, n, 3), np.float32)
        filler.process()
        writer = tc.ModelWriter("w")
        writer.inputs.update({"db_document": filler.outputs["db_document"],
                              "json_db": params, "object_id": "o"})
        writer.process()
        ids.append(writer.outputs["document_id"])
    db = tdb.ObjectDbParameters(params).generate_db()
    assert db.all_ids() == [ids[1]]
    for cells, kw in ((tc, {}), (rc, {})):
        reader = cells.ModelReaderIterative("r", db_params=params,
                                            model_ids=[ids[1]])
        reader.ensure_configured()
        reader.process()
        assert reader.outputs["object_ids"] == ["o"]
        assert reader.outputs["descriptors"][0].shape == (3, 32)


def test_io_cells_match_reference(frames_dir):
    """DatasetSource over a directory of .npz frames (looping and not), an
    Aggregator of two inputs and a Publisher, in both packages."""
    outs = []
    for cells in (rc, tc):
        seen = []
        src = cells.DatasetSource("s", path=frames_dir, loop=False)
        agg = cells.Aggregator("a", n_inputs=2)
        pub = cells.Publisher("p", callback=seen.append)
        for c in (src, agg, pub):
            c.ensure_configured()
        ends = []
        for _ in range(3):
            src.process()
            ends.append(src.outputs["at_end"])
        agg.inputs["pose_results"] = ["x"]
        agg.inputs["pose_results1"] = ["y", "z"]
        agg.process()
        pub.inputs["pose_results"] = agg.outputs["pose_results"]
        pub.process()
        outs.append((ends, src.outputs["image"].sum(), seen,
                     pub.published))
    assert outs[0] == outs[1]
