"""The port's synthetic renderer (tod_tpu_torch/utils/synthetic.py) bit
for bit against the reference's (tod_tpu/utils/synthetic.py): every public
function on seeded inputs, most at 120 x 160 with K scaled, and views 0,
17 and 59 of the bench's objects 0-2 (a plane, a box and a cylinder) at
480 x 640 against ``tests/data/torch_train_fixture.npz``."""

import json

import numpy as np
import pytest

import tod_tpu.utils.synthetic as rsyn
import tod_tpu_torch.utils.synthetic as tsyn

TRAIN_FIXTURE = "tests/data/torch_train_fixture.npz"
HW = (120, 160)
K_SMALL = tsyn.DEFAULT_K * np.array([[0.25], [0.25], [1.0]])


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _bench_obj(mod, i):
    """bench.py make_obj (BENCH_SHAPES=mixed)."""
    oid = f"obj{i:03d}"
    if i % 3 == 0:
        return mod.SyntheticObject.make(oid, seed=100 + i)
    if i % 3 == 1:
        return mod.SyntheticBox.make(oid, seed=100 + i,
                                     size_m=(0.2, 0.15, 0.1))
    return mod.SyntheticCylinder.make(oid, seed=100 + i, radius_m=0.08,
                                      height_m=0.2)


def test_constants_poses_and_rays():
    _same(tsyn.DEFAULT_K, rsyn.DEFAULT_K)
    for seed in range(20):
        for fn in ("facing_pose", "presenting_pose"):
            kw = dict(z=0.5 + 0.05 * seed, max_tilt=0.1 * (seed % 7))
            _same(getattr(tsyn, fn)(np.random.default_rng(seed), **kw),
                  getattr(rsyn, fn)(np.random.default_rng(seed), **kw))
    rng = np.random.default_rng(0)
    for c in list(rng.normal(size=(10, 3))) + [np.array([0.0, 0.0, 2.0])]:
        _same(tsyn.look_at(c, np.zeros(3)), rsyn.look_at(c, np.zeros(3)))
    for K, hw in ((K_SMALL, HW), (tsyn.DEFAULT_K, (48, 64))):
        _same(tsyn._pixel_rays(K, hw), rsyn._pixel_rays(K, hw))


@pytest.mark.parametrize("size", [384, 256, 160])
def test_make_texture(size):
    for seed in range(6):
        _same(tsyn.make_texture(seed * 37 + size, size),
              rsyn.make_texture(seed * 37 + size, size))


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fn = "facing_pose" if i % 2 else "presenting_pose"
        R, T = getattr(rsyn, fn)(rng, z=float(rng.uniform(0.3, 1.2)),
                                 max_tilt=1.2)
        if i % 5 == 4:
            T = T + np.array([0.4, 0.0, -0.2])     # partly off the frame
        out.append((R, T))
    return out


def test_render_quad_and_plane():
    tex = rsyn.make_texture(5, 256)
    s = 0.1
    quad = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]])
    seen = 0
    for R, T in _poses(16, 1):
        for cull in (True, False):
            bufs = []
            for mod in (tsyn, rsyn):
                canvas = np.full(HW, 7, np.uint8)
                depth = np.zeros(HW, np.float32)
                depth[40:60, 50:90] = 0.9
                vis = mod.render_quad(tex, quad, R, T, K_SMALL, HW, canvas,
                                      depth, cull=cull)
                bufs.append((vis, canvas, depth))
            _same(bufs[0], bufs[1])
            seen += int(bufs[0][0].sum())
        _same(tsyn.render_plane(tex, 0.24, R, T, K_SMALL, HW),
              rsyn.render_plane(tex, 0.24, R, T, K_SMALL, HW))
    assert seen > 2000


@pytest.mark.parametrize("i", [0, 1, 2, 4, 5])
def test_objects_render(i):
    """The bench's objects (a plane, a box, a cylinder) built and drawn
    from many poses, alone and over an earlier render."""
    t, r = _bench_obj(tsyn, i), _bench_obj(rsyn, i)
    for attr in ("texture", "textures", "side_texture", "cap_texture"):
        if hasattr(r, attr):
            _same(getattr(t, attr), getattr(r, attr))
    seen = 0
    for R, T in _poses(10, 10 + i):
        out = t.render(R, T, K_SMALL, HW)
        _same(out, r.render(R, T, K_SMALL, HW))
        seen += int((out[2] > 0).sum())
        base = np.full(HW, 50, np.uint8), np.full(HW, 0.95, np.float32)
        _same(t.render(R, T, K_SMALL, HW, base[0].copy(), base[1].copy()),
              r.render(R, T, K_SMALL, HW, base[0].copy(), base[1].copy()))
    assert seen > 2000                    # the poses do show the object


def test_turntable_observations():
    for i in range(3):
        t, r = _bench_obj(tsyn, i), _bench_obj(rsyn, i)
        kw = dict(n_views=5, distance=0.7, elevations_deg=(70.0, 20.0),
                  hw=HW, K=K_SMALL)
        _same(tsyn.turntable_observations(t, **kw),
              rsyn.turntable_observations(r, **kw))


def test_compose_scene_and_degrade_frame():
    """One three-object scene at 120 x 160, and the bench's scene 0 at
    480 x 640 degraded with two occluders (BENCH_NOISE=hard)."""
    objs = [(_bench_obj(tsyn, i), _bench_obj(rsyn, i)) for i in range(3)]
    poses = _poses(3, 3)
    _same(tsyn.compose_scene([o[0] for o in objs], poses, hw=HW, K=K_SMALL,
                             background_seed=5),
          rsyn.compose_scene([o[1] for o in objs], poses, hw=HW, K=K_SMALL,
                             background_seed=5))
    with np.load("tests/data/torch_smoke_fixture.npz") as f:
        image, depth = f["images"][0], f["depths"][0]
    kw = dict(rgb_sigma=10.0, depth_sigma_mm=5.0, depth_dropout=0.10,
              n_occluders=2)
    _same(tsyn.degrade_frame(image, depth, np.random.default_rng(1000), **kw),
          rsyn.degrade_frame(image, depth, np.random.default_rng(1000), **kw))


def test_bench_views_at_full_size():
    """Views 0, 17 and 59 of the bench's objects 0-2 with the bench's
    capture plan equal the reference's renders stored in the train
    fixture (gray, depth and mask)."""
    with np.load(TRAIN_FIXTURE) as f:
        cfg = json.loads(str(f["config_json"]))
        dists = [float(v) for v in cfg["train_dist"].split(",")]
        elevs = [float(v) for v in cfg["train_elev"].split(",")]
        rings = [(dists[0], e) for e in elevs] + [(d, 60.0)
                                                  for d in dists[1:]]
        for i in range(3):
            obj = _bench_obj(tsyn, i)
            for view in (0, 17, 59):
                dist, elev = rings[view // 12]
                obs = tsyn.turntable_observations(
                    obj, n_views=12, elevations_deg=(elev,),
                    distance=dist)[view % 12]
                mask = np.unpackbits(f[f"mask{i}"][view], axis=-1,
                                     bitorder="little")[:, :640]
                _same(obs["image"][..., 0], f[f"gray{i}"][view])
                assert (obs["image"] == obs["image"][..., :1]).all()
                _same(obs["depth"], f[f"depth{i}"][view])
                _same(obs["mask"] > 0, mask.astype(bool))
                assert set(np.unique(obs["mask"])) <= {
                    0, int(f[f"mask_value{i}"])}
                _same(obs["R"].astype(np.float32), f[f"R{i}"][view])
