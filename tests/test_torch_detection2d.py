"""The 2D-only detection path (tod_tpu_torch/geometry/detection2d.py)
against the reference (tod_tpu/geometry/detection2d.py) on the CPU, stage
by stage on the same inputs, then whole.

The scene: three objects in one frame's flat (Q, 2) matches, M = 64 match
slots, 32 hypotheses, 2 instance rounds. Object 0 is a near-planar model
seen at one pose (40 true matches, 24 junk, ten keypoints matched twice),
object 1 another at another pose (30 true, 21 junk), object 2 has ten
matches on five keypoints (it can never reach ``min_inliers`` = 8).

Contracts:

- exact: the clustered stores; the 2D key path (keys bit for bit against
  ``jax.random.split``); the sampling graph and its 64-bin histogram given
  the reference's pair geometry and range; the triples given the same
  Gumbel values and log-weights; the top-8 order with ties; the keypoint
  invalidation; the unique-inlier counts;
- float: pair geometry within ``DPIX2_ATOL``, ``DTRAIN2_ATOL``,
  ``LOG_R_ATOL`` and ``GEOM_RTOL``; log-weights within
  ``LOGW_ATOL``; Gumbel values within ``2^-22 + 2 ulp`` (test_torch_prng.py);
  the model normal against ``eigh``'s smallest eigenvector up to sign
  within ``NORMAL_ATOL``, and the mirrored pose the same for both signs;
  mirrored poses within ``POSE_ATOL``;
- whole: ``ransac_round_2d`` and ``detect_frame_2d`` give the reference's
  found / accepted flags and unique-inlier counts exactly on this scene,
  poses within ``POSE_ATOL``; the synthetic scene of
  test_pnp.py::test_detect_frame_2d_synthetic accepted within 2 cm with at
  least 40 inliers, as the reference; the hopeless object is not searched
  (the reference accepts nothing there) and chunking the objects changes
  nothing.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.geometry import adjacency as radj
from tod_tpu.geometry import detection as rdet
from tod_tpu.geometry import detection2d as rd
from tod_tpu.geometry import ransac as rr
from tod_tpu_torch.geometry import adjacency as tadj
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry import detection2d as td
from tod_tpu_torch.geometry.ransac import ThreefryNoise
from tod_tpu_torch.ops.fast import stable_topk
from tod_tpu_torch.utils import prng
from test_torch_pnp import K, random_pose
from torch_parity import gumbel_triple

torch.set_num_threads(1)

M, N_HYP, N_INST, SEED = 64, 32, 2, 5
CFG = dict(n_hypotheses=N_HYP, min_inliers=8, max_instances=N_INST)
GEOM_RTOL = 1e-5         # the histogram's range
DPIX2_ATOL = 0.125       # px^2: four ulps of |xy|^2 ~ 4e5
DTRAIN2_ATOL = 1e-8      # m^2: a few ulps of |X|^2 ~ 0.04
LOG_R_ATOL = 1e-4        # on pairs > 20 px and > 1 cm apart
LOGW_ATOL = 1e-6         # log(1 + 3-path counts)
NORMAL_ATOL = 1e-4       # |n . n_ref| within this of 1
POSE_ATOL = 1e-4         # rotation entries and meters
GUMBEL_ULP = 2.0 ** -22  # + 2 ulp, test_torch_prng.py's bound


def _observe(rng, R, T, X, noise=0.3):
    uv = (X @ R.T + T) @ K.T
    return (uv[:, :2] / uv[:, 2:3]
            + rng.normal(0, noise, (len(X), 2))).astype(np.float32)


def _junk(rng, n):
    xy = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    return xy, rng.uniform(-0.12, 0.12, (n, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def scene():
    """Flat (Q, 2) matches of the three objects (see the module doc)."""
    rng = np.random.default_rng(11)
    q, k = 100, 2
    obj = np.full((q, k), -1, np.int32)
    valid = np.zeros((q, k), bool)
    train = np.zeros((q, k, 3), np.float32)
    xy = np.zeros((q, 2), np.float32)
    for o, (lo, n_true, n_junk) in enumerate([(0, 40, 14), (54, 30, 11)]):
        R, T = random_pose(rng, z=0.8 + 0.2 * o)
        X = rng.uniform(-0.12, 0.12, (n_true, 3)).astype(np.float32)
        X[:, 2] *= 0.05
        rows = slice(lo, lo + n_true)
        xy[rows], train[rows, 0] = _observe(rng, R, T, X), X
        junk = slice(lo + n_true, lo + n_true + n_junk)
        xy[junk], train[junk, 0] = _junk(rng, n_junk)
        obj[lo:lo + n_true + n_junk, 0] = o
        # ten keypoints matched twice to the same object
        twice = slice(lo, lo + 10)
        obj[twice, 1] = o
        train[twice, 1] = _junk(rng, 10)[1]
    xy[95:], train[95:, 0] = _junk(rng, 5)
    train[95:, 1] = _junk(rng, 5)[1]
    obj[95:] = 2
    valid = obj >= 0
    dist = rng.uniform(10, 30, (q, k)).astype(np.float32)
    return obj, dist, valid, train, xy


def _ref_clustered():
    obj, dist, valid, train, xy = scene()
    return jax.jit(rdet.cluster_matches, static_argnums=7)(
        obj, dist, valid, train, np.zeros((len(obj), 3), np.float32), xy,
        jnp.arange(3), M)


def _port_clustered():
    obj, dist, valid, train, xy = map(torch.from_numpy, scene())
    return tdet.cluster_matches(obj, dist, valid, train,
                                torch.zeros((len(obj), 3)), xy,
                                torch.arange(3), M)


@pytest.fixture(scope="module")
def stores():
    """The clustered stores of both packages: (reference, port)."""
    return _ref_clustered(), _port_clustered()


def _np(x):
    return np.asarray(x)


def test_clustered_stores_match_reference(stores):
    ref, got = stores
    for name in ("query_idx", "query_xy", "train_pts", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), name)
    n_kp = tadj.count_unique_query_indices(got.query_idx, got.valid)
    want = jax.vmap(radj.count_unique_query_indices)(ref.query_idx, ref.valid)
    np.testing.assert_array_equal(n_kp.numpy(), _np(want))
    assert n_kp.tolist() == [54, 41, 5]


@jax.jit
def _ref_geometry(m, K_):
    """The reference's pair geometry and histogram range
    (detection2d.py:80-100), per object."""
    def one(xy, pts):
        dpix2 = radj.pairwise_sq_dists(
            jnp.concatenate([xy, jnp.zeros_like(xy[:, :1])], -1))
        dtrain2 = radj.pairwise_sq_dists(pts)
        log_r = 0.5 * (jnp.log(jnp.maximum(dpix2, 1e-12))
                       - jnp.log(jnp.maximum(dtrain2, 1e-12)))
        return dpix2, dtrain2, log_r

    f = 0.5 * (K_[0, 0] + K_[1, 1])
    lo, hi = jnp.log(f / 5.0), jnp.log(f / 0.25)
    return jax.vmap(one)(m.query_xy, m.train_pts) + (lo, hi)


@jax.jit
def _ref_graph(dpix2, dtrain2, log_r, valid, lo, hi):
    """The reference's sampling graph (detection2d.py:84-108) given the
    pair geometry: (adj, histogram counts), per object."""
    def one(dpix2, dtrain2, log_r, valid):
        mcap = valid.shape[0]
        base = ((dpix2 > rd.PIXEL_SEP_SQ) & (dtrain2 > rd.MIN_TRAIN_SEP ** 2)
                & valid[:, None] & valid[None, :]
                & ~jnp.eye(mcap, dtype=bool))
        n_bins = 64
        in_range = base & (log_r >= lo) & (log_r < hi)
        bins = jnp.clip(((log_r - lo) / (hi - lo) * n_bins).astype(jnp.int32),
                        0, n_bins - 1)
        counts = jnp.zeros(n_bins, jnp.int32).at[
            jnp.where(in_range, bins, 0)].add(in_range.astype(jnp.int32))
        peak = jnp.argmax(counts)
        center = lo + (peak.astype(jnp.float32) + 0.5) / n_bins * (hi - lo)
        return base & (jnp.abs(log_r - center) < jnp.log(1.4)), counts

    return jax.vmap(one)(dpix2, dtrain2, log_r, valid)


@pytest.fixture(scope="module")
def graphs(stores):
    """Both packages' pair geometry, and the reference's graph."""
    ref, got = stores
    r_geom = [_np(x) for x in _ref_geometry(ref, K)]
    t_geom = td.pair_geometry(got) + td.scale_range(torch.from_numpy(K),
                                                    td.Pnp2dConfig(**CFG))
    adj, counts = _ref_graph(*r_geom[:3], ref.valid, *r_geom[3:])
    return r_geom, t_geom, _np(adj), _np(counts)


def test_pair_geometry_matches_reference(graphs):
    """|a|^2 + |b|^2 - 2 a.b loses a few ulps of |a|^2 to cancellation in
    either package; the log ratios are held on the pairs the graph can
    keep (far apart in pixels and on the model)."""
    r_geom, t_geom, _, _ = graphs
    (dpix2, dtrain2, log_r, lo, hi), got = r_geom, [x.numpy() for x in t_geom]
    np.testing.assert_allclose(got[0], dpix2, atol=DPIX2_ATOL)
    np.testing.assert_allclose(got[1], dtrain2, atol=DTRAIN2_ATOL)
    kept = (dpix2 > td.PIXEL_SEP_SQ) & (dtrain2 > td.MIN_TRAIN_SEP ** 2)
    np.testing.assert_allclose(got[2][kept], log_r[kept], atol=LOG_R_ATOL)
    np.testing.assert_allclose(got[3:], [lo, hi], rtol=GEOM_RTOL)


def test_sampling_graph_exact_given_the_geometry(stores, graphs):
    """Fed the reference's distances, ratios and range, the graph and the
    histogram are the reference's, bit for bit."""
    ref, got = stores
    r_geom, _, adj_ref, counts_ref = graphs
    adj, counts = td.sampling_graph(*(torch.from_numpy(x) for x in r_geom[:3]),
                                    got.valid,
                                    *(torch.tensor(x) for x in r_geom[3:]))
    np.testing.assert_array_equal(counts.numpy(), counts_ref)
    np.testing.assert_array_equal(adj.numpy(), adj_ref)
    assert counts_ref[:2].max(-1).min() > 20       # a clear mode per object
    assert td.LOG_SCALE_GATE == float(np.float32(jnp.log(1.4)))


def test_log_weights_match_reference(stores, graphs):
    ref, got = stores
    adj_ref = graphs[2]
    want = jax.jit(jax.vmap(rr.consistency_log_weights))(adj_ref, ref.valid)
    from tod_tpu_torch.geometry.ransac import consistency_log_weights
    got_w = consistency_log_weights(torch.from_numpy(adj_ref), got.valid)
    np.testing.assert_allclose(got_w.numpy(), _np(want), atol=LOGW_ATOL)


def _round_keys(seed, n_obj, i):
    """The reference's round-i key of each object (detection2d.py:231,256)."""
    return [jax.random.split(k, N_INST)[i]
            for k in jax.random.split(jax.random.PRNGKey(seed), n_obj)]


def test_round_noise_follows_the_reference_key_path():
    noise = ThreefryNoise(prng.prng_key(SEED), N_INST, False, "cpu")
    for i in range(N_INST):
        keys = _round_keys(SEED, 3, i)
        want = np.stack([np.asarray(jax.random.split(k, 3)) for k in keys])
        np.testing.assert_array_equal(noise.keys(f"round{i}", 3), want)
        g = noise(f"round{i}", (3, 3, N_HYP, M), rows=np.array([0, 2]))
        ref = np.stack([gumbel_triple(keys[o], N_HYP, M) for o in (0, 2)])
        gap = np.abs(g.numpy() - ref)
        assert (gap <= GUMBEL_ULP + 2 * np.spacing(np.abs(ref))).all()


def test_triples_exact_given_the_noise(stores, graphs):
    ref, got = stores
    adj_ref = graphs[2]
    logw = _np(jax.jit(jax.vmap(rr.consistency_log_weights))(adj_ref,
                                                             ref.valid))
    keys = _round_keys(SEED, 3, 0)
    want, ok_ref = jax.jit(jax.vmap(
        functools.partial(rr.sample_triples, n=N_HYP)))(
            jnp.stack(keys), adj_ref, ref.valid, logw=logw)
    gumbel = torch.from_numpy(np.stack([gumbel_triple(k, N_HYP, M)
                                        for k in keys]))
    (v1, v2, v3), ok = td.sample_triples(gumbel, torch.from_numpy(adj_ref),
                                         got.valid, torch.from_numpy(logw))
    for a, b in zip((v1, v2, v3), want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(ok.numpy(), _np(ok_ref))
    assert ok.numpy()[:2].all()


def test_top8_order_with_ties():
    """Small integer counts tie as a rule: the order is ``top_k``'s (count,
    then the lower index), exactly."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 6, (4, 32 * 8)).astype(np.int32)
    counts[1] = 3                                   # all equal
    counts[2, ::7] = 5
    _, want = jax.lax.top_k(jnp.asarray(counts), td.N_REFINE)
    _, got = stable_topk(torch.from_numpy(counts).long(), td.N_REFINE)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got.numpy()[1].tolist() == list(range(td.N_REFINE))


def _ref_mirror(r0, t0, n_model):
    """The reference's mirror (detection2d.py:172-188)."""
    n_c = r0 @ n_model
    v = t0 / jnp.maximum(jnp.linalg.norm(t0), 1e-9)
    n_ref = 2.0 * jnp.dot(n_c, v) * v - n_c
    axis = jnp.cross(n_c, n_ref)
    s = jnp.linalg.norm(axis)
    c = jnp.clip(jnp.dot(n_c, n_ref), -1.0, 1.0)
    a = axis / jnp.maximum(s, 1e-9)
    ax = jnp.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                    [-a[1], a[0], 0.0]])
    ang = jnp.arctan2(s, c)
    Q = jnp.eye(3) + jnp.sin(ang) * ax + (1.0 - jnp.cos(ang)) * (ax @ ax)
    return jnp.where(s > 1e-6, Q, jnp.eye(3)) @ r0, t0


@jax.jit
def _ref_normal(pts, valid):
    """eigh's smallest-variance direction (detection2d.py:164-170)."""
    ctr = jnp.where(valid[:, None], pts, 0.0)
    mean = ctr.sum(0) / jnp.maximum(valid.sum(), 1)
    cov = ((ctr - mean) * valid[:, None]).T @ (ctr - mean)
    return jnp.linalg.eigh(cov)[1][:, 0]


def test_mirror_matches_reference_up_to_the_normal_sign(stores):
    ref, got = stores
    n_ref = _np(jax.vmap(_ref_normal)(ref.train_pts, ref.valid))
    n = td.model_normal(got.train_pts, got.valid)
    dots = np.abs((n.numpy() * n_ref).sum(-1))
    np.testing.assert_allclose(dots, 1.0, atol=NORMAL_ATOL)
    rng = np.random.default_rng(1)
    R = np.stack([np.stack([random_pose(rng)[0] for _ in range(4)])
                  for _ in range(3)])
    T = np.stack([np.stack([random_pose(rng)[1] for _ in range(4)])
                  for _ in range(3)])
    R_t, T_t = torch.from_numpy(R), torch.from_numpy(T)
    plus = td.mirror_poses(R_t, T_t, n)
    minus = td.mirror_poses(R_t, T_t, -n)
    assert torch.equal(plus[0], minus[0]) and torch.equal(plus[1], minus[1])
    want = jax.jit(jax.vmap(jax.vmap(_ref_mirror, (0, 0, None))))(
        R, T, n_ref)
    np.testing.assert_allclose(plus[0].numpy(), _np(want[0]),
                               atol=POSE_ATOL)
    # a mirror is a rotation other than the pose itself
    assert np.abs(plus[0].numpy() - R).max() > 1e-2


def test_invalidation_exact(stores):
    ref, got = stores
    rng = np.random.default_rng(2)
    inl = rng.uniform(0, 1, (3, M)) < 0.3
    inl &= got.valid.numpy()
    accept = np.array([True, False, True])

    def one(valid, qidx, inliers, acc):
        shares = ((qidx[:, None] == qidx[None, :])
                  & inliers[None, :]).any(axis=1)
        return jnp.where(acc, valid & ~shares, valid)

    want = jax.vmap(one)(ref.valid, ref.query_idx, inl, accept)
    out = td.invalidate_keypoints(got.valid, got.query_idx,
                                  torch.from_numpy(inl),
                                  torch.from_numpy(accept))
    np.testing.assert_array_equal(out.numpy(), _np(want))
    assert (out.numpy() != got.valid.numpy()).sum() > inl[[0, 2]].sum()


@pytest.fixture(scope="module")
def round0(stores):
    """Round 0 of both packages on the scene, each with its own noise."""
    ref, got = stores
    cfg = rd.Pnp2dConfig(**CFG)
    keys = jnp.stack(_round_keys(SEED, 3, 0))
    want = jax.jit(jax.vmap(functools.partial(rd.ransac_round_2d, cfg=cfg),
                            (0, 0, None, 0)))(keys, ref, K, ref.valid)
    noise = ThreefryNoise(prng.prng_key(SEED), N_INST, False, "cpu")
    out = td.ransac_round_2d(noise("round0", (3, 3, N_HYP, M)), got,
                             torch.from_numpy(K), got.valid,
                             td.Pnp2dConfig(**CFG))
    return [_np(x) for x in want], [x.numpy() for x in out]


def test_ransac_round_2d_matches_reference(round0):
    want, got = round0
    (r_w, t_w, inl_w, n_w, f_w), (r, t, inl, n, f) = want, got
    np.testing.assert_array_equal(f, f_w)
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(inl, inl_w)
    np.testing.assert_allclose(r[f], r_w[f], atol=POSE_ATOL)
    np.testing.assert_allclose(t[f], t_w[f], atol=POSE_ATOL)
    assert f[:2].all() and n[0] >= 30 and n[1] >= 25


def _port_frame():
    obj, dist, valid, train, xy = map(torch.from_numpy, scene())
    noise = ThreefryNoise(prng.prng_key(SEED), N_INST, False, "cpu")
    return td.detect_frame_2d(noise, obj, dist, valid, train, xy,
                              torch.from_numpy(K), torch.arange(3), M,
                              td.Pnp2dConfig(**CFG))


@pytest.fixture(scope="module")
def frame_ref():
    obj, dist, valid, train, xy = scene()
    det = jax.jit(functools.partial(
        rd.detect_frame_2d, max_matches=M, cfg=rd.Pnp2dConfig(**CFG)))(
            jax.random.PRNGKey(SEED), obj, dist, valid, train, xy, K,
            jnp.arange(3))
    return [_np(x) for x in det]


def _same_frame(got, want, searched):
    """Accepts equal; the searched objects' unique-inlier counts equal
    (every round's); poses equal within POSE_ATOL where accepted."""
    acc = want[3]
    np.testing.assert_array_equal(got.accepted.numpy(), acc)
    counts = got.n_inliers.numpy()
    np.testing.assert_array_equal(counts[searched], want[2][searched])
    np.testing.assert_allclose(got.R.numpy()[acc], want[0][acc],
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got.T.numpy()[acc], want[1][acc],
                               atol=POSE_ATOL)


def test_detect_frame_2d_matches_reference(frame_ref):
    got = _port_frame()
    _same_frame(got, frame_ref, searched=[0, 1])
    assert frame_ref[3][:2, 0].all() and not frame_ref[3][2].any()
    assert got.R.shape == (3, N_INST, 3, 3)
    assert not got.rms_residual.any() and not got.clique_size.any()


def test_hopeless_objects_skipped_and_chunks_change_no_accept(
        frame_ref, monkeypatch):
    """Object 2 (five keypoints) is not searched, as the reference's
    search of it accepts nothing: its rows hold no accept, zero inliers
    and the identity pose; the others keep their keys (above). Chunks of
    one object give what one batch gives, bit for bit."""
    batch = _port_frame()
    assert not frame_ref[3][2].any() and not batch.accepted[2].any()
    assert not batch.n_inliers[2].any()
    assert torch.equal(batch.R[2], torch.eye(3).expand(N_INST, 3, 3))
    monkeypatch.setattr(td, "OBJECT_CHUNK", 1)
    one = _port_frame()
    for a, b in zip(batch, one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 16, 32])
def test_consensus_product_same_bits_at_every_chunk(chunk):
    """The consensus's camera coordinates (``rotate_points``) of 32
    objects run in chunks of 1, 16 or 32 objects give the same bits, and
    those of the reference's compiled ``X @ R.T + T`` (vmapped over the
    hypotheses, mapped over the objects 8 at a time, as its 2D round
    runs it)."""
    rng = np.random.default_rng(3)
    n_a, n_h, m = 32, 48, 40
    q = rng.normal(size=(n_a * n_h, 4))
    R = _rotations(q).reshape(n_a, n_h, 3, 3)
    T = (rng.normal(size=(n_a, n_h, 3)) * 0.1
         + [0.0, 0.0, 0.8]).astype(np.float32)
    X = rng.uniform(-0.1, 0.1, (n_a, m, 3)).astype(np.float32)

    def per_object(args):
        r, t, x = args
        return jax.vmap(lambda r1, t1: x @ r1.T + t1)(r, t)

    ref = np.asarray(jax.jit(lambda r, t, x: jax.lax.map(
        per_object, (r, t, x), batch_size=8))(R, T, X))      # (A, H, M, 3)
    Rt, Tt, Xt = (torch.from_numpy(a) for a in (R, T, X))
    got = torch.cat([td.rotate_points(Rt[c:c + chunk], Tt[c:c + chunk],
                                      Xt[c:c + chunk])
                     for c in range(0, n_a, chunk)])
    np.testing.assert_array_equal(got.transpose(2, 3).numpy(), ref)


def _rotations(q: np.ndarray) -> np.ndarray:
    """(N, 3, 3) float32 rotations of (N, 4) unnormalised quaternions."""
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w), 2 * (x * y + z * w),
                     1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], 1).reshape(-1, 3, 3).astype(
                         np.float32)


def test_detect_frame_2d_synthetic():
    """test_pnp.py::test_detect_frame_2d_synthetic through both packages."""
    rng = np.random.default_rng(0)
    R, T = random_pose(rng)
    Xt = rng.uniform(-0.12, 0.12, (60, 3)).astype(np.float32)
    Xt[:, 2] *= 0.05
    cam = Xt @ R.T + T
    uv = cam @ K.T
    uv = (uv[:, :2] / uv[:, 2:3]).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    q = 200
    query_xy = np.zeros((q, 2), np.float32)
    train = np.zeros((q, 1, 3), np.float32)
    query_xy[:60] = uv
    train[:60, 0] = Xt
    query_xy[60:] = rng.uniform(0, 600, (q - 60, 2))
    train[60:, 0] = rng.uniform(-0.12, 0.12, (q - 60, 3))
    flat = (np.zeros((q, 1), np.int32), np.full((q, 1), 20.0, np.float32),
            np.ones((q, 1), bool), train, query_xy)

    cfg = dict(n_hypotheses=256, min_inliers=8, max_instances=2)
    want = jax.jit(functools.partial(
        rd.detect_frame_2d, max_matches=256, cfg=rd.Pnp2dConfig(**cfg)))(
            jax.random.PRNGKey(0), *flat, K, jnp.arange(1))
    want = [_np(x) for x in want]
    got = td.detect_frame_2d(
        ThreefryNoise(prng.prng_key(0), 2, False, "cpu"),
        *map(torch.from_numpy, flat), torch.from_numpy(K), torch.arange(1),
        256, td.Pnp2dConfig(**cfg))
    assert got.accepted[0, 0]
    assert np.linalg.norm(got.T.numpy()[0, 0] - T) < 0.02
    assert int(got.n_inliers[0, 0]) >= 40
    _same_frame(got, want, searched=[0])
