"""Parity of the port's geometry (tod_tpu_torch.geometry) with
tod_tpu.geometry.

The RANSAC stages draw Gumbel noise; the reference draws it from
``jax.random`` inside its samplers, the port takes it as an argument. Each
test here hands the port the reference's own draws (torch_parity), so both
sample the same triples and must count the same inliers. Tolerances are
stated at each assert with their reason.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.geometry import adjacency as jadj
from tod_tpu.geometry import detection as jdet
from tod_tpu.geometry import ransac as jran
from tod_tpu.geometry import transforms as jtr
from tod_tpu_torch.geometry import adjacency as tadj
from tod_tpu_torch.geometry import detection as tdet
from tod_tpu_torch.geometry import ransac as tran
from tod_tpu_torch.geometry import transforms as ttr
from torch_parity import JaxReplayNoise, gumbel_batch, gumbel_triple

torch.set_num_threads(1)

SIGMA = 0.01


def _t(x):
    return torch.from_numpy(np.array(x))


def _rot(rng):
    q = rng.normal(size=4)
    return np.asarray(jtr.quat_to_mat(jnp.asarray(q / np.linalg.norm(q),
                                                  jnp.float32)))


def _matches(seed, m=64, n_true=36, n_junk=20, dup=3):
    """One object's store: ``n_true`` matches consistent with a pose
    (1 mm noise), ``n_junk`` random ones, invalid slots after them, and
    ``dup`` matches that share a keypoint with an earlier one."""
    rng = np.random.default_rng(seed)
    R, T = _rot(rng), np.array([0.05, -0.02, 0.8])
    t = np.zeros((m, 3))
    q = np.zeros((m, 3))
    n = n_true + n_junk
    t[:n] = rng.uniform(-0.1, 0.1, (n, 3))
    q[:n_true] = (t[:n_true] @ R.T + T + rng.normal(0, 0.001, (n_true, 3)))
    q[n_true:n] = T + rng.uniform(-0.12, 0.12, (n_junk, 3))
    xy = q[:, :2] / np.maximum(q[:, 2:], 1e-3) * 570.0 + [320.0, 240.0]
    idx = np.arange(m)
    idx[n - dup:n] = idx[:dup]
    valid = np.arange(m) < n
    idx[~valid] = -1
    f = np.float32
    return dict(query_pts=q.astype(f), train_pts=t.astype(f),
                query_idx=idx.astype(np.int32), query_xy=xy.astype(f),
                valid=valid), R, T


def _jm(d):
    return jadj.ObjectMatches(**{k: jnp.asarray(v) for k, v in d.items()})


def _tm(ds):
    """Batched port store from a list of per-object dicts."""
    return tadj.ObjectMatches(**{
        k: _t(np.stack([d[k] for d in ds])) for k in ds[0]})


def test_horn_kabsch_and_transforms_match():
    rng = np.random.default_rng(0)
    b, n = 32, 12
    q = rng.uniform(-0.2, 0.2, (b, n, 3)).astype(np.float32)
    q[0, :, 2] = 0.0                                  # planar: rank-2 S
    R = np.stack([_rot(rng) for _ in range(b)])
    T = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    t = (np.einsum("bij,bnj->bni", R, q) + T[:, None]
         + rng.normal(0, 1e-3, (b, n, 3))).astype(np.float32)
    w = (rng.random((b, n)) < 0.8).astype(np.float32)
    w[1] = 0.0
    w[1, :2] = 1.0                                    # < 3 weights: not ok
    f_j = jtr.kabsch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(w))
    f_t = ttr.kabsch(_t(q), _t(t), _t(w))
    np.testing.assert_array_equal(f_t.ok.numpy(), np.asarray(f_j.ok))
    assert not f_t.ok[1] and f_t.ok[0]
    # the same formula in the same order; the 3x3 correlation contracts in
    # another order, so a few f32 ulps of the unit-scale rotation. Fits
    # that are not ok (here: 2 weights, a rank-1 correlation whose
    # eigenvector is ill-posed) are discarded by every caller, so only ok
    # fits are compared.
    ok = f_t.ok.numpy()
    np.testing.assert_allclose(f_t.R.numpy()[ok], np.asarray(f_j.R)[ok],
                               atol=2e-6)
    np.testing.assert_allclose(f_t.T.numpy()[ok], np.asarray(f_j.T)[ok],
                               atol=2e-6)
    np.testing.assert_allclose(f_t.R.numpy()[ok], R[ok], atol=1e-2)
    h = rng.normal(size=(8, 3, 3)).astype(np.float32)
    p_j, ok_j = jtr.polar_rotation(jnp.asarray(h))
    p_t, ok_t = ttr.polar_rotation(_t(h))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=2e-6)
    a_j = jtr.apply_rt(jnp.asarray(R), jnp.asarray(T), jnp.asarray(q))
    a_t = ttr.apply_rt(_t(R), _t(T), _t(q))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
    i_j = jtr.invert_pose(jnp.asarray(R), jnp.asarray(T))
    i_t = ttr.invert_pose(_t(R), _t(T))
    for a, b_ in zip(i_t, i_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-6)


def _near_threshold(d, span):
    """Pairs whose reference quantities sit within 1e-6 of a threshold of
    fill_adjacency (where f32 summation order may flip the edge)."""
    q, t, xy = d["query_pts"], d["train_pts"], d["query_xy"]
    dq2 = ((q[:, None] - q[None]) ** 2).sum(-1)
    cons = np.abs(np.sqrt(((t[:, None] - t[None]) ** 2).sum(-1))
                  - np.sqrt(dq2))
    dpix2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    eps = 1e-6
    return ((np.abs(dq2 - (span + 2 * SIGMA) ** 2) < eps)
            | (np.abs(cons - 4 * SIGMA) < eps)
            | (np.abs(cons - 2 * SIGMA) < eps)
            | (np.abs(dpix2 - 400.0) < eps * 400.0))


def test_fill_adjacency_and_pruning_match():
    stores = [_matches(s)[0] for s in range(4)]
    spans = np.array([0.3, 0.25, 0.05, 0.3], np.float32)   # 0.05 gates hard
    g_t = tadj.fill_adjacency(_tm(stores), _t(spans), SIGMA)
    flipped = 0
    for a, d in enumerate(stores):
        g_j = jadj.fill_adjacency(_jm(d), jnp.asarray(spans[a]), SIGMA)
        near = _near_threshold(d, spans[a])
        for name in ("physical", "sample"):
            diff = g_t._asdict()[name][a].numpy() != np.asarray(
                getattr(g_j, name))
            assert not (diff & ~near).any(), name
            flipped += int(diff.sum())
        np.testing.assert_array_equal(g_t.valid[a].numpy(),
                                      np.asarray(g_j.valid))
        assert g_t.sample[a].any()
    # edges equal except pairs within 1e-6 of a threshold; none flips here
    assert flipped == 0
    d = stores[0]
    inl = np.zeros(64, bool)
    inl[[0, 5, 9]] = True
    v_j = jadj.invalidate_query_indices(
        jnp.asarray(d["valid"]),
        jadj.fill_adjacency(_jm(d), jnp.asarray(0.3), SIGMA).sample,
        jnp.asarray(d["query_idx"]), jnp.asarray(inl))
    v_t = tadj.invalidate_query_indices(
        _t(d["valid"])[None], g_t.sample[:1], _t(d["query_idx"])[None],
        _t(inl)[None])
    np.testing.assert_array_equal(v_t[0].numpy(), np.asarray(v_j))
    mask = d["valid"].copy()
    n_j = jadj.count_unique_query_indices(jnp.asarray(d["query_idx"]),
                                          jnp.asarray(mask))
    n_t = tadj.count_unique_query_indices(_t(d["query_idx"])[None],
                                          _t(mask)[None])
    assert int(n_t[0]) == int(n_j) == int(mask.sum()) - 3


def _graphs(seed, span=0.3):
    d = _matches(seed)[0]
    return d, jadj.fill_adjacency(_jm(d), jnp.asarray(span), SIGMA)


def test_sample_triples_and_presence_with_injected_noise():
    key = jax.random.PRNGKey(11)
    d, g = _graphs(1)
    n = 96
    logw = jran.consistency_log_weights(g.sample, g.valid)
    (v1, v2, v3), ok = jran.sample_triples(key, g.sample, g.valid, n, logw)
    logw_t = tran.consistency_log_weights(_t(g.sample)[None],
                                          _t(g.valid)[None])
    # 3-path counts are integers below 2^24: exact in f32, then XLA's log
    # of 1 + count, as the reference's log1p compiles
    np.testing.assert_array_equal(logw_t[0].numpy().view(np.int32),
                                  np.asarray(logw).view(np.int32))
    noise = torch.from_numpy(gumbel_triple(key, n, 64))[None]
    (w1, w2, w3), ok_t = tran.sample_triples(noise, _t(g.sample)[None],
                                             _t(g.valid)[None], logw_t)
    for a, b in ((w1, v1), (w2, v2), (w3, v3), (ok_t, ok)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    assert ok_t.any()
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    seeds = (1, 2, 3)
    jg = [_graphs(s) for s in seeds]
    s_j = [int(jran.presence_score(k, _jm(d_), g_, 128, SIGMA))
           for k, (d_, g_) in zip(keys, jg)]
    tg = tadj.AdjacencyGraphs(*(torch.stack([_t(getattr(g_, f))
                                             for _, g_ in jg])
                                for f in ("physical", "sample", "valid")))
    s_t = tran.presence_score(gumbel_batch(keys, 128, 64),
                              _tm([d_ for d_, _ in jg]), tg, SIGMA)
    assert s_t.tolist() == s_j and min(s_j) >= 8


def _ransac_cfg(**kw):
    base = dict(n_hypotheses=256, min_inliers=8, sensor_error=SIGMA,
                max_instances=3, continuation_hypotheses=64,
                tight_final_fit=True)
    base.update(kw)
    return jran.RansacConfig(**base), tran.RansacConfig(**base)


def _pose_close(r_t, t_t, r_j, t_j):
    # refits in f32 over the same inliers; Horn's Newton iteration and the
    # weighted sums round alike up to summation order
    np.testing.assert_allclose(r_t, r_j, atol=1e-5)
    np.testing.assert_allclose(t_t, t_j, atol=1e-5)


@pytest.mark.parametrize("tight", [True, False])
def test_ransac_round_with_injected_noise(tight):
    cfg_j, cfg_t = _ransac_cfg(tight_final_fit=tight)
    key = jax.random.PRNGKey(21)
    d, g = _graphs(2)
    rnd_j = jran.ransac_round(key, _jm(d), g, g.valid, cfg_j)
    tg = tadj.AdjacencyGraphs(_t(g.physical)[None], _t(g.sample)[None],
                              _t(g.valid)[None])
    noise = torch.from_numpy(gumbel_triple(key, 256, 64))[None]
    rnd_t = tran.ransac_round(noise, _tm([d]), tg, tg.valid, cfg_t)
    assert bool(rnd_t.found[0]) == bool(rnd_j.found)
    np.testing.assert_array_equal(rnd_t.inliers[0].numpy(),
                                  np.asarray(rnd_j.inliers))
    assert int(rnd_t.n_unique[0]) == int(rnd_j.n_unique) >= 30
    assert int(rnd_t.clique_size[0]) == int(rnd_j.clique_size)
    _pose_close(rnd_t.R[0].numpy(), rnd_t.T[0].numpy(), np.asarray(rnd_j.R),
                np.asarray(rnd_j.T))
    np.testing.assert_allclose(float(rnd_t.rms_residual[0]),
                               float(rnd_j.rms_residual), rtol=1e-4)


def _frame_matches(seed, n_q=300, n_obj=6):
    """Per-(query, object) matcher outputs of a frame: integer distances
    (so ties are common), with object 2 truly present."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(20, 90, (n_q, n_obj)).astype(np.float32)
    rows = rng.integers(0, 200, (n_q, n_obj)).astype(np.int32)
    obj_start = (np.arange(n_obj) * 256).astype(np.int32)
    points = rng.uniform(-0.1, 0.1, (n_obj * 256, 3)).astype(np.float32)
    R, T = _rot(rng), np.array([0.0, 0.0, 0.8])
    q_pts = (T + rng.uniform(-0.12, 0.12, (n_q, 3))).astype(np.float32)
    true = rng.choice(n_q, 80, replace=False)
    dist[true, 2] = rng.integers(5, 25, 80)
    q_pts[true] = (points[obj_start[2] + rows[true, 2]] @ R.T + T
                   + rng.normal(0, 5e-4, (80, 3))).astype(np.float32)
    xy = (q_pts[:, :2] / q_pts[:, 2:] * 570.0 + [320.0, 240.0]
          ).astype(np.float32)
    q_valid = rng.random(n_q) < 0.95
    spans = np.full(n_obj, 0.3, np.float32)
    return dist, rows, q_valid, q_pts, xy, points, obj_start, spans


def test_stores_prescreen_and_activation_match():
    dist, rows, q_valid, q_pts, xy, points, obj_start, _ = _frame_matches(5)
    # even O: the median is the mean of the two middle values, not
    # torch.median's lower one
    level_j = jnp.median(jnp.asarray(dist), axis=1)
    level_t = tdet.median_level(_t(dist))
    np.testing.assert_array_equal(level_t.numpy(), np.asarray(level_j))
    assert (level_t.numpy() != torch.median(_t(dist), 1).values.numpy()).any()
    sel = np.array([2, 0, -1, 5], np.int32)
    j = jdet.build_object_stores(
        jnp.asarray(dist), jnp.asarray(rows), jnp.asarray(q_valid),
        jnp.asarray(q_pts), jnp.asarray(xy), jnp.asarray(points),
        jnp.asarray(obj_start), jnp.asarray(sel), 96, 50.0, level_j)
    t = tdet.build_object_stores(
        _t(dist), _t(rows), _t(q_valid), _t(q_pts), _t(xy), _t(points),
        _t(obj_start), _t(sel), 96, 50.0, level_t)
    for name in jadj.ObjectMatches._fields:   # gathers of equal inputs
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    pre_j = jdet.prescreen_scores(jnp.asarray(dist), level_j,
                                  jnp.asarray(q_valid), 50.0, 64)
    pre_t = tdet.prescreen_scores(_t(dist), level_t, _t(q_valid), 50.0, 64)
    # sums of multiples of 1/8 below 2^20: exact in any order
    np.testing.assert_array_equal(pre_t.numpy(), np.asarray(pre_j))
    act_cfg = jdet.ActivationConfig(min_score=4)
    scores = np.array([9, 4, 30, 9, 3, 9], np.int32)     # ties at 9
    a_j = jdet.activation_cut(jnp.asarray(scores), None, 4, act_cfg)
    a_t = tdet.activation_cut(_t(scores), 4, tdet.ActivationConfig(
        min_score=4))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    a_j = jdet.activation_cut(jnp.asarray(scores), None, 6, act_cfg)
    a_t = tdet.activation_cut(_t(scores), 6, tdet.ActivationConfig(
        min_score=4))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert a_t.tolist() == [2, 0, 3, 5, 1, -1]


def test_detect_frame_segmented_with_injected_noise():
    """Tier 1 on the prescreened objects, then tier 2's three instance
    rounds (detect_objects -> detect_object_instances), all on the
    reference's draws."""
    dist, rows, q_valid, q_pts, xy, points, obj_start, spans = \
        _frame_matches(6)
    cfg_j, cfg_t = _ransac_cfg()
    guess_j = jdet.GuessConfig(ransac=cfg_j, max_matches_per_object=128,
                               max_active_objects=3)
    guess_t = tdet.GuessConfig(ransac=cfg_t, max_matches_per_object=128,
                               max_active_objects=3)
    act = dict(m_cap=96, n_hypotheses=64, prescreen=4)
    key = jax.random.PRNGKey(41)
    args = (dist, rows, q_valid, q_pts, xy, points, obj_start, spans)
    s_j, det_j = jdet.detect_frame_segmented(
        key, *(jnp.asarray(a) for a in args), guess_j,
        jdet.ActivationConfig(**act), 50.0)
    s_t, det_t = tdet.detect_frame_segmented(
        JaxReplayNoise(key, 3), *(_t(a) for a in args), guess_t,
        tdet.ActivationConfig(**act), 50.0)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(det_t.accepted.numpy(),
                                  np.asarray(det_j.accepted))
    np.testing.assert_array_equal(det_t.n_inliers.numpy(),
                                  np.asarray(det_j.n_inliers))
    np.testing.assert_array_equal(det_t.clique_size.numpy(),
                                  np.asarray(det_j.clique_size))
    _pose_close(det_t.R.numpy(), det_t.T.numpy(), np.asarray(det_j.R),
                np.asarray(det_j.T))
    assert det_t.accepted[2, 0] and det_t.accepted.sum() >= 1


def test_config_dataclasses_mirror_reference():
    for j, t in ((jran.RansacConfig, tran.RansacConfig),
                 (jdet.ActivationConfig, tdet.ActivationConfig)):
        assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    gj = dataclasses.asdict(jdet.GuessConfig())
    gt = dataclasses.asdict(tdet.GuessConfig())
    assert gj == gt
