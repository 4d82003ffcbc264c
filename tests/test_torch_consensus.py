"""The 2D path's reprojection consensus (kernel R1's plain versions in
tod_tpu_torch/geometry/detection2d.py) against the reference's own lines
(tod_tpu/geometry/detection2d.py:116-190), compiled by ``jax.jit`` on the
CPU, bit for bit.

The reference's expressions are copied here as its round runs them: the
objects mapped 8 at a time (``jax.lax.map``), ``count`` vmapped over the
hypotheses and their 8 P3P candidates, ``project`` from
``tod_tpu.geometry.pnp``. The inputs are ``chip_smoke.consensus_cases``'
(phase 3l's on the card) at A = 4 objects, H = 48 poses, M = 40 matches:
poses near each object's view and anywhere in front, a NaN pose, points
at camera z = +-1e-9, 1e-6 and their neighbours, 0 and behind the camera
under the identity pose, invalid matches, and an object with no valid
match.

Contracts, each exact (NaN where NaN): the counts of every pose; the
stable top 8, the model normal, the mirrors and the 16 poses' inliers
of the selection; the inlier masks and the truncated SSE of the 16
poses; ``ops/reduce.py tree_sum`` against the compiled ``sum``; the CPU
wrappers are the plain versions and launch nothing.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from tod_tpu.geometry.pnp import project
from tod_tpu_torch.geometry import detection2d as td
from tod_tpu_torch.geometry.adjacency import ObjectMatches
from tod_tpu_torch.ops.reduce import tree_sum

torch.set_num_threads(1)

N_A, N_H, N_M = 4, 48, 40
THR2 = 16.0                     # pixel_error 4 px, squared


def _cases(seed=5, shape=(N_A, N_H, N_M)):
    return chip_smoke.consensus_cases(np.random.default_rng(seed), *shape)


def _ref_object(K, args):
    """The reference's consensus for one object (detection2d.py:116-190):
    ``R`` (B, 8, 3, 3) and ``T`` (B, 8, 3) candidates, ``pose_ok`` (B, 8)
    in place of ``sols.valid & samp_ok``."""
    R, T, X, xy, valid, pose_ok = args
    thr2 = THR2

    def count(R, T):
        uv, front = project(R, T, K, X)
        err2 = ((uv - xy) ** 2).sum(-1)
        return valid & front & (err2 < thr2)

    inl = jax.vmap(jax.vmap(count))(R, T)
    inl = inl & pose_ok[..., None]
    flat = inl.sum(-1).reshape(-1)
    _, top = jax.lax.top_k(flat, td.N_REFINE)
    r_top = R.reshape(-1, 3, 3)[top]
    t_top = T.reshape(-1, 3)[top]
    inl_top = inl.reshape(-1, X.shape[0])[top]

    def trunc_sse(R, T):
        uv, front = project(R, T, K, X)
        err2 = ((uv - xy) ** 2).sum(-1)
        err2 = jnp.where(front, err2, 4.0 * thr2)
        return jnp.where(valid, jnp.minimum(err2, 4.0 * thr2), 0.0).sum()

    ctr = jnp.where(valid[:, None], X, 0.0)
    nvalid = jnp.maximum(valid.sum(), 1)
    mean = ctr.sum(0) / nvalid
    cov = ((ctr - mean) * valid[:, None]).T @ (ctr - mean)
    _, evecs = jnp.linalg.eigh(cov)
    n_model = evecs[:, 0]

    def mirror(r0, t0):
        n_c = r0 @ n_model
        v = t0 / jnp.maximum(jnp.linalg.norm(t0), 1e-9)
        n_ref = 2.0 * jnp.dot(n_c, v) * v - n_c
        axis = jnp.cross(n_c, n_ref)
        s = jnp.linalg.norm(axis)
        c = jnp.clip(jnp.dot(n_c, n_ref), -1.0, 1.0)
        a = axis / jnp.maximum(s, 1e-9)
        ax = jnp.array([[0.0, -a[2], a[1]],
                        [a[2], 0.0, -a[0]],
                        [-a[1], a[0], 0.0]])
        ang = jnp.arctan2(s, c)
        Q = (jnp.eye(3) + jnp.sin(ang) * ax
             + (1.0 - jnp.cos(ang)) * (ax @ ax))
        Q = jnp.where(s > 1e-6, Q, jnp.eye(3))
        return Q @ r0, t0

    r_mir, t_mir = jax.vmap(mirror)(r_top, t_top)
    inl_mir = jax.vmap(count)(r_mir, t_mir) & (flat[top] >= 3)[:, None]
    r_all = jnp.concatenate([r_top, r_mir])
    t_all = jnp.concatenate([t_top, t_mir])
    return dict(counts=flat, top=top, top_n=flat[top], R=r_all, T=t_all,
                inliers=jnp.concatenate([inl_top, inl_mir]), normal=n_model,
                masks=jax.vmap(count)(r_all, t_all),
                sse=jax.vmap(trunc_sse)(r_all, t_all))


@functools.lru_cache(maxsize=None)
def _reference(seed=5):
    R, T, K, X, xy, valid, ok = (x.numpy() for x in _cases(seed))
    per = functools.partial(_ref_object, K)
    out = jax.jit(lambda *a: jax.lax.map(per, a, batch_size=8))(
        R.reshape(N_A, N_H // 8, 8, 3, 3), T.reshape(N_A, N_H // 8, 8, 3),
        X, xy, valid, ok.reshape(N_A, N_H // 8, 8))
    return {k: np.asarray(v) for k, v in out.items()}


def _port(R, T, K, X, xy, valid, ok):
    m = ObjectMatches(query_pts=torch.zeros_like(X), train_pts=X,
                      query_idx=torch.zeros(valid.shape, dtype=torch.int64),
                      query_xy=xy, valid=valid)
    counts = td.consensus_counts(R, T, K, m, valid, ok, THR2)
    sel = td.consensus_select(counts, R, T, K, m, valid, ok, THR2)
    masks, n_masks = td.consensus_masks(sel.R, sel.T, K, m, valid, THR2)
    sse = td.consensus_sse(sel.R, sel.T, K, m, valid, THR2)
    return counts, sel, masks, n_masks, sse


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      want[~nan].view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def both():
    return _reference(), _port(*_cases())


def test_cases_cover_the_edges():
    """The inputs hold what the docstring says: inliers and outliers, a
    NaN pose, points at the z edges and behind the camera, invalid
    matches, an object with none."""
    R, T, K, X, xy, valid, ok = _cases()
    want = _reference()
    assert want["counts"].max() > 10 and (want["counts"] == 0).any()
    assert torch.isnan(R).any() and not valid[2].any() and not ok.all()
    z = X[0, :, 2].numpy()
    for edge in (1e-9, -1e-9, 1e-6, 0.0):
        assert (z == np.float32(edge)).any()
    assert (z < 0).any() and (~valid.numpy()).any()


def test_counts_bit_for_bit(both):
    want, (counts, *_) = both
    assert counts.dtype == torch.int32
    _same(counts, want["counts"].astype(np.int32), "counts")


@pytest.mark.parametrize("field", ["top_n", "top", "normal", "R", "T",
                                   "inliers"])
def test_selection_bit_for_bit(both, field):
    """The stable top 8 (ties to the lower index), the model normal
    (eigh's column 0 of the compiled covariance), the seeds and M1's
    mirrors of them, and the 16 poses' inliers (a seed's where its pose
    is valid, a mirror's where its seed counts 3 or more)."""
    want, (_, sel, *_) = both
    w = want[field]
    if field == "top_n":
        w = w.astype(np.int32)
    _same(getattr(sel, field), w, field)
    if field == "inliers":
        _same(sel.counts, w.sum(-1).astype(np.int32), "counts of the 16")


def test_masks_and_sse_bit_for_bit(both):
    """The refinement's recounts (``count`` of the 16 poses, no pose mask)
    and ``trunc_sse`` (the terms summed in the compiled reduce's order)."""
    want, (_, _, masks, n_masks, sse) = both
    _same(masks, want["masks"], "masks")
    _same(n_masks, want["masks"].sum(-1).astype(np.int32), "mask counts")
    _same(sse, want["sse"], "sse")


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 40, 63, 64, 65, 100, 777,
                               1024, 1025, 1031, 5000])
def test_tree_sum_is_the_compiled_sum(n):
    """``tree_sum`` against ``jax.jit`` of ``x.sum()`` over n terms, vmapped
    over rows (windows of 32 from +0 past 32 terms, padded in front by
    half the padding, then the windows' sums the same way)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(6, n)) * rng.uniform(0, 1e3, (6, n))).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda r: r.sum()))(x))
    _same(tree_sum(torch.from_numpy(x), 1), want, f"sum of {n}")


def test_cpu_wrappers_are_the_plain_versions():
    """On CPU tensors each wrapper is its plain version, bit for bit, and
    launches nothing; a float64 pose or a pose on another device than the
    points is refused."""
    R, T, K, X, xy, valid, ok = _cases(seed=9, shape=(3, 16, 50))
    m = ObjectMatches(query_pts=torch.zeros_like(X), train_pts=X,
                      query_idx=torch.zeros(valid.shape, dtype=torch.int64),
                      query_xy=xy, valid=valid)
    before = td.consensus_kernel.launches
    counts = td.consensus_counts(R, T, K, m, valid, ok, THR2)
    assert torch.equal(counts, td.consensus_counts_torch(R, T, K, m, valid,
                                                         ok, THR2))
    sel = td.consensus_select(counts, R, T, K, m, valid, ok, THR2)
    want = td.consensus_select_torch(counts, R, T, K, m, valid, ok, THR2)
    for a, b in zip(sel, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
    masks, _ = td.consensus_masks(sel.R, sel.T, K, m, valid, THR2)
    assert torch.equal(masks, td.count_inliers(sel.R, sel.T, K, m, valid,
                                               THR2))
    sse = td.consensus_sse(sel.R, sel.T, K, m, valid, THR2)
    assert torch.equal(sse.view(torch.int32), td.truncated_sse(
        sel.R, sel.T, K, m, valid, THR2).view(torch.int32))
    assert td.consensus_kernel.launches == before
    with pytest.raises(ValueError):
        td.consensus_counts(R.double(), T, K, m, valid, ok, THR2)
    with pytest.raises(ValueError):
        td.consensus_sse(R.to("meta"), T, K, m, valid, THR2)
