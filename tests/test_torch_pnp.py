"""The P3P solver and Gauss-Newton refinement (tod_tpu_torch/geometry/pnp.py)
against ``jax.jit`` of the reference (tod_tpu/geometry/pnp.py) on the CPU.

Contracts (f32; the compiled reference fuses multiply-adds and its
transcendentals differ from torch's by an ulp, and the port emulates
neither, so every stage here is a float stage):

- ``solve_quartic`` on seeded coefficient batches with 0, 2 and 4 real
  roots (test_pnp.py's generator): the same validity mask, roots within
  ``ROOT_ATOL``;
- ``p3p`` on seeded well-posed samples (test_pnp.py's generator): the
  quartic is ill-conditioned in f32 (the reference: "f32 drifts ~cm"), so a
  rounding difference can move a candidate to another slot or past the
  residual gate (ROADMAP queue C). Held per candidate SET: the ground truth
  recovered within 1 mm on at least 30 of 40 samples by each, on the same
  sample in 85 % of them, and each package's valid candidates found in
  the other's (within ``P3P_T_ATOL``) for at least ``P3P_SHARED`` of them;
- ``project``: pixels within ``UV_ATOL``, the in-front mask exactly;
- ``gauss_newton_pose``: poses within ``GN_ATOL``; its analytic Jacobian
  against ``torch.func.jacfwd`` of the reference's residual (the
  ``rot_smooth`` update) within ``JAC_RTOL``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.geometry import pnp as rp
from tod_tpu_torch.geometry import pnp as tp

torch.set_num_threads(1)

K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float32)
ROOT_ATOL = 1e-3        # roots in [-3, 3]; near-double roots lose ~sqrt(eps)
P3P_T_ATOL = 1e-3       # meters: one candidate "found" in the other set
P3P_SHARED = 0.9        # share of valid candidates found in the other set
UV_ATOL = 1e-4          # pixels
GN_ATOL = 1e-5          # rotation entries and meters
JAC_RTOL = 1e-5         # of the Jacobian's largest entry


def rodrigues_np(ax):
    th = np.linalg.norm(ax)
    k = ax / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def random_pose(rng, z=0.9):
    """test_pnp.py's pose generator (without cv2)."""
    R = rodrigues_np(rng.uniform(-0.4, 0.4, 3))
    T = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15), z])
    return R.astype(np.float32), T.astype(np.float32)


def bearings_np(uv):
    b = np.concatenate([(uv - K[:2, 2]) / np.diag(K)[:2],
                        np.ones((len(uv), 1))], 1)
    return (b / np.linalg.norm(b, axis=1, keepdims=True)).astype(np.float32)


def p3p_samples(rng, n):
    """``n`` well-posed P3P samples (test_pnp.py's): bearings, points and
    the true translations."""
    bear, pts, ts = [], [], []
    for _ in range(n):
        R, T = random_pose(rng)
        X = rng.uniform(-0.12, 0.12, (3, 3)).astype(np.float32)
        X[:, 2] *= 0.1
        uv = (X @ R.T + T) @ K.T
        bear.append(bearings_np(uv[:, :2] / uv[:, 2:3]))
        pts.append(X)
        ts.append(T)
    return np.stack(bear), np.stack(pts), np.stack(ts)


@pytest.mark.parametrize("n_real", [0, 2, 4])
def test_solve_quartic_matches_reference(n_real):
    rng = np.random.default_rng(n_real)
    coeffs = []
    for _ in range(64):
        roots = np.sort(rng.uniform(-3, 3, n_real))
        cplx = [complex(1, 1), complex(1, -1)] * ((4 - n_real) // 2)
        coeffs.append(np.real(np.poly(list(roots) + cplx)))
    c = np.asarray(coeffs, np.float32)
    r_ref, v_ref = jax.jit(rp.solve_quartic)(*[jnp.asarray(c[:, i])
                                              for i in range(5)])
    r, v = tp.solve_quartic(*[torch.from_numpy(c[:, i]) for i in range(5)])
    r_ref, v_ref = np.asarray(r_ref), np.asarray(v_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)
    np.testing.assert_allclose(np.where(v_ref, r.numpy(), 0),
                               np.where(v_ref, r_ref, 0), atol=ROOT_ATOL)
    assert v_ref.sum(-1).min() >= n_real


def _found_in(t_a, v_a, t_b, v_b):
    """(found, total): valid candidates of a with a valid candidate of b
    within P3P_T_ATOL, over the samples."""
    gap = np.linalg.norm(t_a[:, :, None] - t_b[:, None, :], axis=-1)
    hit = ((gap < P3P_T_ATOL) & v_b[:, None, :]).any(-1)
    return int((hit & v_a).sum()), int(v_a.sum())


def test_p3p_matches_reference():
    rng = np.random.default_rng(0)
    bear, pts, t_true = p3p_samples(rng, 40)
    ref = jax.jit(jax.vmap(rp.p3p))(jnp.asarray(bear), jnp.asarray(pts))
    got = tp.p3p(torch.from_numpy(bear), torch.from_numpy(pts))
    t_ref, v_ref = np.asarray(ref.T), np.asarray(ref.valid)
    t_got, v_got = got.T.numpy(), got.valid.numpy()
    assert got.R.shape == (40, 8, 3, 3) and v_got.shape == (40, 8)

    def recovered(t, v):
        gap = np.linalg.norm(t - t_true[:, None], axis=-1)
        return (np.where(v, gap, np.inf).min(-1) < 1e-3)

    # each recovers the truth on at least test_pnp.py's 30 of 40, mostly
    # on the same samples (an f32 miss is the sample's conditioning)
    hits_got, hits_ref = recovered(t_got, v_got), recovered(t_ref, v_ref)
    assert min(hits_got.sum(), hits_ref.sum()) >= 30
    assert (hits_got == hits_ref).mean() >= 0.85
    for a, b in (((t_got, v_got), (t_ref, v_ref)),
                 ((t_ref, v_ref), (t_got, v_got))):
        hit, total = _found_in(*a, *b)
        assert hit >= P3P_SHARED * total, (hit, total)
    # where a slot agrees, its rotation agrees too
    same = v_ref & v_got & (np.linalg.norm(t_ref - t_got, axis=-1)
                            < P3P_T_ATOL)
    assert same.sum() >= v_ref.sum() // 2
    np.testing.assert_allclose(got.R.numpy()[same], np.asarray(ref.R)[same],
                               atol=1e-2)


def test_p3p_batches_over_leading_axes():
    """(objects, hypotheses) leading axes give each sample's own result."""
    rng = np.random.default_rng(1)
    bear, pts, _ = p3p_samples(rng, 6)
    flat = tp.p3p(torch.from_numpy(bear), torch.from_numpy(pts))
    nested = tp.p3p(torch.from_numpy(bear).reshape(2, 3, 3, 3),
                    torch.from_numpy(pts).reshape(2, 3, 3, 3))
    for a, b in zip(flat, nested):
        assert torch.equal(a, b.flatten(0, 1))


def _poses(rng, n):
    R = np.stack([rodrigues_np(rng.uniform(-0.4, 0.4, 3)) for _ in range(n)])
    T = rng.uniform(-0.1, 0.1, (n, 3)) + [0, 0, 0.8]
    return R.astype(np.float32), T.astype(np.float32)


def test_project_matches_reference():
    rng = np.random.default_rng(2)
    R, T = _poses(rng, 5)
    X = rng.uniform(-0.12, 0.12, (5, 60, 3)).astype(np.float32)
    X[0, :5, 2] = -2.0                           # behind the camera
    uv_ref, front_ref = jax.jit(jax.vmap(rp.project, (0, 0, None, 0)))(
        R, T, K, X)
    uv, front = tp.project(torch.from_numpy(R), torch.from_numpy(T),
                           torch.from_numpy(K), torch.from_numpy(X))
    np.testing.assert_array_equal(front.numpy(), np.asarray(front_ref))
    assert not front.numpy()[0, :5].any()
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_ref), atol=UV_ATOL)


@pytest.fixture(scope="module")
def gn_case():
    """Five perturbed poses, 60 noisy observations each, a fifth of the
    rows weighted out."""
    rng = np.random.default_rng(3)
    R, T = _poses(rng, 5)
    X = rng.uniform(-0.12, 0.12, (5, 60, 3)).astype(np.float32)
    uv, _ = jax.vmap(rp.project, (0, 0, None, 0))(R, T, K, X)
    uv = np.asarray(uv) + rng.normal(0, 0.3, (5, 60, 2)).astype(np.float32)
    R0 = (R @ np.stack([rodrigues_np(rng.uniform(-0.03, 0.03, 3))
                        for _ in range(5)])).astype(np.float32)
    T0 = (T + rng.uniform(-0.01, 0.01, (5, 3))).astype(np.float32)
    w = (rng.uniform(0, 1, (5, 60)) > 0.2).astype(np.float32)
    return R0, T0, X, uv, w, T


def test_gauss_newton_pose_matches_reference(gn_case):
    R0, T0, X, uv, w, T_true = gn_case
    r_ref, t_ref = jax.jit(jax.vmap(rp.gauss_newton_pose,
                                    (0, 0, None, 0, 0, 0)))(R0, T0, K, X, uv,
                                                            w)
    r, t = tp.gauss_newton_pose(*(torch.from_numpy(a) for a in (
        R0, T0)), torch.from_numpy(K), *(torch.from_numpy(a) for a in (
            X, uv, w)))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=GN_ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=GN_ATOL)
    assert np.abs(t.numpy() - T_true).max() < 2e-3      # it converged


def _reference_residual(delta, R, T, K_, X, uv, w):
    """The reference's residual of ``gauss_newton_pose`` (pnp.py:258-266)
    in torch: the ``rot_smooth`` update of (R, T) by ``delta``, projected,
    weighted, flattened."""
    kx = tp.skew(delta[:3])
    dR = torch.eye(3, dtype=delta.dtype) + kx + 0.5 * (kx @ kx)
    uvp, _ = tp.project(dR @ R, T + delta[3:], K_, X)
    return ((uvp - uv) * w[:, None]).reshape(-1)


def test_analytic_jacobian_matches_jacfwd(gn_case):
    R0, T0, X, uv, w, _ = gn_case
    K_ = torch.from_numpy(K)
    for i in range(len(R0)):
        args = [torch.from_numpy(a[i]) for a in (R0, T0)] + [K_] + [
            torch.from_numpy(a[i]) for a in (X, uv, w)]
        want = torch.func.jacfwd(_reference_residual)(torch.zeros(6), *args)
        r, J = tp.reprojection_jacobian(*args)
        np.testing.assert_allclose(
            J.reshape(-1, 6).numpy(), want.numpy(),
            atol=JAC_RTOL * float(want.abs().max()))
        np.testing.assert_allclose(
            r.reshape(-1).numpy(),
            _reference_residual(torch.zeros(6), *args).numpy(), atol=1e-4)
