"""The P3P solver and Gauss-Newton refinement (tod_tpu_torch/geometry/pnp.py)
against ``jax.jit`` of the reference (tod_tpu/geometry/pnp.py) on the CPU.

Contracts (f32; the port's P3P and refinement round alike on the CPU and
the card: the C library's ``powf``, ``cosf``, ``sincosf`` and ``atan2f``
transcribed, XLA's ``arccos`` form, correctly rounded roots, fixed sums
and LAPACK's LU as the reference host runs it, bit for bit
(``geometry/lapack.py``). The compiled reference also contracts
multiply-adds inside its fusions; the port transcribes the contractions
of P3P from the side lengths through Ferrari's solution, the polishes,
the first distances and their Newton steps (read off by
``tools/fit_p3p_order.py`` and ``tools/fit_p3p_fusions.py``): the
distances are the reference's bit for bit, held by
``test_p3p_roots_are_the_compiled_fusions`` and
``test_p3p_parts_from_the_reference_at_the_coefficients``, which names
where the bits part, the Horn fit (ROADMAP queue C); the candidate poses
and the refinement are float stages here):

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

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tod_tpu.geometry import pnp as rp
from tod_tpu_torch.geometry import pnp as tp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(1)

K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float32)
ROOT_ATOL = 1e-3        # roots in [-3, 3]; near-double roots lose ~sqrt(eps)
P3P_T_ATOL = 1e-3       # meters: one candidate "found" in the other set
P3P_SHARED = 0.93       # share of valid candidates found in the other set
UV_ATOL = 1e-4          # pixels
GN_ATOL = 1.5e-7        # rotation entries and meters
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


@pytest.fixture(scope="module")
def compiled_p3p():
    """The compiled reference's ``jax.vmap(p3p)`` on 6,000 samples of
    ``tools/fit_p3p_order.py``'s generator (seed 3; near-quadruple roots
    among them): XLA's own fusions, called through their dumped object
    files up to the last polish of the roots
    (``fit_p3p_fusions.compiled_trace``), and ``(bear, pts, trace,
    names)``."""
    import glob
    import shutil

    import fit_p3p_fusions as fus
    import fit_p3p_order as fit

    n = 6000
    tmp = fus.dump(fus.DUMP, n)
    try:
        text = open(glob.glob(os.path.join(
            tmp, "*jit_p3p.cpu_after_optimizations.txt"))[0]).read()
        names = fus.ferrari_fusions(text)
        bear, pts = fit.samples(n, seed=3)
        trace = fus.compiled_trace(text, tmp, bear, pts,
                                   names["polishes"][-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return bear, pts, trace, names


def _port_ratios(bear, pts):
    """The port's side ratios and cosines, and ``quartic_normalized``."""
    import fit_p3p_order as fit

    sides, _ = fit.reference_stages(bear, pts)
    a, b, c, ca, cb, cg = (torch.from_numpy(np.array(x)) for x in sides)
    ratios = ((a * a) / (b * b), (c * c) / (b * b), ca, cb, cg)
    return ratios, tp.quartic_normalized(*ratios)


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)


def test_p3p_roots_are_the_compiled_fusions(compiled_p3p):
    """Ferrari's four roots (``pnp.ferrari_roots``) and each of the six
    polishes' ``f / fp`` (``pnp.polish_step``) give the bits of the
    compiled reference's fusions (their object code, fed the compiled
    chain's own values), on every sample: the resolvent with XLA's rsqrt
    (``ops/rsqrtps.py``), the cube roots' contracted arguments, each
    root's region, each polish's recomputed coefficients."""
    from tod_tpu_torch.ops.image import fma_f32

    bear, pts, trace, names = compiled_p3p
    ratios, normalized = _port_ratios(bear, pts)
    x = tp.ferrari_roots(*normalized)
    ys = torch.from_numpy(trace[names["roots"]])
    want = fma_f32(-normalized[0][:, None].expand_as(ys),
                   torch.full_like(ys, 0.25), ys)        # the roots - a / 4
    np.testing.assert_array_equal(_bits(x), _bits(want))
    r = [t[..., None] for t in ratios]
    for name in names["polishes"]:
        d = tp.polish_step(x, *r)
        np.testing.assert_array_equal(_bits(d), _bits(trace[name]),
                                      err_msg=name)
        x = x - d


def _reference_with_parts():
    """``jax.vmap`` of a copy of the reference's ``p3p`` that also returns
    its polished roots, its distances after the Newton steps and its Horn
    fit's model-point centroid (copies of tod_tpu/geometry/pnp.py:119-222
    and transforms.py:193-212, the return lines extended): its candidates
    are the reference's, bit for bit (asserted by the caller)."""
    import inspect

    from tod_tpu.geometry import transforms as rt

    ns = dict(rt.__dict__)
    fit_src = inspect.getsource(rt.kabsch)
    ret = "    return RigidFit(R=R, T=T, ok=ok & enough)"
    assert fit_src.count(ret) == 1
    exec(fit_src.replace("def kabsch(", "def kabsch_parts(").replace(
        ret, ret + ", cq"), ns)
    ns.update({k: v for k, v in rp.__dict__.items() if k not in ns})
    src = inspect.getsource(rp.p3p)
    call = "    fit = kabsch(world, cam, jnp.ones((8, 3), jnp.float32))"
    ret = ("    return P3PSolutions(R=fit.R, T=fit.T, "
           "valid=ok & fit.ok)")
    assert src.count(ret) == 1 and src.count(call) == 1
    src = src.replace("def p3p(", "def p3p_parts(").replace(
        call, call.replace("fit = kabsch(", "fit, cq = kabsch_parts(")
    ).replace(ret, ret + ", v, jnp.stack([s1, s2, s3], -1), cq")
    exec(src, ns)
    return jax.jit(jax.vmap(ns["p3p_parts"]))


def test_p3p_parts_from_the_reference_at_the_coefficients(compiled_p3p):
    """Where the port's P3P and the compiled reference's part. Not at the
    inputs: the side lengths (the reference's reduce, one FMA chain in its
    object code, which ``pnp._side`` transcribes) and the cosines (its dot,
    left-to-right sums) are its bits, every one; nor at the quartic's
    normalised coefficients (``C3/C4 .. C0/C4``, four fusions with LLVM's
    contractions, read off by ``tools/fit_p3p_fusions.py``), given by
    ``pnp.quartic_normalized`` where the unfused
    ``pnp.quartic_coefficients`` does not; nor at the roots
    (``test_p3p_roots_are_the_compiled_fusions``), nor at the distances
    after the eight Newton steps (the first distances and the steps'
    residuals and Jacobian as compiled), the reference's on every sample
    whose roots a copy of its program (returning them) computes as the
    program does. The bits part at the Horn fit: the compiled reference
    folds its unit weights, each centroid a sum times float32(1/3), where
    the port's ``kabsch`` divides by the weights' sum (ROADMAP queue C);
    no valid candidate pose keeps the reference's bits yet. The
    candidates still agree within 1 mm (``test_p3p_matches_reference``)."""
    import fit_p3p_order as fit

    rng = np.random.default_rng(0)
    bear, pts, _ = p3p_samples(rng, 40)
    ref = jax.jit(jax.vmap(rp.p3p))(jnp.asarray(bear), jnp.asarray(pts))
    got = tp.p3p(torch.from_numpy(bear), torch.from_numpy(pts))
    r_ref, t_ref = np.asarray(ref.R), np.asarray(ref.T)
    same = ((got.R.numpy().view(np.int32) == r_ref.view(np.int32)).all(
        (-1, -2)) & (got.T.numpy().view(np.int32)
                     == t_ref.view(np.int32)).all(-1))
    assert not (same & np.asarray(ref.valid)).any()

    bear, pts = fit.samples(2000, seed=3)
    want_sides, want_coef = fit.reference_stages(bear, pts)
    sides, unfused, coef, c0_rule = fit.port_stages(bear, pts)
    for g, w in zip(sides, want_sides):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    assert all(fit.off(u, w) for u, w in zip(unfused, want_sides[:3]))
    assert all(fit.off(g, w) for g, w in zip(coef, want_coef))
    np.testing.assert_array_equal(c0_rule.view(np.int32),
                                  want_coef[3].view(np.int32))
    a, b, c, ca, cb, cg = (torch.from_numpy(np.array(x)) for x in sides)
    normalized = tp.quartic_normalized((a * a) / (b * b), (c * c) / (b * b),
                                       ca, cb, cg)
    for g, w in zip(normalized, want_coef):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.view(np.int32))

    # the distances after the Newton steps; then the Horn fit's centroid
    bear, pts, _, _ = compiled_p3p
    sols, v_ref, s_ref, cq_ref = _reference_with_parts()(bear, pts)
    plain = jax.jit(jax.vmap(rp.p3p))(bear, pts)
    for x, y in zip(sols, plain):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ratios, normalized = _port_ratios(bear, pts)
    v = tp.ferrari_roots(*normalized)
    for _ in range(6):
        v = v - tp.polish_step(v, *[t[..., None] for t in ratios])
    alike = (_bits(v) == _bits(v_ref)).all(-1)
    assert alike.mean() > 0.999, alike.mean()
    s, ok = tp.p3p_distances_torch(torch.from_numpy(bear),
                                   torch.from_numpy(pts))
    np.testing.assert_array_equal(_bits(s)[alike], _bits(s_ref)[alike])
    # the reference's centroid: ((p0 + p1) + p2) * float32(1/3), the
    # weights folded; the port's: the pairwise sum over the weights' sum
    p = torch.from_numpy(pts)
    folded = ((p[:, 0] + p[:, 1]) + p[:, 2]) * torch.full((), 1.0 / 3.0)
    np.testing.assert_array_equal(
        _bits(folded[:, None].expand(cq_ref.shape)), _bits(cq_ref))
    ones = torch.ones(p.shape[:-1] + (1,))
    cq = tp.pairwise_sum(ones * p, -2) / (tp.pairwise_sum(ones, -2) + 1e-30)
    assert (_bits(cq)[:, None] != _bits(cq_ref)).any()


def _reference_step_parts(R, T, X, uv, w):
    """The first Gauss-Newton step's residual at ``delta = 0`` and its
    ``jax.jacfwd`` Jacobian, as the reference's ``step`` computes them
    (tod_tpu/geometry/pnp.py:240-270, the ``residual`` closure copied)."""
    def rot_smooth(w3):
        kx = jnp.array([[0.0, -w3[2], w3[1]], [w3[2], 0.0, -w3[0]],
                        [-w3[1], w3[0], 0.0]])
        return jnp.eye(3) + kx + 0.5 * (kx @ kx)

    def residual(delta):
        Rn = rot_smooth(delta[:3]) @ R
        uvp, _ = rp.project(Rn, T + delta[3:], K, X)
        return ((uvp - uv) * w[:, None]).reshape(-1)

    return residual(jnp.zeros(6)), jax.jacfwd(residual)(jnp.zeros(6))


def test_refinement_parts_from_the_reference_at_the_residual(gn_case):
    """Where the port's refinement and the compiled reference's part: at
    its first operation, the weighted residual at ``delta = 0`` that
    ``jax.jacfwd``'s program computes beside the tangents, its camera
    points XLA's batched ``dot`` (most entries are the reference's bits,
    not all: ROADMAP queue C); the Jacobian
    columns of the rotation part too, the translation's u and v columns
    being ``fx / z w`` and ``fy / z w`` alike. Held loosely by
    ``test_gauss_newton_pose_matches_reference`` (``GN_ATOL``)."""
    R0, T0, X, uv, w, _ = gn_case
    r_ref, J_ref = (np.asarray(x) for x in jax.jit(jax.vmap(
        _reference_step_parts))(R0, T0, X, uv, w))
    r, J = tp.reprojection_jacobian(*map(torch.from_numpy,
                                         (R0, T0, K, X, uv, w)))
    same_r = _bits(r.reshape(5, -1)) == _bits(r_ref)
    assert 0.5 < same_r.mean() < 1.0, same_r.mean()
    same_j = _bits(J.reshape(5, -1, 6)) == _bits(J_ref)
    assert same_j[..., 3:5].all() and not same_j[..., :3].all()


@pytest.mark.parametrize("n", [3, 6])
def test_lu_solve_against_jnp_linalg_solve(n):
    """The explicit LU (the P3P Newton step's 3x3, the refinement's 6x6
    normal equations) against ``jnp.linalg.solve`` (LAPACK's ``sgetrf``
    and ``strsm`` through XLA): the same bits on well-conditioned systems,
    with partial pivoting (a zero leading entry), and non-finite entries
    for a singular system, as an LU solve gives (tests/test_torch_lapack.py
    holds the edge cases)."""
    rng = np.random.default_rng(n)
    J = rng.standard_normal((500, 4 * n, n)).astype(np.float32)
    M = (np.einsum("bki,bkj->bij", J, J) + np.eye(n)).astype(np.float32)
    M[0, 0, 0] = 0.0                                  # needs a pivot
    F = rng.standard_normal((500, n)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b: jnp.linalg.solve(a, b[:, None])[:, 0]))(M, F))
    got = tp.lu_solve(torch.from_numpy(M), torch.from_numpy(F)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    singular = np.ones((1, n, n), np.float32)
    out = tp.lu_solve(torch.from_numpy(singular), torch.ones((1, n)))
    assert not torch.isfinite(out).all()


def test_p3p_distances_twin_is_p3ps_first_stage():
    """``p3p`` is ``p3p_distances`` (the kernel's plain twin on the CPU)
    and the fixed-order Horn fit: the candidates' camera points fit back
    to the distances, and a candidate is valid only where the twin says
    so."""
    rng = np.random.default_rng(5)
    bear, pts, _ = p3p_samples(rng, 16)
    b, p = torch.from_numpy(bear), torch.from_numpy(pts)
    s, ok = tp.p3p_distances(b, p)
    assert s.shape == (16, 8, 3) and ok.shape == (16, 8)
    sols = tp.p3p(b, p)
    assert not (sols.valid & ~ok).any()
    cam = p[:, None] @ sols.R.transpose(-1, -2) + sols.T[:, :, None]
    dist = torch.linalg.norm(cam, dim=-1)                # (16, 8, 3)
    np.testing.assert_allclose(dist[sols.valid].numpy(),
                               s[sols.valid].numpy(), rtol=1e-3)
    with pytest.raises(TypeError):
        tp.p3p_distances(b.double(), p.double())
    with pytest.raises(ValueError):
        tp.p3p_distances(b[:, :2], p[:, :2])


def test_p2_shared_limit_matches_the_kernel():
    """Kernel P2 holds nothing of size N in shared memory (no dynamic
    shared memory, no global scratch): its fixed arrays, the two shared
    levels' halves of 27 sums, the pose and the level sizes, fit the
    card's 48 KB of static shared memory a block; the reduction model of
    tests/test_torch_p2_tree.py runs its thread count."""
    import re
    from pathlib import Path

    import test_torch_p2_tree as tree

    src = (Path(tp.__file__).parents[1] / "csrc" / "gauss_newton.cu"
           ).read_text()
    assert "extern __shared__" not in src and "scratch" not in src
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kThreads"] == tree.THREADS and const["kSums"] == 27
    slots = const["kThreads"] // 2
    shared = 4 * (2 * 12 + const["kMaxLevels"] + 2 * 27 * slots)
    assert "kSlots = kThreads / 2" in src and shared < 48 * 1024
    assert not hasattr(tp, "GN_SHARED_BYTES")
