"""LAPACK's small solvers in the port (tod_tpu_torch/geometry/lapack.py)
bit for bit against the reference's: ``jnp.linalg.solve`` (``sgetrf`` +
``strsm``) and ``jnp.linalg.eigh`` (``ssyevd``), both scipy's OpenBLAS on
the reference host (tests/test_torch_premise.py holds that premise;
tools/fit_lapack_order.py reads the orders off).

Contracts, all exact (float32 bits; NaN equal to NaN):

- ``lu_solve`` at n = 3 on 20,000 random systems and at n = 6 on 5,000
  normal-equation matrices ``J^T J + 1e-6 I``: the same bits as
  ``jax.jit(jax.vmap(jnp.linalg.solve))`` and as scipy's ``sgetrf`` then
  ``strsm`` twice;
- pivot ties and singular matrices (small integers), a zero leading
  entry, NaN entries, subnormal and tiny pivots: the same bits (scipy's
  for the subnormal and tiny pivots, whose subnormal values XLA's host
  flushes around its LAPACK calls), so a singular or
  NaN system is non-finite exactly where the reference's is;
- ``smallest_eigenvector_torch`` (kernel M2's plain version) equal to
  ``jnp.linalg.eigh``'s column 0, sign included, on planar, isotropic,
  rank-0 and rank-1 covariances; ``syevd3``'s eigenvalues and vectors
  equal to ``ssyevd``'s over scales that take both of its scaling
  branches.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.linalg import blas, lapack as sl

from tod_tpu_torch.geometry import lapack
from tod_tpu_torch.geometry import pnp as tp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(1)

_solve = jax.jit(jax.vmap(lambda a, b: jnp.linalg.solve(a, b[:, None])[:, 0]))
_eigh = jax.jit(jax.vmap(jnp.linalg.eigh))


def same(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                     & np.isnan(b))


def scipy_solve(M, F):
    """sgetrf, the row swaps, strsm (lower unit), strsm (upper)."""
    out = []
    for m, f in zip(M, F):
        lu, piv, _ = sl.sgetrf(m)
        c = f.copy()
        for j, p in enumerate(piv):
            c[[j, p]] = c[[p, j]]
        y = blas.strsm(1.0, lu, c[:, None], lower=1, diag=1)
        out.append(blas.strsm(1.0, lu, y, lower=0)[:, 0])
    return np.array(out, np.float32)


def port_solve(M, F):
    return tp.lu_solve(torch.from_numpy(M), torch.from_numpy(F)).numpy()


@pytest.mark.parametrize("n", [3, 6])
def test_lu_solve_bit_for_bit(n):
    import fit_lapack_order as fit
    rng = np.random.default_rng(n)
    if n == 3:
        M = rng.standard_normal((20000, 3, 3)).astype(np.float32)
        F = rng.standard_normal((20000, 3)).astype(np.float32)
    else:
        M, F = fit.normal_matrices(6, 5000, 7)
    got = port_solve(M, F)
    assert same(got, _solve(M, F)).all()
    assert same(got[:2000], scipy_solve(M[:2000], F[:2000])).all()
    assert same(got, fit.lu_solve(M, F)).all()      # the tool's reading


def _edge(kind: str, n: int, rng):
    count = 2000
    M = rng.standard_normal((count, n, n)).astype(np.float32)
    if kind == "ties":
        M = rng.integers(-2, 3, (count, n, n)).astype(np.float32)
    elif kind == "zero_lead":
        M[:, 0, 0] = 0.0
    elif kind == "nan":
        at = rng.integers(0, n, (count, 2))
        M[np.arange(count), at[:, 0], at[:, 1]] = np.nan
    elif kind == "singular":
        M[:, :, -1] = M[:, :, 0] * 2.0
    elif kind in ("subnormal", "tiny"):
        M[:, :, 0] *= 1e-39 if kind == "subnormal" else 3e-38
    F = rng.integers(-3, 4, (count, n)).astype(np.float32) if kind == "ties" \
        else rng.standard_normal((count, n)).astype(np.float32)
    return M, F


@pytest.mark.parametrize("n", [3, 6])
@pytest.mark.parametrize("kind", ["ties", "zero_lead", "nan", "singular",
                                  "subnormal", "tiny"])
def test_lu_solve_edge_cases(kind, n):
    M, F = _edge(kind, n, np.random.default_rng(len(kind) * 10 + n))
    got = port_solve(M, F)
    if kind not in ("subnormal", "tiny"):
        # XLA's host flushes subnormals, which these pivots make on the way
        assert same(got, _solve(M, F)).all()
    assert same(got[:500], scipy_solve(M[:500], F[:500])).all()
    if kind in ("ties", "singular", "nan"):
        assert not np.isfinite(got).all(1).all()     # some non-finite out
    if kind == "zero_lead":
        assert np.isfinite(got).all()


def _covariances(kind: str, rng, count=300):
    out = []
    for _ in range(count):
        if kind == "planar":
            P = rng.standard_normal((int(rng.integers(3, 200)), 3)) * [
                0.1, 0.07, 0.002 * rng.random()]
            Q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            d = (P @ Q.T).astype(np.float32)
            d = d - d.mean(0)
            out.append(d.T @ d)
        elif kind == "isotropic":
            out.append(np.eye(3) * rng.random())
        elif kind == "rank0":
            out.append(np.zeros((3, 3)))
        else:
            u = rng.standard_normal(3)
            out.append(np.outer(u, u))
    return np.array(out, np.float32)


@pytest.mark.parametrize("kind", ["planar", "isotropic", "rank0", "rank1"])
def test_normal_bit_for_bit(kind):
    C = _covariances(kind, np.random.default_rng(len(kind)),
                     2000 if kind == "planar" else 300)
    want = np.asarray(_eigh(C)[1])[:, :, 0]
    got = lapack.smallest_eigenvector_torch(torch.from_numpy(C)).numpy()
    assert same(got, want).all()           # the sign too
    from tod_tpu_torch.geometry import detection2d as td
    assert same(td.sym3_smallest_vector(torch.from_numpy(C)).numpy(),
                want).all()


@pytest.mark.parametrize("scale", [1e-30, 1e-20, 1e-5, 1.0, 1e18, 1e30])
def test_syevd3_against_ssyevd(scale):
    """Both scaling branches (ssyevd's own below 2^-51.5 and above 2^51.5,
    ssteqr's below 2^-15) and none: eigenvalues and vectors exact."""
    rng = np.random.default_rng(int(abs(np.log10(scale))))
    A = (rng.standard_normal((200, 3, 3)) * scale).astype(np.float32)
    A = (A + A.transpose(0, 2, 1)).astype(np.float32)
    for a in A:
        w, V, _ = sl.ssyevd(a, compute_v=1, lower=1)
        d, Z = lapack.syevd3(a)
        assert same(np.array(Z, np.float32), V).all()
        assert same(np.array(d, np.float32), w).all()


def test_p3p_fixture_holds_the_twins():
    """tests/data/torch_p3p_fixture.npz (tools/make_torch_p3p_fixture.py,
    the reference's outputs that chip_smoke.py phase 3k holds the card
    against): the port's LU at n = 3 and 6 and its model normal give its
    bits on the CPU, so the card's kernels are held to the reference."""
    fx = np.load(os.path.join(os.path.dirname(__file__), "data",
                              "torch_p3p_fixture.npz"))
    for n in (3, 6):
        got = port_solve(fx[f"lu{n}_M"], fx[f"lu{n}_F"])
        assert same(got, fx[f"lu{n}_x"]).all()
    got = lapack.smallest_eigenvector_torch(torch.from_numpy(fx["cov"]))
    assert same(got.numpy(), fx["normal"]).all()
