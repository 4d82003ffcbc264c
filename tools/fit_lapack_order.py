"""Read LAPACK's arithmetic order off scipy's OpenBLAS, for the port's
bit-for-bit ``jnp.linalg.solve`` and ``jnp.linalg.eigh``.

Runs on the CPU with numpy, scipy (and JAX for the last check of each
part), on the host type whose rounding the port copies: scipy's OpenBLAS
0.3.30 on its ``SkylakeX`` core (``tests/test_torch_premise.py``):

    JAX_PLATFORMS=cpu python tools/fit_lapack_order.py [--samples 20000]
        [--no-jax]

The reference's solve compiles to ``lapack_sgetrf_ffi`` and two
``lapack_strsm_ffi`` (lower unit, then upper), its ``eigh`` to
``lapack_ssyevd_ffi``; jaxlib calls scipy's LAPACK for all three. So each
order is probed against ``scipy.linalg.lapack`` / ``blas`` stage by stage,
candidate against candidate, and the reading is then held whole:

1. The LU (OpenBLAS's left-looking ``getf2``): the strided ``sdot`` of
   L's row against the column is probed in isolation (the rows i < j of
   each column, from scipy's own L and U): pairs ``fma(x0, y0, x1 y1)``
   summed in order, an odd last product rounded and added, is the only
   candidate that gives every bit at n = 6. The GEMV rows r >= j are an
   FMA chain from +0; the pivot the first largest magnitude; a pivot of
   magnitude below FLT_MIN (zero, subnormal, NaN) swaps and scales nothing
   in columns 0..j. The TRSM kernels solve in row blocks of 2 and 1 (n =
   3) or 4 and 2 (n = 6): a GEMM chain from +0 before a block, ``fma(-x,
   l, c)`` inside it, the upper solve times the diagonal's reciprocal.
   ``lu_solve`` below is this reading in numpy; it is held against
   ``sgetrf``, ``strsm`` and ``jax.jit(jax.vmap(jnp.linalg.solve))`` at
   n = 3 (random) and n = 6 (``J^T J + 1e-6 I``).
2. ``ssyevd`` at n = 3 (``tod_tpu_torch/geometry/lapack.py syevd3``, the
   LAPACK 3.12 Fortran, unfused, around OpenBLAS's BLAS kernels): the
   ``ssymv``/``sdot``/``saxpy``/``ssyr2`` orders of ``ssytd2`` against
   ``ssytrd``, the ``sgemv_t``/``sger`` orders of ``sorm2r`` against
   ``sormqr``, then eigenvalues and vectors against ``ssyevd`` (scaled and
   unscaled) and column 0 against ``jnp.linalg.eigh``.

It exits with status 1 if the reading misses a bit anywhere.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

f32 = np.float32


def fma(a, b, c):
    """Elementwise f32 ``a * b + c`` rounded once (the exact f64 product,
    the f64 sum rounded to odd, then to f32)."""
    a, b, c = np.broadcast_arrays(np.asarray(a, f32), np.asarray(b, f32),
                                  np.asarray(c, f32))
    p = a.astype(np.float64) * b.astype(np.float64)
    cc = c.astype(np.float64)
    with np.errstate(all="ignore"):
        s = p + cc
        back = s - p
        err = (p - (s - back)) + (cc - back)
    bits = s.view(np.int64).copy()
    odd = (err != 0) & (err == err) & ((bits & 1) == 0) & np.isfinite(s)
    bits[odd] += np.where((err > 0) == (s > 0), 1, -1)[odd]
    return bits.view(np.float64).astype(f32)


# --- the LU ---------------------------------------------------------------

DOTS = {
    "chain": lambda xs, ys: _chain(list(zip(xs, ys))),
    "reversed chain": lambda xs, ys: _chain(list(zip(xs, ys))[::-1]),
    "unfused": lambda xs, ys: _unfused(xs, ys),
    "pairs": lambda xs, ys: _pairs(xs, ys),
}


def _chain(terms):
    acc = np.zeros_like(terms[0][0])
    for x, y in terms:
        acc = fma(x, y, acc)
    return acc


def _unfused(xs, ys):
    acc = np.zeros_like(xs[0])
    with np.errstate(all="ignore"):
        for x, y in zip(xs, ys):
            acc = (acc + (x * y).astype(f32)).astype(f32)
    return acc


def _pairs(xs, ys):
    acc = np.zeros_like(xs[0])
    with np.errstate(all="ignore"):
        for m in range(0, len(xs) - 1, 2):
            acc = (acc + fma(xs[m], ys[m], (xs[m + 1] * ys[m + 1]).astype(
                f32))).astype(f32)
        if len(xs) % 2:
            acc = (acc + (xs[-1] * ys[-1]).astype(f32)).astype(f32)
    return acc


def blocks(n: int, forward: bool):
    """The TRSM kernels' row blocks at unroll 16 (see lapack.py _blocks)."""
    out, i, h = [], 0, 8
    while i + 16 <= n:
        out.append((i, i + 16))
        i += 16
    while h:
        if n & h:
            out.append((i, i + h))
            i += h
        h >>= 1
    if forward:
        return out
    e, back = n, []
    for size in [b - a for a, b in out][::-1]:
        back.append((e - size, e))
        e -= size
    return back


def getf2(M, dot=_pairs):
    """OpenBLAS getf2 over a batch (B, n, n): (LU, row permutation)."""
    A = np.array(M, f32)
    nb, n, _ = A.shape
    ar = np.arange(nb)
    perm = np.tile(np.arange(n), (nb, 1))
    with np.errstate(all="ignore"):
        for j in range(n):
            for i in range(1, j):
                A[:, i, j] -= dot([A[:, i, k] for k in range(i)],
                                  [A[:, k, j] for k in range(i)])
            if j:
                for r in range(j, n):
                    A[:, r, j] -= _chain([(A[:, r, k], A[:, k, j])
                                          for k in range(j)])
            mag = np.abs(A[:, j:, j])
            jp = j + np.argmax(np.where(np.isnan(mag), -1, mag), axis=1)
            piv = A[ar, jp, j]
            scale = np.abs(piv) >= np.finfo(f32).tiny
            for c in range(n):
                swap = (jp != j) & (scale if c <= j else True)
                a_j, a_p = A[:, j, c].copy(), A[ar, jp, c].copy()
                A[:, j, c] = np.where(swap, a_p, a_j)
                A[ar, jp, c] = np.where(swap, a_j, a_p)
            p_j, p_p = perm[:, j].copy(), perm[ar, jp].copy()
            perm[:, j], perm[ar, jp] = p_p, p_j
            rcp = (f32(1) / piv).astype(f32)
            for r in range(j + 1, n):
                A[:, r, j] = np.where(scale, A[:, r, j] * rcp, A[:, r, j])
    return A, perm


def trsm(A, c, lower: bool):
    """OpenBLAS's generic TRSM kernels on one right-hand side (B, n)."""
    n = A.shape[-1]
    c = [np.array(c[:, i], f32) for i in range(n)]
    done = []
    with np.errstate(all="ignore"):
        for s, e in blocks(n, lower):
            for r in range(s, e):
                if done:
                    c[r] = (c[r] - _chain([(A[:, r, k], c[k])
                                           for k in sorted(done)])).astype(
                        f32)
            rows = range(s, e) if lower else range(e - 1, s - 1, -1)
            for i in rows:
                if not lower:
                    c[i] = (c[i] * (f32(1) / A[:, i, i])).astype(f32)
                for r in (range(i + 1, e) if lower else range(s, i)):
                    c[r] = fma(-c[i], A[:, r, i], c[r])
            done += list(range(s, e))
    return np.stack(c, 1)


def lu_solve(M, F):
    A, perm = getf2(M)
    return trsm(A, trsm(A, np.take_along_axis(np.asarray(F, f32), perm, 1),
                        True), False)


def normal_matrices(n: int, count: int, seed: int):
    """``J^T J + 1e-6 I`` of random (40, n) J with column scales 0.1-10."""
    rng = np.random.default_rng(seed)
    J = (rng.standard_normal((count, 40, n))
         * rng.uniform(0.1, 10, (count, 1, n))).astype(f32)
    M = (np.einsum("bki,bkj->bij", J, J) + 1e-6 * np.eye(n)).astype(f32)
    return M, rng.standard_normal((count, n)).astype(f32)


def same(a, b) -> np.ndarray:
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    return (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))


def scipy_lu(M):
    from scipy.linalg import lapack
    out, perms = [], []
    for m in M:
        lu, piv, _ = lapack.sgetrf(m)
        p = np.arange(len(m))
        for j, q in enumerate(piv):
            p[[j, q]] = p[[q, j]]
        out.append(lu)
        perms.append(p)
    return np.array(out), np.array(perms)


def lu_part(samples: int, use_jax: bool) -> bool:
    from scipy.linalg import blas
    ok = True
    M, _ = normal_matrices(6, min(samples, 5000), 1)
    ref, perm = scipy_lu(M)
    # the strided sdot alone, rows i < j, from scipy's L and U
    PM = np.take_along_axis(M, perm[:, :, None], 1)
    print("getf2's strided sdot, rows i < j (n = 6), candidates against "
          "sgetrf:")
    for name, dot in DOTS.items():
        hits = total = 0
        with np.errstate(all="ignore"):
            for j in range(2, 6):
                for i in range(1, j):
                    d = dot([ref[:, i, k] for k in range(i)],
                            [ref[:, k, j] for k in range(i)])
                    hits += int(same(PM[:, i, j] - d, ref[:, i, j]).sum())
                    total += len(M)
        print(f"  {name:<15} {hits} of {total}")
        if name == "pairs":
            ok &= hits == total
    for n, count, seed in ((3, samples, 3), (6, min(samples, 5000), 6)):
        if n == 3:
            M = np.random.default_rng(seed).standard_normal(
                (count, 3, 3)).astype(f32)
            F = np.random.default_rng(seed + 1).standard_normal(
                (count, 3)).astype(f32)
        else:
            M, F = normal_matrices(n, count, seed)
        A, perm = getf2(M)
        ref, rperm = scipy_lu(M)
        lu_hits = int(same(A, ref).all((1, 2)).sum())
        c = np.take_along_axis(F, rperm, 1)
        y_ref = np.array([blas.strsm(1.0, r, v[:, None], lower=1, diag=1)[:, 0]
                          for r, v in zip(ref, c)])
        x_ref = np.array([blas.strsm(1.0, r, v[:, None], lower=0)[:, 0]
                          for r, v in zip(ref, y_ref)])
        lo = int(same(trsm(ref, c, True), y_ref).all(1).sum())
        up = int(same(trsm(ref, y_ref, False), x_ref).all(1).sum())
        line = (f"n = {n}: getf2 = sgetrf {lu_hits} of {count}; lower "
                f"trsm {lo}, upper trsm {up} of {count}")
        ok &= lu_hits == lo == up == count
        if use_jax:
            import jax
            import jax.numpy as jnp
            want = np.asarray(jax.jit(jax.vmap(
                lambda a, b: jnp.linalg.solve(a, b[:, None])[:, 0]))(M, F))
            hits = int(same(lu_solve(M, F), want).all(1).sum())
            line += f"; the solve = jnp.linalg.solve {hits} of {count}"
            ok &= hits == count
        print(line)
    return ok


# --- ssyevd ---------------------------------------------------------------

def covariances(count: int, seed: int) -> np.ndarray:
    """Planar-like 3x3 covariances of 40 points."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        P = rng.standard_normal((40, 3)) * [0.1, 0.07, 0.002 * rng.random()]
        R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
        d = (P @ R.T).astype(f32)
        d = d - d.mean(0)
        out.append((d.T @ d).astype(f32))
    return np.array(out)


def eigh_part(samples: int, use_jax: bool) -> bool:
    from scipy.linalg import lapack as sl

    from tod_tpu_torch.geometry import lapack
    ok = True
    count = min(samples, 3000)
    C = covariances(count, 0)
    # ssytd2's update of the trailing 2x2 after the one reflector: the dot
    # w^T v of ssymv's w and v = (1, x) as pairs or as a chain
    hits = {"pairs": 0, "chain": 0}
    for c in C:
        ref_c, d, e, tau, _ = sl.ssytrd(c, lower=1)
        got_d, got_e = {}, {}
        for order in hits:
            a = [[f32(c[i][j]) for j in range(3)] for i in range(3)]
            alpha, x = a[1][0], a[2][0]
            beta = -lapack._sign(lapack._lapy2(alpha, abs(x)), alpha)
            t = (beta - alpha) / beta
            x = x * (f32(1) / (alpha - beta))
            a11, a21, a22 = a[1][1], a[2][1], a[2][2]
            y0 = lapack.fma1(t, a21 * x, t * a11)
            y1 = lapack.fma1(t * x, a22, t * a21)
            dt = (lapack.fma1(y0, f32(1), y1 * x) if order == "pairs"
                  else lapack.fma1(y1, x, y0 * f32(1)))
            al = ((-f32(0.5)) * t) * (f32(0) + dt)
            w0, w1 = lapack.fma1(al, f32(1), y0), lapack.fma1(al, x, y1)
            got = [lapack.fma1(-w0, f32(1), lapack.fma1(-f32(1), w0, a11)),
                   lapack.fma1(-w1, x, lapack.fma1(-x, w1, a22))]
            hits[order] += int(same(np.array(got, f32), d[1:]).all())
    print("ssytd2's dot of ssymv's w and v against ssytrd (d[1], d[2] "
          f"bit for bit, {count} covariances): " + ", ".join(
              f"{k} {v}" for k, v in hits.items()))
    ok &= hits["pairs"] == count
    # syevd3 whole, against ssyevd (vectors, values), also scaled ranges
    rng = np.random.default_rng(9)
    cases = [C] + [((lambda m: (m + m.transpose(0, 2, 1)).astype(f32))(
        (rng.standard_normal((300, 3, 3)) * s).astype(f32)))
        for s in (1e-30, 1e-20, 1e-5, 1e18, 1e30)]
    for c in cases:
        hit = 0
        for m in c:
            w, V, _ = sl.ssyevd(m, compute_v=1, lower=1)
            d, Z = lapack.syevd3(m)
            hit += int(same(np.array(Z, f32), V).all()
                       and same(np.array(d, f32), w).all())
        scale = float(np.abs(c).max())
        print(f"syevd3 = ssyevd (values and vectors), |a| up to "
              f"{scale:.1e}: {hit} of {len(c)}")
        ok &= hit == len(c)
    if use_jax:
        import jax
        import jax.numpy as jnp
        import torch
        want = np.asarray(jax.jit(jax.vmap(jnp.linalg.eigh))(C)[1])[:, :, 0]
        got = lapack.smallest_eigenvector_torch(torch.from_numpy(C)).numpy()
        hit = int(same(got, want).all(1).sum())
        print(f"smallest_eigenvector_torch = jnp.linalg.eigh's column 0: "
              f"{hit} of {count} (signs too)")
        ok &= hit == count
    return ok


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=20000)
    p.add_argument("--no-jax", action="store_true")
    args = p.parse_args()
    ok = lu_part(args.samples, not args.no_jax)
    ok &= eigh_part(args.samples, not args.no_jax)
    print("reading holds" if ok else "READING MISSES BITS")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
