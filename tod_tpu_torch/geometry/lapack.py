"""LAPACK's small dense solvers, bit for bit as the reference runs them on
its host: ``jnp.linalg.solve`` (``sgetrf``, then ``strsm`` twice) and
``jnp.linalg.eigh`` (``ssyevd``), both through scipy's OpenBLAS 0.3.30 on
its ``SkylakeX`` core (``tests/test_torch_premise.py`` holds that premise;
``tools/fit_lapack_order.py`` reads the orders off against scipy).

- :func:`lu_solve` (n <= 6): OpenBLAS's own ``getf2`` and TRSM kernels,
  whose BLAS calls contract multiply-adds. Elementwise over any leading
  axes, the same bits on every device; kernels P1 and P2 transcribe it
  (``csrc/lapack_lu.cuh``).
- :func:`syevd3` (n = 3): reference LAPACK's Fortran (compiled without
  contractions) around OpenBLAS's BLAS kernels (which contract): ``ssytd2``,
  ``ssteqr`` (``sstedc``'s small case) and ``sorm2r`` (``sormtr``), with
  ``ssyevd``'s and ``ssteqr``'s scaling. It is a data-dependent QL/QR
  iteration, so it runs a matrix at a time in float32 scalars; kernel M2
  (``csrc/mirror.cu``) runs the same code a thread a matrix.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from tod_tpu_torch.ops.image import fma_f32

SFMIN = 1.1754943508222875e-38   # LAPACK's slamch('S'): FLT_MIN


def _chain(pairs, zero: torch.Tensor) -> torch.Tensor:
    """``sum a_k b_k`` as one FMA chain from +0 in order (OpenBLAS's GEMV
    tail rows and its GEMM kernel's depth loop)."""
    acc = zero
    for a, b in pairs:
        acc = fma_f32(a, b, acc)
    return acc


def _dot_pairs(pairs, zero: torch.Tensor) -> torch.Tensor:
    """OpenBLAS's strided ``sdot`` on the reference host (getf2's row of
    L against the column): from +0, each pair of terms added as ``fma(x0,
    y0, x1 y1)`` (the second product rounded), an odd last product rounded
    and added (``tools/fit_lapack_order.py``)."""
    acc = zero
    for m in range(0, len(pairs) - 1, 2):
        (a0, b0), (a1, b1) = pairs[m], pairs[m + 1]
        acc = acc + fma_f32(a0, b0, a1 * b1)
    if len(pairs) % 2:
        a, b = pairs[-1]
        acc = acc + a * b
    return acc


def _blocks(n: int, forward: bool):
    """The row blocks of OpenBLAS's generic TRSM kernels at unroll 16:
    whole blocks of 16, then the remainder's powers of two, largest first
    going forward (the lower solve, ``trsm_kernel_LT``), smallest first
    from the bottom going backward (the upper solve, ``trsm_kernel_LN``)."""
    out, i = [], 0
    while i + 16 <= n:
        out.append((i, i + 16))
        i += 16
    h = 8
    while h:
        if n & h:
            out.append((i, i + h))
            i += h
        h >>= 1
    if forward:
        return out
    sizes = [e - s for s, e in out][::-1]
    out, e = [], n
    for size in sizes:
        out.append((e - size, e))
        e -= size
    return out


def lu_solve(M: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """``M^-1 F`` for (..., n, n) ``M`` and (..., n) ``F``, n <= 6, bit for
    bit as ``jnp.linalg.solve`` on the reference host: LAPACK ``sgetrf``
    then ``strsm`` twice, as scipy's OpenBLAS 0.3.30 (``SkylakeX`` core)
    runs them (read off by ``tools/fit_lapack_order.py``).

    - The LU is OpenBLAS's left-looking ``getf2``. Column j takes the
      earlier row swaps; rows 1 <= i < j subtract :func:`_dot_pairs` of L's
      row i and the column; rows r >= j subtract the FMA chain
      (:func:`_chain`) over k < j. The pivot is the first largest
      magnitude. Its row swap always reaches the later columns and the
      right-hand side; columns 0..j swap, and the rows below are scaled by
      the pivot's rounded reciprocal, only if its magnitude is at least
      ``SFMIN`` (a zero, subnormal or NaN pivot leaves them).
    - The solves run OpenBLAS's generic TRSM kernels in :func:`_blocks`.
      Before a block, its rows subtract the chain over the rows solved.
      Inside a block each solved value updates the block's later rows by
      ``fma(-x, l, c)``. The upper solve multiplies by the diagonal's
      rounded reciprocal.

    Every step is elementwise (the row swaps are selects), so the bits are
    the same on every device and there is no host wait. A singular ``M``
    gives non-finite entries, as an LU solve does."""
    n = M.shape[-1]
    if n > 6:
        raise ValueError(f"lu_solve reads OpenBLAS's order up to n = 6, "
                         f"got {n}")
    M, F = torch.broadcast_tensors(M, F[..., None])
    a = [[M[..., r, c] for c in range(n)] for r in range(n)]
    b = [F[..., r, 0] for r in range(n)]
    zero = torch.zeros((), dtype=M.dtype, device=M.device)
    one = torch.ones((), dtype=M.dtype, device=M.device)
    for j in range(n):
        for i in range(1, j):
            a[i][j] = a[i][j] - _dot_pairs(
                [(a[i][k], a[k][j]) for k in range(i)], zero)
        if j:
            for r in range(j, n):
                a[r][j] = a[r][j] - _chain(
                    [(a[r][k], a[k][j]) for k in range(j)], zero)
        # the first largest magnitude: strict comparisons in row order
        best, pivot = torch.abs(a[j][j]), a[j][j]
        at = [None] * n
        for r in range(j + 1, n):
            more = torch.abs(a[r][j]) > best
            best = torch.where(more, torch.abs(a[r][j]), best)
            pivot = torch.where(more, a[r][j], pivot)
            at = [more if q == r else (None if at[q] is None else
                                       at[q] & ~more) for q in range(n)]
        # the swap is recorded (later columns, the right-hand side) for any
        # pivot; columns 0..j swap, and the rows below scale by the
        # reciprocal, only for a pivot of magnitude >= SFMIN (not a zero,
        # subnormal or NaN one)
        scale = torch.abs(pivot) >= SFMIN
        for r in range(j + 1, n):
            for c in range(n):
                swap = at[r] if c > j else at[r] & scale
                a[j][c], a[r][c] = (torch.where(swap, a[r][c], a[j][c]),
                                    torch.where(swap, a[j][c], a[r][c]))
            b[j], b[r] = (torch.where(at[r], b[r], b[j]),
                          torch.where(at[r], b[j], b[r]))
        rcp = one / pivot
        for r in range(j + 1, n):
            a[r][j] = torch.where(scale, a[r][j] * rcp, a[r][j])
    # L y = P F (unit diagonal), then U x = y
    done = []
    for s, e in _blocks(n, True):
        for r in range(s, e):
            if done:
                b[r] = b[r] - _chain([(a[r][k], b[k]) for k in done], zero)
        for i in range(s, e):
            for r in range(i + 1, e):
                b[r] = fma_f32(-b[i], a[r][i], b[r])
        done += list(range(s, e))
    done = []
    for s, e in _blocks(n, False):
        for r in range(s, e):
            if done:
                b[r] = b[r] - _chain([(a[r][k], b[k]) for k in done], zero)
        for i in range(e - 1, s - 1, -1):
            b[i] = b[i] * (one / a[i][i])
            for r in range(s, i):
                b[r] = fma_f32(-b[i], a[r][i], b[r])
        done = list(range(s, e)) + done
    return torch.stack(b, -1)


# ---------------------------------------------------------------------------
# ssyevd at n = 3, JOBZ = 'V', UPLO = 'L' (LAPACK 3.12 as OpenBLAS 0.3.30
# builds it), in float32 scalars
# ---------------------------------------------------------------------------

_f = np.float32
_ONE, _ZERO, _HALF, _TWO = _f(1), _f(0), _f(0.5), _f(2)
_EPS = _f(2.0 ** -24)            # slamch('E')
_SAFMIN = _f(2.0 ** -126)        # slamch('S')
_HUGE = _f(np.finfo(np.float32).max)


def fma1(a, b, c) -> np.float32:
    """f32 ``a * b + c`` rounded once: the exact f64 product, its f64 sum
    rounded to odd (TwoSum's error decides), then to f32."""
    p = np.float64(a) * np.float64(b)
    c = np.float64(c)
    s = p + c
    if np.isfinite(s):
        back = s - p
        err = (p - (s - back)) + (c - back)
        if err != 0:
            bits = np.array(s).view(np.int64)
            if not bits & 1:
                bits = bits + (1 if (err > 0) == (s > 0) else -1)
                s = bits.view(np.float64)
    return _f(s)


def _sign(a, b) -> np.float32:
    """Fortran ``SIGN(a, b)``: |a| with b's sign bit."""
    return -abs(a) if np.signbit(b) else abs(a)


def _scale_steps(cfrom, cto) -> List[np.float32]:
    """The multipliers ``SLASCL`` applies in turn to scale by cto / cfrom
    without overflow (none when the factor is 1)."""
    small, big = _SAFMIN, _ONE / _SAFMIN
    cfromc, ctoc, out = _f(cfrom), _f(cto), []
    while True:
        cfrom1 = cfromc * small
        if cfrom1 == cfromc:                 # cfromc is infinite
            return out + [ctoc / cfromc]
        cto1 = ctoc / big
        if cto1 == ctoc:                     # ctoc is 0 or infinite
            return out + [ctoc]
        if abs(cfrom1) > abs(ctoc) and ctoc != 0:
            out.append(small)
            cfromc = cfrom1
        elif abs(cto1) > abs(cfromc):
            out.append(big)
            ctoc = cto1
        else:
            mul = ctoc / cfromc
            return out if mul == _ONE else out + [mul]


def _lapy2(x, y) -> np.float32:
    """``SLAPY2``: sqrt(x^2 + y^2) without overflow, NaN in, NaN out."""
    if np.isnan(x):
        return x
    if np.isnan(y):
        return y
    w, z = max(abs(x), abs(y)), min(abs(x), abs(y))
    if z == 0 or w > _HUGE:
        return w
    t = z / w
    return w * np.sqrt(_ONE + t * t)


def _lartg(f, g) -> Tuple[np.float32, np.float32, np.float32]:
    """``SLARTG`` (LAPACK 3.10's): the plane rotation (c, s, r) with
    [c s; -s c] [f; g] = [r; 0]."""
    rtmin, rtmax = np.sqrt(_SAFMIN), np.sqrt(_f(2.0 ** 126) / _TWO)
    f1, g1 = abs(f), abs(g)
    if g == 0:
        return _ONE, _ZERO, f
    if f == 0:
        return _ZERO, _sign(_ONE, g), g1
    if rtmin < f1 < rtmax and rtmin < g1 < rtmax:
        d = np.sqrt(f * f + g * g)
        r = _sign(d, f)
        return f1 / d, g / r, r
    u = min(_f(2.0 ** 126), max(_SAFMIN, f1, g1))
    fs, gs = f / u, g / u
    d = np.sqrt(fs * fs + gs * gs)
    r = _sign(d, f)
    return abs(fs) / d, gs / r, r * u


def _laev2(a, b, c):
    """``SLAEV2``: the eigensystem of [a b; b c]: (rt1, rt2, cs1, sn1)."""
    sm, df = a + c, a - c
    adf, tb = abs(df), b + b
    ab = abs(tb)
    acmx, acmn = (a, c) if abs(a) > abs(c) else (c, a)
    if adf > ab:
        t = ab / adf
        rt = adf * np.sqrt(_ONE + t * t)
    elif adf < ab:
        t = adf / ab
        rt = ab * np.sqrt(_ONE + t * t)
    else:
        rt = ab * np.sqrt(_TWO)
    if sm < 0:
        rt1, sgn1 = _HALF * (sm - rt), -1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    elif sm > 0:
        rt1, sgn1 = _HALF * (sm + rt), 1
        rt2 = (acmx / rt1) * acmn - (b / rt1) * b
    else:
        rt1, rt2, sgn1 = _HALF * rt, -_HALF * rt, 1
    cs, sgn2 = (df + rt, 1) if df >= 0 else (df - rt, -1)
    if abs(cs) > ab:
        ct = -tb / cs
        sn1 = _ONE / np.sqrt(_ONE + ct * ct)
        cs1 = ct * sn1
    elif ab == 0:
        cs1, sn1 = _ONE, _ZERO
    else:
        tn = -cs / tb
        cs1 = _ONE / np.sqrt(_ONE + tn * tn)
        sn1 = tn * cs1
    if sgn1 == sgn2:
        cs1, sn1 = -sn1, cs1
    return rt1, rt2, cs1, sn1


def _rotate(Z, j0: int, cs, ss, backward: bool) -> None:
    """``SLASR('R', 'V', 'B' or 'F')`` on Z's columns j0, j0 + 1, ...:
    rotation k mixes columns j0 + k and j0 + k + 1 (skipped when it is the
    identity), the last first when ``backward``."""
    order = range(len(cs) - 1, -1, -1) if backward else range(len(cs))
    for k in order:
        c, s = cs[k], ss[k]
        if c != _ONE or s != _ZERO:
            j = j0 + k
            for row in Z:
                t = row[j + 1]
                row[j + 1] = c * t - s * row[j]
                row[j] = s * t + c * row[j]


def _steqr(d: list, e: list):
    """``SSTEQR('I')`` at n = 3 (the QL or QR implicit iteration, blocks
    split where e is negligible, a block scaled into range first, the
    eigenvalues sorted ascending by selection): (d, Z) with Z's columns the
    eigenvectors of the tridiagonal (d, e)."""
    n, eps2 = 3, _EPS * _EPS
    ssfmax = np.sqrt(_ONE / _SAFMIN) / _f(3)
    ssfmin = np.sqrt(_SAFMIN) / eps2
    Z = [[_ONE if i == j else _ZERO for j in range(n)] for i in range(n)]
    nmaxit, jtot, l1 = n * 30, 0, 0
    while l1 <= n - 1:
        if l1 > 0:
            e[l1 - 1] = _ZERO
        m = n - 1
        for k in range(l1, n - 1):
            tst = abs(e[k])
            if tst == 0:
                m = k
                break
            if tst <= (np.sqrt(abs(d[k])) * np.sqrt(abs(d[k + 1]))) * _EPS:
                e[k] = _ZERO
                m = k
                break
        l = lsv = l1
        lend = lendsv = m
        l1 = m + 1
        if lend == l:
            continue
        anorm = _ZERO
        for x in d[l:lend + 1] + e[l:lend]:
            if anorm < abs(x) or np.isnan(x):
                anorm = abs(x)
        if anorm == 0:
            continue
        to = ssfmax if anorm > ssfmax else ssfmin if anorm < ssfmin else None
        if to is not None:
            for mul in _scale_steps(anorm, to):
                d[l:lend + 1] = [x * mul for x in d[l:lend + 1]]
                e[l:lend] = [x * mul for x in e[l:lend]]
        if abs(d[lend]) < abs(d[l]):
            lend, l = lsv, lendsv
        step = 1 if lend > l else -1          # QL down, QR up
        while True:
            # a negligible off-diagonal entry between l and lend
            m = lend
            for k in range(l, lend, step):
                ek = e[k] if step > 0 else e[k - 1]
                if abs(ek) * abs(ek) <= (eps2 * abs(d[k])) \
                        * abs(d[k + step]) + _SAFMIN:
                    m = k
                    break
            if m != lend:
                e[m if step > 0 else m - 1] = _ZERO
            p = d[l]
            if m == l:                        # an eigenvalue found
                l += step
                if (l - lend) * step <= 0:
                    continue
                break
            if m == l + step:                 # a 2x2 block
                lo = min(l, m)
                rt1, rt2, c, s = _laev2(d[lo], e[lo], d[lo + 1])
                _rotate(Z, lo, [c], [s], step > 0)
                d[lo], d[lo + 1], e[lo] = rt1, rt2, _ZERO
                l += 2 * step
                if (l - lend) * step <= 0:
                    continue
                break
            if jtot == nmaxit:
                break
            jtot += 1
            # the shift, then the chase from m back to l
            el = e[l] if step > 0 else e[l - 1]
            g = (d[l + step] - p) / (_TWO * el)
            r = _lapy2(g, _ONE)
            g = d[m] - p + (el / (g + _sign(r, g)))
            s, c, p = _ONE, _ONE, _ZERO
            cs, ss = [], []
            for i in (range(m - 1, l - 1, -1) if step > 0 else range(m, l)):
                f, b = s * e[i], c * e[i]
                c, s, r = _lartg(g, f)
                if i != m - step if step > 0 else i != m:
                    e[i + 1 if step > 0 else i - 1] = r
                g = d[i + step if step > 0 else i] - p
                r = (d[i if step > 0 else i + 1] - g) * s + _TWO * c * b
                p = s * r
                d[i + 1 if step > 0 else i] = g + p
                g = c * r - b
                cs.append(c)
                ss.append(-s if step > 0 else s)
            if step > 0:
                _rotate(Z, l, cs[::-1], ss[::-1], True)
            else:
                _rotate(Z, m, cs, ss, False)
            d[l] = d[l] - p
            e[l if step > 0 else l - 1] = g
        if to is not None:
            for mul in _scale_steps(to, anorm):
                d[lsv:lendsv + 1] = [x * mul for x in d[lsv:lendsv + 1]]
                e[lsv:lendsv] = [x * mul for x in e[lsv:lendsv]]
        if jtot >= nmaxit:
            return d, Z                       # no convergence: unsorted
    for i in range(n - 1):                    # selection sort
        k, p = i, d[i]
        for j in range(i + 1, n):
            if d[j] < p:
                k, p = j, d[j]
        if k != i:
            d[k], d[i] = d[i], p
            for row in Z:
                row[i], row[k] = row[k], row[i]
    return d, Z


def syevd3(A) -> Tuple[list, list]:
    """``ssyevd(JOBZ='V', UPLO='L')`` of one symmetric 3x3 (its lower
    triangle read): (eigenvalues ascending, Z) with Z[i][k] entry i of
    eigenvector k, the bits and signs ``jnp.linalg.eigh`` gives on the
    reference host."""
    a = [[_f(A[i][j]) for j in range(3)] for i in range(3)]
    small = _SAFMIN / _f(2.0 ** -23)               # slamch('P')
    rmin, rmax = np.sqrt(small), np.sqrt(_ONE / small)
    anrm = _ZERO
    for j in range(3):
        for i in range(j, 3):
            if anrm < abs(a[i][j]) or np.isnan(a[i][j]):
                anrm = abs(a[i][j])
    sigma = rmin / anrm if _ZERO < anrm < rmin else \
        rmax / anrm if anrm > rmax else None
    if sigma is not None:
        for mul in _scale_steps(_ONE, sigma):
            for j in range(3):
                for i in range(j, 3):
                    a[i][j] = a[i][j] * mul
    # ssytd2: H = I - tau v v^T (v = (1, x)) zeroes a[2][0]
    alpha, x, tau = a[1][0], a[2][0], _ZERO
    if abs(x) != 0:                           # slarfg(2, alpha, x)
        beta = -_sign(_lapy2(alpha, abs(x)), alpha)
        tiny, knt = _SAFMIN / _EPS, 0
        if abs(beta) < tiny:
            while True:
                knt += 1
                x, beta, alpha = x / tiny, beta / tiny, alpha / tiny
                if not (abs(beta) < tiny and knt < 20):
                    break
            beta = -_sign(_lapy2(alpha, abs(x)), alpha)
        tau = (beta - alpha) / beta
        x = x * (_ONE / (alpha - beta))
        for _ in range(knt):
            beta = beta * tiny
        alpha = beta
    e0 = alpha
    if tau != 0:
        a11, a21, a22 = a[1][1], a[2][1], a[2][2]
        # ssymv (OpenBLAS's lower kernel), then the pair dot, saxpy, ssyr2
        t1 = tau * _ONE
        y0, y1 = t1 * a11, t1 * a21
        y0 = fma1(tau, a21 * x, y0)
        y1 = fma1(tau * x, a22, y1)
        alpha2 = ((-_HALF) * tau) * (_ZERO + fma1(y0, _ONE, y1 * x))
        w0, w1 = fma1(alpha2, _ONE, y0), fma1(alpha2, x, y1)
        a11 = fma1(-w0, _ONE, fma1(-_ONE, w0, a11))
        a21 = fma1(-w0, x, fma1(-_ONE, w1, a21))
        a22 = fma1(-w1, x, fma1(-x, w1, a22))
        a[1][1], a[2][1], a[2][2] = a11, a21, a22
    d, Z = _steqr([a[0][0], a[1][1], a[2][2]], [e0, a[2][1]])
    if tau != 0:
        # sorm2r: rows 1, 2 of Z times H (sgemv_t's pair dot, sger's FMAs)
        lastv = 2 if x != 0 else 1
        lastc = 0
        for j in range(2, -1, -1):
            if any(Z[1 + i][j] != 0 for i in range(lastv)):
                lastc = j + 1
                break
        for j in range(lastc):
            w = fma1(Z[1][j], _ONE, Z[2][j] * x) if lastv == 2 else Z[1][j]
            t = (-tau) * w
            Z[1][j] = fma1(t, _ONE, Z[1][j])
            if lastv == 2:
                Z[2][j] = fma1(t, x, Z[2][j])
    if sigma is not None:
        d = [v * (_ONE / sigma) for v in d]
    return d, Z


def smallest_eigenvector_torch(cov: torch.Tensor) -> torch.Tensor:
    """Column 0 of ``jnp.linalg.eigh(cov)[1]`` for float32 (..., 3, 3)
    ``cov``, bit for bit and sign for sign: the symmetrised matrix ((a +
    a^T) / 2, as ``eigh`` takes it), then :func:`syevd3` a matrix at a
    time."""
    sym = (cov + cov.transpose(-1, -2)) / 2
    flat = sym.detach().to("cpu", torch.float32).reshape(-1, 3, 3).numpy()
    out = np.empty((len(flat), 3), np.float32)
    for i, a in enumerate(flat):
        _, Z = syevd3(a)
        out[i] = [Z[0][0], Z[1][0], Z[2][0]]
    return torch.from_numpy(out).reshape(cov.shape[:-1]).to(cov.device)


__all__ = ["SFMIN", "fma1", "lu_solve", "smallest_eigenvector_torch",
           "syevd3"]
