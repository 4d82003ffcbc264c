// Device code of the 2D path's mirror pose (M1) and model normal (M2),
// shared by csrc/mirror.cu (their own entry points) and csrc/consensus.cu
// (kernel R1, which runs both inside its selection block). See mirror.cu
// for what they replace and how they round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace tod_mirror {

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}

// transforms.dot3: (u0 v0 + u1 v1) + u2 v2
__device__ __forceinline__ float dot3f(const float* u, const float* v) {
  return fadd(fadd(fmul(u[0], v[0]), fmul(u[1], v[1])), fmul(u[2], v[2]));
}

// detection2d._dot3_chain (XLA's row-major gemv): fma(u2, v2, fma(u1, v1,
// u0 v0))
__device__ __forceinline__ float dot3_chain(const float* u, const float* v) {
  return __fmaf_rn(u[2], v[2], __fmaf_rn(u[1], v[1], fmul(u[0], v[0])));
}

// detection2d._matmul3_chain (XLA's emitted batched dot): entry (i, j) is
// fma(a_i2, b_2j, fma(a_i1, b_1j, a_i0 b_0j))
__device__ __forceinline__ void matmul3_chain(const float* a, const float* b,
                                              float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = __fmaf_rn(a[3 * i + 2], b[6 + j],
                               __fmaf_rn(a[3 * i + 1], b[3 + j],
                                         fmul(a[3 * i], b[j])));
}

// torch.clamp_min(x, lo): lo below it, a NaN kept
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// mirror_poses_torch for one pose: R (3x3, row-major), T and the object's
// normal n; writes Q @ R and T
__device__ void mirror_one(const float* __restrict__ R,
                           const float* __restrict__ T,
                           const float* __restrict__ n,
                           float* __restrict__ R_out,
                           float* __restrict__ T_out) {
  float r[9], t[3], nm[3];
  for (int k = 0; k < 9; ++k) r[k] = R[k];
  for (int k = 0; k < 3; ++k) t[k] = T[k], nm[k] = n[k];
  float n_c[3];
  for (int i = 0; i < 3; ++i) n_c[i] = dot3_chain(r + 3 * i, nm);
  const float t_norm = clamp_min(__fsqrt_rn(dot3_chain(t, t)), 1e-9f);
  float v[3];
  for (int i = 0; i < 3; ++i) v[i] = __fdiv_rn(t[i], t_norm);
  const float d2 = fmul(dot3f(n_c, v), 2.0f);
  // x and y contracted, z not (the reference's vectorised loop)
  const float n_ref[3] = {__fmaf_rn(d2, v[0], -n_c[0]),
                          __fmaf_rn(d2, v[1], -n_c[1]),
                          fsub(fmul(d2, v[2]), n_c[2])};
  float axis[3];                           // fma(a, b, -(c d)) an entry
  axis[0] = __fmaf_rn(n_c[1], n_ref[2], -fmul(n_c[2], n_ref[1]));
  axis[1] = __fmaf_rn(n_c[2], n_ref[0], -fmul(n_c[0], n_ref[2]));
  axis[2] = __fmaf_rn(n_c[0], n_ref[1], -fmul(n_c[1], n_ref[0]));
  const float s = __fsqrt_rn(dot3_chain(axis, axis));
  float c = dot3f(n_c, n_ref);             // torch.clamp(c, -1, 1)
  c = c < -1.0f ? -1.0f : (c > 1.0f ? 1.0f : c);
  const float s_div = clamp_min(s, 1e-9f);
  float a[3];
  for (int i = 0; i < 3; ++i) a[i] = __fdiv_rn(axis[i], s_div);
  // pnp.skew: +0 on the diagonal, the others negated or not
  const float ax[9] = {0.0f, -a[2], a[1], a[2], 0.0f, -a[0],
                       -a[1], a[0], 0.0f};
  float sn, cs;
  tod_libm::sincosf_libm(tod_libm::atan2f_libm(s, c), &sn, &cs);
  float ax2[9];
  matmul3_chain(ax, ax, ax2);
  const float one_c = fsub(1.0f, cs);
  float q[9];
  const bool turn = s > 1e-6f;
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    // fma(1 - cos, ax ax, eye + sin ax), or eye where s <= 1e-6
    q[k] = turn ? __fmaf_rn(one_c, ax2[k], fadd(eye, fmul(sn, ax[k])))
                : eye;
  }
  float out[9];
  matmul3_chain(q, r, out);
  for (int k = 0; k < 9; ++k) R_out[k] = out[k];
  for (int k = 0; k < 3; ++k) T_out[k] = t[k];
}

// ---- M2: LAPACK's ssyevd (JOBZ = 'V', UPLO = 'L') at n = 3, as
// geometry/lapack.py syevd3 transcribes it (the reference's
// jnp.linalg.eigh on its host: the Fortran unfused, OpenBLAS's BLAS
// kernels with their FMAs). Every operation an __f*_rn in the Fortran's
// order; the QL/QR iteration data-dependent, a thread a matrix.

constexpr float kOne = 1.0f, kZero = 0.0f, kHalf = 0.5f, kTwo = 2.0f;
constexpr float kEps = 5.9604644775390625e-08f;       // slamch('E') = 2^-24
constexpr float kSafmin = 1.17549435082228751e-38f;   // slamch('S') = 2^-126
constexpr float kHuge = 3.40282346638528860e+38f;

__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float fsqrt(float a) { return __fsqrt_rn(a); }
// Fortran SIGN(a, b): |a| with b's sign bit
__device__ __forceinline__ float fsign(float a, float b) {
  return signbit(b) ? -fabsf(a) : fabsf(a);
}

// SLASCL's multipliers for cto / cfrom, applied in turn to x[0..n)
__device__ void lascl(float cfrom, float cto, float* x, int n) {
  const float small = kSafmin, big = fdiv(kOne, kSafmin);
  float cfromc = cfrom, ctoc = cto;
  for (;;) {
    float mul;
    bool done = true;
    const float cfrom1 = fmul(cfromc, small);
    if (cfrom1 == cfromc) {
      mul = fdiv(ctoc, cfromc);
    } else {
      const float cto1 = fdiv(ctoc, big);
      if (cto1 == ctoc) {
        mul = ctoc;
      } else if (fabsf(cfrom1) > fabsf(ctoc) && ctoc != 0.0f) {
        mul = small;
        done = false;
        cfromc = cfrom1;
      } else if (fabsf(cto1) > fabsf(cfromc)) {
        mul = big;
        done = false;
        ctoc = cto1;
      } else {
        mul = fdiv(ctoc, cfromc);
        if (mul == kOne) return;
      }
    }
    for (int k = 0; k < n; ++k) x[k] = fmul(x[k], mul);
    if (done) return;
  }
}

__device__ float lapy2(float x, float y) {
  if (isnan(x)) return x;
  if (isnan(y)) return y;
  const float xa = fabsf(x), ya = fabsf(y);
  const float w = xa < ya ? ya : xa, z = ya < xa ? ya : xa;
  if (z == 0.0f || w > kHuge) return w;
  const float t = fdiv(z, w);
  return fmul(w, fsqrt(fadd(kOne, fmul(t, t))));
}

// SLARTG: [c s; -s c] [f; g] = [r; 0]
__device__ void lartg(float f, float g, float* c, float* s, float* r) {
  const float rtmin = 1.08420217e-19f;                 // sqrt(2^-126)
  const float rtmax = fsqrt(fdiv(8.50705917e+37f, kTwo));   // sqrt(2^125)
  const float f1 = fabsf(f), g1 = fabsf(g);
  if (g == 0.0f) {
    *c = kOne; *s = kZero; *r = f;
  } else if (f == 0.0f) {
    *c = kZero; *s = fsign(kOne, g); *r = g1;
  } else if (f1 > rtmin && f1 < rtmax && g1 > rtmin && g1 < rtmax) {
    const float d = fsqrt(fadd(fmul(f, f), fmul(g, g)));
    *c = fdiv(f1, d);
    *r = fsign(d, f);
    *s = fdiv(g, *r);
  } else {
    float u = kSafmin;                   // min(safmax, max(safmin, f1, g1))
    if (f1 > u) u = f1;
    if (g1 > u) u = g1;
    if (8.50705917e+37f < u) u = 8.50705917e+37f;
    const float fs = fdiv(f, u), gs = fdiv(g, u);
    const float d = fsqrt(fadd(fmul(fs, fs), fmul(gs, gs)));
    *c = fdiv(fabsf(fs), d);
    const float rr = fsign(d, f);
    *s = fdiv(gs, rr);
    *r = fmul(rr, u);
  }
}

// SLAEV2: the eigensystem of [a b; b c]
__device__ void laev2(float a, float b, float c, float* rt1, float* rt2,
                      float* cs1, float* sn1) {
  const float sm = fadd(a, c), df = fsub(a, c), adf = fabsf(df);
  const float tb = fadd(b, b), ab = fabsf(tb);
  const bool big_a = fabsf(a) > fabsf(c);
  const float acmx = big_a ? a : c, acmn = big_a ? c : a;
  float rt;
  if (adf > ab) {
    const float t = fdiv(ab, adf);
    rt = fmul(adf, fsqrt(fadd(kOne, fmul(t, t))));
  } else if (adf < ab) {
    const float t = fdiv(adf, ab);
    rt = fmul(ab, fsqrt(fadd(kOne, fmul(t, t))));
  } else {
    rt = fmul(ab, 1.41421354f);                          // SQRT(TWO)
  }
  int sgn1;
  if (sm < 0.0f) {
    *rt1 = fmul(kHalf, fsub(sm, rt));
    sgn1 = -1;
    *rt2 = fsub(fmul(fdiv(acmx, *rt1), acmn), fmul(fdiv(b, *rt1), b));
  } else if (sm > 0.0f) {
    *rt1 = fmul(kHalf, fadd(sm, rt));
    sgn1 = 1;
    *rt2 = fsub(fmul(fdiv(acmx, *rt1), acmn), fmul(fdiv(b, *rt1), b));
  } else {
    *rt1 = fmul(kHalf, rt);
    *rt2 = fmul(-kHalf, rt);
    sgn1 = 1;
  }
  const int sgn2 = df >= 0.0f ? 1 : -1;
  const float cs = df >= 0.0f ? fadd(df, rt) : fsub(df, rt);
  float c1, s1;
  if (fabsf(cs) > ab) {
    const float ct = fdiv(-tb, cs);
    s1 = fdiv(kOne, fsqrt(fadd(kOne, fmul(ct, ct))));
    c1 = fmul(ct, s1);
  } else if (ab == 0.0f) {
    c1 = kOne;
    s1 = kZero;
  } else {
    const float tn = fdiv(-cs, tb);
    c1 = fdiv(kOne, fsqrt(fadd(kOne, fmul(tn, tn))));
    s1 = fmul(tn, c1);
  }
  if (sgn1 == sgn2) {
    *cs1 = -s1;
    *sn1 = c1;
  } else {
    *cs1 = c1;
    *sn1 = s1;
  }
}

// SLASR('R', 'V', 'B' or 'F'): rotation k (0 <= k < nrot) mixes columns
// j0 + k and j0 + k + 1 of Z, the last first when backward
__device__ void rotate(float Z[3][3], int j0, const float* cs,
                       const float* ss, int nrot, bool backward) {
  for (int q = 0; q < nrot; ++q) {
    const int k = backward ? nrot - 1 - q : q;
    const float c = cs[k], s = ss[k];
    if (c != kOne || s != kZero) {
      const int j = j0 + k;
      for (int i = 0; i < 3; ++i) {
        const float t = Z[i][j + 1];
        Z[i][j + 1] = fsub(fmul(c, t), fmul(s, Z[i][j]));
        Z[i][j] = fadd(fmul(s, t), fmul(c, Z[i][j]));
      }
    }
  }
}

// SSTEQR('I') at n = 3 on (d, e); Z's columns the eigenvectors, sorted
__device__ void steqr(float d[3], float e[2], float Z[3][3]) {
  const int n = 3;
  const float eps2 = fmul(kEps, kEps);
  const float ssfmax = fdiv(fsqrt(fdiv(kOne, kSafmin)), 3.0f);
  const float ssfmin = fdiv(fsqrt(kSafmin), eps2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Z[i][j] = i == j ? kOne : kZero;
  const int nmaxit = n * 30;
  int jtot = 0, l1 = 0;
  while (l1 <= n - 1) {
    if (l1 > 0) e[l1 - 1] = kZero;
    int m = n - 1;
    for (int k = l1; k < n - 1; ++k) {
      const float tst = fabsf(e[k]);
      if (tst == 0.0f) { m = k; break; }
      if (tst <= fmul(fmul(fsqrt(fabsf(d[k])), fsqrt(fabsf(d[k + 1]))),
                      kEps)) {
        e[k] = kZero;
        m = k;
        break;
      }
    }
    int l = l1, lsv = l1, lend = m, lendsv = m;
    l1 = m + 1;
    if (lend == l) continue;
    float anorm = kZero;
    for (int k = l; k <= lend; ++k)
      if (anorm < fabsf(d[k]) || isnan(d[k])) anorm = fabsf(d[k]);
    for (int k = l; k < lend; ++k)
      if (anorm < fabsf(e[k]) || isnan(e[k])) anorm = fabsf(e[k]);
    if (anorm == 0.0f) continue;
    const int iscale = anorm > ssfmax ? 1 : (anorm < ssfmin ? 2 : 0);
    const float to = iscale == 1 ? ssfmax : ssfmin;
    if (iscale) {
      lascl(anorm, to, d + l, lend - l + 1);
      lascl(anorm, to, e + l, lend - l);
    }
    if (fabsf(d[lend]) < fabsf(d[l])) {
      lend = lsv;
      l = lendsv;
    }
    const int step = lend > l ? 1 : -1;           // QL down, QR up
    for (;;) {
      m = lend;
      for (int k = l; k != lend; k += step) {
        const float ek = fabsf(step > 0 ? e[k] : e[k - 1]);
        if (fmul(ek, ek) <= fadd(fmul(fmul(eps2, fabsf(d[k])),
                                      fabsf(d[k + step])), kSafmin)) {
          m = k;
          break;
        }
      }
      if (m != lend) e[step > 0 ? m : m - 1] = kZero;
      float p = d[l];
      if (m == l) {                               // an eigenvalue found
        l += step;
        if ((l - lend) * step <= 0) continue;
        break;
      }
      if (m == l + step) {                        // a 2x2 block
        const int lo = l < m ? l : m;
        float rt1, rt2, c, s;
        laev2(d[lo], e[lo], d[lo + 1], &rt1, &rt2, &c, &s);
        rotate(Z, lo, &c, &s, 1, step > 0);
        d[lo] = rt1;
        d[lo + 1] = rt2;
        e[lo] = kZero;
        l += 2 * step;
        if ((l - lend) * step <= 0) continue;
        break;
      }
      if (jtot == nmaxit) break;
      ++jtot;
      // the shift, then the chase from m back to l
      const float el = step > 0 ? e[l] : e[l - 1];
      float g = fdiv(fsub(d[l + step], p), fmul(kTwo, el));
      float r = lapy2(g, kOne);
      g = fadd(fsub(d[m], p), fdiv(el, fadd(g, fsign(r, g))));
      float s = kOne, c = kOne;
      p = kZero;
      float cs[2], ss[2];
      int nrot = 0;
      for (int i = step > 0 ? m - 1 : m; step > 0 ? i >= l : i < l;
           i += step > 0 ? -1 : 1) {
        const float f = fmul(s, e[i]), b = fmul(c, e[i]);
        lartg(g, f, &c, &s, &r);
        if (i != m - (step > 0 ? 1 : 0)) e[step > 0 ? i + 1 : i - 1] = r;
        const int lo = step > 0 ? i : i + 1;     // D(I) QL, D(I+1) QR
        const int up = step > 0 ? i + 1 : i;     // the entry updated
        g = fsub(d[up], p);
        r = fadd(fmul(fsub(d[lo], g), s), fmul(fmul(kTwo, c), b));
        p = fmul(s, r);
        d[up] = fadd(g, p);
        g = fsub(fmul(c, r), b);
        cs[nrot] = c;
        ss[nrot] = step > 0 ? -s : s;
        ++nrot;
      }
      if (step > 0) {                             // saved from m - 1 down
        const float c0 = cs[0], s0 = ss[0];
        if (nrot == 2) {
          cs[0] = cs[1]; ss[0] = ss[1]; cs[1] = c0; ss[1] = s0;
        }
        rotate(Z, l, cs, ss, nrot, true);
      } else {
        rotate(Z, m, cs, ss, nrot, false);
      }
      d[l] = fsub(d[l], p);
      e[step > 0 ? l : l - 1] = g;
    }
    if (iscale) {
      lascl(to, anorm, d + lsv, lendsv - lsv + 1);
      lascl(to, anorm, e + lsv, lendsv - lsv);
    }
    if (jtot >= nmaxit) return;                   // no convergence: unsorted
  }
  for (int i = 0; i < n - 1; ++i) {               // selection sort
    int k = i;
    float p = d[i];
    for (int j = i + 1; j < n; ++j)
      if (d[j] < p) { k = j; p = d[j]; }
    if (k != i) {
      d[k] = d[i];
      d[i] = p;
      for (int r = 0; r < 3; ++r) {
        const float t = Z[r][i];
        Z[r][i] = Z[r][k];
        Z[r][k] = t;
      }
    }
  }
}

// syevd3's column 0 for one float32 matrix (row-major), symmetrised first
// ((a + a^T) / 2, as jnp.linalg.eigh takes it): the exact bits and sign
// of jnp.linalg.eigh(cov)[1][:, 0] on the reference host
__device__ void sym3_one(const float* __restrict__ cov,
                         float* __restrict__ out) {
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = fdiv(fadd(cov[3 * i + j], cov[3 * j + i]), 2.0f);
  const float small = fdiv(kSafmin, 1.1920928955078125e-07f);   // / 2^-23
  const float rmin = fsqrt(small), rmax = fsqrt(fdiv(kOne, small));
  float anrm = kZero;
  for (int j = 0; j < 3; ++j)
    for (int i = j; i < 3; ++i)
      if (anrm < fabsf(a[i][j]) || isnan(a[i][j])) anrm = fabsf(a[i][j]);
  float sigma = kOne;
  const bool scaled = (anrm > 0.0f && anrm < rmin) || anrm > rmax;
  if (scaled) {
    sigma = anrm > rmax ? fdiv(rmax, anrm) : fdiv(rmin, anrm);
    float low[6] = {a[0][0], a[1][0], a[2][0], a[1][1], a[2][1], a[2][2]};
    lascl(kOne, sigma, low, 6);
    a[0][0] = low[0]; a[1][0] = low[1]; a[2][0] = low[2];
    a[1][1] = low[3]; a[2][1] = low[4]; a[2][2] = low[5];
  }
  // ssytd2: slarfg(2, a10, a20), then ssymv, the dot, saxpy, ssyr2
  float alpha = a[1][0], x = a[2][0], tau = kZero;
  if (fabsf(x) != 0.0f) {
    float beta = -fsign(lapy2(alpha, fabsf(x)), alpha);
    const float tiny = fdiv(kSafmin, kEps);
    int knt = 0;
    if (fabsf(beta) < tiny) {
      do {
        ++knt;
        x = fdiv(x, tiny);
        beta = fdiv(beta, tiny);
        alpha = fdiv(alpha, tiny);
      } while (fabsf(beta) < tiny && knt < 20);
      beta = -fsign(lapy2(alpha, fabsf(x)), alpha);
    }
    tau = fdiv(fsub(beta, alpha), beta);
    x = fmul(x, fdiv(kOne, fsub(alpha, beta)));
    for (int k = 0; k < knt; ++k) beta = fmul(beta, tiny);
    alpha = beta;
  }
  const float e0 = alpha;
  if (tau != 0.0f) {
    float a11 = a[1][1], a21 = a[2][1], a22 = a[2][2];
    const float t1 = fmul(tau, kOne);
    float y0 = fmul(t1, a11), y1 = fmul(t1, a21);
    y0 = __fmaf_rn(tau, fmul(a21, x), y0);
    y1 = __fmaf_rn(fmul(tau, x), a22, y1);
    const float dotv = fadd(kZero, __fmaf_rn(y0, kOne, fmul(y1, x)));
    const float al = fmul(fmul(-kHalf, tau), dotv);
    const float w0 = __fmaf_rn(al, kOne, y0), w1 = __fmaf_rn(al, x, y1);
    a11 = __fmaf_rn(-w0, kOne, __fmaf_rn(-kOne, w0, a11));
    a21 = __fmaf_rn(-w0, x, __fmaf_rn(-kOne, w1, a21));
    a22 = __fmaf_rn(-w1, x, __fmaf_rn(-x, w1, a22));
    a[1][1] = a11; a[2][1] = a21; a[2][2] = a22;
  }
  float d[3] = {a[0][0], a[1][1], a[2][2]}, e[2] = {e0, a[2][1]};
  float Z[3][3];
  steqr(d, e, Z);
  if (tau != 0.0f) {
    // sorm2r: rows 1, 2 of Z times H (sgemv_t's pair dot, sger's FMAs)
    const int lastv = x != 0.0f ? 2 : 1;
    int lastc = 0;
    for (int j = 2; j >= 0 && !lastc; --j)
      if (Z[1][j] != 0.0f || (lastv == 2 && Z[2][j] != 0.0f)) lastc = j + 1;
    for (int j = 0; j < lastc; ++j) {
      const float w = lastv == 2 ? __fmaf_rn(Z[1][j], kOne, fmul(Z[2][j], x))
                                 : Z[1][j];
      const float t = fmul(-tau, w);
      Z[1][j] = __fmaf_rn(t, kOne, Z[1][j]);
      if (lastv == 2) Z[2][j] = __fmaf_rn(t, x, Z[2][j]);
    }
  }
  for (int i = 0; i < 3; ++i) out[i] = Z[i][0];
}

}  // namespace tod_mirror
