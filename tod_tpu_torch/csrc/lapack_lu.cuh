// LAPACK's single-precision solve (sgetrf, then strsm twice) for small n,
// bit for bit as jnp.linalg.solve runs it on the reference host: scipy's
// OpenBLAS 0.3.30 on its SkylakeX core (read off against scipy by
// tools/fit_lapack_order.py; the plain version is
// tod_tpu_torch/geometry/lapack.py lu_solve, the same operations in the
// same order). Kernels P1 (csrc/p3p.cu, n = 3) and P2 (csrc/gauss_newton.cu,
// n = 6) include it.
//
// - The LU is OpenBLAS's left-looking getf2. Column j takes the earlier
//   row swaps. Rows 1 <= i < j subtract the strided sdot of L's row i and
//   the column: from +0, each pair of terms as fma(x0, y0, x1 y1), an odd
//   last product rounded and added. Rows r >= j subtract the GEMV tail's
//   FMA chain from +0 over k < j. The pivot is the first largest
//   magnitude. Its swap always reaches the later columns and the
//   right-hand side; columns 0..j swap, and the rows below scale by the
//   pivot's rounded reciprocal, only if its magnitude is at least FLT_MIN.
// - The triangular solves are OpenBLAS's generic TRSM kernels at unroll
//   16: the remainder's row blocks (powers of two) largest first going
//   down (lower, unit diagonal), smallest first going up (upper). Before a
//   block, its rows subtract the GEMM kernel's FMA chain over the rows
//   already solved; inside it each solved value updates the block's later
//   rows by fma(-x, l, c). The upper solve multiplies by the diagonal's
//   rounded reciprocal.
//
// Every index is a compile-time constant once the loops unroll, and the
// row swaps are selects, so the matrix stays in registers. A singular
// matrix gives non-finite entries, as an LU solve does.

#pragma once

#include <cuda_runtime.h>

namespace tod_lapack {

constexpr float kSfmin = 1.17549435e-38f;   // slamch('S')

// b := a^-1 b; a is overwritten by its LU. n <= 6: the orders read off
// (the dot, GEMV and TRSM kernels take other paths past it).
template <int N>
__device__ __forceinline__ void lu_solve(float a[N][N], float b[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 1; i < j; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m + 1 < i; m += 2)
        acc = __fadd_rn(acc, __fmaf_rn(a[i][m], a[m][j],
                                       __fmul_rn(a[i][m + 1], a[m + 1][j])));
      if (i & 1) acc = __fadd_rn(acc, __fmul_rn(a[i][i - 1], a[i - 1][j]));
      a[i][j] = __fsub_rn(a[i][j], acc);
    }
    if (j > 0) {
#pragma unroll
      for (int r = j; r < N; ++r) {
        float t = 0.0f;
#pragma unroll
        for (int k = 0; k < j; ++k) t = __fmaf_rn(a[r][k], a[k][j], t);
        a[r][j] = __fsub_rn(a[r][j], t);
      }
    }
    float best = fabsf(a[j][j]), pivot = a[j][j];
    int at = j;
#pragma unroll
    for (int r = j + 1; r < N; ++r) {
      if (fabsf(a[r][j]) > best) {
        best = fabsf(a[r][j]);
        pivot = a[r][j];
        at = r;
      }
    }
    const bool scale = fabsf(pivot) >= kSfmin;
#pragma unroll
    for (int r = j + 1; r < N; ++r) {
      const bool sw = at == r;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const bool s = c > j ? sw : (sw && scale);
        const float x = a[j][c], y = a[r][c];
        a[j][c] = s ? y : x;
        a[r][c] = s ? x : y;
      }
      const float x = b[j], y = b[r];
      b[j] = sw ? y : x;
      b[r] = sw ? x : y;
    }
    const float rcp = __frcp_rn(pivot);
#pragma unroll
    for (int r = j + 1; r < N; ++r)
      a[r][j] = scale ? __fmul_rn(a[r][j], rcp) : a[r][j];
  }
  // L y = P b, unit diagonal: blocks of 8, 4, 2, 1 from the top
  int s = 0;
#pragma unroll
  for (int h = 8; h >= 1; h >>= 1) {
    if (N & h) {
#pragma unroll
      for (int r = s; r < s + h; ++r) {
        if (s > 0) {
          float t = 0.0f;
#pragma unroll
          for (int k = 0; k < s; ++k) t = __fmaf_rn(a[r][k], b[k], t);
          b[r] = __fsub_rn(b[r], t);
        }
      }
#pragma unroll
      for (int i = s; i < s + h; ++i)
#pragma unroll
        for (int r = i + 1; r < s + h; ++r)
          b[r] = __fmaf_rn(-b[i], a[r][i], b[r]);
      s += h;
    }
  }
  // U x = y: blocks of 1, 2, 4, 8 from the bottom
  int e = N;
#pragma unroll
  for (int h = 1; h <= 8; h <<= 1) {
    if (N & h) {
#pragma unroll
      for (int r = e - h; r < e; ++r) {
        if (e < N) {
          float t = 0.0f;
#pragma unroll
          for (int k = e; k < N; ++k) t = __fmaf_rn(a[r][k], b[k], t);
          b[r] = __fsub_rn(b[r], t);
        }
      }
#pragma unroll
      for (int i = e - 1; i >= e - h; --i) {
        b[i] = __fmul_rn(b[i], __frcp_rn(a[i][i]));
#pragma unroll
        for (int r = e - h; r < i; ++r)
          b[r] = __fmaf_rn(-b[i], a[r][i], b[r]);
      }
      e -= h;
    }
  }
}

}  // namespace tod_lapack
