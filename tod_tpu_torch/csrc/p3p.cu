// Grunert's P3P on Hopper, rounded as the port's plain version rounds it.
//
// P1 tod_p3p replaces, on the card, the elementwise arithmetic of the
// reference's P3P (tod_tpu/geometry/pnp.py:119-222 p3p under jax.vmap):
// not a Pallas kernel, but XLA's fusions of the side lengths and cosines,
// the quartic's five coefficients, Ferrari's solution (Cardano and its
// trigonometric branch, the cube root through powf, arccos as XLA compiles
// chlo.acos, atan2f(sqrt((1 - x)(1 + x)), x), the cosine through cosf),
// the six Newton polishes of the roots, the two back-substitution branches,
// the eight 3x3 Newton steps on the cosine-law system and the residual
// gate. It returns the (n, 8, 3) distances and their validity; the Horn
// fit stays in PyTorch (geometry/transforms.py kabsch, fixed order).
//
// Rounding: every float operation is an explicit __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn / __fsqrt_rn / __fmaf_rn, in the order of the
// reference's Python expressions (left to right, integer powers as jax
// expands them, A ** 3 = A * (A * A)). The side lengths are the compiled
// reference's FMA chain, read off its object code
// (tools/fit_p3p_order.py); every later stage is unfused, though XLA's CPU
// backend contracts multiply-adds in its fusions from the quartic's
// coefficients on (ROADMAP queue C: P3P parts from the reference there). The libm calls are glibc 2.36's FMA builds (libm_f32.cuh). The
// 3x3 solve is an LU with partial pivoting in LAPACK getf2's order (the
// column scaled by the pivot's reciprocal, rank-1 updates applied to the
// right-hand side as well, then the back substitution by columns dividing
// by the diagonal: pnp.py lu_solve). The plain version is
// tod_tpu_torch/geometry/pnp.py p3p_distances_torch: the CPU path, the
// same operations in the same order, so both devices give the same bits.
//
// Design: one thread a sample, its 3 bearings and 3 points in registers,
// its 4 roots and 8 candidates in turn (~2,000 float operations and four
// libm calls a sample against 72 bytes read and 104 written: the float
// rate bounds it, but at the 2D path's 8,192 samples a chunk the launch
// and the serial chain of one thread do).

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsq(float a) { return __fsqrt_rn(a); }
// the plain version's torch.clamp_min(x, c): c only where x < c (NaN and
// -0 against +0 keep x)
__device__ __forceinline__ float maxc(float x, float c) {
  return x < c ? c : x;
}
// torch.maximum: NaN propagates, the first operand on a tie
__device__ __forceinline__ float maxnan(float x, float y) {
  return x != x ? x : (y != y ? y : (x < y ? y : x));
}
// torch.clamp(x, -1, 1)
__device__ __forceinline__ float clip11(float x) {
  return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
}
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
__device__ __forceinline__ float cbrt_ref(float x) {   // sign(x) |x|^(1/3)
  return fm(sign_of(x), tod_libm::powf_libm(fabsf(x), 1.0f / 3.0f));
}
__device__ __forceinline__ bool is_fin(float x) { return isfinite(x); }

__device__ void solve_quartic(float c4, float c3, float c2, float c1,
                              float c0, float roots[4]) {
  const float a = fd(c3, c4);
  const float b = fd(c2, c4);
  const float c = fd(c1, c4);
  const float d = fd(c0, c4);
  const float p = fs(b, fd(fm(fm(3.0f, a), a), 8.0f));
  const float q = fa(fs(c, fd(fm(a, b), 2.0f)), fd(fm(fm(a, a), a), 8.0f));
  const float r = fs(fa(fs(d, fd(fm(a, c), 4.0f)), fd(fm(fm(a, a), b), 16.0f)),
                     fd(fm(fm(fm(fm(3.0f, a), a), a), a), 256.0f));
  const float A = p;
  const float B = fs(fd(fm(p, p), 4.0f), r);
  const float C = fd(fm(-q, q), 8.0f);
  const float Q = fd(fs(fm(3.0f, B), fm(A, A)), 9.0f);
  const float R = fd(fs(fs(fm(fm(9.0f, A), B), fm(27.0f, C)),
                        fm(2.0f, fm(A, fm(A, A)))), 54.0f);
  const float Q3 = fm(Q, fm(Q, Q));
  const float D = fa(Q3, fm(R, R));
  const float sqrtD = fsq(maxc(D, 0.0f));
  const float m_pos = fs(fa(cbrt_ref(fa(R, sqrtD)), cbrt_ref(fs(R, sqrtD))),
                         fd(A, 3.0f));
  const float theta = tod_libm::acosf_xla(
      clip11(fd(R, fsq(maxc(-Q3, 1e-30f)))));
  const float m_neg = fs(fm(fm(2.0f, fsq(maxc(-Q, 0.0f))),
                            tod_libm::cosf_libm(fd(theta, 3.0f))),
                         fd(A, 3.0f));
  float m = D >= 0.0f ? m_pos : m_neg;
  m = maxc(m, 1e-12f);
  const float s = fsq(fm(2.0f, m));
  const float t0 = fs(fa(fd(p, 2.0f), m), fd(q, fm(2.0f, s)));
  const float t1 = fa(fa(fd(p, 2.0f), m), fd(q, fm(2.0f, s)));
  const float d0 = fs(fm(s, s), fm(4.0f, t0));
  const float d1 = fs(fm(s, s), fm(4.0f, t1));
  const float sq0 = fsq(maxc(d0, 0.0f));
  const float sq1 = fsq(maxc(d1, 0.0f));
  const float shift = fd(a, 4.0f);
  roots[0] = fs(fd(fa(-s, sq0), 2.0f), shift);
  roots[1] = fs(fd(fs(-s, sq0), 2.0f), shift);
  roots[2] = fs(fd(fa(s, sq1), 2.0f), shift);
  roots[3] = fs(fd(fs(s, sq1), 2.0f), shift);
  for (int it = 0; it < 6; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = roots[j];
      const float f = fa(fm(fa(fm(fa(fm(fa(fm(c4, x), c3), x), c2), x), c1), x),
                         c0);
      const float fp = fa(fm(fa(fm(fa(fm(fm(4.0f, c4), x), fm(3.0f, c3)), x),
                               fm(2.0f, c2)), x), c1);
      roots[j] = fs(x, fd(f, fabsf(fp) > 1e-12f ? fp : 1.0f));
    }
  }
}

// J delta = F for the Newton step, LU with partial pivoting
__device__ void solve3(float J[3][3], float F[3], float x[3]) {
  int p = 0;
  float best = fabsf(J[0][0]);
  if (fabsf(J[1][0]) > best) { p = 1; best = fabsf(J[1][0]); }
  if (fabsf(J[2][0]) > best) p = 2;
  if (p != 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t = J[0][k]; J[0][k] = J[p][k]; J[p][k] = t;
    }
    const float t = F[0]; F[0] = F[p]; F[p] = t;
  }
  const float rcp = fd(1.0f, J[0][0]);
  float l1 = fm(J[1][0], rcp);
  float l2 = fm(J[2][0], rcp);
  J[1][1] = fs(J[1][1], fm(l1, J[0][1]));
  J[1][2] = fs(J[1][2], fm(l1, J[0][2]));
  J[2][1] = fs(J[2][1], fm(l2, J[0][1]));
  J[2][2] = fs(J[2][2], fm(l2, J[0][2]));
  if (fabsf(J[2][1]) > fabsf(J[1][1])) {
#pragma unroll
    for (int k = 1; k < 3; ++k) {
      const float t = J[1][k]; J[1][k] = J[2][k]; J[2][k] = t;
    }
    float t = l1; l1 = l2; l2 = t;
    t = F[1]; F[1] = F[2]; F[2] = t;
  }
  const float rcp1 = fd(1.0f, J[1][1]);
  const float l21 = fm(J[2][1], rcp1);
  J[2][2] = fs(J[2][2], fm(l21, J[1][2]));
  const float y1 = fs(F[1], fm(l1, F[0]));
  const float y2 = fs(fs(F[2], fm(l2, F[0])), fm(l21, y1));
  x[2] = fd(y2, J[2][2]);
  x[1] = fd(fs(y1, fm(J[1][2], x[2])), J[1][1]);
  x[0] = fd(fs(fs(F[0], fm(J[0][2], x[2])), fm(J[0][1], x[1])), J[0][0]);
}

__device__ __forceinline__ void cosine_law(const float s[3], float ca,
                                           float cb, float cg, float a2,
                                           float b2, float c2, float F[3]) {
  F[0] = fs(fs(fa(fm(s[1], s[1]), fm(s[2], s[2])),
               fm(fm(fm(2.0f, s[1]), s[2]), ca)), a2);
  F[1] = fs(fs(fa(fm(s[0], s[0]), fm(s[2], s[2])),
               fm(fm(fm(2.0f, s[0]), s[2]), cb)), b2);
  F[2] = fs(fs(fa(fm(s[0], s[0]), fm(s[1], s[1])),
               fm(fm(fm(2.0f, s[0]), s[1]), cg)), c2);
}

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return fa(fa(fm(u[0], v[0]), fm(u[1], v[1])), fm(u[2], v[2]));
}

// |u - v| as XLA reduces it: sqrt(fma(d2, d2, fma(d1, d1, d0 d0)))
__device__ __forceinline__ float dist3(const float* u, const float* v) {
  const float d[3] = {fs(u[0], v[0]), fs(u[1], v[1]), fs(u[2], v[2])};
  return fsq(__fmaf_rn(d[2], d[2], __fmaf_rn(d[1], d[1], fm(d[0], d[0]))));
}

__global__ void __launch_bounds__(kThreads)
p3p_kernel(const float* __restrict__ bear, const float* __restrict__ pts,
           float* __restrict__ s_out, uint8_t* __restrict__ ok_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float f[9], P[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    f[k] = __ldg(bear + 9 * i + k);
    P[k] = __ldg(pts + 9 * i + k);
  }
  const float a = dist3(P + 3, P + 6);      // opposite P1
  const float b = dist3(P + 0, P + 6);      // opposite P2
  const float c = dist3(P + 0, P + 3);      // opposite P3
  const float ca = dot3(f + 3, f + 6);
  const float cb = dot3(f + 0, f + 6);
  const float cg = dot3(f + 0, f + 3);
  const float a2 = fm(a, a), b2 = fm(b, b), c2 = fm(c, c);
  const float Ar = fd(a2, b2);
  const float Br = fd(c2, b2);
  const float C4 = fa(fa(fs(fa(fs(fs(fm(Ar, Ar), fm(fm(2.0f, Ar), Br)), fm(2.0f, Ar)), fm(Br, Br)), fm(fm(fm(4.0f, Br), ca), ca)), fm(2.0f, Br)), 1.0f);
  const float C3 = fs(fs(fa(fa(fs(fa(fa(fa(fm(fm(fm(-4.0f, Ar), Ar), cb), fm(fm(fm(8.0f, Ar), Br), cb)), fm(fm(fm(4.0f, Ar), ca), cg)), fm(fm(4.0f, Ar), cb)), fm(fm(fm(4.0f, Br), Br), cb)), fm(fm(fm(fm(8.0f, Br), ca), ca), cb)), fm(fm(fm(4.0f, Br), ca), cg)), fm(fm(4.0f, Br), cb)), fm(fm(4.0f, ca), cg));
  const float C2 = fs(fa(fa(fs(fs(fa(fa(fs(fs(fs(fs(fa(fm(fm(fm(fm(4.0f, Ar), Ar), cb), cb), fm(fm(2.0f, Ar), Ar)), fm(fm(fm(fm(8.0f, Ar), Br), cb), cb)), fm(fm(4.0f, Ar), Br)), fm(fm(fm(fm(8.0f, Ar), ca), cb), cg)), fm(fm(fm(4.0f, Ar), cg), cg)), fm(fm(fm(fm(4.0f, Br), Br), cb), cb)), fm(fm(2.0f, Br), Br)), fm(fm(fm(4.0f, Br), ca), ca)), fm(fm(fm(fm(8.0f, Br), ca), cb), cg)), fm(fm(4.0f, ca), ca)), fm(fm(4.0f, cg), cg)), 2.0f);
  const float C1 = fs(fa(fa(fs(fs(fa(fa(fa(fm(fm(fm(-4.0f, Ar), Ar), cb), fm(fm(fm(8.0f, Ar), Br), cb)), fm(fm(fm(4.0f, Ar), ca), cg)), fm(fm(fm(fm(8.0f, Ar), cb), cg), cg)), fm(fm(4.0f, Ar), cb)), fm(fm(fm(4.0f, Br), Br), cb)), fm(fm(fm(4.0f, Br), ca), cg)), fm(fm(4.0f, Br), cb)), fm(fm(4.0f, ca), cg));
  const float C0 = fa(fs(fa(fa(fs(fs(fm(Ar, Ar), fm(fm(2.0f, Ar), Br)), fm(fm(fm(4.0f, Ar), cg), cg)), fm(2.0f, Ar)), fm(Br, Br)), fm(2.0f, Br)), 1.0f);
  float v[4];
  solve_quartic(C4, C3, C2, C1, C0, v);
  const float scale = maxnan(maxnan(a2, b2), c2);
  const float gate = fm(1e-4f, scale);
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const float g = maxc(fs(fa(1.0f, fm(v[j], v[j])), fm(fm(2.0f, v[j]), cb)),
                         1e-12f);
    const float s1 = fsq(fd(b2, g));
    const float disc = maxc(fs(fm(cg, cg), fs(1.0f, fm(Br, g))), 0.0f);
    const float sq = fsq(disc);
#pragma unroll 1
    for (int br = 0; br < 2; ++br) {
      const float u = br == 0 ? fa(cg, sq) : fs(cg, sq);
      float s[3] = {s1, fm(u, s1), fm(v[j], s1)};
#pragma unroll 1
      for (int it = 0; it < 8; ++it) {
        float F[3];
        cosine_law(s, ca, cb, cg, a2, b2, c2, F);
        float J[3][3] = {
            {1e-9f, fs(fm(2.0f, s[1]), fm(fm(2.0f, s[2]), ca)),
             fs(fm(2.0f, s[2]), fm(fm(2.0f, s[1]), ca))},
            {fs(fm(2.0f, s[0]), fm(fm(2.0f, s[2]), cb)), 1e-9f,
             fs(fm(2.0f, s[2]), fm(fm(2.0f, s[0]), cb))},
            {fs(fm(2.0f, s[0]), fm(fm(2.0f, s[1]), cg)),
             fs(fm(2.0f, s[1]), fm(fm(2.0f, s[0]), cg)), 1e-9f}};
        float delta[3];
        solve3(J, F, delta);
        if (is_fin(delta[0]) && is_fin(delta[1]) && is_fin(delta[2])) {
          s[0] = fs(s[0], delta[0]);
          s[1] = fs(s[1], delta[1]);
          s[2] = fs(s[2], delta[2]);
        }
      }
      float res[3];
      cosine_law(s, ca, cb, cg, a2, b2, c2, res);
      const bool solved = fabsf(res[0]) < gate && fabsf(res[1]) < gate
          && fabsf(res[2]) < gate;
      const bool ok = s[0] > 0.0f && s[1] > 0.0f && s[2] > 0.0f && solved
          && is_fin(s[0]) && is_fin(s[1]) && is_fin(s[2]);
      const int slot = br * 4 + j;
      float* o = s_out + (static_cast<int64_t>(i) * 8 + slot) * 3;
      o[0] = s[0];
      o[1] = s[1];
      o[2] = s[2];
      ok_out[static_cast<int64_t>(i) * 8 + slot] = ok ? 1 : 0;
    }
  }
}

}  // namespace

// For n samples: bearings (n, 3, 3) and points (n, 3, 3) float32 ->
// distances (n, 8, 3) float32 and validity (n, 8) uint8. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_p3p(const void* bearings, const void* points,
                       void* s_out, void* ok_out, int n, void* stream) {
  if (n <= 0) return 0;
  p3p_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bearings), static_cast<const float*>(points),
      static_cast<float*>(s_out), static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}
