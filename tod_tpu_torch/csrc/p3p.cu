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
// (tools/fit_p3p_order.py), and so are the normalised coefficients
// C3/C4 .. C0/C4 (four fusions, read off by tools/fit_p3p_fusions.py); the
// 3x3 Newton solve is LAPACK's, as jnp.linalg.solve runs it on the
// reference host (lapack_lu.cuh, tools/fit_lapack_order.py). Ferrari's
// resolvent, the roots' polishes and the Newton steps' residuals and
// Jacobian are unfused here, though XLA's CPU backend contracts
// multiply-adds in those fusions too (ROADMAP queue C: P3P parts from the
// reference at the resolvent). The
// libm calls are glibc 2.36's FMA builds (libm_f32.cuh). The plain version
// is tod_tpu_torch/geometry/pnp.py p3p_distances_torch: the CPU path, the
// same operations in the same order, so both devices give the same bits.
//
// Design: a group of 4 lanes a sample, each lane one root and both its
// branches (slot = branch * 4 + root). Every lane of a group computes the
// sample's shared prefix itself (the sides, cosines, quartic coefficients
// and Ferrari's solution: the same operations in the same order, so the
// same bits, and no divergence within the group), then polishes its own
// root alone (the six Newton polishes of the four roots never mix them)
// and runs its two candidates' eight 3x3 Newton steps, the gate and the
// output slots. A warp then holds 8 samples; at the 2D path's 8,192-16,384
// samples a call is 33-66 k threads, against one serial chain of ~6,300
// float operations a thread before. The 3x3 solve pivots by selects on
// register values (no row indexed at run time), so nothing lives in local
// memory but the libm's indexed tables.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lapack_lu.cuh"
#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;          // lanes a sample: a root each

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

// Root j (0-3) of c4 x^4 + ... + c0 by Ferrari's method after its six
// Newton polishes: the port's solve_quartic restricted to one root (the
// polishes update each root from itself alone), from the normalised
// coefficients a = c3 / c4, b, c, d as quartic_normalized computes them.
__device__ float quartic_root(float c4, float c3, float c2, float c1,
                              float c0, float a, float b, float c, float d,
                              int j) {
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
  // roots 0, 1 from t0 = (p / 2 + m) - q / 2s, roots 2, 3 from t1 = ... +
  const float half = fa(fd(p, 2.0f), m), lean = fd(q, fm(2.0f, s));
  const float t = j < 2 ? fs(half, lean) : fa(half, lean);
  const float dd = fs(fm(s, s), fm(4.0f, t));
  const float sq = fsq(maxc(dd, 0.0f));
  const float base = j < 2 ? -s : s;
  float x = fs(fd((j & 1) ? fs(base, sq) : fa(base, sq), 2.0f), fd(a, 4.0f));
  for (int it = 0; it < 6; ++it) {
    const float f = fa(fm(fa(fm(fa(fm(fa(fm(c4, x), c3), x), c2), x), c1), x),
                       c0);
    const float fp = fa(fm(fa(fm(fa(fm(fm(4.0f, c4), x), fm(3.0f, c3)), x),
                             fm(2.0f, c2)), x), c1);
    x = fs(x, fd(f, fabsf(fp) > 1e-12f ? fp : 1.0f));
  }
  return x;
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

// One candidate (root v, branch br) from its first distance s1: eight
// Newton steps on the cosine-law system, the gate, its output slot
__device__ __forceinline__ void candidate(float v, float s1, float sq, int br,
                                          float ca, float cb, float cg,
                                          float a2, float b2, float c2,
                                          float gate, float* o,
                                          uint8_t* ok_out) {
  const float u = br == 0 ? fa(cg, sq) : fs(cg, sq);
  float s[3] = {s1, fm(u, s1), fm(v, s1)};
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
    float delta[3] = {F[0], F[1], F[2]};
    tod_lapack::lu_solve<3>(J, delta);
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
  o[0] = s[0];
  o[1] = s[1];
  o[2] = s[2];
  *ok_out = ok ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
p3p_kernel(const float* __restrict__ bear, const float* __restrict__ pts,
           float* __restrict__ s_out, uint8_t* __restrict__ ok_out, int n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads
                    + threadIdx.x;
  const int64_t i = t / kLanes;          // the sample; a group never cut
  if (i >= n) return;
  const int j = static_cast<int>(t % kLanes);   // the lane's root
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
  // pnp.py quartic_normalized: C3/C4 .. C0/C4 as the compiled reference's
  // four fusions contract them (each recomputes C4 its own way)
  const float A2 = fa(Ar, Ar), B2 = fa(Br, Br);
  const float A4 = fm(Ar, 4.0f), B4 = fm(Br, 4.0f);
  const float A8 = fm(Ar, 8.0f), B8 = fm(Br, 8.0f), ca4 = fm(ca, 4.0f);
  const float head = fs(__fmaf_rn(Ar, Ar, -fm(A2, Br)), A2);
  const float den1 = fa(fa(B2, __fmaf_rn(-fm(B4, ca), ca,
                                         __fmaf_rn(Br, Br, head))), 1.0f);
  const float den2 = fa(fa(B2, fs(__fmaf_rn(Br, Br, head),
                                  fm(fm(B4, ca), ca))), 1.0f);
  const float den0 = fa(fa(B2, __fmaf_rn(-fm(B4, ca), ca,
                                         fa(fm(Br, Br), head))), 1.0f);
  const float tail = -fm(fm(A4, Ar), cb);
  const float n3 = __fmaf_rn(-ca4, cg, __fmaf_rn(-B4, cb, __fmaf_rn(
      fm(B4, ca), cg, __fmaf_rn(fm(fm(B8, ca), ca), cb, __fmaf_rn(
          -fm(B4, Br), cb, __fmaf_rn(A4, cb, __fmaf_rn(
              fm(A4, ca), cg, __fmaf_rn(fm(A8, Br), cb, tail))))))));
  const float n2 = fs(__fmaf_rn(fm(cg, 4.0f), cg, __fmaf_rn(ca4, ca, __fmaf_rn(
      -fm(fm(B8, ca), cb), cg, fs(__fmaf_rn(B2, Br, __fmaf_rn(
          fm(fm(B4, Br), cb), cb, __fmaf_rn(-fm(A4, cg), cg, __fmaf_rn(
              -fm(fm(A8, ca), cb), cg, __fmaf_rn(-A4, Br, __fmaf_rn(
                  -fm(fm(A8, Br), cb), cb, __fmaf_rn(
                      A2, Ar, fm(fm(fm(A4, Ar), cb), cb)))))))),
          fm(fm(B4, ca), ca))))), 2.0f);
  const float n1 = __fmaf_rn(-ca4, cg, __fmaf_rn(B4, cb, __fmaf_rn(
      fm(B4, ca), cg, __fmaf_rn(-fm(B4, Br), cb, __fmaf_rn(-A4, cb, __fmaf_rn(
          fm(fm(A8, cb), cg), cg, __fmaf_rn(fm(A4, ca), cg, __fmaf_rn(
              fm(A8, Br), cb, tail))))))));
  const float n0 = fa(fs(fa(fm(Br, Br), fa(A2, __fmaf_rn(
      -fm(A4, cg), cg, __fmaf_rn(Ar, Ar, -fm(A2, Br))))), B2), 1.0f);
  const float v = quartic_root(C4, C3, C2, C1, C0, fd(n3, den1),
                               fd(n2, den2), fd(n1, den1), fd(n0, den0), j);
  const float scale = maxnan(maxnan(a2, b2), c2);
  const float gate = fm(1e-4f, scale);
  const float gv = maxc(fs(fa(1.0f, fm(v, v)), fm(fm(2.0f, v), cb)), 1e-12f);
  const float s1 = fsq(fd(b2, gv));
  const float disc = maxc(fs(fm(cg, cg), fs(1.0f, fm(Br, gv))), 0.0f);
  const float sq = fsq(disc);
#pragma unroll 1
  for (int br = 0; br < 2; ++br) {
    const int64_t slot = i * 8 + br * 4 + j;
    candidate(v, s1, sq, br, ca, cb, cg, a2, b2, c2, gate, s_out + slot * 3,
              ok_out + slot);
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
  const int64_t threads = static_cast<int64_t>(n) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  p3p_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bearings), static_cast<const float*>(points),
      static_cast<float*>(s_out), static_cast<uint8_t*>(ok_out), n);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// lapack_lu.cuh alone, a thread a system: the check that the card's LU
// gives jnp.linalg.solve's bits (chip_smoke.py phase 3k holds it against
// tests/data/torch_p3p_fixture.npz); not on the detection path
template <int N>
__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(const float* __restrict__ M, const float* __restrict__ F,
                float* __restrict__ x, int n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads
                    + threadIdx.x;
  if (i >= n) return;
  float a[N][N], b[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) a[r][c] = M[(i * N + r) * N + c];
    b[r] = F[i * N + r];
  }
  tod_lapack::lu_solve<N>(a, b);
#pragma unroll
  for (int r = 0; r < N; ++r) x[i * N + r] = b[r];
}

}  // namespace

// x = M^-1 F for n_systems contiguous float32 systems of size n (3 or 6):
// M (n_systems, n, n) row-major, F and x (n_systems, n). Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_lu_solve(const void* M, const void* F, void* x,
                            int n_systems, int n, void* stream) {
  if (n_systems <= 0) return 0;
  const int blocks = (n_systems + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 3)
    lu_solve_kernel<3><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(M), static_cast<const float*>(F),
        static_cast<float*>(x), n_systems);
  else if (n == 6)
    lu_solve_kernel<6><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(M), static_cast<const float*>(F),
        static_cast<float*>(x), n_systems);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
