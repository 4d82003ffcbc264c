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
// __fmul_rn / __fdiv_rn / __fsqrt_rn / __fmaf_rn. The side lengths are the
// compiled reference's FMA chain, read off its object code
// (tools/fit_p3p_order.py); the normalised coefficients C3/C4 .. C0/C4
// (four fusions), Ferrari's solution and the six polishes are its fusions
// as LLVM contracts them (read off by tools/fit_p3p_fusions.py, which
// calls XLA's own compiled fusions to check them): divisions by constants
// products by their float32 reciprocals, the resolvent's arccos argument
// a product by XLA's rsqrt (the reference host's rsqrtps estimate, a
// table passed as data, and two Newton steps), each root a region of its
// own, each polish recomputing the quartic's coefficients; the 3x3 Newton
// solve is LAPACK's, as jnp.linalg.solve runs it on the reference host
// (lapack_lu.cuh, tools/fit_lapack_order.py). So are the first distances
// and the Newton steps' residuals and Jacobian: the distances P1 returns
// are the reference's (the Horn fit after them, in PyTorch, is not yet:
// ROADMAP queue C).
// The libm calls are glibc 2.36's FMA builds (libm_f32.cuh). The plain
// version is tod_tpu_torch/geometry/pnp.py p3p_distances_torch: the CPU
// path, the same operations in the same order, so both devices give the
// same bits.
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
__device__ __forceinline__ bool is_fin(float x) { return isfinite(x); }

// ops/rsqrtps.py rsqrt_xla: XLA:CPU's rsqrt on the reference host, its
// rsqrtps estimate (`table`: 2 x 1024 entries by the exponent's parity and
// the mantissa's top 10 bits, passed as data) with the exponent halved,
// then two Newton steps as its IR contracts them
__device__ __forceinline__ float rsqrt_xla(float x,
                                           const int32_t* __restrict__ table) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  const int par = e & 1;
  float y = __int_as_float(__ldg(table + par * 1024 + ((bits >> 13) & 1023))
                           - ((e - par) / 2) * (1 << 23));
  for (int k = 0; k < 2; ++k)
    y = __fmaf_rn(fm(y, -0.5f), __fmaf_rn(fm(x, y), y, -1.0f), y);
  return x == INFINITY ? 0.0f : y;
}

// pnp.py ferrari_roots, root j (0-3) of the monic quartic y^4 + a y^3 +
// b y^2 + c y + d before the polishes, as the compiled reference's
// fusions round it: divisions by constants products by their float32
// reciprocals, one-use products fused into the add that takes them, the
// arccos's argument R * rsqrt(-Q^3), R + sqrtD contracted inside the cube
// roots and not in their signs, s^2 - 4 t an FMA in each root's region
__device__ float ferrari_root(float a, float b, float c, float d, int j,
                              const int32_t* __restrict__ table) {
  const float a3a = fm(fm(a, 3.0f), a);
  const float p = __fmaf_rn(-a3a, 0.125f, b);
  const float pp = fm(p, p);
  const float q = __fmaf_rn(fm(fm(a, a), a), 0.125f,
                            __fmaf_rn(-fm(a, b), 0.5f, c));
  const float r = __fmaf_rn(-fm(fm(a3a, a), a), 0.00390625f,
                            __fmaf_rn(fm(fm(a, a), b), 0.0625f,
                                      __fmaf_rn(-fm(a, c), 0.25f, d)));
  const float B = __fmaf_rn(pp, 0.25f, -r);
  const float Q = fm(__fmaf_rn(B, 3.0f, -pp), 1.0f / 9.0f);
  const float Rn = fs(__fmaf_rn(fm(p, 9.0f), B, fm(fm(q, q), 3.375f)),
                      fm(fm(pp, p), 2.0f));
  const float R = fm(Rn, 1.0f / 54.0f);
  const float QQ = fm(Q, Q);
  const float D = __fmaf_rn(QQ, Q, fm(R, R));
  const float sqrt_d = fsq(maxnan(D, 0.0f));
  const float sqrt_mq = fsq(maxnan(-Q, 0.0f));
  const float theta = tod_libm::acosf_xla(clip11(
      fm(R, rsqrt_xla(maxnan(-fm(QQ, Q), 1e-30f), table))));
  const float third = 1.0f / 3.0f;
  const float cube0 = tod_libm::powf_libm(
      fabsf(__fmaf_rn(Rn, 1.0f / 54.0f, sqrt_d)), third);
  const float cube1 = tod_libm::powf_libm(
      fabsf(__fmaf_rn(Rn, 1.0f / 54.0f, -sqrt_d)), third);
  const float m_pos = __fmaf_rn(sign_of(fa(sqrt_d, R)), cube0,
                                fm(sign_of(fs(R, sqrt_d)), cube1));
  const float m_neg = fm(fm(sqrt_mq, 2.0f),
                         tod_libm::cosf_libm(fm(theta, third)));
  const float m = maxc(__fmaf_rn(-p, third, D >= 0.0f ? m_pos : m_neg),
                       1e-12f);
  // (y^2 + s y + t0)(y^2 - s y + t1), s = sqrt(2 m); roots 0, 1 from t0
  const float s = fsq(fm(m, 2.0f));
  const float q2s = fd(q, fm(s, 2.0f));
  const float h = __fmaf_rn(p, 0.5f, m);
  const float t = j < 2 ? fs(h, q2s) : fa(q2s, h);
  const float sq = fsq(maxnan(__fmaf_rn(s, s, -fm(t, 4.0f)), 0.0f));
  const float y = j == 0 ? fs(sq, s)
                : j == 1 ? fs(-s, sq)
                : j == 2 ? fa(s, sq) : fs(s, sq);
  return __fmaf_rn(-a, 0.25f, fm(y, 0.5f));
}

// pnp.py polish_step's coefficients of the quartic in v, from the side
// ratios and cosines, as the compiled polish fusion recomputes them
struct Quartic {
  float C4, C3, C2, C1, C0;
};

__device__ Quartic polish_quartic(float Ar, float Br, float ca, float cb,
                                  float cg) {
  const float A2 = fm(Ar, 2.0f), A4 = fm(Ar, 4.0f), A8 = fm(Ar, 8.0f);
  const float B2 = fm(Br, 2.0f), B4 = fm(Br, 4.0f), BB = fm(Br, Br);
  const float head = __fmaf_rn(Ar, Ar, -fm(A2, Br));
  const float B4ca = fm(B4, ca), B4caca = fm(B4ca, ca);
  const float A8Brcb = fm(fm(A8, Br), cb);
  const float c31 = __fmaf_rn(fm(A4, ca), cg,
                              fs(A8Brcb, fm(fm(A4, Ar), cb)));
  const float A4cb = fm(A4, cb), B4Brcb = fm(fm(B4, Br), cb);
  const float B8ca = fm(fm(Br, 8.0f), ca), B4cacg = fm(B4ca, cg);
  const float B4cb = fm(B4, cb), ca4 = fm(ca, 4.0f), ca4cg = fm(ca4, cg);
  const float A4cgcg = fm(fm(A4, cg), cg);
  Quartic k;
  k.C4 = fa(fa(B2, fs(fa(BB, fs(head, A2)), B4caca)), 1.0f);
  k.C3 = fs(fs(fa(B4cacg, __fmaf_rn(fm(B8ca, ca), cb,
                                    fs(fa(A4cb, c31), B4Brcb))),
               B4cb), ca4cg);
  float c2 = __fmaf_rn(-A4, Br, __fmaf_rn(-A8Brcb, cb, __fmaf_rn(
      A2, Ar, fm(fm(fm(A4, Ar), cb), cb))));
  c2 = __fmaf_rn(B4Brcb, cb,
                 fs(__fmaf_rn(-fm(fm(A8, ca), cb), cg, c2), A4cgcg));
  c2 = __fmaf_rn(-fm(B8ca, cb), cg, fs(__fmaf_rn(B2, Br, c2), B4caca));
  k.C2 = fs(__fmaf_rn(fm(cg, 4.0f), cg, __fmaf_rn(ca4, ca, c2)), 2.0f);
  k.C1 = fs(fa(B4cb, fa(B4cacg, fs(fs(__fmaf_rn(fm(fm(A8, cb), cg), cg,
                                                c31), A4cb), B4Brcb))),
            ca4cg);
  k.C0 = fa(fs(fa(BB, fa(A2, fs(head, A4cgcg))), B2), 1.0f);
  return k;
}

// pnp.py polish_step: f / fp at x by contracted Horner steps, fp taken as
// 1 where |fp| <= 1e-12
__device__ __forceinline__ float polish_delta(const Quartic& k, float x) {
  const float f = __fmaf_rn(__fmaf_rn(__fmaf_rn(__fmaf_rn(
      k.C4, x, k.C3), x, k.C2), x, k.C1), x, k.C0);
  const float fp = __fmaf_rn(__fmaf_rn(__fmaf_rn(
      fm(k.C4, 4.0f), x, fm(k.C3, 3.0f)), x, fm(k.C2, 2.0f)), x, k.C1);
  return fd(f, fabsf(fp) > 1e-12f ? fp : 1.0f);
}

// pnp.py _cosine_law: x^2 + y^2 - 2 x y cos - side^2 as the compiled
// Newton step contracts it, fma(-(2 x y), cos, fma(x, x, y y)) - side^2
__device__ __forceinline__ float law(float x, float y, float cos,
                                     float side) {
  return fs(__fmaf_rn(-fm(fm(x, 2.0f), y), cos, __fmaf_rn(x, x, fm(y, y))),
            side);
}

__device__ __forceinline__ void cosine_law(const float s[3], float ca,
                                           float cb, float cg, float a2,
                                           float b2, float c2, float F[3]) {
  F[0] = law(s[1], s[2], ca, a2);
  F[1] = law(s[0], s[2], cb, b2);
  F[2] = law(s[0], s[1], cg, c2);
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
    // + 1e-9 I: the off-diagonal entries + 0, as the reference adds it
    float J[3][3] = {
        {1e-9f, fa(fs(fm(2.0f, s[1]), fm(fm(2.0f, s[2]), ca)), 0.0f),
         fa(fs(fm(2.0f, s[2]), fm(fm(2.0f, s[1]), ca)), 0.0f)},
        {fa(fs(fm(2.0f, s[0]), fm(fm(2.0f, s[2]), cb)), 0.0f), 1e-9f,
         fa(fs(fm(2.0f, s[2]), fm(fm(2.0f, s[0]), cb)), 0.0f)},
        {fa(fs(fm(2.0f, s[0]), fm(fm(2.0f, s[1]), cg)), 0.0f),
         fa(fs(fm(2.0f, s[1]), fm(fm(2.0f, s[0]), cg)), 0.0f), 1e-9f}};
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
           const int32_t* __restrict__ rsqrt_table,
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
  // Ferrari's root j and its six Newton polishes (pnp.py p3p_distances)
  float v = ferrari_root(fd(n3, den1), fd(n2, den2), fd(n1, den1),
                         fd(n0, den0), j, rsqrt_table);
  const Quartic k = polish_quartic(Ar, Br, ca, cb, cg);
#pragma unroll 1
  for (int it = 0; it < 6; ++it) v = fs(v, polish_delta(k, v));
  const float scale = maxnan(maxnan(a2, b2), c2);
  const float gate = fm(1e-4f, scale);
  // the first distances as compiled: g = fma(-v, 2 cb, fma(v, v, 1)), the
  // discriminant cg cg - fma(-Br, g, 1)
  const float gv = maxc(__fmaf_rn(-v, fm(cb, 2.0f), __fmaf_rn(v, v, 1.0f)),
                        1e-12f);
  const float s1 = fsq(fd(b2, gv));
  const float disc = maxc(fs(fm(cg, cg), __fmaf_rn(-Br, gv, 1.0f)), 0.0f);
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
// distances (n, 8, 3) float32 and validity (n, 8) uint8; rsqrt_table:
// ops/rsqrtps.py RSQRTPS_TABLE (2048 int32) on the card. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_p3p(const void* bearings, const void* points,
                       const void* rsqrt_table, void* s_out, void* ok_out,
                       int n, void* stream) {
  if (n <= 0) return 0;
  const int64_t threads = static_cast<int64_t>(n) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  p3p_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bearings), static_cast<const float*>(points),
      static_cast<const int32_t*>(rsqrt_table), static_cast<float*>(s_out),
      static_cast<uint8_t*>(ok_out), n);
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
