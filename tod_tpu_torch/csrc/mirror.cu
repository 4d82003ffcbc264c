// The 2D-only path's mirror pose and model normal on Hopper, bit for bit
// with their plain versions.
//
// M1 tod_mirror_poses replaces, on the card, the reference's mirror branch
// (tod_tpu/geometry/detection2d.py:172-186, jax.vmap of `mirror` over the
// top poses): not a Pallas kernel, but XLA's fusions of the dots, the cross
// product, the libm atan2f / sinf / cosf calls and the two 3x3 products.
// The plain version is tod_tpu_torch/geometry/detection2d.py
// mirror_poses_torch: a chain of small tensor ops (transforms.dot3, cross3,
// matmul3, each operation rounded), glibc's atan2f and sincosf.
//
// M2 tod_sym3_smallest replaces the reference's jnp.linalg.eigh of the
// model points' covariance (detection2d.py:164-169, the eigenvector of the
// smallest eigenvalue). The plain version is detection2d.py
// sym3_smallest_vector_torch: the trigonometric solution of the
// characteristic cubic in float64, its angle's arccos (XLA's chlo.acos:
// atan2f(sqrt((1 - x)(1 + x)), x)) and cos in float32, and the largest of
// three cross products of rows of cov - lambda I.
//
// Both were chains of 40-70 elementwise launches a call (two of them L1e's
// atan2f, two L4's sincosf / cosf) on a few hundred elements: launch-bound.
// Design: one thread a pose (M1) or matrix (M2), everything in registers,
// one launch a call. Every float32 operation is an __f*_rn and every
// float64 one an __d*_rn in the plain version's order (nvcc never
// contracts them into an FMA), the square roots __fsqrt_rn / __dsqrt_rn
// (the plain versions' ops/libm.py sqrt_rn), the divisions __fdiv_rn /
// __ddiv_rn, and atan2f, sincosf and cosf glibc's (libm_f32.cuh, as L1e
// and L4 compute them), so the card gives the CPU's bits. The clamps keep
// a NaN, as torch.clamp does, and the argmax takes the first of equal
// norms and a NaN as the largest, as torch.argmax does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

using tod_libm::dadd;
using tod_libm::dmul;
using tod_libm::dsub;

constexpr int kThreads = 128;

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
__device__ __forceinline__ double dot3d(const double* u, const double* v) {
  return dadd(dadd(dmul(u[0], v[0]), dmul(u[1], v[1])), dmul(u[2], v[2]));
}

// transforms.cross3: each entry two products and a difference
__device__ __forceinline__ void cross3f(const float* u, const float* v,
                                        float* o) {
  o[0] = fsub(fmul(u[1], v[2]), fmul(u[2], v[1]));
  o[1] = fsub(fmul(u[2], v[0]), fmul(u[0], v[2]));
  o[2] = fsub(fmul(u[0], v[1]), fmul(u[1], v[0]));
}
__device__ __forceinline__ void cross3d(const double* u, const double* v,
                                        double* o) {
  o[0] = dsub(dmul(u[1], v[2]), dmul(u[2], v[1]));
  o[1] = dsub(dmul(u[2], v[0]), dmul(u[0], v[2]));
  o[2] = dsub(dmul(u[0], v[1]), dmul(u[1], v[0]));
}

// transforms.matmul3: entry (i, j) is (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j
__device__ __forceinline__ void matmul3f(const float* a, const float* b,
                                         float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = fadd(fadd(fmul(a[3 * i], b[j]),
                               fmul(a[3 * i + 1], b[3 + j])),
                          fmul(a[3 * i + 2], b[6 + j]));
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
  for (int i = 0; i < 3; ++i) n_c[i] = dot3f(r + 3 * i, nm);
  const float t_norm = clamp_min(__fsqrt_rn(dot3f(t, t)), 1e-9f);
  float v[3];
  for (int i = 0; i < 3; ++i) v[i] = __fdiv_rn(t[i], t_norm);
  const float d2 = fmul(2.0f, dot3f(n_c, v));
  float n_ref[3];
  for (int i = 0; i < 3; ++i) n_ref[i] = fsub(fmul(d2, v[i]), n_c[i]);
  float axis[3];
  cross3f(n_c, n_ref, axis);
  const float s = __fsqrt_rn(dot3f(axis, axis));
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
  matmul3f(ax, ax, ax2);
  const float one_c = fsub(1.0f, cs);
  float q[9];
  const bool turn = s > 1e-6f;
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    // (eye + sin ax) + (1 - cos) ax ax, or eye where s <= 1e-6
    q[k] = turn ? fadd(fadd(eye, fmul(sn, ax[k])), fmul(one_c, ax2[k]))
                : eye;
  }
  float out[9];
  matmul3f(q, r, out);
  for (int k = 0; k < 9; ++k) R_out[k] = out[k];
  for (int k = 0; k < 3; ++k) T_out[k] = t[k];
}

__global__ void __launch_bounds__(kThreads)
mirror_kernel(const float* __restrict__ R, const float* __restrict__ T,
              const float* __restrict__ n, float* __restrict__ R_out,
              float* __restrict__ T_out, int n_poses, int per_object) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_poses) return;
  mirror_one(R + 9 * static_cast<int64_t>(i), T + 3 * static_cast<int64_t>(i),
             n + 3 * static_cast<int64_t>(i / per_object),
             R_out + 9 * static_cast<int64_t>(i),
             T_out + 3 * static_cast<int64_t>(i));
}

// sym3_smallest_vector_torch for one symmetric float32 matrix
__device__ void sym3_one(const float* __restrict__ cov,
                         float* __restrict__ out) {
  double c[9];
  for (int k = 0; k < 9; ++k) c[k] = static_cast<double>(cov[k]);
  const double q = __ddiv_rn(dadd(dadd(c[0], c[4]), c[8]), 3.0);
  const double off = dadd(dadd(dmul(c[1], c[1]), dmul(c[2], c[2])),
                          dmul(c[5], c[5]));
  const double e0 = dsub(c[0], q), e1 = dsub(c[4], q), e2 = dsub(c[8], q);
  const double p2 = dadd(dadd(dadd(dmul(e0, e0), dmul(e1, e1)),
                              dmul(e2, e2)),
                         dmul(2.0, off));
  const double p = __dsqrt_rn(__ddiv_rn(p2, 6.0));
  const double safe_p = p > 0.0 ? p : 1.0;
  double b[9];
  for (int k = 0; k < 9; ++k)     // (c - q eye) / safe_p, q eye rounded too
    b[k] = __ddiv_rn(dsub(c[k], dmul(q, k % 4 == 0 ? 1.0 : 0.0)), safe_p);
  // transforms._det3
  const double det = dadd(
      dsub(dmul(b[0], dsub(dmul(b[4], b[8]), dmul(b[5], b[7]))),
           dmul(b[1], dsub(dmul(b[3], b[8]), dmul(b[5], b[6])))),
      dmul(b[2], dsub(dmul(b[3], b[7]), dmul(b[4], b[6]))));
  double h = dmul(det, 0.5);                // / 2.0, then torch.clamp
  h = h < -1.0 ? -1.0 : (h > 1.0 ? 1.0 : h);
  const float phi = __fdiv_rn(tod_libm::acosf_xla(__double2float_rn(h)),
                              3.0f);
  const float ang = fadd(phi, static_cast<float>(2.0 * 3.141592653589793
                                                 / 3.0));
  const double lam = dadd(q, dmul(dmul(2.0, p), static_cast<double>(
                                   tod_libm::cosf_libm(ang))));
  double a[9];
  for (int k = 0; k < 9; ++k)
    a[k] = dsub(c[k], dmul(lam, k % 4 == 0 ? 1.0 : 0.0));
  double cands[9];
  cross3d(a, a + 3, cands);
  cross3d(a, a + 6, cands + 3);
  cross3d(a + 3, a + 6, cands + 6);
  int best = 0;
  double best_norm = dot3d(cands, cands);
  for (int j = 1; j < 3; ++j) {
    const double nj = dot3d(cands + 3 * j, cands + 3 * j);
    // torch.argmax: the first of the largest, a NaN above every number
    if (!isnan(best_norm) && (nj > best_norm || isnan(nj))) {
      best = j;
      best_norm = nj;
    }
  }
  const double length = __dsqrt_rn(best_norm);
  for (int i = 0; i < 3; ++i) {
    // an isotropic or rank-0 matrix: every direction is an eigenvector
    const double v = length > 0.0 ? __ddiv_rn(cands[3 * best + i], length)
                                  : (i == 0 ? 1.0 : 0.0);
    out[i] = __double2float_rn(v);
  }
}

__global__ void __launch_bounds__(kThreads)
sym3_kernel(const float* __restrict__ cov, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sym3_one(cov + 9 * static_cast<int64_t>(i),
                      out + 3 * static_cast<int64_t>(i));
}

}  // namespace

// R_out = Q R and T_out = T for n_poses contiguous float32 poses (R: 9
// floats a pose, T: 3), the normal n (3 floats) shared by each run of
// per_object consecutive poses. Launches on `stream` and returns
// cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_mirror_poses(const void* R, const void* T, const void* n,
                                void* R_out, void* T_out, int n_poses,
                                int per_object, void* stream) {
  if (n_poses <= 0) return 0;
  if (per_object < 1 || n_poses % per_object)
    return static_cast<int>(cudaErrorInvalidValue);
  mirror_kernel<<<(n_poses + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(T),
      static_cast<const float*>(n), static_cast<float*>(R_out),
      static_cast<float*>(T_out), n_poses, per_object);
  return static_cast<int>(cudaGetLastError());
}

// out (3 floats a matrix) = the unit eigenvector of the smallest eigenvalue
// of each of n contiguous symmetric float32 3x3 matrices. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_sym3_smallest(const void* cov, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  sym3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cov), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
