// Gauss-Newton pose refinement on Hopper, rounded as the port's plain
// version rounds it.
//
// P2 tod_gauss_newton replaces, on the card, the reference's refinement
// (tod_tpu/geometry/pnp.py:225-280 gauss_newton_pose under jax.vmap): not
// a Pallas kernel, but XLA's fusions of the reprojection residual, its
// jax.jacfwd Jacobian, J^T J and J^T r, LAPACK's solve and the Rodrigues
// update. The plain version is tod_tpu_torch/geometry/pnp.py
// gauss_newton_pose_torch: the same float operations in the same order
// (the rotation as fma(x2, r2, fma(x1, r1, x0 r0)), the Jacobian written
// out, the sums over the 2N rows in transforms.pairwise_sum's order: the
// halves added elementwise, an odd last row carried to the end; the 6x6
// step by pnp.lu_solve's LU; sincosf and the roots correctly rounded), so
// both devices give the same bits.
//
// Design: one block a pose, all `iters` iterations in one launch. Each
// thread computes its matches' residual and Jacobian rows into shared
// memory (72 bytes a match; past kMaxSharedBytes, into the caller's global
// scratch instead: the same template, instantiated for each space); the
// 21 entries of J^T J (the matrix is symmetric: J_k J_l and J_l J_k round
// alike) and the 6 of J^T r are each reduced by the pairwise halving in a
// double buffer; one thread solves, updates the pose, and the
// block reads it back. The PyTorch version launches ~350 kernels an
// iteration; this one, per call, one. Bound: the float rate at ~100
// operations a row and iteration, far below the launch it replaces.

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;
// the rows of a pose held in dynamic shared memory, at most (72 bytes a
// match: 12 Jacobian entries, 2 residuals, 4 reduction slots); below the
// card's 227 KB a block, with room for the static arrays
constexpr int kMaxSharedBytes = 224 * 1024;

__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }

// (A (.)(B)) for 3x3: (a0 b0 + a1 b1) + a2 b2, transforms.matmul3
__device__ __forceinline__ void matmul3(const float A[3][3],
                                        const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = fa(fa(fm(A[i][0], B[0][j]), fm(A[i][1], B[1][j])),
                   fm(A[i][2], B[2][j]));
}

// pnp.lu_solve for n = 6 on the augmented [H | g]
__device__ void lu_solve6(float A[6][7], float x[6]) {
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    int piv = k;
    float best = fabsf(A[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      const float mag = fabsf(A[i][k]);
      if (mag > best) {
        piv = i;
        best = mag;
      }
    }
    if (piv != k) {
      for (int j = 0; j < 7; ++j) {
        const float t = A[k][j];
        A[k][j] = A[piv][j];
        A[piv][j] = t;
      }
    }
    const float rcp = fd(1.0f, A[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      const float l = fm(A[i][k], rcp);
      for (int j = k + 1; j < 7; ++j) A[i][j] = fs(A[i][j], fm(l, A[k][j]));
    }
  }
  float g[6];
  for (int i = 0; i < 6; ++i) g[i] = A[i][6];
  for (int j = 5; j >= 0; --j) {
    x[j] = fd(g[j], A[j][j]);
    for (int i = 0; i < j; ++i) g[i] = fs(g[i], fm(A[i][j], x[j]));
  }
}

// the pairwise sum of buf[0, n) (transforms.pairwise_sum); `tmp` holds as
// many floats; the result in whichever buffer the last step wrote
__device__ __forceinline__ float pairwise(float* buf, float* tmp, int n) {
  float* src = buf;
  float* dst = tmp;
  while (n > 1) {
    const int half = n / 2;
    for (int i = threadIdx.x; i < half; i += blockDim.x)
      dst[i] = fa(src[i], src[i + half]);
    if ((n & 1) && threadIdx.x == 0) dst[half] = src[n - 1];
    __syncthreads();
    n = half + (n & 1);
    float* t = src;
    src = dst;
    dst = t;
  }
  const float out = src[0];
  __syncthreads();
  return out;
}

// kGlobal: the rows in `scratch` (global memory), else in dynamic shared
// memory; a template parameter, so that the shared instantiation's loads
// and stores stay shared-memory instructions
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
gauss_newton_kernel(const float* __restrict__ R0, const float* __restrict__ T0,
                    const float* __restrict__ K, const float* __restrict__ X,
                    const float* __restrict__ uv, const float* __restrict__ w,
                    float* __restrict__ R_out, float* __restrict__ T_out,
                    float* __restrict__ scratch, int n, int iters) {
  extern __shared__ float smem[];
  const int rows = 2 * n;
  // 18 n floats a pose: shared memory, or the pose's slice of `scratch`
  float* jac = kGlobal ? scratch + static_cast<int64_t>(blockIdx.x) * 18 * n
                       : smem;       // [rows][6]
  float* res = jac + rows * 6;        // [rows]
  float* buf = res + rows;            // [rows]
  float* tmp = buf + rows;            // [rows]
  __shared__ float pose[12];          // R row-major, then T
  __shared__ float sums[27];          // J^T J's 21 upper entries, J^T r's 6
  const int p = blockIdx.x;
  const float* Xp = X + static_cast<int64_t>(p) * n * 3;
  const float* uvp = uv + static_cast<int64_t>(p) * n * 2;
  const float* wp = w + static_cast<int64_t>(p) * n;
  if (threadIdx.x < 9) pose[threadIdx.x] = R0[p * 9 + threadIdx.x];
  else if (threadIdx.x < 12) pose[threadIdx.x] = T0[p * 3 + threadIdx.x - 9];
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float R[3][3], T[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = pose[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = pose[9 + i];
    for (int m = threadIdx.x; m < n; m += blockDim.x) {
      const float x0 = Xp[3 * m], x1 = Xp[3 * m + 1], x2 = Xp[3 * m + 2];
      float y[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        y[j] = __fmaf_rn(x2, R[j][2], __fmaf_rn(x1, R[j][1], fm(x0, R[j][0])));
      const float xc = fa(y[0], T[0]), yc = fa(y[1], T[1]),
                  z = fa(y[2], T[2]);
      const bool live = fabsf(z) > 1e-9f;
      const float zc = live ? z : 1e-9f;
      const float wm = wp[m];
      const float u = fa(fd(fm(fx, xc), zc), cx);
      const float v = fa(fd(fm(fy, yc), zc), cy);
      res[2 * m] = fm(fs(u, uvp[2 * m]), wm);
      res[2 * m + 1] = fm(fs(v, uvp[2 * m + 1]), wm);
      const float dz = live ? 1.0f : 0.0f;
      const float a = fm(fd(fx, zc), wm);
      const float b = fm(fd(fy, zc), wm);
      const float zz = fm(zc, zc);
      const float c = fm(fm(fd(fm(-fx, xc), zz), dz), wm);
      const float d = fm(fm(fd(fm(-fy, yc), zz), dz), wm);
      float* ju = jac + 2 * m * 6;
      float* jv = ju + 6;
      ju[0] = fm(c, y[1]);
      ju[1] = fs(fm(a, y[2]), fm(c, y[0]));
      ju[2] = fm(-a, y[1]);
      ju[3] = a;
      ju[4] = 0.0f;
      ju[5] = c;
      jv[0] = fs(fm(d, y[1]), fm(b, y[2]));
      jv[1] = fm(-d, y[0]);
      jv[2] = fm(b, y[0]);
      jv[3] = 0.0f;
      jv[4] = b;
      jv[5] = d;
    }
    __syncthreads();
    int q = 0;
    for (int k = 0; k < 6; ++k) {
      for (int l = k; l < 6; ++l) {
        for (int r = threadIdx.x; r < rows; r += blockDim.x)
          buf[r] = fm(jac[r * 6 + k], jac[r * 6 + l]);
        __syncthreads();
        const float s = pairwise(buf, tmp, rows);
        if (threadIdx.x == 0) sums[q] = s;
        ++q;
      }
    }
    for (int k = 0; k < 6; ++k) {
      for (int r = threadIdx.x; r < rows; r += blockDim.x)
        buf[r] = fm(jac[r * 6 + k], res[r]);
      __syncthreads();
      const float s = pairwise(buf, tmp, rows);
      if (threadIdx.x == 0) sums[21 + k] = s;
    }
    if (threadIdx.x == 0) {
      float A[6][7];
      int qq = 0;
      for (int k = 0; k < 6; ++k)
        for (int l = k; l < 6; ++l) {
          A[k][l] = sums[qq];
          A[l][k] = sums[qq];
          ++qq;
        }
      for (int k = 0; k < 6; ++k)
        for (int l = 0; l < 6; ++l)
          A[k][l] = fa(A[k][l], k == l ? 1e-6f : 0.0f);
      for (int k = 0; k < 6; ++k) A[k][6] = sums[21 + k];
      float delta[6];
      lu_solve6(A, delta);
      bool ok = true;
      for (int k = 0; k < 6; ++k) {
        delta[k] = -delta[k];
        ok = ok && isfinite(delta[k]);
      }
      for (int k = 0; k < 6; ++k) delta[k] = ok ? delta[k] : 0.0f;
      // rodrigues(delta[:3]) @ R, T + delta[3:]
      const float th = fa(__fsqrt_rn(fa(fa(fm(delta[0], delta[0]),
                                           fm(delta[1], delta[1])),
                                        fm(delta[2], delta[2]))), 1e-12f);
      const float k0 = fd(delta[0], th), k1 = fd(delta[1], th),
                  k2 = fd(delta[2], th);
      const float kx[3][3] = {{0.0f, -k2, k1}, {k2, 0.0f, -k0},
                              {-k1, k0, 0.0f}};
      float sn, cs;
      tod_libm::sincosf_libm(th, &sn, &cs);
      float kk[3][3], Q[3][3], Rn[3][3];
      matmul3(kx, kx, kk);
      const float omc = fs(1.0f, cs);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          Q[i][j] = fa(fa(i == j ? 1.0f : 0.0f, fm(sn, kx[i][j])),
                       fm(omc, kk[i][j]));
      matmul3(Q, R, Rn);
      for (int i = 0; i < 9; ++i) pose[i] = Rn[i / 3][i % 3];
      for (int i = 0; i < 3; ++i) pose[9 + i] = fa(T[i], delta[3 + i]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 9) R_out[p * 9 + threadIdx.x] = pose[threadIdx.x];
  else if (threadIdx.x < 12) T_out[p * 3 + threadIdx.x - 9] = pose[threadIdx.x];
}

}  // namespace

// Refine n_poses poses by `iters` Gauss-Newton steps: R0 (n_poses, 3, 3),
// T0 (n_poses, 3), K (3, 3), and per pose X (n, 3), uv (n, 2), w (n), all
// float32 and contiguous, into R_out / T_out. `scratch` is null, or
// n_poses x 18 n floats of global memory for the rows (needed where 72 n
// bytes pass kMaxSharedBytes). Launches on `stream` and returns
// cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_gauss_newton(const void* R0, const void* T0, const void* K,
                                const void* X, const void* uv, const void* w,
                                void* R_out, void* T_out, void* scratch,
                                int n_poses, int n, int iters, void* stream) {
  if (n_poses <= 0) return 0;
  const int64_t bytes = static_cast<int64_t>(n) * 18 * 4;
  if (n < 1 || (!scratch && bytes > kMaxSharedBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scratch ? 0 : static_cast<int>(bytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gauss_newton_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kernel = scratch ? gauss_newton_kernel<true>
                        : gauss_newton_kernel<false>;
  kernel<<<n_poses, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R0), static_cast<const float*>(T0),
      static_cast<const float*>(K), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(w),
      static_cast<float*>(R_out), static_cast<float*>(T_out),
      static_cast<float*>(scratch), n, iters);
  return static_cast<int>(cudaGetLastError());
}
