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
// step by pnp.lu_solve's LU, LAPACK's as jnp.linalg.solve runs it on the
// reference host (lapack_lu.cuh); sincosf and the roots correctly rounded), so
// both devices give the same bits.
//
// Design: one block a pose, all `iters` iterations in one launch, and one
// reduction tree for the 27 sums (J^T J's 21 upper entries, J^T r's 6),
// whose grouping is pairwise_sum's (IEEE addition commutes exactly, so only
// the grouping sets the bits). Its levels, from the 2N rows up:
// - register levels: thread t owns the level-L node t, where L is the
//   first level of at most kThreads nodes, and sums its subtree depth
//   first, a level-1 node at a time from its two rows: their residuals
//   and Jacobians computed in registers from the pose and the matches (no
//   Jacobian is stored), the pending left subtree of level 1 in registers,
//   of higher levels on a small per-thread stack (local memory; none up to
//   4 kThreads rows);
// - shared levels: while more than 32 nodes are left, the right half's
//   nodes go through shared memory to the left half's threads (an odd last
//   node to the middle), one barrier a level for all 27 sums;
// - warp levels: the last 32 or fewer in warp 0 by __shfl_down_sync.
// Nothing of size N sits in shared memory, so one code path serves any N.
// Then thread 0 solves the 6x6 step alone in LAPACK's order (lapack_lu.cuh:
// its left-looking LU has no row-parallel form that keeps the bits),
// updates the pose, and the block reads it back. The
// points and pixels are read once an object (`per_object` poses share
// them), not copied to every pose.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lapack_lu.cuh"
#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 27;             // J^T J's 21 upper entries, J^T r's 6
constexpr int kMaxLevels = 16;        // register levels: up to 2^16 kThreads rows
constexpr int kStack = kMaxLevels - 2;  // the pending subtrees past level 1
constexpr int kSlots = kThreads / 2;  // a shared level's right half at most

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

// Row r of 2n (match r / 2, its u row if r is even, else its v row) at
// pose (R, T): its Jacobian J and weighted residual, as
// reprojection_jacobian writes them out
__device__ __forceinline__ void jacobian_row(
    const float R[3][3], const float T[3], float fx, float fy, float cx,
    float cy, const float* __restrict__ Xo, const float* __restrict__ uvo,
    const float* __restrict__ wp, int r, float J[6], float* res) {
  const int m = r >> 1;
  const bool v_row = r & 1;
  const float x0 = __ldg(Xo + 3 * m), x1 = __ldg(Xo + 3 * m + 1),
              x2 = __ldg(Xo + 3 * m + 2);
  float y[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    y[j] = __fmaf_rn(x2, R[j][2], __fmaf_rn(x1, R[j][1], fm(x0, R[j][0])));
  const float xc = fa(y[0], T[0]), yc = fa(y[1], T[1]), z = fa(y[2], T[2]);
  const bool live = fabsf(z) > 1e-9f;
  const float zc = live ? z : 1e-9f;
  const float wm = __ldg(wp + m);
  // the u row's (fx, cx, x) or the v row's (fy, cy, y)
  const float f = v_row ? fy : fx, c0 = v_row ? cy : cx, q = v_row ? yc : xc;
  *res = fm(fs(fa(fd(fm(f, q), zc), c0), __ldg(uvo + r)), wm);
  const float dz = live ? 1.0f : 0.0f;
  const float zz = fm(zc, zc);
  const float a = fm(fd(f, zc), wm);                    // a, or b
  const float c = fm(fm(fd(fm(-f, q), zz), dz), wm);    // c, or d
  // ju = (c y1, a y2 - c y0, -a y1, a, 0, c);
  // jv = (d y1 - b y2, -d y0, b y0, 0, b, d)
  const float cy1 = fm(c, y[1]), ay2 = fm(a, y[2]);
  J[0] = v_row ? fs(cy1, ay2) : cy1;
  J[1] = v_row ? fm(-c, y[0]) : fs(ay2, fm(c, y[0]));
  J[2] = v_row ? fm(a, y[0]) : fm(-a, y[1]);
  J[3] = v_row ? 0.0f : a;
  J[4] = v_row ? a : 0.0f;
  J[5] = c;
}

// A level-1 node's 27 sums, J_k J_l (k <= l) then J_k res, from its rows
// `left` (if `has_left`) and `right`: p_left + p_right, or p_right; into
// out, or (`add`) added to it (one rounding each)
__device__ __forceinline__ void node_sums(const float Ja[6], float ra,
                                          const float Jb[6], float rb,
                                          bool has_left, bool add,
                                          float out[kSums]) {
  int e = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int l = k; l < 6; ++l, ++e) {
      const float pb = fm(Jb[k], Jb[l]);
      const float v = has_left ? fa(fm(Ja[k], Ja[l]), pb) : pb;
      out[e] = add ? fa(out[e], v) : v;
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float pb = fm(Jb[k], rb);
    const float v = has_left ? fa(fm(Ja[k], ra), pb) : pb;
    out[21 + k] = add ? fa(out[21 + k], v) : v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gauss_newton_kernel(const float* __restrict__ R0, const float* __restrict__ T0,
                    const float* __restrict__ K, const float* __restrict__ X,
                    const float* __restrict__ uv, const float* __restrict__ w,
                    float* __restrict__ R_out, float* __restrict__ T_out,
                    int n, int per_object, int iters) {
  __shared__ float pose[2][12];         // R row-major, then T; by parity
  __shared__ int halves[kMaxLevels];    // the register levels' half sizes
  __shared__ float slots[2][kSums][kSlots];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t o = p / per_object;
  const float* Xo = X + o * n * 3;
  const float* uvo = uv + o * n * 2;
  const float* wp = w + static_cast<int64_t>(p) * n;
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  // the tree's levels: n_0 = 2n rows, n_{k+1} = n_k - n_k / 2
  int levels = 0, nodes = 2 * n;
  while (nodes > kThreads) {
    if (t == 0) halves[levels] = nodes / 2;
    nodes -= nodes / 2;
    ++levels;
  }
  if (t < 9) pose[0][t] = R0[p * 9 + t];
  else if (t < 12) pose[0][t] = T0[p * 3 + t - 9];
  __syncthreads();
  float P1[kSums];                      // the pending subtree of level 1
  float stack[kStack][kSums];           // and of levels 2, 3, ...
  for (int it = 0; it < iters; ++it) {
    float R[3][3], T[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i / 3][i % 3] = pose[it & 1][i];
#pragma unroll
    for (int i = 0; i < 3; ++i) T[i] = pose[it & 1][9 + i];
    // register levels: node t of level `levels` from its level-1 nodes
    // depth first, each from its two rows at once; bit k - 1 of `path`
    // takes the right child (+ halves[k]) at level k + 1, k >= 1
    if (t < nodes) {
      float Ja[6] = {}, Jb[6], ra = 0.0f, rb;
      if (levels == 0) {                // node t is row t
        jacobian_row(R, T, fx, fy, cx, cy, Xo, uvo, wp, t, Jb, &rb);
        node_sums(Jb, rb, Jb, rb, false, false, P1);
      }
#pragma unroll 1
      for (int path = 0; path < (levels ? 1 << (levels - 1) : 0); ++path) {
        int node = t;
        bool ok = true;
        for (int k = levels - 1; k >= 1; --k) {
          if ((path >> (k - 1)) & 1) node += halves[k];
          else ok = ok && node < halves[k];
        }
        if (!ok) continue;            // a carried node has no left child
        // the level-1 node `node`: rows node (if below halves[0]) and
        // node + halves[0]; added to its left sibling if it has one
        const bool has_left = node < halves[0];
        if (has_left)
          jacobian_row(R, T, fx, fy, cx, cy, Xo, uvo, wp, node, Ja, &ra);
        jacobian_row(R, T, fx, fy, cx, cy, Xo, uvo, wp, node + halves[0], Jb,
                     &rb);
        const bool right1 = levels > 1 && (path & 1);
        node_sums(Ja, ra, Jb, rb, has_left,
                  right1 && node - halves[1] < halves[1], P1);
        if (!right1) continue;        // P1 waits for its right sibling
        // P1 is a level-2 node; up the levels while it is a right child
        node -= halves[1];
        for (int k = 2; k < levels; ++k) {
          if (!((path >> (k - 1)) & 1)) {
#pragma unroll
            for (int e = 0; e < kSums; ++e) stack[k - 2][e] = P1[e];
            break;
          }
          node -= halves[k];
          if (node < halves[k]) {
#pragma unroll
            for (int e = 0; e < kSums; ++e)
              P1[e] = fa(stack[k - 2][e], P1[e]);
          }
        }
      }
    }
    // shared levels: nodes [half, n) to the threads below half
    int n_left = nodes;
    for (int b = 0; n_left > 32; b ^= 1) {
      const int half = n_left / 2;
      if (t >= half && t < n_left) {
#pragma unroll
        for (int e = 0; e < kSums; ++e) slots[b][e][t - half] = P1[e];
      }
      __syncthreads();
      if (t < half) {
#pragma unroll
        for (int e = 0; e < kSums; ++e) P1[e] = fa(P1[e], slots[b][e][t]);
      } else if (t == half && (n_left & 1)) {
#pragma unroll
        for (int e = 0; e < kSums; ++e) P1[e] = slots[b][e][half];
      }
      n_left -= half;
    }
    if (t < 32) {
      // warp levels: lane i + half to lane i, an odd last lane to the middle
      while (n_left > 1) {
        const int half = n_left / 2;
#pragma unroll
        for (int e = 0; e < kSums; ++e) {
          const float q = __shfl_down_sync(0xffffffffu, P1[e], half);
          P1[e] = t < half ? fa(P1[e], q) : q;
        }
        n_left -= half;
      }
    }
    float delta[6];
    if (t == 0) {
      // H = J^T J + 1e-6 I and g = J^T r from the sums, solved by this
      // lane alone in LAPACK's order (lapack_lu.cuh)
      float H[6][6];
      int e = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int l = k; l < 6; ++l, ++e) {
          H[k][l] = fa(P1[e], k == l ? 1e-6f : 0.0f);
          H[l][k] = H[k][l];
        }
#pragma unroll
      for (int k = 0; k < 6; ++k) delta[k] = P1[21 + k];
      tod_lapack::lu_solve<6>(H, delta);
      bool ok = true;
      for (int k = 0; k < 6; ++k) {
        delta[k] = -delta[k];
        ok = ok && isfinite(delta[k]);
      }
      for (int k = 0; k < 6; ++k) delta[k] = ok ? delta[k] : 0.0f;
    }
    if (t == 0) {
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
      for (int i = 0; i < 9; ++i) pose[(it + 1) & 1][i] = Rn[i / 3][i % 3];
      for (int i = 0; i < 3; ++i)
        pose[(it + 1) & 1][9 + i] = fa(T[i], delta[3 + i]);
    }
    __syncthreads();
  }
  if (t < 9) R_out[p * 9 + t] = pose[iters & 1][t];
  else if (t < 12) T_out[p * 3 + t - 9] = pose[iters & 1][t];
}

}  // namespace

// Refine n_poses poses by `iters` Gauss-Newton steps: R0 (n_poses, 3, 3),
// T0 (n_poses, 3), K (3, 3), w (n_poses, n), and per object (each
// `per_object` consecutive poses share one) X (n, 3), uv (n, 2), all
// float32 and contiguous, into R_out / T_out. Any n >= 1. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_gauss_newton(const void* R0, const void* T0, const void* K,
                                const void* X, const void* uv, const void* w,
                                void* R_out, void* T_out, int n_poses, int n,
                                int per_object, int iters, void* stream) {
  if (n_poses <= 0) return 0;
  int levels = 0;
  for (int64_t nodes = 2 * static_cast<int64_t>(n); nodes > kThreads;
       nodes -= nodes / 2)
    ++levels;
  if (n < 1 || per_object < 1 || n_poses % per_object || iters < 0
      || levels > kMaxLevels || 2 * static_cast<int64_t>(n) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  gauss_newton_kernel<<<n_poses, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R0), static_cast<const float*>(T0),
      static_cast<const float*>(K), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(w),
      static_cast<float*>(R_out), static_cast<float*>(T_out), n, per_object,
      iters);
  return static_cast<int>(cudaGetLastError());
}
