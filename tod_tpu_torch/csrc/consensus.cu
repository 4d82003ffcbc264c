// Kernel R1: the 2D path's reprojection consensus on Hopper, bit for bit
// with its plain versions.
//
// R1 replaces, on the card, the reference's consensus and its mirror
// branch (tod_tpu/geometry/detection2d.py:116-124 `count` over every P3P
// candidate, :141-145 `trunc_sse`, :172-190 the mirror poses and their
// counts): not a Pallas kernel, but XLA's fusions of `project`, its
// reduces over the matches and the mirror's dots. The plain versions are
// tod_tpu_torch/geometry/detection2d.py's consensus_counts_torch,
// consensus_select_torch, count_inliers and truncated_sse: rotate_points'
// fused multiply-adds, then (f x / z + c) - u; the SSE's terms summed by
// ops/reduce.py tree_sum (XLA's 32-wide reduce-window, then the windows);
// stable_topk, model_covariance with LAPACK's ssyevd, mirror_poses_torch.
//
// Three entry points, each one launch:
// - counts (tod_consensus_counts): a block a (tile of 128 poses, object),
//   a thread a pose with R and T in registers; the object's points, pixels
//   and valid flags staged in shared memory as SoA, 1,024 at a time, read
//   by every lane at the same address (a broadcast). Writes the (A, H)
//   int32 inlier counts masked by the pose's validity; no (A, H, M) mask.
// - select (tod_consensus_select): a block an object. The stable top 8 of
//   the counts (eight block-wide arg-maxes of (count, -index) keys), the
//   model normal (the mean in tree_sum's order, the covariance one FMA
//   chain a thread an entry, then M2's ssyevd by one thread), M1's mirror
//   of the 8 (a thread each), and the 16 poses' inlier masks and counts
//   (a warp a seed and its mirror).
// - masks (tod_consensus_masks): a warp a pose, for the refinement's
//   recounts and its truncated SSE: the (A, H', M) masks and counts, or
//   the SSE summed in tree_sum's order (a 32-wide window a lane, then the
//   windows' sums in shared memory).
//
// Every float operation is an explicit __f*_rn or __fmaf_rn in the plain
// version's order (nvcc contracts none), divisions __fdiv_rn, so the card
// gives the CPU's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mirror.cuh"

namespace {

using namespace tod_mirror;

constexpr int kPoseThreads = 128;    // counts: poses a block
constexpr int kTile = 1024;          // points staged a pass
constexpr int kSelectThreads = 256;  // select: a block an object
constexpr int kRefine = 8;           // detection2d.N_REFINE
constexpr int kWindow = 32;          // XLA's reduce-window width
constexpr int kMaskWarps = 8;        // masks: poses (warps) a block

struct Camera {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ K) {
  return {K[0], K[4], K[2], K[5]};
}

// detection2d.reprojection_error of one point under one pose (r row-major):
// rotate_points' fma(x2, r2, fma(x1, r1, x0 r0)) + t, then
// ((f x) / zc + c) - u and fma(dv, dv, du du); *front = z > 1e-6
__device__ __forceinline__ float reproject(const float* r, const float* t,
                                           float x, float y, float z,
                                           float u, float v, Camera k,
                                           bool* front) {
  const float cx = fadd(__fmaf_rn(z, r[2], __fmaf_rn(y, r[1], fmul(x, r[0]))),
                        t[0]);
  const float cy = fadd(__fmaf_rn(z, r[5], __fmaf_rn(y, r[4], fmul(x, r[3]))),
                        t[1]);
  const float cz = fadd(__fmaf_rn(z, r[8], __fmaf_rn(y, r[7], fmul(x, r[6]))),
                        t[2]);
  *front = cz > 1e-6f;
  const float zc = fabsf(cz) > 1e-9f ? cz : 1e-9f;
  const float du = fsub(fadd(__fdiv_rn(fmul(cx, k.fx), zc), k.cx), u);
  const float dv = fsub(fadd(__fdiv_rn(fmul(cy, k.fy), zc), k.cy), v);
  return __fmaf_rn(dv, dv, fmul(du, du));
}

// torch.minimum: a NaN wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (a < b ? a : b);
}

// One tile of an object's points in shared memory, SoA.
struct Tile {
  float x[kTile], y[kTile], z[kTile], u[kTile], v[kTile];
  uint8_t ok[kTile];
};

__device__ __forceinline__ void stage(Tile* s, const float* __restrict__ X,
                                      const float* __restrict__ xy,
                                      const uint8_t* __restrict__ valid,
                                      int base, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = base + i;
    s->x[i] = X[3 * j];
    s->y[i] = X[3 * j + 1];
    s->z[i] = X[3 * j + 2];
    s->u[i] = xy[2 * j];
    s->v[i] = xy[2 * j + 1];
    s->ok[i] = valid[j];
  }
}

__global__ void __launch_bounds__(kPoseThreads)
counts_kernel(const float* __restrict__ R, const float* __restrict__ T,
              const float* __restrict__ X, const float* __restrict__ xy,
              const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ pose_ok,
              const float* __restrict__ K, int32_t* __restrict__ counts,
              int n_h, int m, float thr2) {
  __shared__ Tile s;
  const int a = blockIdx.y;
  const int h = blockIdx.x * kPoseThreads + threadIdx.x;
  const int64_t pose = static_cast<int64_t>(a) * n_h + h;
  const bool live = h < n_h && pose_ok[h < n_h ? pose : 0];
  float r[9], t[3];
  for (int i = 0; i < 9; ++i) r[i] = live ? R[9 * pose + i] : 0.0f;
  for (int i = 0; i < 3; ++i) t[i] = live ? T[3 * pose + i] : 0.0f;
  const Camera k = load_camera(K);
  const float* Xa = X + 3 * static_cast<int64_t>(a) * m;
  const float* xya = xy + 2 * static_cast<int64_t>(a) * m;
  const uint8_t* va = valid + static_cast<int64_t>(a) * m;
  int n_in = 0;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();
    stage(&s, Xa, xya, va, base, n);
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      if (!s.ok[i]) continue;            // the same i in every lane
      bool front;
      const float e = reproject(r, t, s.x[i], s.y[i], s.z[i], s.u[i],
                                s.v[i], k, &front);
      n_in += front && e < thr2;
    }
  }
  if (h < n_h) counts[pose] = n_in;
}

// The block-wide maximum of one 64-bit key a thread (every thread calls).
__device__ unsigned long long block_max(unsigned long long key,
                                        unsigned long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
    key = other > key ? other : key;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = key;
  __syncthreads();
  unsigned long long best = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    best = scratch[w] > best ? scratch[w] : best;
  return best;
}

// XLA's tree order over n values of `src` (n > kWindow): windows of
// kWindow over the values padded with (pad / 2) zeros in front, each
// added in order from +0, into `dst`; returns the windows' count. Lanes
// `first`..: a window a lane, `stride` lanes in all.
__device__ __forceinline__ int window_level(const float* src, float* dst,
                                            int n, int first, int stride) {
  const int nw = (n + kWindow - 1) / kWindow;
  const int front = (nw * kWindow - n) / 2;
  for (int w = first; w < nw; w += stride) {
    float s = 0.0f;
    for (int i = 0; i < kWindow; ++i) {
      const int j = w * kWindow + i - front;
      s = fadd(s, (j >= 0 && j < n) ? src[j] : 0.0f);
    }
    dst[w] = s;
  }
  return nw;
}

// The model's mean coordinate c (0..2): the tree sum of where(valid, X, 0)
// over m points (ops/reduce.py tree_sum), by the whole block. buf: two
// arrays of ceil(m / kWindow) floats. Every thread gets the sum.
__device__ float tree_mean_sum(const float* __restrict__ Xa,
                               const uint8_t* __restrict__ va, int m, int c,
                               float* buf0, float* buf1, float* result) {
  if (m <= kWindow) {
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int j = 0; j < m; ++j) s = fadd(s, va[j] ? Xa[3 * j + c] : 0.0f);
      *result = s;
    }
    __syncthreads();
    return *result;
  }
  int n;
  {
    const int nw = (m + kWindow - 1) / kWindow;
    const int front = (nw * kWindow - m) / 2;
    for (int w = threadIdx.x; w < nw; w += blockDim.x) {
      float s = 0.0f;
      for (int i = 0; i < kWindow; ++i) {
        const int j = w * kWindow + i - front;
        s = fadd(s, (j >= 0 && j < m && va[j]) ? Xa[3 * j + c] : 0.0f);
      }
      buf0[w] = s;
    }
    n = nw;
  }
  __syncthreads();
  float* src = buf0;
  float* dst = buf1;
  while (n > kWindow) {
    n = window_level(src, dst, n, threadIdx.x, blockDim.x);
    __syncthreads();
    float* swap = src;
    src = dst;
    dst = swap;
  }
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s = fadd(s, src[j]);
    *result = s;
  }
  __syncthreads();
  return *result;
}

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const int32_t* __restrict__ counts, const float* __restrict__ R,
              const float* __restrict__ T, const float* __restrict__ X,
              const float* __restrict__ xy, const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ pose_ok, const float* __restrict__ K,
              int64_t* __restrict__ top_out, int32_t* __restrict__ top_n_out,
              float* __restrict__ r_out, float* __restrict__ t_out,
              uint8_t* __restrict__ masks, int32_t* __restrict__ n_out,
              float* __restrict__ normal_out, int n_h, int m, float thr2) {
  extern __shared__ float tree_buf[];     // 2 x ceil(m / kWindow) floats
  __shared__ Tile s;
  __shared__ unsigned long long scratch[kSelectThreads / 32];
  __shared__ int s_top[kRefine], s_top_n[kRefine];
  __shared__ float s_mean[3], s_cov[9], s_normal[3], s_sum;
  __shared__ float s_r[2 * kRefine][9], s_t[2 * kRefine][3];
  __shared__ int s_n[2 * kRefine];
  __shared__ int s_valid;
  const int a = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int32_t* ca = counts + static_cast<int64_t>(a) * n_h;
  const float* Ra = R + 9 * static_cast<int64_t>(a) * n_h;
  const float* Ta = T + 3 * static_cast<int64_t>(a) * n_h;
  const float* Xa = X + 3 * static_cast<int64_t>(a) * m;
  const float* xya = xy + 2 * static_cast<int64_t>(a) * m;
  const uint8_t* va = valid + static_cast<int64_t>(a) * m;

  // 1. stable_topk(counts, 8): (count, ~index) keys, ties to the lower index
  unsigned long long last = ~0ull;
  for (int r = 0; r < kRefine; ++r) {
    unsigned long long best = 0;
    for (int h = tid; h < n_h; h += kSelectThreads) {
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(ca[h]))
           << 32) | (0xffffffffu - static_cast<uint32_t>(h));
      if (key < last && key > best) best = key;
    }
    last = block_max(best, scratch);
    if (tid == 0) {
      s_top[r] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(last));
      s_top_n[r] = static_cast<int>(last >> 32);
    }
  }
  if (tid == 0) s_valid = 0;
  __syncthreads();

  // 2. the model normal: the mean in XLA's tree order, the covariance one
  // FMA chain from +0 an entry (model_covariance), ssyevd's column 0
  int n_valid = 0;
  for (int j = tid; j < m; j += kSelectThreads) n_valid += va[j] != 0;
  for (int o = 16; o > 0; o >>= 1) n_valid += __shfl_xor_sync(0xffffffffu,
                                                              n_valid, o);
  if (lane == 0) atomicAdd(&s_valid, n_valid);
  const int nw = (m + kWindow - 1) / kWindow;
  for (int c = 0; c < 3; ++c) {
    const float sum = tree_mean_sum(Xa, va, m, c, tree_buf, tree_buf + nw,
                                    &s_sum);
    if (tid == 0)
      s_mean[c] = __fdiv_rn(sum, __int2float_rn(max(s_valid, 1)));
    __syncthreads();
  }
  const int ci = tid / 3, cj = tid % 3;
  float cov = 0.0f;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();
    stage(&s, Xa, xya, va, base, n);
    __syncthreads();
    if (tid < 9) {
      const float mi = s_mean[ci], mj = s_mean[cj];
      const float* col_i = ci == 0 ? s.x : (ci == 1 ? s.y : s.z);
      const float* col_j = cj == 0 ? s.x : (cj == 1 ? s.y : s.z);
      for (int i = 0; i < n; ++i) {
        const bool ok = s.ok[i];
        const float di = fsub(ok ? col_i[i] : 0.0f, mi);
        const float dj = fsub(ok ? col_j[i] : 0.0f, mj);
        cov = __fmaf_rn(fmul(di, ok ? 1.0f : 0.0f), dj, cov);
      }
    }
  }
  if (tid < 9) s_cov[tid] = cov;
  __syncthreads();
  if (tid == 0) sym3_one(s_cov, s_normal);
  __syncthreads();

  // 3. the seeds and M1's mirrors of them
  if (tid < kRefine) {
    const int h = s_top[tid];
    for (int i = 0; i < 9; ++i) s_r[tid][i] = Ra[9 * static_cast<int64_t>(h) + i];
    for (int i = 0; i < 3; ++i) s_t[tid][i] = Ta[3 * static_cast<int64_t>(h) + i];
    mirror_one(Ra + 9 * static_cast<int64_t>(h), Ta + 3 * static_cast<int64_t>(h),
               s_normal, s_r[kRefine + tid], s_t[kRefine + tid]);
  }
  __syncthreads();

  // 4. the 16 poses' masks and counts: warp w the seed w and its mirror;
  // a seed's mask carries its validity, a mirror's the seed's count >= 3
  const Camera k = load_camera(K);
  const int64_t pose0 = static_cast<int64_t>(a) * 2 * kRefine;
  int n_in[2] = {0, 0};
  bool keep[2];
  keep[0] = pose_ok[static_cast<int64_t>(a) * n_h + s_top[warp]] != 0;
  keep[1] = s_top_n[warp] >= 3;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    if (m > kTile) {                     // else the tile of step 2 stays
      __syncthreads();
      stage(&s, Xa, xya, va, base, n);
      __syncthreads();
    }
    for (int q = 0; q < 2; ++q) {
      const int p = warp + q * kRefine;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        bool in = false;
        if (i < n && s.ok[i] && keep[q]) {
          bool front;
          const float e = reproject(s_r[p], s_t[p], s.x[i], s.y[i], s.z[i],
                                    s.u[i], s.v[i], k, &front);
          in = front && e < thr2;
        }
        if (i < n) masks[(pose0 + p) * m + base + i] = in;
        n_in[q] += __popc(__ballot_sync(0xffffffffu, in));
      }
    }
  }
  if (lane == 0) {
    s_n[warp] = n_in[0];
    s_n[warp + kRefine] = n_in[1];
  }
  __syncthreads();
  if (tid < 2 * kRefine) {
    for (int i = 0; i < 9; ++i) r_out[9 * (pose0 + tid) + i] = s_r[tid][i];
    for (int i = 0; i < 3; ++i) t_out[3 * (pose0 + tid) + i] = s_t[tid][i];
    n_out[pose0 + tid] = s_n[tid];
  }
  if (tid < kRefine) {
    top_out[static_cast<int64_t>(a) * kRefine + tid] = s_top[tid];
    top_n_out[static_cast<int64_t>(a) * kRefine + tid] = s_top_n[tid];
  }
  if (tid < 3) normal_out[3 * static_cast<int64_t>(a) + tid] = s_normal[tid];
}

__global__ void __launch_bounds__(kMaskWarps * 32)
masks_kernel(const float* __restrict__ R, const float* __restrict__ T,
             const float* __restrict__ X, const float* __restrict__ xy,
             const uint8_t* __restrict__ valid, const float* __restrict__ K,
             uint8_t* __restrict__ masks, int32_t* __restrict__ counts,
             float* __restrict__ sse, int n_poses, int n_h, int m,
             float thr2, float cap) {
  extern __shared__ float tree_buf[];     // a warp: 2 x ceil(m / kWindow)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kMaskWarps + warp;
  if (p >= n_poses) return;               // a whole warp
  const int64_t a = p / n_h;
  float r[9], t[3];
  for (int i = 0; i < 9; ++i) r[i] = R[9 * p + i];
  for (int i = 0; i < 3; ++i) t[i] = T[3 * p + i];
  const Camera k = load_camera(K);
  const float* Xa = X + 3 * a * m;
  const float* xya = xy + 2 * a * m;
  const uint8_t* va = valid + a * m;
  if (masks || counts) {
    int n_in = 0;
    for (int i0 = 0; i0 < m; i0 += 32) {
      const int j = i0 + lane;
      bool in = false;
      if (j < m && va[j]) {
        bool front;
        const float e = reproject(r, t, Xa[3 * j], Xa[3 * j + 1],
                                  Xa[3 * j + 2], xya[2 * j], xya[2 * j + 1],
                                  k, &front);
        in = front && e < thr2;
      }
      if (j < m && masks) masks[p * m + j] = in;
      n_in += __popc(__ballot_sync(0xffffffffu, in));
    }
    if (counts && lane == 0) counts[p] = n_in;
  }
  if (!sse) return;
  // truncated_sse: where(valid, min(where(front, e, cap), cap), 0), summed
  // in XLA's tree order
  auto term = [&](int j) -> float {
    if (j < 0 || j >= m || !va[j]) return 0.0f;
    bool front;
    const float e = reproject(r, t, Xa[3 * j], Xa[3 * j + 1], Xa[3 * j + 2],
                              xya[2 * j], xya[2 * j + 1], k, &front);
    return nan_min(front ? e : cap, cap);
  };
  if (m <= kWindow) {
    float s = 0.0f;
    for (int j = 0; j < m; ++j) s = fadd(s, term(j));
    if (lane == 0) sse[p] = s;
    return;
  }
  const int nw = (m + kWindow - 1) / kWindow;
  float* src = tree_buf + warp * 2 * nw;
  float* dst = src + nw;
  const int front = (nw * kWindow - m) / 2;
  for (int w = lane; w < nw; w += 32) {
    float s = 0.0f;
    for (int i = 0; i < kWindow; ++i) s = fadd(s, term(w * kWindow + i - front));
    src[w] = s;
  }
  __syncwarp();
  int n = nw;
  while (n > kWindow) {
    n = window_level(src, dst, n, lane, 32);
    __syncwarp();
    float* swap = src;
    src = dst;
    dst = swap;
  }
  if (lane == 0) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s = fadd(s, src[j]);
    sse[p] = s;
  }
}

__device__ __host__ inline float float_of(int bits) {
  union {
    int i;
    float f;
  } u;
  u.i = bits;
  return u.f;
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// counts (A, H) int32: the inliers of each of the A x H poses (R: 9
// floats, T: 3) over its object's m points (X: 3 floats, xy: 2, valid:
// one byte), 0 where pose_ok is 0. K: the 3x3 camera on the card; thr2:
// the float's bits. Launches on `stream` and returns cudaGetLastError();
// it neither allocates nor synchronises.
extern "C" int tod_consensus_counts(const void* R, const void* T,
                                    const void* X, const void* xy,
                                    const void* valid, const void* pose_ok,
                                    const void* K, void* counts, int n_a,
                                    int n_h, int m, int thr2_bits,
                                    void* stream) {
  if (n_a <= 0 || n_h <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_h + kPoseThreads - 1) / kPoseThreads, n_a);
  counts_kernel<<<grid, kPoseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(T),
      static_cast<const float*>(X), static_cast<const float*>(xy),
      static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(pose_ok), static_cast<const float*>(K),
      static_cast<int32_t*>(counts), n_h, m, float_of(thr2_bits));
  return static_cast<int>(cudaGetLastError());
}

// For each of n_a objects, from its (n_h,) counts and poses: top (8) int64
// and top_n (8) int32, the stable top 8; r_out (16 x 9) and t_out (16 x 3)
// the 8 seeds then their mirrors about the model normal (normal_out, 3);
// masks (16 x m bytes) and n_out (16) int32 the 16 poses' inliers, a
// seed's where its pose_ok, a mirror's where its seed's count >= 3.
// n_h >= 8. Launches on `stream` and returns cudaGetLastError().
extern "C" int tod_consensus_select(const void* counts, const void* R,
                                    const void* T, const void* X,
                                    const void* xy, const void* valid,
                                    const void* pose_ok, const void* K,
                                    void* top, void* top_n, void* r_out,
                                    void* t_out, void* masks, void* n_out,
                                    void* normal_out, int n_a, int n_h,
                                    int m, int thr2_bits, void* stream) {
  if (n_a <= 0) return 0;
  if (n_h < kRefine || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * ((m + kWindow - 1) / kWindow + 1);
  if (const int err = set_smem(reinterpret_cast<const void*>(select_kernel),
                               smem))
    return err;
  select_kernel<<<n_a, kSelectThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<const float*>(R),
      static_cast<const float*>(T), static_cast<const float*>(X),
      static_cast<const float*>(xy), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(pose_ok), static_cast<const float*>(K),
      static_cast<int64_t*>(top), static_cast<int32_t*>(top_n),
      static_cast<float*>(r_out), static_cast<float*>(t_out),
      static_cast<uint8_t*>(masks), static_cast<int32_t*>(n_out),
      static_cast<float*>(normal_out), n_h, m, float_of(thr2_bits));
  return static_cast<int>(cudaGetLastError());
}

// For each of the n_a x n_h poses (a warp each) over its object's m points:
// masks (m bytes a pose) and counts (int32) of its inliers, and sse
// (float) its truncated squared error (cap: the float's bits); a null
// output is skipped. Launches on `stream` and returns cudaGetLastError().
extern "C" int tod_consensus_masks(const void* R, const void* T,
                                   const void* X, const void* xy,
                                   const void* valid, const void* K,
                                   void* masks, void* counts, void* sse,
                                   int n_a, int n_h, int m, int thr2_bits,
                                   int cap_bits, void* stream) {
  const int n_poses = n_a * n_h;
  if (n_poses <= 0) return 0;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sse ? kMaskWarps * 2 * sizeof(float) *
                                ((m + kWindow - 1) / kWindow)
                          : 0;
  if (const int err = set_smem(reinterpret_cast<const void*>(masks_kernel),
                               smem))
    return err;
  masks_kernel<<<(n_poses + kMaskWarps - 1) / kMaskWarps, kMaskWarps * 32,
                 smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(T),
      static_cast<const float*>(X), static_cast<const float*>(xy),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(K),
      static_cast<uint8_t*>(masks), static_cast<int32_t*>(counts),
      static_cast<float*>(sse), n_poses, n_h, m, float_of(thr2_bits),
      float_of(cap_bits));
  return static_cast<int>(cudaGetLastError());
}
