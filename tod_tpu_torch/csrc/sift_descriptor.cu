// SIFT descriptor histograms on Hopper, summed in the compiled reference's
// order, and Lowe's normalisation.
//
// L2 tod_sift_contract replaces, on the card, the reference's contraction
// of the soft-binned gradient weights with the rotated spatial tables
// (tod_tpu/ops/sift.py:121-128: jnp.einsum over 1,369 pixels for all 32
// angle bins, then a one-hot einsum that keeps the keypoint's bin) and its
// normalisation (:131-134): not a Pallas kernel, but XLA's CPU dot, whose
// oneDNN kernel sums each output in one of three orders that depend on the
// product's width (tod_tpu_torch/ops/sift.py contraction_order,
// contraction_groups). For keypoint k, cell s and orientation o:
//     p_g = fma chain, ascending depth, over the nonzero taps (depth, w)
//           of column 16 bins[k] + s that fall in partial g (of 4),
//           p_g = fma(w, t[k][depth][o], p_g) from +0;
//     d   = (p0 + p1) + (p2 + p3);
// then, over the keypoint's 128 d (cell-major): n = sqrt of the squares
// added in order within each 32-wide window from +0 and the 4 windows
// added in order; d = min(d / (n + 1e-9), 0.2); the same norm again;
// out = d / (n + 1e-9). Zero taps are skipped: every term is >= +0, and
// the reference's one-hot selection adds exact zeros. Every operation is
// rounded as the reference's is: __fmaf_rn for its fused chains,
// __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn elsewhere, which nvcc
// never contracts. The plain versions are ops/sift.py sift_contract_torch
// and sift_normalize_torch.
//
// Design: one block of 128 threads a keypoint, a thread an output (s, o).
// Only the pixels that the 16 cells of the keypoint's angle bin read are
// staged in shared memory, 8 floats (32 bytes) a pixel with 16-byte loads:
// 841-901 of the 1,369 (26,912-28,832 of 43,808 bytes; the rotated cells
// reach |offset| < 15 along their own axes). Each thread then runs its
// four chains over the taps of its column (121-146 taps, each a slot in
// the staged pixels; the 8 threads of a cell read one tap each step, a
// broadcast), and the block normalises its 128 sums in shared memory. The
// tap tables (slots, weights, each column's partial bounds, each bin's
// pixels) are built and uploaded once a device and order.
//
// Bound on the H100: each staged pixel is read once, ~28,000 bytes a
// keypoint, against 16 x 8 x ~135 FMAs; the bytes bound it (3.35 TB/s
// against the 67 TFLOP/s float32 rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 1369;
constexpr int kOri = 8;
constexpr int kCells = 16;
constexpr int kGroups = 4;
constexpr int kDim = kCells * kOri;            // 128, one thread each
constexpr int kWindow = 32;                    // the norm's reduce window
constexpr int kWeights = kDepth * kOri;        // 10,952 floats a keypoint
constexpr int kMaxPixels = 912;                // ops/sift.py MAX_PIXELS

__device__ __forceinline__ float norm_of(const float* desc, float* win,
                                         float* scale) {
  const int tid = threadIdx.x;
  if (tid < kDim / kWindow) {
    float acc = 0.0f;
    for (int i = 0; i < kWindow; ++i) {
      const float v = desc[tid * kWindow + i];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    win[tid] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < kDim / kWindow; ++w) total = __fadd_rn(total, win[w]);
    *scale = __fadd_rn(__fsqrt_rn(total), 1e-9f);
  }
  __syncthreads();
  return *scale;
}

__global__ void __launch_bounds__(kDim)
sift_contract_kernel(const float* __restrict__ t,
                     const int32_t* __restrict__ bins,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ slots,
                     const float* __restrict__ weights,
                     const int32_t* __restrict__ pixel_starts,
                     const int32_t* __restrict__ pixels,
                     float* __restrict__ out) {
  __shared__ __align__(16) float weight_tile[kMaxPixels * kOri];
  __shared__ float desc[kDim];
  __shared__ float win[kDim / kWindow];
  __shared__ float scale;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int bin = __ldg(bins + k);
  const int first = __ldg(pixel_starts + bin);
  const int n_pixels = __ldg(pixel_starts + bin + 1) - first;
  const float4* src =
      reinterpret_cast<const float4*>(t + static_cast<int64_t>(k) * kWeights);
  float4* dst = reinterpret_cast<float4*>(weight_tile);
  // two 16-byte halves a pixel: the pixel's 8 orientations
  for (int i = tid; i < 2 * n_pixels; i += kDim)
    dst[i] = __ldg(src + 2 * __ldg(pixels + first + i / 2) + i % 2);
  __syncthreads();

  const int cell = tid / kOri, o = tid % kOri;
  const int col = bin * kCells + cell;
  float part[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    float acc = 0.0f;
    const int end = __ldg(starts + col * kGroups + g + 1);
    for (int i = __ldg(starts + col * kGroups + g); i < end; ++i) {
      acc = __fmaf_rn(__ldg(weights + i),
                      weight_tile[__ldg(slots + i) * kOri + o], acc);
    }
    part[g] = acc;
  }
  float d = __fadd_rn(__fadd_rn(part[0], part[1]),
                      __fadd_rn(part[2], part[3]));
  desc[tid] = d;
  __syncthreads();
  d = fminf(__fdiv_rn(d, norm_of(desc, win, &scale)), 0.2f);
  desc[tid] = d;
  __syncthreads();
  out[static_cast<int64_t>(k) * kDim + tid] =
      __fdiv_rn(d, norm_of(desc, win, &scale));
}

}  // namespace

// out (k_count, 128) float32 from t (k_count, 1369, 8) float32, bins
// (k_count,) int32 in [0, 32), and the order's tap tables: starts (512 x 4
// + 1) int32, slots and weights (starts[2048]) int32 and float32, each
// bin's pixels pixel_starts (33) int32 and pixels (pixel_starts[32]) int32,
// at most kMaxPixels a bin. Launches on `stream` and returns
// cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_sift_contract(const void* t, const void* bins,
                                 const void* starts, const void* slots,
                                 const void* weights,
                                 const void* pixel_starts, const void* pixels,
                                 void* out, int k_count, void* stream) {
  if (k_count <= 0) return 0;
  sift_contract_kernel<<<k_count, kDim, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const int32_t*>(bins),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(slots),
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(pixel_starts),
      static_cast<const int32_t*>(pixels), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
