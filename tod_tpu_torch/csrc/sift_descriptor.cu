// SIFT descriptors on Hopper, from the level image to the normalised 128
// floats in one kernel, every operation rounded as the compiled reference
// rounds it.
//
// L2 tod_sift_describe replaces, on the card, the reference's descriptor
// (tod_tpu/ops/sift.py:93-134: the patches, their central differences, the
// fused sum of squares and its root, libm's atan2f, the soft orientation
// bins, XLA's dot of the rotated spatial tables for all 32 angle bins, the
// one-hot einsum that keeps the keypoint's bin, Lowe's normalisation): not
// a Pallas kernel, but XLA's CPU fusions, a libm call and a oneDNN dot.
// For keypoint k at integer (x, y) with angle a, the patch is the 37 x 37
// pixels from (clamp(y - 18), clamp(x - 18)); for each pixel p of it that
// the 16 cells of k's angle bin read:
//     gx, gy = the central differences (0 on the patch's border);
//     mag    = sqrt(fma(gx, gx, gy * gy)), correctly rounded;
//     rel    = remainder((atan2f(gy, gx) - a) * f32(8 / 2 pi), 8)
//              (libm_f32.cuh; fmod, then + 8 where negative; fmod exact
//              by one subtraction below 16);
//     b0     = floor(rel) mod 8, frac = rel - floor(rel),
//     w0     = mag * (1 - frac) at orientation b0, w1 = mag * frac at
//              b0 + 1 mod 8, 0 at the other six;
// then for cell s and orientation o, the partial sums g (of 4) of the
// nonzero taps (depth p, weight W) of table column 16 bin + s:
//     p_g = fma(W, w(p, o), p_g) from +0 in ascending depth,
//     d   = (p0 + p1) + (p2 + p3);
// and over the keypoint's 128 d (cell-major): n = sqrt of the squares
// added in order within each 32-wide window from +0 and the 4 windows in
// order; d = min(d / (n + 1e-9), 0.2); the same norm again; out = d / (n +
// 1e-9). The partials follow the oneDNN kernel under XLA's dot, which
// depends on the product's width (tod_tpu_torch/ops/sift.py
// contraction_order, contraction_groups). A tap whose orientation is
// neither b0 nor b1 adds fma(W, +0, acc) = acc (every term is >= +0), as
// the reference's zeros do. Every operation is an explicit __fmaf_rn /
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which nvcc
// never contracts. The plain version is ops/sift.py sift_describe_torch
// (gradients, soft_bins, sift_contract_torch, sift_normalize_torch).
//
// Design: a pre-pass of one block (tod_sift_describe launches both on the
// stream) groups the keypoints by angle bin, in index order within a bin,
// and cuts each bin's list into items of kPerBlock = 4; block b of the
// describe kernel reads item b's bin and keypoints (O(K) work in all, not
// a scan of the K angles a block). Warp s computes cell s, a thread an
// orientation of one keypoint, so a warp's
// taps are one list (no divergence, the tap's slot and weight a
// broadcast). The block stages its bin's tap tables (slots, weights, each
// cell's partial bounds, the bin's pixels) in shared memory once for its
// keypoints, then their 4 patches (1,369 floats each), from which the
// threads make the two weights and the first bin of each pixel the bin
// taps (841-901 of the 1,369), kept in shared memory (rows padded so that
// the 4 keypoints of a slot sit in distinct banks), never an 8-wide
// weight vector. Each thread runs its output's four partial chains
// interleaved, and the block normalises its sums in shared memory (~72 KB
// a block: 3 blocks, 48 warps, an SM). Bound on the H100: the level
// image, the positions, angles and outputs and the tap tables read once,
// against ~45 float operations a tapped pixel and an FMA a tap and
// nonzero orientation (two of the eight) at the float32 rate (operations
// bound it). The tap chains
// take about half its time, four shared-memory loads a tap and warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kPatchR = 18;
constexpr int kPatchW = 2 * kPatchR + 1;       // 37
constexpr int kDepth = kPatchW * kPatchW;      // 1,369
constexpr int kOri = 8;
constexpr int kCells = 16;
constexpr int kGroups = 4;
constexpr int kBins = 32;
constexpr int kDim = kCells * kOri;            // 128 outputs a keypoint
constexpr int kWindow = 32;                    // the norm's reduce window
constexpr int kMaxPixels = 912;                // ops/sift.py MAX_PIXELS
constexpr int kMaxTaps = 2560;                 // ops/sift.py MAX_BIN_TAPS
constexpr int kPerBlock = 4;                   // keypoints a block
constexpr int kThreads = kCells * kPerBlock * kOri;   // 512: warp = cell
constexpr int kW01Row = kMaxPixels + 1;        // float2s: banks +2 a row
constexpr int kB0Row = kMaxPixels + 4;         // bytes: banks +5 a row

struct Shared {
  float weight[kMaxTaps];                      // the bin's taps
  uint16_t slot[kMaxTaps];
  uint16_t pixel[kMaxPixels];                  // the bin's pixels
  int bounds[kCells * kGroups + 1];            // partials, from the bin's first
  union {
    float patch[kPerBlock][kDepth];            // while the pixels are made
    float desc[kPerBlock][kDim];               // then the sums
  };
  float2 w01[kPerBlock][kW01Row];              // (w0, w1) a tapped pixel
  uint8_t b0[kPerBlock][kB0Row];
  float win[kPerBlock][kDim / kWindow];
  float scale[kPerBlock];
  int corner[kPerBlock][2];                    // the patches' (sy, sx)
  float angle[kPerBlock];
  int sel[kPerBlock];                          // the block's keypoints
  int item[2];                                 // bin, count
};

// the pre-pass's output, int32: the bins' first items (kBins + 1, an
// exclusive prefix of ceil(count / kPerBlock)), their first positions in
// the grouped list (kBins + 1), then the grouped list (k_count)
constexpr int kItems = 0;
constexpr int kStarts = kBins + 1;
constexpr int kOrder = 2 * (kBins + 1);
constexpr int kRankThreads = 1024;

// ops/orb.py angle_bins: round(angle x f32(32 / 2 pi)) half to even, then
// torch.remainder by 32
__device__ __forceinline__ int angle_bin(float a, float scale) {
  float m = rintf(__fmul_rn(a, scale));
  if (!(fabsf(m) < 32.0f)) m = fmodf(m, 32.0f);
  return static_cast<int>(m < 0.0f ? __fadd_rn(m, 32.0f) : m);
}

// one block: the keypoints grouped by angle bin into `scratch` (kItems,
// kStarts, kOrder), in index order within a bin (the counts by shared
// atomics, then a chunk of kRankThreads at a time ranked by
// __match_any_sync within a warp and by the earlier warps' counts)
__global__ void __launch_bounds__(kRankThreads)
sift_rank_kernel(const float* __restrict__ angle, int k_count,
                 int bin_scale_bits, int* __restrict__ scratch) {
  constexpr int kWarps = kRankThreads / 32;
  __shared__ int count[kBins];
  __shared__ int next[kBins];                     // the bin's next position
  __shared__ int warp_bins[kWarps][kBins];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float bin_scale = __int_as_float(bin_scale_bits);
  if (tid < kBins) count[tid] = 0;
  __syncthreads();
  for (int k = tid; k < k_count; k += kRankThreads)
    atomicAdd(&count[angle_bin(__ldg(angle + k), bin_scale)], 1);
  __syncthreads();
  if (warp == 0) {                                // inclusive scans
    const int c = count[lane], c_items = (c + kPerBlock - 1) / kPerBlock;
    int items = c_items, start = c;
    for (int d = 1; d < kBins; d *= 2) {
      const int n_items = __shfl_up_sync(0xffffffffu, items, d);
      const int n_start = __shfl_up_sync(0xffffffffu, start, d);
      if (lane >= d) {
        items += n_items;
        start += n_start;
      }
    }
    scratch[kItems + lane] = items - c_items;
    scratch[kStarts + lane] = start - c;
    next[lane] = start - c;
    if (lane == kBins - 1) {
      scratch[kItems + kBins] = items;
      scratch[kStarts + kBins] = start;
    }
  }
  int* order = scratch + kOrder;
  for (int base = 0; base < k_count; base += kRankThreads) {
    for (int i = tid; i < kWarps * kBins; i += kRankThreads)
      warp_bins[i / kBins][i % kBins] = 0;
    __syncthreads();
    const int k = base + tid;
    const int bin = k < k_count ? angle_bin(__ldg(angle + k), bin_scale)
                                : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (bin >= 0 && rank == 0) warp_bins[warp][bin] = __popc(peers);
    __syncthreads();
    if (bin >= 0) {
      int before = next[bin] + rank;
      for (int w = 0; w < warp; ++w) before += warp_bins[w][bin];
      order[before] = k;
    }
    __syncthreads();
    if (tid < kBins)
      for (int w = 0; w < kWarps; ++w) next[tid] += warp_bins[w][tid];
    __syncthreads();
  }
}

// warp 0: the block's item from the pre-pass (sm.item, sm.sel); count 0
// past the last item
__device__ __forceinline__ void read_item(const int* __restrict__ scratch,
                                          Shared& sm) {
  const int lane = threadIdx.x, b = static_cast<int>(blockIdx.x);
  const unsigned hit = __ballot_sync(
      0xffffffffu, b >= __ldg(scratch + kItems + lane)
                   && b < __ldg(scratch + kItems + lane + 1));
  if (hit == 0) {                                 // empty bins never hit
    if (lane == 0) sm.item[1] = 0;
    return;
  }
  const int bin = __ffs(hit) - 1;
  const int start = __ldg(scratch + kStarts + bin);
  const int rank0 = (b - __ldg(scratch + kItems + bin)) * kPerBlock;
  const int count = min(kPerBlock,
                        __ldg(scratch + kStarts + bin + 1) - start - rank0);
  if (lane < count)
    sm.sel[lane] = __ldg(scratch + kOrder + start + rank0 + lane);
  if (lane == 0) {
    sm.item[0] = bin;
    sm.item[1] = count;
  }
}

// fmod(rel, 8) then + 8 where negative: torch.remainder's (and jnp.mod's)
// float rule; below 16 the fmod is one exact subtraction
__device__ __forceinline__ float remainder8(float rel) {
  const float mag = fabsf(rel);
  float m = rel;
  if (!(mag < 8.0f))
    m = mag < 16.0f ? copysignf(__fsub_rn(mag, 8.0f), rel)
                    : fmodf(rel, 8.0f);
  return m < 0.0f ? __fadd_rn(m, 8.0f) : m;
}

// 1 / (the norm + 1e-9) of each keypoint's sums: the squares added in
// order within each 32-wide window from +0, the windows in order
__device__ __forceinline__ void norm_scales(Shared& sm) {
  const int tid = threadIdx.x;
  if (tid < kPerBlock * (kDim / kWindow)) {
    const int j = tid / (kDim / kWindow), w = tid % (kDim / kWindow);
    float acc = 0.0f;
    for (int i = 0; i < kWindow; ++i) {
      const float v = sm.desc[j][w * kWindow + i];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    sm.win[j][w] = acc;
  }
  __syncthreads();
  if (tid < kPerBlock) {
    float total = 0.0f;
    for (int w = 0; w < kDim / kWindow; ++w)
      total = __fadd_rn(total, sm.win[tid][w]);
    sm.scale[tid] = __fadd_rn(__fsqrt_rn(total), 1e-9f);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sift_describe_kernel(const float* __restrict__ image, int height, int width,
                     const int32_t* __restrict__ xy,
                     const float* __restrict__ angle, int rel_scale_bits,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ slots,
                     const float* __restrict__ weights,
                     const int32_t* __restrict__ pixel_starts,
                     const int32_t* __restrict__ pixels,
                     const int* __restrict__ scratch,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sm = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x;
  const float rel_scale = __int_as_float(rel_scale_bits);
  if (tid < 32) read_item(scratch, sm);
  __syncthreads();
  const int bin = sm.item[0], count = sm.item[1];
  if (count == 0) return;

  // the bin's tap tables and pixels, the keypoints' corners and angles
  const int tap0 = __ldg(starts + bin * kCells * kGroups);
  const int n_taps = __ldg(starts + (bin + 1) * kCells * kGroups) - tap0;
  for (int i = tid; i < n_taps; i += kThreads) {
    sm.weight[i] = __ldg(weights + tap0 + i);
    sm.slot[i] = static_cast<uint16_t>(__ldg(slots + tap0 + i));
  }
  if (tid <= kCells * kGroups)
    sm.bounds[tid] = __ldg(starts + bin * kCells * kGroups + tid) - tap0;
  const int pix0 = __ldg(pixel_starts + bin);
  const int n_pixels = __ldg(pixel_starts + bin + 1) - pix0;
  for (int i = tid; i < n_pixels; i += kThreads)
    sm.pixel[i] = static_cast<uint16_t>(__ldg(pixels + pix0 + i));
  if (tid < count) {
    const int k = sm.sel[tid];
    sm.corner[tid][0] = min(max(__ldg(xy + 2 * k + 1) - kPatchR, 0),
                            height - kPatchW);
    sm.corner[tid][1] = min(max(__ldg(xy + 2 * k) - kPatchR, 0),
                            width - kPatchW);
    sm.angle[tid] = __ldg(angle + k);
  }
  __syncthreads();

  // the patches, then each tapped pixel's (w0, w1) and b0
  for (int i = tid; i < count * kDepth; i += kThreads) {
    const int j = i / kDepth, p = i % kDepth;
    sm.patch[j][p] = __ldg(image + static_cast<int64_t>(
        sm.corner[j][0] + p / kPatchW) * width + sm.corner[j][1]
        + p % kPatchW);
  }
  __syncthreads();
  for (int i = tid; i < count * n_pixels; i += kThreads) {
    const int j = i / n_pixels, slot = i % n_pixels;
    const float* patch = sm.patch[j];
    const int p = sm.pixel[slot];
    const int r = p / kPatchW, c = p % kPatchW;
    const float gx = c >= 1 && c < kPatchW - 1
        ? __fsub_rn(patch[p + 1], patch[p - 1]) : 0.0f;
    const float gy = r >= 1 && r < kPatchW - 1
        ? __fsub_rn(patch[p + kPatchW], patch[p - kPatchW]) : 0.0f;
    const float mag = __fsqrt_rn(__fmaf_rn(gx, gx, __fmul_rn(gy, gy)));
    const float rel = remainder8(__fmul_rn(
        __fsub_rn(tod_libm::atan2f_libm(gy, gx), sm.angle[j]), rel_scale));
    const float bin0 = floorf(rel);
    const float frac = __fsub_rn(rel, bin0);
    sm.w01[j][slot] = make_float2(__fmul_rn(mag, __fsub_rn(1.0f, frac)),
                                  __fmul_rn(mag, frac));
    sm.b0[j][slot] = static_cast<uint8_t>(static_cast<int>(bin0)
                                          & (kOri - 1));
  }
  __syncthreads();

  // output (cell, o) of keypoint j: its four partial chains, interleaved
  const int cell = tid / (kPerBlock * kOri);
  const int j = tid / kOri % kPerBlock;
  const int o = tid % kOri, o_prev = (o + kOri - 1) % kOri;
  int beg[kGroups], len[kGroups], longest = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    beg[g] = sm.bounds[cell * kGroups + g];
    len[g] = sm.bounds[cell * kGroups + g + 1] - beg[g];
    longest = max(longest, len[g]);
  }
  const float2* w01 = sm.w01[j];
  const uint8_t* b0 = sm.b0[j];
  float acc[kGroups] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < longest; ++i) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      if (i < len[g]) {
        const int slot = sm.slot[beg[g] + i];
        const int b = b0[slot];
        const float2 v = w01[slot];
        const float x = b == o ? v.x : (b == o_prev ? v.y : 0.0f);
        acc[g] = __fmaf_rn(sm.weight[beg[g] + i], x, acc[g]);
      }
    }
  }
  const int out_col = cell * kOri + o;
  float d = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
  sm.desc[j][out_col] = d;          // the patches are no longer read
  __syncthreads();
  norm_scales(sm);
  d = fminf(__fdiv_rn(d, sm.scale[j]), 0.2f);
  sm.desc[j][out_col] = d;
  __syncthreads();
  norm_scales(sm);
  if (j < count)
    out[static_cast<int64_t>(sm.sel[j]) * kDim + out_col] =
        __fdiv_rn(d, sm.scale[j]);
}

}  // namespace

// out (k_count, 128) float32 descriptors of the keypoints xy (k_count, 2)
// int32 (x, y) with angles (k_count,) float32 on image (height, width)
// float32, height and width at least 37; bin_scale and rel_scale the bits
// of float32 32 / (2 pi) as ops/orb.py _BIN_SCALE rounds it and of 8 /
// (2 pi); the contraction order's tap tables: starts (512 x 4 + 1) int32,
// slots and weights (starts[2048]) int32 and float32, at most kMaxTaps a
// bin, each bin's pixels pixel_starts (33) int32 and pixels
// (pixel_starts[32]) int32, at most kMaxPixels a bin; scratch
// (k_count + 66) int32, the pre-pass's output. Launches the pre-pass and
// the kernel on `stream` and returns cudaGetLastError(); it neither
// allocates nor synchronises.
extern "C" int tod_sift_describe(const void* image, const void* xy,
                                 const void* angle, const void* starts,
                                 const void* slots, const void* weights,
                                 const void* pixel_starts, const void* pixels,
                                 void* scratch, void* out,
                                 int height, int width,
                                 int k_count, int bin_scale, int rel_scale,
                                 void* stream) {
  if (k_count <= 0) return 0;
  if (height < kPatchW || width < kPatchW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Shared));
  cudaError_t status = cudaFuncSetAttribute(
      sift_describe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sift_rank_kernel<<<1, kRankThreads, 0, s>>>(
      static_cast<const float*>(angle), k_count, bin_scale,
      static_cast<int*>(scratch));
  // every bin's last item may be short: at most k / kPerBlock + 32 items
  const int blocks = (k_count + kPerBlock - 1) / kPerBlock + kBins;
  sift_describe_kernel<<<blocks, kThreads, bytes, s>>>(
      static_cast<const float*>(image), height, width,
      static_cast<const int32_t*>(xy), static_cast<const float*>(angle),
      rel_scale,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(slots),
      static_cast<const float*>(weights),
      static_cast<const int32_t*>(pixel_starts),
      static_cast<const int32_t*>(pixels),
      static_cast<const int*>(scratch), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
