// Squared L2 distances of float descriptors on Hopper, rounded as the
// compiled reference rounds them.
//
// L3 tod_l2_distances replaces, on the card, the distance tile of the
// reference's L2 matcher (tod_tpu/ops/matching.py:107-141 l2_topk, the cell
// graph's SIFT DescriptorMatcher): not a Pallas kernel, but XLA's CPU
// reduces, its dot at Precision.HIGHEST and an elementwise fusion, whose
// order tod_tpu_torch/ops/matching.py states (read off by
// tools/fit_l2_order.py). For query q and row r, both 128 float32:
//     |x|^2 = the squares rounded, added in order within each 32-wide
//             window from +0, the 4 windows added in order;
//     q.r   = fused multiply-adds from +0 in ascending depth: one chain
//             (kind 0, "chain"), even and odd chains added (1, "parity"),
//             chains over depth mod 4 as (p0 + p1) + (p2 + p3) (2,
//             "lanes"), or, for one query (3, "vector"), 8 chains over
//             depth mod 8 taking the 8-float blocks in kVectorBlocks'
//             order (lane 0 from +0, the others from -0), then lanes
//             (l, l + 4) added, then (0, 2) and (1, 3), then the two;
//     d     = max((|q|^2 + |r|^2) - 2 q.r, 0), and 1e9 (BIG_DIST) in the
//             columns from n_valid on (the chunk's padding rows).
// Every operation is an explicit __fmaf_rn / __fadd_rn / __fmul_rn, which
// nvcc never contracts. The plain version is ops/matching.py
// l2_distances_torch.
//
// Design: a block of 256 threads computes a 64 x 64 tile, 16 outputs a
// thread (4 queries x 4 rows), each output's partial chains in registers.
// The tile's query and row slices of 32 depths are staged in shared
// memory (rows padded to 33 floats: no bank conflicts), one slice at a
// time in ascending depth, so each chain runs in order; the slice is also
// the norms' 32-wide window, which threads 0-127 sum for the tile's rows.
// One query takes its own kernel: a thread a row, the query in shared
// memory. Bound on the H100: 2 x 128 float operations a pair against
// 4 bytes written; at the matcher's Q x 4,096 tiles the float32 rate
// bounds it (67 TFLOP/s against 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 128;
constexpr int kWindow = 32;           // the norms' window and a depth slice
constexpr int kTile = 64;             // queries and rows of a block's tile
constexpr int kSide = 16;             // threads along each side of the tile
constexpr int kPer = kTile / kSide;   // outputs a thread along each side
constexpr int kThreads = kSide * kSide;
constexpr int kPad = kWindow + 1;
constexpr float kBig = 1e9f;
__constant__ int kVectorBlocks[16] = {0, 4, 8,  12, 5, 1, 9,  13,
                                      6, 2, 10, 14, 7, 3, 11, 15};

__device__ __forceinline__ float distance(float q_sq, float r_sq, float dot) {
  const float d = __fsub_rn(__fadd_rn(q_sq, r_sq), __fmul_rn(2.0f, dot));
  return d < 0.0f ? 0.0f : d;
}

// stage depths [depth0, depth0 + 32) of the 64 rows from `first` (zero
// from row n on) into tile[row][0..32)
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int first, int n, int depth0,
                                      float (*tile)[kPad]) {
  for (int i = threadIdx.x; i < kTile * kWindow / 4; i += kThreads) {
    const int row = i / (kWindow / 4), quad = i % (kWindow / 4);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (first + row < n)
      v = __ldg(reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(first + row) * kDim + depth0) + quad);
    tile[row][4 * quad] = v.x;
    tile[row][4 * quad + 1] = v.y;
    tile[row][4 * quad + 2] = v.z;
    tile[row][4 * quad + 3] = v.w;
  }
}

// the window's sum of squares, in order from +0
__device__ __forceinline__ float window_sum(const float* row) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kWindow; ++i)
    acc = __fadd_rn(acc, __fmul_rn(row[i], row[i]));
  return acc;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
l2_tile_kernel(const float* __restrict__ query, const float* __restrict__ rows,
               float* __restrict__ out, int n_q, int n_rows, int n_valid) {
  constexpr int kParts = kKind == 0 ? 1 : (kKind == 1 ? 2 : 4);
  __shared__ float q_tile[kTile][kPad];
  __shared__ float r_tile[kTile][kPad];
  __shared__ float q_sq[kTile];
  __shared__ float r_sq[kTile];
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int q0 = blockIdx.y * kTile, r0 = blockIdx.x * kTile;
  float acc[kPer][kPer][kParts];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int g = 0; g < kParts; ++g) acc[i][j][g] = 0.0f;
  float norm = 0.0f;   // threads 0-63: a query's |q|^2; 64-127: a row's

  for (int w = 0; w < kDim / kWindow; ++w) {
    __syncthreads();
    stage(query, q0, n_q, w * kWindow, q_tile);
    stage(rows, r0, n_rows, w * kWindow, r_tile);
    __syncthreads();
    if (threadIdx.x < 2 * kTile) {
      const float win = window_sum(threadIdx.x < kTile
                                       ? q_tile[threadIdx.x]
                                       : r_tile[threadIdx.x - kTile]);
      norm = w == 0 ? win : __fadd_rn(norm, win);
    }
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      // depth w * 32 + k: its partial by the kind (32 is a multiple of 4)
      const int g = kKind == 0 ? 0 : (kKind == 1 ? k % 2 : k % 4);
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = q_tile[ty + kSide * i][k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = r_tile[tx + kSide * j][k];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          acc[i][j][g] = __fmaf_rn(a[i], b[j], acc[i][j][g]);
    }
  }
  if (threadIdx.x < kTile) q_sq[threadIdx.x] = norm;
  else if (threadIdx.x < 2 * kTile) r_sq[threadIdx.x - kTile] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= n_q) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int rj = r0 + tx + kSide * j;
      if (rj >= n_rows) continue;
      const float* p = acc[i][j];
      float dot;
      if constexpr (kParts == 1) dot = p[0];
      else if constexpr (kParts == 2) dot = __fadd_rn(p[0], p[1]);
      else dot = __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
      out[static_cast<int64_t>(qi) * n_rows + rj] =
          rj < n_valid ? distance(q_sq[ty + kSide * i], r_sq[tx + kSide * j],
                                  dot)
                       : kBig;
    }
  }
}

// one query (the "vector" order): a thread a row
__global__ void __launch_bounds__(kThreads)
l2_vector_kernel(const float* __restrict__ query,
                 const float* __restrict__ rows, float* __restrict__ out,
                 int n_rows, int n_valid) {
  __shared__ float q[kDim];
  __shared__ float q_norm;
  if (threadIdx.x < kDim) q[threadIdx.x] = __ldg(query + threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = window_sum(q);
    for (int w = 1; w < kDim / kWindow; ++w)
      total = __fadd_rn(total, window_sum(q + w * kWindow));
    q_norm = total;
  }
  __syncthreads();
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  if (r >= n_valid) {
    out[r] = kBig;
    return;
  }
  const float* row = rows + static_cast<int64_t>(r) * kDim;
  float x[kDim];
#pragma unroll
  for (int i = 0; i < kDim / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + i);
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
  float r_norm = window_sum(x);
#pragma unroll
  for (int w = 1; w < kDim / kWindow; ++w)
    r_norm = __fadd_rn(r_norm, window_sum(x + w * kWindow));
  float lane[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) lane[l] = l == 0 ? 0.0f : -0.0f;
#pragma unroll
  for (int b = 0; b < 16; ++b)
#pragma unroll
    for (int l = 0; l < 8; ++l)
      lane[l] = __fmaf_rn(q[8 * kVectorBlocks[b] + l],
                          x[8 * kVectorBlocks[b] + l], lane[l]);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(lane[i], lane[i + 4]);
  out[r] = distance(q_norm, r_norm,
                    __fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3])));
}

}  // namespace

// out (n_q, n_rows) float32 squared distances of query (n_q, 128) float32
// to rows (n_rows, 128) float32, both contiguous and 16-byte aligned, in
// the order `kind` (0 chain, 1 parity, 2 lanes, 3 vector: n_q must be 1);
// 1e9 in the columns from n_valid on. Launches on `stream` and returns
// cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_l2_distances(const void* query, const void* rows,
                                void* out, int n_q, int n_rows, int n_valid,
                                int kind, void* stream) {
  if (n_q <= 0 || n_rows <= 0) return 0;
  const auto* q = static_cast<const float*>(query);
  const auto* r = static_cast<const float*>(rows);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 3) {
    if (n_q != 1) return static_cast<int>(cudaErrorInvalidValue);
    l2_vector_kernel<<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        q, r, o, n_rows, n_valid);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((n_rows + kTile - 1) / kTile, (n_q + kTile - 1) / kTile);
  switch (kind) {
    case 0:
      l2_tile_kernel<0><<<grid, kThreads, 0, s>>>(q, r, o, n_q, n_rows,
                                                  n_valid);
      break;
    case 1:
      l2_tile_kernel<1><<<grid, kThreads, 0, s>>>(q, r, o, n_q, n_rows,
                                                  n_valid);
      break;
    case 2:
      l2_tile_kernel<2><<<grid, kThreads, 0, s>>>(q, r, o, n_q, n_rows,
                                                  n_valid);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
