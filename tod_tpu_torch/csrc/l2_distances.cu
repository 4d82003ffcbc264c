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
//
// L3 tod_l2_topk is the matcher whole for the "chain" order (more than one
// query at a chunk of 4,096: the SIFT graph's case): l2_topk's (Q, k)
// nearest rows over the whole DB, each distance in exactly the tile's
// order above, with no distance written to device memory. Three kernels in
// one call: a pre-pass computes every query's and row's |x|^2 once (the
// 32-wide windows in order); the sweep runs a grid of query tiles x row
// splits, a block holding its 128 queries in shared memory for the whole
// sweep and streaming its split's rows in 128-row tiles whose 32-deep
// slices cp.async stages into a double buffer while the previous slice is
// multiplied (each output's chain still in ascending depth; 256 threads,
// 8 x 8 outputs a thread, float4 shared loads); each tile's distances go
// through shared memory to two threads a query, which keep the k best
// (distance, row) of their half of the tile's rows in registers; a merge
// pass takes the k best of the splits' lists. Ties go to the lower row and
// the start's k (1e9, -1) slots come before any row at or past 1e9, as the
// chunked scan (ops/matching.py _merge_topk) orders them. Bound: the float
// rate (2 x 128 operations a pair at 67 TFLOP/s); the design's shared-
// memory traffic is one float4 of queries and of rows per 16 FMAs.

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

// ---------------------------------------------------------------------------
// The fused matcher (chain order): norms pre-pass, split sweep, merge
// ---------------------------------------------------------------------------

constexpr int kFq = 128;              // queries a block
constexpr int kFr = 128;              // rows a tile
constexpr int kFside = 16;
constexpr int kFper = 8;              // outputs a thread along each side
constexpr int kFthreads = kFside * kFside;
constexpr int kQpitch = kDim + 4;     // floats a staged query row
constexpr int kRpitch = kWindow + 4;  // floats a staged row slice
constexpr int kDpitch = kFr + 1;      // floats a row of the distance tile
constexpr int kMaxK = 8;
constexpr int kFusedSmem = (kFq * kQpitch + 2 * kFr * kRpitch
                            + kFq * kDpitch + kFq) * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// (d, i) before (bd, bi): by distance, then the lower index (-1 first)
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// insert (cd, ci), known to come before entry k - 1, into the sorted list
__device__ __forceinline__ void insert(float (&d)[kMaxK], int (&ix)[kMaxK],
                                      int k, float cd, int ci) {
  bool placed = false;
#pragma unroll
  for (int s = kMaxK - 1; s >= 1; --s) {
    if (s < k && !placed) {
      if (before(cd, ci, d[s - 1], ix[s - 1])) {
        d[s] = d[s - 1];
        ix[s] = ix[s - 1];
      } else {
        d[s] = cd;
        ix[s] = ci;
        placed = true;
      }
    }
  }
  if (!placed) {
    d[0] = cd;
    ix[0] = ci;
  }
}

__device__ __forceinline__ void last(const float (&d)[kMaxK],
                                     const int (&ix)[kMaxK], int k,
                                     float* wd, int* wi) {
#pragma unroll
  for (int s = 0; s < kMaxK; ++s)
    if (s == k - 1) {
      *wd = d[s];
      *wi = ix[s];
    }
}

// |x|^2 of rows [0, n) of a (n, 128) matrix, one thread a row
__global__ void __launch_bounds__(256)
norms_kernel(const float* __restrict__ a, int n_a, const float* __restrict__ b,
             int n_b, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_a + n_b) return;
  const float* row = r < n_a ? a + static_cast<int64_t>(r) * kDim
                             : b + static_cast<int64_t>(r - n_a) * kDim;
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kDim / kWindow; ++w) {
    float x[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          row + w * kWindow) + i);
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
    const float win = window_sum(x);
    total = w == 0 ? win : __fadd_rn(total, win);
  }
  out[r] = total;
}

// stage depths [depth0, depth0 + 32) of rows [r0, r0 + 128) (an index past
// n_rows reads the last row: such rows are never scanned)
__device__ __forceinline__ void stage_rows(const float* __restrict__ rows,
                                           int r0, int n_rows, int depth0,
                                           float* dst) {
#pragma unroll
  for (int c = 0; c < kFr * kWindow / 4 / kFthreads; ++c) {
    const int i = threadIdx.x + c * kFthreads;
    const int row = i / (kWindow / 4), quad = i % (kWindow / 4);
    const int src_row = min(r0 + row, n_rows - 1);
    cp_async16(dst + row * kRpitch + 4 * quad,
               rows + static_cast<int64_t>(src_row) * kDim + depth0
                   + 4 * quad);
  }
}

__global__ void __launch_bounds__(kFthreads, 1)
l2_topk_sweep(const float* __restrict__ query, const float* __restrict__ rows,
              const float* __restrict__ norms, float* __restrict__ part_d,
              int* __restrict__ part_i, int n_q, int n_rows, int n_valid,
              int k, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                                   // [kFq][kQpitch]
  float* rs = qs + kFq * kQpitch;                     // [2][kFr][kRpitch]
  float* dt = rs + 2 * kFr * kRpitch;                 // [kFq][kDpitch]
  float* rsq = dt + kFq * kDpitch;                    // [kFr]
  const int tx = threadIdx.x % kFside, ty = threadIdx.x / kFside;
  const int q0 = blockIdx.x * kFq;
  const int split = blockIdx.y;
  const int n_tiles = (n_valid + kFr - 1) / kFr;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_stages = (t_end - t_begin) * (kDim / kWindow);

  // the block's queries (zero past n_q) and their norms, once
  for (int i = threadIdx.x; i < kFq * kDim / 4; i += kFthreads) {
    const int row = i / (kDim / 4), quad = i % (kDim / 4);
    float* dst = qs + row * kQpitch + 4 * quad;
    if (q0 + row < n_q)
      cp_async16(dst, query + static_cast<int64_t>(q0 + row) * kDim
                          + 4 * quad);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int my_q = threadIdx.x % kFq, half = threadIdx.x / kFq;
  if (n_stages > 0) stage_rows(rows, t_begin * kFr, n_rows, 0, rs);
  cp_async_commit();

  float best_d[kMaxK];
  int best_i[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    best_d[s] = kBig;
    best_i[s] = -1;
  }
  float worst_d = kBig;
  int worst_i = -1;
  float acc[kFper][kFper];
  float qsq_reg[kFper];

  for (int st = 0; st < n_stages; ++st) {
    const int tile = t_begin + st / (kDim / kWindow);
    const int w = st % (kDim / kWindow);
    const int r0 = tile * kFr;
    if (st + 1 < n_stages) {
      const int nt = t_begin + (st + 1) / (kDim / kWindow);
      stage_rows(rows, nt * kFr, n_rows,
                 ((st + 1) % (kDim / kWindow)) * kWindow,
                 rs + ((st + 1) % 2) * kFr * kRpitch);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < kFper; ++i)
#pragma unroll
        for (int j = 0; j < kFper; ++j) acc[i][j] = 0.0f;
    }
    const float* rb = rs + (st % 2) * kFr * kRpitch;
#pragma unroll 2
    for (int kk = 0; kk < kWindow; kk += 4) {
      float4 a[kFper], b[kFper];
#pragma unroll
      for (int i = 0; i < kFper; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            qs + (ty + kFside * i) * kQpitch + w * kWindow + kk);
#pragma unroll
      for (int j = 0; j < kFper; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            rb + (tx + kFside * j) * kRpitch + kk);
#pragma unroll
      for (int i = 0; i < kFper; ++i)
#pragma unroll
        for (int j = 0; j < kFper; ++j) {
          acc[i][j] = __fmaf_rn(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = __fmaf_rn(a[i].w, b[j].w, acc[i][j]);
        }
    }
    if (w == kDim / kWindow - 1) {
      // the tile's distances through shared memory to the scanning threads
      if (threadIdx.x < kFr)
        rsq[threadIdx.x] = r0 + threadIdx.x < n_rows
                               ? norms[n_q + r0 + threadIdx.x] : 0.0f;
#pragma unroll
      for (int i = 0; i < kFper; ++i) {
        const int qi = q0 + ty + kFside * i;
        qsq_reg[i] = qi < n_q ? norms[qi] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kFper; ++i)
#pragma unroll
        for (int j = 0; j < kFper; ++j)
          dt[(ty + kFside * i) * kDpitch + tx + kFside * j] =
              distance(qsq_reg[i], rsq[tx + kFside * j], acc[i][j]);
      __syncthreads();
      const int c0 = half * (kFr / 2);
      const int c_end = min(kFr / 2, n_valid - r0 - c0);
      for (int c = 0; c < c_end; ++c) {
        const float d = dt[my_q * kDpitch + c0 + c];
        const int ri = r0 + c0 + c;
        if (before(d, ri, worst_d, worst_i)) {
          insert(best_d, best_i, k, d, ri);
          last(best_d, best_i, k, &worst_d, &worst_i);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (q0 + my_q < n_q) {
    const int64_t list = (static_cast<int64_t>(2 * split + half) * n_q
                          + q0 + my_q) * k;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s)
      if (s < k) {
        part_d[list + s] = best_d[s];
        part_i[list + s] = best_i[s];
      }
  }
}

// the k best of each query's n_lists lists, into (n_q, k) outputs
__global__ void __launch_bounds__(128)
l2_topk_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
              float* __restrict__ out_d, int* __restrict__ out_i, int n_q,
              int k, int n_lists) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_q) return;
  float d[kMaxK];
  int ix[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    d[s] = kBig;
    ix[s] = -1;
  }
  float wd = kBig;
  int wi = -1;
  for (int l = 0; l < n_lists; ++l) {
    const int64_t base = (static_cast<int64_t>(l) * n_q + q) * k;
    for (int s = 0; s < k; ++s) {
      const float cd = part_d[base + s];
      const int ci = part_i[base + s];
      if (!before(cd, ci, wd, wi)) break;     // each list is sorted
      insert(d, ix, k, cd, ci);
      last(d, ix, k, &wd, &wi);
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxK; ++s)
    if (s < k) {
      out_d[static_cast<int64_t>(q) * k + s] = d[s];
      out_i[static_cast<int64_t>(q) * k + s] = ix[s];
    }
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

// The k (<= 8) nearest of rows [0, n_valid) of `rows` (n_rows, 128) float32
// to each of `query`'s (n_q, 128) rows in the "chain" order, as l2_topk
// orders them: out_d (n_q, k) float32, out_i (n_q, k) int32 (-1 with 1e9
// where fewer rows are valid). Scratch, allocated by the caller: norms
// (n_q + n_rows floats) and the splits' lists part_d / part_i (2 x n_split
// x n_q x k each); `tiles_per_split` 128-row tiles a split. Three launches
// on `stream`; returns the first cudaError_t; it neither allocates nor
// synchronises.
extern "C" int tod_l2_topk(const void* query, const void* rows, void* norms,
                           void* part_d, void* part_i, void* out_d,
                           void* out_i, int n_q, int n_rows, int n_valid,
                           int k, int n_split, int tiles_per_split,
                           void* stream) {
  if (n_q <= 0) return 0;
  if (k < 1 || k > kMaxK || n_split < 1 || n_valid > n_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        l2_topk_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFusedSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nr = static_cast<float*>(norms);
  const int n_norms = n_q + n_rows;
  norms_kernel<<<(n_norms + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(query), n_q, static_cast<const float*>(rows),
      n_rows, nr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_q + kFq - 1) / kFq, n_split);
  l2_topk_sweep<<<grid, kFthreads, kFusedSmem, s>>>(
      static_cast<const float*>(query), static_cast<const float*>(rows), nr,
      static_cast<float*>(part_d), static_cast<int*>(part_i), n_q, n_rows,
      n_valid, k, tiles_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  l2_topk_merge<<<(n_q + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(part_d), static_cast<const int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), n_q, k,
      2 * n_split);
  return static_cast<int>(cudaGetLastError());
}
