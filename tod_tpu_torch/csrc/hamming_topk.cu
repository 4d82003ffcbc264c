// Radius k-nearest DB rows by Hamming distance on Hopper (kernel B5), and
// the isolation modes of its inner loop (T1).
//
// B5 tod_hamming_topk replaces the TPU kernel tod_tpu/ops/pallas/hamming.py
// _hamming_topk_kernel (called through hamming_topk_fused): for every query,
// the <= k nearest DB rows among rows < n_valid with Hamming distance
// <= radius, ascending by (dist, global row). A missing slot is
// (1e9, -1), after every real match. The TPU kernel reached that order with
// a per-chunk key dist << 13 | col (lowest column first) and a carry that
// sat first in each merge (earlier chunk first); here the order is the
// lexicographic one on (dist, row) throughout, which is the same order.
//
// Design. B1's block (csrc/segmented_top1.cu): one thread per query, its
// 8 packed words in registers; the block stages 512-row tiles of the DB in
// shared memory and every thread reads the same row (a broadcast), XOR,
// __popc, add. The radius test comes first: a row is inserted only when
// d <= min(radius, worst - 1), into a sorted list of k (dist, row) pairs in
// registers (k a template argument, fully unrolled). Rows ascend within a
// block, so the strict test keeps the earlier row on a tie.
//
// Q = 5000 queries give only 40 tiles of 128, too few for 132 SMs, so the
// grid also splits the rows: block (t, s) sweeps rows
// [s * rows_per_split, (s + 1) * rows_per_split) and writes its sorted list
// as 64-bit keys dist << 32 | row into a (S, Q, k) scratch (25 bits of row
// are needed at 1000 objects, so a 32-bit key cannot hold them). A second
// small kernel merges each query's S lists on the same keys and writes f32
// distances and int32 rows. Rows >= n_valid are never read.
//
// Bound on the H100: integer popc throughput, as B1. A pair costs 8 XOR +
// 8 POPC + 8 adds and one compare; at Q = 5000 against 2.1M rows that is
// ~8.5e10 popc a frame. The DB's 32 bytes a row are read once per query
// tile, from L2 or device memory. The int8 tensor-core product on unpacked
// bits (the TPU's design, 2 x 256 operations a pair) is the redesign.
//
// T1 tod_hamming_probe is the card's counterpart of the TPU isolation bench
// tools/bench_dot_iso.py (its anonymous kernel): the same sweep and split
// with the extraction replaced by
//   kDistSum   the sum of each query's distances (a checksum that keeps
//              the distance work alive), atomically added per block;
//   kRowMin    each query's minimum distance (atomicMin per block);
//   kBlockMin  the minimum over all pairs (a warp reduction, then one
//              atomicMin per warp).
// All are integers, so each is exact whatever the order of the atomics.
// Comparing them with B5 splits B5's time into distance and extraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 128;      // queries per block, one per thread
constexpr int kRowTile = 512;    // DB rows staged in shared memory per step
constexpr int kMergeThreads = 128;
constexpr int kNoDist = 0x7FFFFFFF;
constexpr unsigned long long kEmptyKey = ~0ull;

enum Mode : int { kTopK = 0, kDistSum = 1, kRowMin = 2, kBlockMin = 3 };

__device__ __forceinline__ int hamming(const uint32_t (&w)[8], const uint4 a,
                                       const uint4 b) {
  return __popc(w[0] ^ a.x) + __popc(w[1] ^ a.y) + __popc(w[2] ^ a.z)
       + __popc(w[3] ^ a.w) + __popc(w[4] ^ b.x) + __popc(w[5] ^ b.y)
       + __popc(w[6] ^ b.z) + __popc(w[7] ^ b.w);
}

// Insert (d, row) into the sorted list; the caller guarantees that it
// belongs there (d below the current worst). It enters at the tail and moves
// up past strictly larger distances only, so equal distances keep the
// earlier (lower) row first.
template <int K>
__device__ __forceinline__ void insert_pair(int (&bd)[K], int (&br)[K], int d,
                                            int row) {
  bd[K - 1] = d;
  br[K - 1] = row;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool up = bd[j] < bd[j - 1];
    const int d0 = bd[j - 1], r0 = br[j - 1];
    bd[j - 1] = up ? bd[j] : d0;
    br[j - 1] = up ? br[j] : r0;
    bd[j] = up ? d0 : bd[j];
    br[j] = up ? r0 : br[j];
  }
}

template <int K>
__device__ __forceinline__ void insert_key(unsigned long long (&best)[K],
                                           unsigned long long key) {
  best[K - 1] = key;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const unsigned long long a = best[j - 1], b = best[j];
    best[j - 1] = b < a ? b : a;
    best[j] = b < a ? a : b;
  }
}

// Grid (query tiles, splits). MODE kTopK writes part (S, n_q, K); the probe
// modes accumulate into sums / mins.
template <int MODE, int K>
__global__ void __launch_bounds__(kQTile)
sweep_kernel(const uint4* __restrict__ query,   // (n_q, 2) x 16 bytes
             const uint4* __restrict__ db,      // (n_db, 2) x 16 bytes
             int n_q, int n_valid, int rows_per_split, int radius,
             unsigned long long* __restrict__ part,
             unsigned long long* __restrict__ sums,
             int* __restrict__ mins) {
  __shared__ uint4 tile[kRowTile * 2];
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.y) * rows_per_split;
  const int start = static_cast<int>(first < n_valid ? first : n_valid);
  const int end = static_cast<int>(
      first + rows_per_split < n_valid ? first + rows_per_split : n_valid);
  uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (qi < n_q) {
    const uint4 a = query[2 * qi];
    const uint4 b = query[2 * qi + 1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  int bd[K], br[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = kNoDist;
    br[j] = -1;
  }
  int thr = radius;                 // insert iff d <= thr
  unsigned long long sum = 0;
  int m = kNoDist;
  for (int base = start; base < end; base += kRowTile) {
    const int count = min(kRowTile, end - base);
    __syncthreads();   // the previous tile is no longer read
    const uint4* src = db + 2 * static_cast<size_t>(base);
    for (int i = threadIdx.x; i < 2 * count; i += kQTile) tile[i] = src[i];
    __syncthreads();
    uint32_t acc = 0;  // <= 512 x 256: fits
    for (int r = 0; r < count; ++r) {
      const int d = hamming(w, tile[2 * r], tile[2 * r + 1]);
      if constexpr (MODE == kTopK) {
        if (d <= thr) {
          insert_pair<K>(bd, br, d, base + r);
          thr = min(radius, bd[K - 1] - 1);
        }
      } else if constexpr (MODE == kDistSum) {
        acc += static_cast<uint32_t>(d);
      } else {
        m = min(m, d);
      }
    }
    if constexpr (MODE == kDistSum) sum += acc;
  }
  if constexpr (MODE == kTopK) {
    if (qi < n_q) {
      unsigned long long* out =
          part + (static_cast<size_t>(blockIdx.y) * n_q + qi) * K;
#pragma unroll
      for (int j = 0; j < K; ++j)
        out[j] = bd[j] == kNoDist
                     ? kEmptyKey
                     : (static_cast<unsigned long long>(bd[j]) << 32)
                           | static_cast<uint32_t>(br[j]);
    }
  } else if constexpr (MODE == kDistSum) {
    if (qi < n_q && end > start) atomicAdd(sums + qi, sum);
  } else if constexpr (MODE == kRowMin) {
    if (qi < n_q && end > start) atomicMin(mins + qi, m);
  } else {
    if (qi >= n_q) m = kNoDist;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if ((threadIdx.x & 31) == 0 && m != kNoDist) atomicMin(mins, m);
  }
}

// One thread per query: merge its S sorted lists of part (S, n_q, K).
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const unsigned long long* __restrict__ part, int n_q,
             int n_split, float* __restrict__ out_dist,
             int* __restrict__ out_idx) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= n_q) return;
  unsigned long long best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kEmptyKey;
  for (int s = 0; s < n_split; ++s) {
    const unsigned long long* in =
        part + (static_cast<size_t>(s) * n_q + qi) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const unsigned long long key = in[j];
      if (key >= best[K - 1]) break;   // the list ascends: no later key fits
      insert_key<K>(best, key);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t cell = static_cast<size_t>(qi) * K + j;
    const bool hole = best[j] == kEmptyKey;
    out_dist[cell] = hole ? 1e9f : static_cast<float>(best[j] >> 32);
    out_idx[cell] = hole ? -1 : static_cast<int>(best[j] & 0xFFFFFFFFu);
  }
}

template <int K>
void launch_topk(const uint4* query, const uint4* db, unsigned long long* part,
                 float* out_dist, int* out_idx, int n_q, int n_valid,
                 int radius, int n_split, int rows_per_split,
                 cudaStream_t stream) {
  const dim3 grid((n_q + kQTile - 1) / kQTile, n_split);
  sweep_kernel<kTopK, K><<<grid, kQTile, 0, stream>>>(
      query, db, n_q, n_valid, rows_per_split, radius, part, nullptr,
      nullptr);
  merge_kernel<K><<<(n_q + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                    0, stream>>>(part, n_q, n_split, out_dist, out_idx);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError(); none allocates or synchronises.

// B5: part is the (n_split, n_q, k) uint64 scratch; out_dist (n_q, k) f32,
// out_idx (n_q, k) int32. 1 <= k <= 8.
extern "C" int tod_hamming_topk(const void* query, const void* db, void* part,
                                void* out_dist, void* out_idx, int n_q,
                                int n_valid, int k, int radius, int n_split,
                                int rows_per_split, void* stream) {
  if (n_q <= 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || n_split > 65535 || rows_per_split < 0 || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const uint4*>(query);
  const auto* d = static_cast<const uint4*>(db);
  auto* p = static_cast<unsigned long long*>(part);
  auto* od = static_cast<float*>(out_dist);
  auto* oi = static_cast<int*>(out_idx);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_topk<1>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 2: launch_topk<2>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 3: launch_topk<3>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 4: launch_topk<4>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 5: launch_topk<5>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 6: launch_topk<6>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 7: launch_topk<7>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 8: launch_topk<8>(q, d, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// T1: mode 1 adds into sums (n_q,) uint64 (zeroed by the caller); mode 2
// takes the min into mins (n_q,) int32 and mode 3 into mins (1,) int32
// (both preset to INT32_MAX by the caller).
extern "C" int tod_hamming_probe(const void* query, const void* db,
                                 void* sums, void* mins, int n_q, int n_valid,
                                 int mode, int n_split, int rows_per_split,
                                 void* stream) {
  if (n_q <= 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || n_split > 65535 || rows_per_split < 0 || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_q + kQTile - 1) / kQTile, n_split);
  const auto* q = static_cast<const uint4*>(query);
  const auto* d = static_cast<const uint4*>(db);
  auto* su = static_cast<unsigned long long*>(sums);
  auto* mi = static_cast<int*>(mins);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDistSum:
      sweep_kernel<kDistSum, 1><<<grid, kQTile, 0, s>>>(
          q, d, n_q, n_valid, rows_per_split, 0, nullptr, su, nullptr);
      break;
    case kRowMin:
      sweep_kernel<kRowMin, 1><<<grid, kQTile, 0, s>>>(
          q, d, n_q, n_valid, rows_per_split, 0, nullptr, nullptr, mi);
      break;
    case kBlockMin:
      sweep_kernel<kBlockMin, 1><<<grid, kQTile, 0, s>>>(
          q, d, n_q, n_valid, rows_per_split, 0, nullptr, nullptr, mi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
