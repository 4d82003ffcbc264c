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
// Design. The distance product runs on the tensor cores, as the TPU kernel
// ran it on its matrix unit: dist = |q| + |r| - 2 popc(q & r), the
// popcounts |q|, |r| taken once. Two routes compute popc(q & r) with
// mma.sync, both held here (template ROUTE):
//   kS8  int8 m16n8k32 on 0/1 bytes: 8 k-steps a 16 x 8 tile, 256 MACs a
//        pair (the TPU's formulation). The DB stays packed in device
//        memory (32 bytes a row); the block unpacks each staged row tile
//        once, a nibble to four bytes by (nib * 0x00204081) & 0x01010101,
//        straight into the B-fragment order, so a warp reads 256
//        contiguous bytes a (tile, k-step).
//   kB1  1-bit m16n8k256 .and.popc: one instruction a 16 x 8 tile over the
//        packed words, no unpacking.
// The k order inside a step is free as long as queries and rows use the
// same one: lane (g, t) feeds words 2t, 2t + 1 of its row (b1), or byte
// ks & 3 of word 2t + (ks >> 2), low nibble then high nibble (s8).
//
// A block is 256 queries (8 warps x two 16-query m-tiles) against one row
// split; each step stages 128 rows (prefetched into registers while the
// previous step computes). The epilogue stays on the CUDA cores at about
// three operations a pair: v = |r| - 2 popc (one IMAD), a compare with the
// query's threshold tq = min(radius, worst - 1) - |q|, and a warp-uniform
// __any_sync branch into the rare insertion. A lane of the mma owns two
// queries x two columns of each 16 x 8 tile, so each query keeps four
// sorted lists (one per lane of its quad) of k 32-bit keys
// dist << 23 | row - split start, in shared memory. Each lane sees its
// columns in ascending row order and inserts only strictly closer rows, so
// a list keeps the earliest row on a tie. At the end one thread a query
// merges its four lists on the keys (order-free) and writes the block's
// partial as 64-bit keys dist << 32 | row into an (S, Q, k) scratch; a
// second small kernel merges each query's S lists on the same keys (25
// bits of row are needed at 1000 objects). Rows >= n_valid are never read:
// a staged row past the split's end gets |r| = 2^20, beyond any radius.
// The split plan (ops/hamming.py split_plan) keeps a split below 2^23
// rows.
//
// B5 takes one route, fixed here (kB5Route, reported by
// tod_hamming_b5_route), chosen by T1's timing of both on the H100
// (PERF.md). Bound on the H100: the product's tensor-core
// rate; the DB's 32 bytes a row are read once per query tile, mostly from
// L2.
//
// T1 tod_hamming_probe is the card's counterpart of the TPU isolation bench
// tools/bench_dot_iso.py (its anonymous kernel): the sweep with the
// extraction replaced by
//   kDistSum   the sum of each query's distances (a checksum that keeps
//              the distance work alive), atomically added per block;
//   kRowMin    each query's minimum distance (atomicMin per block);
//   kBlockMin  the minimum over all pairs (a warp reduction, then one
//              atomicMin per warp).
// All are integers, so each is exact whatever the order of the atomics.
// Each mode runs on three routes: kPopc, B5's earlier CUDA-core design
// (one thread a query, XOR + __popc against rows broadcast from shared
// memory), and the two tensor-core routes above. Comparing them
// with each other and with B5 splits B5's time into product and
// extraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode : int { kTopK = 0, kDistSum = 1, kRowMin = 2, kBlockMin = 3 };
enum Route : int { kPopc = 0, kS8 = 1, kB1 = 2 };

constexpr int kB5Route = kB1;   // the faster route on the H100 (PERF.md)

constexpr int kNoDist = 0x7FFFFFFF;
constexpr unsigned long long kEmptyKey = ~0ull;
constexpr int kMergeThreads = 128;

// ---- the CUDA-core popc sweep (T1's kPopc route) ---------------------------

constexpr int kQTile = 128;      // queries per block, one per thread
constexpr int kRowTile = 512;    // DB rows staged in shared memory per step

__device__ __forceinline__ int hamming(const uint32_t (&w)[8], const uint4 a,
                                       const uint4 b) {
  return __popc(w[0] ^ a.x) + __popc(w[1] ^ a.y) + __popc(w[2] ^ a.z)
       + __popc(w[3] ^ a.w) + __popc(w[4] ^ b.x) + __popc(w[5] ^ b.y)
       + __popc(w[6] ^ b.z) + __popc(w[7] ^ b.w);
}

// Grid (query tiles of 128, splits); a probe mode accumulates into sums /
// mins.
template <int MODE>
__global__ void __launch_bounds__(kQTile)
popc_probe_kernel(const uint4* __restrict__ query,   // (n_q, 2) x 16 bytes
                  const uint4* __restrict__ db,      // (n_db, 2) x 16 bytes
                  int n_q, int n_valid, int rows_per_split,
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
      if constexpr (MODE == kDistSum) {
        acc += static_cast<uint32_t>(d);
      } else {
        m = min(m, d);
      }
    }
    if constexpr (MODE == kDistSum) sum += acc;
  }
  if constexpr (MODE == kDistSum) {
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

// ---- the tensor-core sweep (B5, and T1's kS8 / kB1 routes) -----------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcM = 2;                          // 16-query m-tiles a warp
constexpr int kTcQTile = 16 * kTcM * kTcWarps;   // 256 queries a block
constexpr int kTcRows = 128;                     // rows staged a step
constexpr int kTcNTiles = kTcRows / 8;
constexpr int kRowPast = 1 << 20;   // |r| of a staged row past the end
constexpr int kLocalBits = 23;      // row - split start in a list key
constexpr uint32_t kLocalMask = (1u << kLocalBits) - 1u;
constexpr uint32_t kEmpty32 = 0xFFFFFFFFu;
constexpr int kNoQuery = -(1 << 30);   // threshold of a query past n_q

// Shared memory of one block: the staged tile (s8: unpacked B fragments,
// 256 bytes a row; b1: packed rows, 32 bytes a row), the rows' popcounts,
// and for B5 the 4 x k keys of each query's lists.
__host__ __device__ constexpr int tc_tile_bytes(int route) {
  return route == kS8 ? kTcRows * 256 : kTcRows * 32;
}
__host__ __device__ constexpr int tc_smem_bytes(int route, int mode, int k) {
  return tc_tile_bytes(route) + kTcRows * 4
       + (mode == kTopK ? kTcQTile * 4 * k * 4 : 0);
}

__device__ __forceinline__ uint32_t expand4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;   // bit i -> byte i, as 0/1
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Insert key into a sorted list of K keys (the largest falls out).
template <int K>
__device__ __forceinline__ void insert_sorted(uint32_t* list, uint32_t key) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t x = list[j];
    if (key < x) {
      list[j] = key;
      key = x;
    }
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

// Grid (query tiles of 256, splits); block (t, s) sweeps rows
// [s * rows_per_split, min((s + 1) * rows_per_split, n_valid)). MODE kTopK
// writes part (S, n_q, K); the probe modes accumulate into sums / mins.
template <int ROUTE, int MODE, int K>
__global__ void __launch_bounds__(kTcThreads)
tc_sweep_kernel(const uint2* __restrict__ query,   // (n_q, 4) x 8 bytes
                const uint4* __restrict__ db,      // (n_db, 2) x 16 bytes
                int n_q, int n_valid, int rows_per_split, int radius,
                unsigned long long* __restrict__ part,
                unsigned long long* __restrict__ sums,
                int* __restrict__ mins) {
  extern __shared__ uint4 smem[];
  uint2* tile = reinterpret_cast<uint2*>(smem);
  int* rpop = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem) + tc_tile_bytes(ROUTE));
  uint32_t* lists = reinterpret_cast<uint32_t*>(rpop + kTcRows);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long first = static_cast<long long>(blockIdx.y) * rows_per_split;
  const int start = static_cast<int>(first < n_valid ? first : n_valid);
  const int end = static_cast<int>(
      first + rows_per_split < n_valid ? first + rows_per_split : n_valid);
  const int q_block = blockIdx.x * kTcQTile;

  // A fragments and |q| of this lane's queries: m-tile mt, half h (query
  // row g or g + 8 of the tile).
  constexpr int kARegs = ROUTE == kS8 ? 32 : 4;
  uint32_t a[kTcM][kARegs];
  int qpop[kTcM][2];
  int tq[kTcM][2];             // insert iff |r| - 2 popc <= tq
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) {
    uint2 w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q_block + warp * 16 * kTcM + mt * 16 + g + 8 * h;
      w[h] = qi < n_q ? query[4 * static_cast<size_t>(qi) + t4]
                      : make_uint2(0u, 0u);
      int p = __popc(w[h].x) + __popc(w[h].y);
      p += __shfl_xor_sync(0xFFFFFFFFu, p, 1);
      p += __shfl_xor_sync(0xFFFFFFFFu, p, 2);
      qpop[mt][h] = p;
      tq[mt][h] = qi < n_q ? radius - p : kNoQuery;
    }
    if constexpr (ROUTE == kS8) {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int sh = 8 * (ks & 3);
        const uint32_t w0 = ks < 4 ? w[0].x : w[0].y;
        const uint32_t w1 = ks < 4 ? w[1].x : w[1].y;
        a[mt][4 * ks + 0] = expand4((w0 >> sh) & 0xFu);
        a[mt][4 * ks + 1] = expand4((w1 >> sh) & 0xFu);
        a[mt][4 * ks + 2] = expand4((w0 >> (sh + 4)) & 0xFu);
        a[mt][4 * ks + 3] = expand4((w1 >> (sh + 4)) & 0xFu);
      }
    } else {
      a[mt][0] = w[0].x;
      a[mt][1] = w[1].x;
      a[mt][2] = w[0].y;
      a[mt][3] = w[1].y;
    }
  }
  if constexpr (MODE == kTopK) {
    for (int i = threadIdx.x; i < kTcQTile * 4 * K; i += kTcThreads)
      lists[i] = kEmpty32;
  }
  uint32_t sum[kTcM][2] = {};
  int m[kTcM][2];
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) m[mt][0] = m[mt][1] = kNoDist;

  // Staging: thread t holds half t & 1 (16 bytes) of row t >> 1.
  const int s_row = threadIdx.x >> 1, s_half = threadIdx.x & 1;
  auto fetch = [&](int base) {
    const int row = base + s_row;
    return row < end ? db[2 * static_cast<size_t>(row) + s_half]
                     : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 pre = start < end ? fetch(start) : make_uint4(0u, 0u, 0u, 0u);
  for (int base = start; base < end; base += kTcRows) {
    const int count = min(kTcRows, end - base);
    __syncthreads();   // the previous tile is no longer read
    {
      const uint4 v = pre;
      int p = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      p += __shfl_xor_sync(0xFFFFFFFFu, p, 1);
      if (s_half == 0) rpop[s_row] = s_row < count ? p : kRowPast;
      if constexpr (ROUTE == kS8) {
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
        const int frag_lane = (s_row & 7) * 4;
        uint2* dst = tile + (s_row >> 3) * 8 * 32;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int word = 4 * s_half + j;   // 2 t + (ks >> 2)
          const int t = word >> 1, hi = word & 1;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte = (words[j] >> (8 * b)) & 0xFFu;
            dst[(4 * hi + b) * 32 + frag_lane + t] =
                make_uint2(expand4(byte & 0xFu), expand4(byte >> 4));
          }
        }
      } else {
        reinterpret_cast<uint4*>(tile)[2 * s_row + s_half] = v;
      }
    }
    __syncthreads();
    if (base + kTcRows < end) pre = fetch(base + kTcRows);
    const int local = base - start;
#pragma unroll 1
    for (int nt = 0; nt < kTcNTiles; ++nt) {
      int acc[kTcM][4];
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt)
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
      if constexpr (ROUTE == kS8) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint2 b = tile[(nt * 8 + ks) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < kTcM; ++mt)
            mma_s8(acc[mt], a[mt][4 * ks], a[mt][4 * ks + 1],
                   a[mt][4 * ks + 2], a[mt][4 * ks + 3], b.x, b.y);
        }
      } else {
        const uint2 b = tile[(nt * 8 + g) * 4 + t4];
#pragma unroll
        for (int mt = 0; mt < kTcM; ++mt)
          mma_b1(acc[mt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b.x, b.y);
      }
      const int col = nt * 8 + 2 * t4;          // this lane's first column
      const int2 rp = *reinterpret_cast<const int2*>(rpop + col);
      // v[mt][j]: j = 2 h + c, query half h, column col + c
      int v[kTcM][4];
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt) {
        v[mt][0] = rp.x - 2 * acc[mt][0];
        v[mt][1] = rp.y - 2 * acc[mt][1];
        v[mt][2] = rp.x - 2 * acc[mt][2];
        v[mt][3] = rp.y - 2 * acc[mt][3];
      }
      if constexpr (MODE == kTopK) {
        bool hit = false;
#pragma unroll
        for (int mt = 0; mt < kTcM; ++mt)
          hit |= (v[mt][0] <= tq[mt][0]) | (v[mt][1] <= tq[mt][0])
               | (v[mt][2] <= tq[mt][1]) | (v[mt][3] <= tq[mt][1]);
        if (__any_sync(0xFFFFFFFFu, hit) && hit) {
#pragma unroll
          for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {   // ascending rows per query
              const int h = j >> 1;
              if (v[mt][j] <= tq[mt][h]) {
                const int qloc = warp * 16 * kTcM + mt * 16 + g + 8 * h;
                uint32_t* list = lists + (4 * qloc + t4) * K;
                const uint32_t d = v[mt][j] + qpop[mt][h];
                const uint32_t row = local + col + (j & 1);
                insert_sorted<K>(list, d << kLocalBits | row);
                const int worst = list[K - 1] >> kLocalBits;
                tq[mt][h] = min(radius, worst - 1) - qpop[mt][h];
              }
            }
          }
        }
      } else if constexpr (MODE == kDistSum) {
        const bool ok0 = col < count, ok1 = col + 1 < count;
#pragma unroll
        for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t d0 = v[mt][2 * h] + qpop[mt][h];
            const uint32_t d1 = v[mt][2 * h + 1] + qpop[mt][h];
            sum[mt][h] += (ok0 ? d0 : 0u) + (ok1 ? d1 : 0u);
          }
        }
      } else {   // a column past the end has |r| = 2^20: never the minimum
#pragma unroll
        for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m[mt][h] = min(m[mt][h], min(v[mt][2 * h], v[mt][2 * h + 1])
                                         + qpop[mt][h]);
        }
      }
    }
  }

  if constexpr (MODE == kTopK) {
    __syncthreads();
    const int qi = q_block + threadIdx.x;   // list owner qloc = threadIdx.x
    if (qi < n_q) {
      uint32_t best[K];
#pragma unroll
      for (int j = 0; j < K; ++j) best[j] = kEmpty32;
      const uint32_t* mine = lists + 4 * threadIdx.x * K;
      for (int l = 0; l < 4; ++l) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const uint32_t key = mine[l * K + j];
          if (key >= best[K - 1]) break;   // the list ascends
          insert_sorted<K>(best, key);
        }
      }
      unsigned long long* out =
          part + (static_cast<size_t>(blockIdx.y) * n_q + qi) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const unsigned long long d = best[j] >> kLocalBits;
        const uint32_t row = start + (best[j] & kLocalMask);
        out[j] = best[j] == kEmpty32 ? kEmptyKey : d << 32 | row;
      }
    }
  } else if constexpr (MODE == kBlockMin) {
    int b = kNoDist;
#pragma unroll
    for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (tq[mt][h] != kNoQuery) b = min(b, m[mt][h]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      b = min(b, __shfl_xor_sync(0xFFFFFFFFu, b, off));
    if (lane == 0 && b != kNoDist && end > start) atomicMin(mins, b);
  } else {
#pragma unroll
    for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = q_block + warp * 16 * kTcM + mt * 16 + g + 8 * h;
        if constexpr (MODE == kDistSum) {
          uint32_t s = sum[mt][h];
          s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
          s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
          if (t4 == 0 && qi < n_q && end > start)
            atomicAdd(sums + qi, static_cast<unsigned long long>(s));
        } else {
          int s = m[mt][h];
          s = min(s, __shfl_xor_sync(0xFFFFFFFFu, s, 1));
          s = min(s, __shfl_xor_sync(0xFFFFFFFFu, s, 2));
          if (t4 == 0 && qi < n_q && end > start) atomicMin(mins + qi, s);
        }
      }
    }
  }
}

template <int ROUTE, int MODE, int K>
cudaError_t launch_tc(const void* query, const void* db, int n_q,
                      int n_valid, int n_split, int rows_per_split,
                      int radius, unsigned long long* part,
                      unsigned long long* sums, int* mins,
                      cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes(ROUTE, MODE, K);
  auto kernel = tc_sweep_kernel<ROUTE, MODE, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kTcQTile - 1) / kTcQTile, n_split);
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const uint2*>(query), static_cast<const uint4*>(db), n_q,
      n_valid, rows_per_split, radius, part, sums, mins);
  return cudaGetLastError();
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
cudaError_t launch_topk(const void* query, const void* db,
                        unsigned long long* part, float* out_dist,
                        int* out_idx, int n_q, int n_valid, int radius,
                        int n_split, int rows_per_split, cudaStream_t stream) {
  const cudaError_t err = launch_tc<kB5Route, kTopK, K>(
      query, db, n_q, n_valid, n_split, rows_per_split, radius, part,
      nullptr, nullptr, stream);
  if (err != cudaSuccess) return err;
  merge_kernel<K><<<(n_q + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                    0, stream>>>(part, n_q, n_split, out_dist, out_idx);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_probe(int route, const void* query, const void* db,
                         int n_q, int n_valid, int n_split,
                         int rows_per_split, unsigned long long* sums,
                         int* mins, cudaStream_t stream) {
  if (route == kS8)
    return launch_tc<kS8, MODE, 1>(query, db, n_q, n_valid, n_split,
                                   rows_per_split, 0, nullptr, sums, mins,
                                   stream);
  if (route == kB1)
    return launch_tc<kB1, MODE, 1>(query, db, n_q, n_valid, n_split,
                                   rows_per_split, 0, nullptr, sums, mins,
                                   stream);
  if (route != kPopc) return cudaErrorInvalidValue;
  const dim3 grid((n_q + kQTile - 1) / kQTile, n_split);
  popc_probe_kernel<MODE><<<grid, kQTile, 0, stream>>>(
      static_cast<const uint4*>(query), static_cast<const uint4*>(db), n_q,
      n_valid, rows_per_split, sums, mins);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns a cudaError_t (cudaGetLastError() after the launches); none
// allocates or synchronises.

// B5: part is the (n_split, n_q, k) uint64 scratch; out_dist (n_q, k) f32,
// out_idx (n_q, k) int32. 1 <= k <= 8; splits of at most 2^23 rows.
extern "C" int tod_hamming_topk(const void* query, const void* db, void* part,
                                void* out_dist, void* out_idx, int n_q,
                                int n_valid, int k, int radius, int n_split,
                                int rows_per_split, void* stream) {
  if (n_q <= 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || n_split > 65535 || rows_per_split < 0
      || rows_per_split > (1 << kLocalBits) || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<unsigned long long*>(part);
  auto* od = static_cast<float*>(out_dist);
  auto* oi = static_cast<int*>(out_idx);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch_topk<1>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 2: err = launch_topk<2>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 3: err = launch_topk<3>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 4: err = launch_topk<4>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 5: err = launch_topk<5>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 6: err = launch_topk<6>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 7: err = launch_topk<7>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    case 8: err = launch_topk<8>(query, db, p, od, oi, n_q, n_valid, radius, n_split, rows_per_split, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// T1: mode 1 adds into sums (n_q,) uint64 (zeroed by the caller); mode 2
// takes the min into mins (n_q,) int32 and mode 3 into mins (1,) int32
// (both preset to INT32_MAX by the caller). route 0 popc (blocks of 128
// queries), 1 s8 mma, 2 b1 mma (blocks of 256 queries; splits of at most
// 2^23 rows).
extern "C" int tod_hamming_probe(const void* query, const void* db,
                                 void* sums, void* mins, int n_q, int n_valid,
                                 int mode, int route, int n_split,
                                 int rows_per_split, void* stream) {
  if (n_q <= 0) return static_cast<int>(cudaGetLastError());
  if (n_split < 1 || n_split > 65535 || rows_per_split < 0
      || rows_per_split > (1 << kLocalBits) || n_valid < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* su = static_cast<unsigned long long*>(sums);
  auto* mi = static_cast<int*>(mins);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kDistSum: err = launch_probe<kDistSum>(route, query, db, n_q, n_valid, n_split, rows_per_split, su, mi, s); break;
    case kRowMin: err = launch_probe<kRowMin>(route, query, db, n_q, n_valid, n_split, rows_per_split, su, mi, s); break;
    case kBlockMin: err = launch_probe<kBlockMin>(route, query, db, n_q, n_valid, n_split, rows_per_split, su, mi, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The route B5 is compiled with (Route: 0 popc, 1 s8, 2 b1).
extern "C" int tod_hamming_b5_route() { return kB5Route; }
