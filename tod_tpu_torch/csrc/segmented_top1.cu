// Per-(query, object) nearest model row by Hamming distance on Hopper.
//
// Two entry points:
//
// B1 tod_object_top1 replaces the TPU kernel tod_tpu/ops/pallas/segmented.py
// _object_top1_kernel (called through object_top1_fused): for every query q
// and object o, the key
//     min(dist, 511) << 18 | row_within_object
// is minimised over the object's real rows, so ties go to the lowest row;
// an object with no real rows reports (511, 0).
//
// B2 tod_object_top1_gathered replaces _gathered_top1_kernel (called through
// object_top1_gathered_fused), the fine pass of coarse->fine matching: the
// same key, but only for the objects of a selection sel (C,), one output
// column per slot. A slot outside [0, O) (-1 = empty) reports the invalid
// key 0x7FFFFFFF, i.e. (8191, 262143). The TPU kernel walked per-step
// scalar-prefetch tables (chunk, output slot, row base) over a static grid
// with a trash lane for padding steps; here a block reads sel[c] itself
// and sweeps that object's real rows only, so there are no tables and no
// padding reads.
//
// Design, one tile and two grids: the 1-bit product on the tensor cores.
// A block is one (256-query tile, object) pair, B1's object o = blockIdx.y
// written at column o, B2's object sel[blockIdx.y] written at column
// blockIdx.y; both run the same device function, object_tile_top1, so a
// column of B2 is B1's column sel[c] by construction. The query tile is
// fastest in the grid, so the tiles that read one object's rows run
// together and find them in L2. With the popcounts |q|, |r| taken once,
//     dist = |q| + |r| - 2 popc(q & r),
// and popc(q & r) of a 16-query x 8-row tile is one mma.sync m16n8k256
// .b1 .and.popc on the packed words (no unpacking). The block's 8 warps
// each hold two 16-query m-tiles as A fragments in registers (lane (g, t)
// feeds words 2t, 2t + 1 of its query and row: the k order is free as long
// as both operands share it); the object's rows are staged 128 at a time
// (each thread fetches 16 bytes of the next tile into registers while the
// block computes the current one) with each row's per-column constant
// (|r| + 256) << 18 | row_in_object. Objects have at most 2^18 rows
// (pack_segmented refuses more), so the whole arg-min is one key a pair,
//     key = ((|r| + 256) << 18 | row) - (popc(q & r) << 19)
//         = (dist - |q| + 256) << 18 | row,
// one IMAD on the column constant, then one IMNMX. |r| + 256 - 2 popc
// lies in [0, 512], so the key is below 2^28; a smaller key is a smaller
// distance (|q| is the query's constant), then a lower row, across every
// tile, so no fold is needed: the four lanes of a quad take the min. A
// staged row past the end has the constant 0x7FFFFFFF, above every real
// key. Out: dist = (key >> 18) - 256 + |q|, row = key & (2^18 - 1); an
// object with no rows reports (511, 0). A B2 block whose slot is a hole
// decides so once, before any barrier, and writes the hole's cells.
//
// Bound on the H100: the 1-bit tensor-core product (512 bit operations a
// pair), and at about two integer operations a pair the epilogue on the
// CUDA cores; the DB's 32 bytes a row are read once per query tile,
// mostly from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBits = 18;
constexpr int kRowMask = (1 << kRowBits) - 1;
constexpr int kHoleKey = 0x7FFFFFFF;   // an empty slot: (8191, 262143)

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcM = 2;                          // 16-query m-tiles a warp
constexpr int kTcQTile = 16 * kTcM * kTcWarps;   // 256 queries a block
constexpr int kTcRows = 128;                     // rows staged a step
constexpr int kTcNTiles = kTcRows / 8;
constexpr int kPopBias = 256;       // |r| + 256 - 2 popc(q & r) >= 0
constexpr int kPastKey = 0x7FFFFFFF;   // the constant of a row past the end
constexpr int kEmptyDist = 511;        // an object with no rows: (511, 0)
static_assert(kTcQTile == kTcThreads, "a hole's block writes a query a thread");

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The cells (q, col) of the block's 256 queries q against rows
// [start, start + n) of the DB, written at column col of (n_q, n_cols)
// outputs. Every thread of the block must call it (it synchronises the
// block).
__device__ __forceinline__ void object_tile_top1(
    const uint2* __restrict__ query,   // (n_q, 4) x 8 B
    const uint4* __restrict__ db,      // (n_db, 2) x 16 B
    int start, int n, float* __restrict__ out_dist,
    int* __restrict__ out_row, int n_q, int n_cols, int col) {
  __shared__ uint4 tile[kTcRows * 2];
  __shared__ __align__(16) int col_key[kTcRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_block = blockIdx.x * kTcQTile;

  // A fragments and |q| of this lane's queries: m-tile mt, half h (query
  // row g or g + 8 of the tile)
  uint32_t a[kTcM][4];
  int qpop[kTcM][2];
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
    }
    a[mt][0] = w[0].x;
    a[mt][1] = w[1].x;
    a[mt][2] = w[0].y;
    a[mt][3] = w[1].y;
  }
  int best[kTcM][2];
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) best[mt][0] = best[mt][1] = kPastKey;

  // Staging: thread t holds half t & 1 (16 bytes) of row t >> 1.
  const int s_row = threadIdx.x >> 1, s_half = threadIdx.x & 1;
  auto fetch = [&](int base) {
    return base + s_row < n
               ? db[2 * (static_cast<size_t>(start) + base + s_row) + s_half]
               : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 pre = fetch(0);
  for (int base = 0; base < n; base += kTcRows) {
    __syncthreads();   // the previous tile is no longer read
    {
      const uint4 v = pre;
      int p = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      p += __shfl_xor_sync(0xFFFFFFFFu, p, 1);
      if (s_half == 0)
        col_key[s_row] = base + s_row < n
                             ? ((p + kPopBias) << kRowBits) | (base + s_row)
                             : kPastKey;
      tile[2 * s_row + s_half] = v;
    }
    __syncthreads();
    if (base + kTcRows < n) pre = fetch(base + kTcRows);
#pragma unroll 4
    for (int nt = 0; nt < kTcNTiles; ++nt) {
      const uint2 b =
          reinterpret_cast<const uint2*>(tile)[(nt * 8 + g) * 4 + t4];
      int acc[kTcM][4];
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt) {
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
        mma_b1(acc[mt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b.x, b.y);
      }
      // this lane's columns nt * 8 + 2 t4 and + 1
      const int2 ck =
          *reinterpret_cast<const int2*>(&col_key[nt * 8 + 2 * t4]);
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt) {
        best[mt][0] = min(best[mt][0],
                          min(ck.x - (acc[mt][0] << (kRowBits + 1)),
                              ck.y - (acc[mt][1] << (kRowBits + 1))));
        best[mt][1] = min(best[mt][1],
                          min(ck.x - (acc[mt][2] << (kRowBits + 1)),
                              ck.y - (acc[mt][3] << (kRowBits + 1))));
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int key = best[mt][h];
      key = min(key, __shfl_xor_sync(0xFFFFFFFFu, key, 1));
      key = min(key, __shfl_xor_sync(0xFFFFFFFFu, key, 2));
      const int qi = q_block + warp * 16 * kTcM + mt * 16 + g + 8 * h;
      if (t4 == 0 && qi < n_q) {
        const size_t cell = static_cast<size_t>(qi) * n_cols + col;
        out_dist[cell] = static_cast<float>(
            n > 0 ? (key >> kRowBits) - kPopBias + qpop[mt][h] : kEmptyDist);
        out_row[cell] = n > 0 ? key & kRowMask : 0;
      }
    }
  }
}

// B1: grid (query tiles of 256, objects).
__global__ void __launch_bounds__(kTcThreads)
object_top1_tc_kernel(const uint2* __restrict__ query,
                      const uint4* __restrict__ db,
                      const int* __restrict__ obj_start, // (n_obj,)
                      const int* __restrict__ n_rows,    // (n_obj,)
                      float* __restrict__ out_dist,      // (n_q, n_obj)
                      int* __restrict__ out_row,         // (n_q, n_obj)
                      int n_q, int n_obj) {
  const int o = blockIdx.y;
  object_tile_top1(query, db, obj_start[o], n_rows[o], out_dist, out_row,
                   n_q, n_obj, o);
}

// B2: grid (query tiles of 256, slots); the object of slot c is sel[c].
__global__ void __launch_bounds__(kTcThreads)
object_top1_gathered_tc_kernel(const uint2* __restrict__ query,
                               const uint4* __restrict__ db,
                               const int* __restrict__ obj_start,
                               const int* __restrict__ n_rows,
                               const int* __restrict__ sel,    // (n_sel,)
                               float* __restrict__ out_dist,   // (n_q, n_sel)
                               int* __restrict__ out_row,      // (n_q, n_sel)
                               int n_q, int n_sel, int n_obj) {
  const int c = blockIdx.y;
  const int o = sel[c];            // the same for the whole block
  if (o >= 0 && o < n_obj) {
    object_tile_top1(query, db, obj_start[o], n_rows[o], out_dist, out_row,
                     n_q, n_sel, c);
    return;
  }
  const int qi = blockIdx.x * kTcQTile + threadIdx.x;   // a hole
  if (qi < n_q) {
    const size_t cell = static_cast<size_t>(qi) * n_sel + c;
    out_dist[cell] = static_cast<float>(kHoleKey >> kRowBits);
    out_row[cell] = kHoleKey & kRowMask;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError(); none allocates or synchronises.
extern "C" int tod_object_top1(const void* query, const void* db,
                               const void* obj_start, const void* n_rows,
                               void* out_dist, void* out_row,
                               int n_q, int n_cols, int n_obj, void* stream) {
  if (n_cols != n_obj) return static_cast<int>(cudaErrorInvalidValue);
  if (n_q > 0 && n_obj > 0) {
    const dim3 grid((n_q + kTcQTile - 1) / kTcQTile, n_obj);
    object_top1_tc_kernel<<<grid, kTcThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(obj_start), static_cast<const int*>(n_rows),
        static_cast<float*>(out_dist), static_cast<int*>(out_row), n_q, n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tod_object_top1_gathered(const void* query, const void* db,
                                        const void* obj_start,
                                        const void* n_rows, const void* sel,
                                        void* out_dist, void* out_row,
                                        int n_q, int n_sel, int n_obj,
                                        void* stream) {
  if (n_q > 0 && n_sel > 0) {
    const dim3 grid((n_q + kTcQTile - 1) / kTcQTile, n_sel);
    object_top1_gathered_tc_kernel<<<grid, kTcThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(obj_start), static_cast<const int*>(n_rows),
        static_cast<const int*>(sel), static_cast<float*>(out_dist),
        static_cast<int*>(out_row), n_q, n_sel, n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}
