// Per-(query, object) nearest model row by squared L2 distance between
// int8-quantised SIFT descriptors on Hopper.
//
// Two entry points:
//
// B3 tod_object_top1_l2 replaces the TPU kernel
// tod_tpu/ops/pallas/segmented_l2.py _object_top1_l2_kernel (called through
// object_top1_l2_fused): for every query q and object o, the minimum over
// the object's real rows r of
//     |q|^2 + |r|^2 - 2 q.r
// in exact int32 arithmetic, and the lowest row that attains it. The TPU
// kernel also visits each segment's padding rows, whose stored norm is 2^28
// and whose vector is zero, so an object with no real rows reports
// (|q|^2 + 2^28, row 0) there; this kernel visits real rows only and
// writes that value for an object without rows, which gives the same cell.
//
// B4 tod_object_top1_l2_gathered replaces _gathered_l2_kernel (called
// through object_top1_l2_gathered_fused), the fine pass of coarse->fine
// matching: the same cell, but only for the objects of a selection sel (C,),
// one output column per slot, so each column is bitwise B3's column sel[c].
// A slot outside [0, O) (-1 = empty) reports (0x7FFFFFFF, row 0), what a
// never-written lane of the TPU kernel holds. The TPU kernel walked
// per-step scalar-prefetch tables over a static grid with a trash lane;
// here a block reads sel[c] itself and sweeps that object's real rows.
//
// Both write int32 squared distances and rows; the conversion to L2 units,
// sqrt(d) / 256, is applied by the caller, as it is outside the TPU kernel.
//
// Design, one tile and two grids: the int8 product on the tensor cores. A
// block is one (256-query tile, object) pair, B3's object o = blockIdx.y,
// B4's object sel[blockIdx.y]; the query tile is fastest in the grid, so
// the tiles that read one object's rows run together and find them in L2.
// Both run the same device function, object_tile_top1. Its
// 8 warps each hold two 16-query m-tiles of the queries as mma.sync
// m16n8k32 s8 A fragments in registers (K = 128: four k-steps); the
// object's rows, row-major int8 (128 contiguous bytes, the .col B
// operand), are staged 128 at a time with cp.async into a double buffer
// (16-byte chunks XOR-swizzled by row so that the B-fragment reads are
// free of bank conflicts; rows past the object's end zero-filled). The
// k order inside a step is free as long as both operands use the same
// one: lane (g, t) takes words 2 (ks & 1) and 2 (ks & 1) + 1 of 16-byte
// chunk 4 (ks >> 1) + t of its query / row.
//
// The arg-min folds into one integer min a pair, the TPU kernel's trick:
//     key = (|r|^2 - 2 q.r + 2^21) << 7 | col
// with col the row's place in its 128-row tile. |r|^2 - 2 q.r = d - |q|^2
// lies in [-2^21, 128 * 255^2] for every int8 value (|q|^2 <= 128 * 128^2
// = 2^21), so the key is below 2^31, and
//     key = (128 |r|^2 + 2^28 + col) - 256 q.r
// is one IMAD a pair on a per-column constant, then one IMNMX. The
// smaller key has the smaller distance (|q|^2 is the query's constant),
// then the lower row. A staged row past the end has the constant
// 0x7FFFFFFF and a zero vector: never below a real key. Tiles fold in
// ascending order on the distance alone (strictly), then the four lanes
// of a quad merge their (distance, row) pairs.
//
// Bound on the H100: the int8 tensor-core rate (2 x 128 operations a
// pair); the rows' 132 bytes are read once per query tile, mostly from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecs = 8;        // 16-byte vectors per 128-byte row
constexpr int kPadNorm = 1 << 28;           // the TPU DB's padding-row norm
constexpr int kDistInvalid = 0x7FFFFFFF;    // a hole's squared distance

// ---- the tensor-core tile ------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcM = 2;                          // 16-query m-tiles a warp
constexpr int kTcQTile = 16 * kTcM * kTcWarps;   // 256 queries a block
constexpr int kTcRows = 128;                     // rows staged a step
constexpr int kTcNTiles = kTcRows / 8;
constexpr int kColBits = 7;                      // log2(kTcRows)
constexpr int kKeyBias = 1 << 21;                // >= |q|^2 of any int8 q
constexpr int kNoKey = 0x7FFFFFFF;

// The 16-byte chunk c of row r sits at chunk c ^ swizzle(r) of its
// 128-byte line: the 8 lanes of a quarter-warp (two rows, four chunks
// each) then read 8 distinct chunks.
__device__ __forceinline__ int swizzle(int r) {
  return ((r & 1) << 2) | ((r >> 1) & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The cells (q, col) of the block's 256 queries q against rows
// [start, start + n) of the DB, written at column col of (n_q, n_cols)
// outputs. Every thread of the block must call it (it synchronises the
// block).
__device__ __forceinline__ void object_tile_top1(
    const uint4* __restrict__ query,   // (n_q, 8) x 16 B
    const uint4* __restrict__ db,      // (n_db, 8) x 16 B
    const int* __restrict__ norm_sq,   // (n_db,)
    int start, int n, int* __restrict__ out_dist, int* __restrict__ out_row,
    int n_q, int n_cols, int col) {
  __shared__ uint4 tile[2][kTcRows * kVecs];
  __shared__ __align__(16) int col_key[2][kTcRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_block = blockIdx.x * kTcQTile;

  // A fragments: m-tile mt, query half h (row g or g + 8 of the tile);
  // chunks t4 and 4 + t4 of the query hold its four k-steps.
  uint32_t a[kTcM][16];
  int q_norm[kTcM][2];
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q_block + warp * 16 * kTcM + mt * 16 + g + 8 * h;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 x = qi < n_q ? query[kVecs * static_cast<size_t>(qi) + t4]
                               : zero;
      const uint4 y = qi < n_q
                          ? query[kVecs * static_cast<size_t>(qi) + 4 + t4]
                          : zero;
      const uint32_t w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      int nrm = 0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        a[mt][4 * ks + h] = w[2 * ks];           // a0 / a1: low k half
        a[mt][4 * ks + 2 + h] = w[2 * ks + 1];   // a2 / a3: high k half
        nrm = __dp4a(static_cast<int>(w[2 * ks]),
                     static_cast<int>(w[2 * ks]), nrm);
        nrm = __dp4a(static_cast<int>(w[2 * ks + 1]),
                     static_cast<int>(w[2 * ks + 1]), nrm);
      }
      nrm += __shfl_xor_sync(0xFFFFFFFFu, nrm, 1);
      nrm += __shfl_xor_sync(0xFFFFFFFFu, nrm, 2);
      q_norm[mt][h] = nrm;
    }
  }

  // this lane's best (key's distance part, row) per query, over its columns
  int best_v[kTcM][2], best_row[kTcM][2];
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) {
    best_v[mt][0] = best_v[mt][1] = kNoKey >> kColBits;
    best_row[mt][0] = best_row[mt][1] = 0;
  }
  auto stage = [&](int base, int buf) {
    for (int i = threadIdx.x; i < kTcRows * kVecs; i += kTcThreads) {
      const int r = i >> 3, c = i & 7;
      const bool real = base + r < n;
      const uint4* src =
          real ? db + kVecs * (static_cast<size_t>(start) + base + r) + c : db;
      cp_async16(&tile[buf][r * kVecs + (c ^ swizzle(r))], src,
                 real ? 16 : 0);
    }
    for (int r = threadIdx.x; r < kTcRows; r += kTcThreads)
      col_key[buf][r] = base + r < n
                            ? ((norm_sq[start + base + r] + kKeyBias)
                               << kColBits) | r
                            : kNoKey;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int n_tiles = (n + kTcRows - 1) / kTcRows;
  if (n_tiles > 0) stage(0, 0);
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int buf = tt & 1;
    if (tt + 1 < n_tiles) {
      stage((tt + 1) * kTcRows, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    int t_min[kTcM][2];
#pragma unroll
    for (int mt = 0; mt < kTcM; ++mt) t_min[mt][0] = t_min[mt][1] = kNoKey;
#pragma unroll 2
    for (int nt = 0; nt < kTcNTiles; ++nt) {
      const int r = nt * 8 + g;
      const uint4 x = tile[buf][r * kVecs + (t4 ^ swizzle(r))];
      const uint4 y = tile[buf][r * kVecs + ((4 + t4) ^ swizzle(r))];
      const uint32_t b[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      int acc[kTcM][4];
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt)
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int mt = 0; mt < kTcM; ++mt)
          mma_s8(acc[mt], a[mt][4 * ks], a[mt][4 * ks + 1],
                 a[mt][4 * ks + 2], a[mt][4 * ks + 3], b[2 * ks],
                 b[2 * ks + 1]);
      }
      const int2 ck =
          *reinterpret_cast<const int2*>(&col_key[buf][nt * 8 + 2 * t4]);
#pragma unroll
      for (int mt = 0; mt < kTcM; ++mt) {
        t_min[mt][0] = min(t_min[mt][0], min(ck.x - 256 * acc[mt][0],
                                             ck.y - 256 * acc[mt][1]));
        t_min[mt][1] = min(t_min[mt][1], min(ck.x - 256 * acc[mt][2],
                                             ck.y - 256 * acc[mt][3]));
      }
    }
#pragma unroll
    for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = t_min[mt][h] >> kColBits;
        if (v < best_v[mt][h]) {   // strict: an earlier tile keeps a tie
          best_v[mt][h] = v;
          best_row[mt][h] = tt * kTcRows + (t_min[mt][h] & (kTcRows - 1));
        }
      }
    }
    __syncthreads();   // the buffer is restaged next step
  }
#pragma unroll
  for (int mt = 0; mt < kTcM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = best_v[mt][h], row = best_row[mt][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const int ov = __shfl_xor_sync(0xFFFFFFFFu, v, off);
        const int orow = __shfl_xor_sync(0xFFFFFFFFu, row, off);
        if (ov < v || (ov == v && orow < row)) {
          v = ov;
          row = orow;
        }
      }
      const int qi = q_block + warp * 16 * kTcM + mt * 16 + g + 8 * h;
      if (t4 == 0 && qi < n_q) {
        const size_t cell = static_cast<size_t>(qi) * n_cols + col;
        out_dist[cell] = n > 0 ? v - kKeyBias + q_norm[mt][h]
                               : q_norm[mt][h] + kPadNorm;
        out_row[cell] = n > 0 ? row : 0;
      }
    }
  }
}

// B3: grid (query tiles of 256, objects).
__global__ void __launch_bounds__(kTcThreads)
object_top1_l2_tc_kernel(const uint4* __restrict__ query,
                         const uint4* __restrict__ db,
                         const int* __restrict__ norm_sq,
                         const int* __restrict__ obj_start, // (n_obj,)
                         const int* __restrict__ n_rows,    // (n_obj,)
                         int* __restrict__ out_dist,        // (n_q, n_obj)
                         int* __restrict__ out_row,         // (n_q, n_obj)
                         int n_q, int n_obj) {
  const int o = blockIdx.y;
  object_tile_top1(query, db, norm_sq, obj_start[o], n_rows[o], out_dist,
                   out_row, n_q, n_obj, o);
}

// B4: grid (query tiles of 256, slots); the object of slot c is sel[c].
__global__ void __launch_bounds__(kTcThreads)
object_top1_l2_gathered_tc_kernel(const uint4* __restrict__ query,
                                  const uint4* __restrict__ db,
                                  const int* __restrict__ norm_sq,
                                  const int* __restrict__ obj_start,
                                  const int* __restrict__ n_rows,
                                  const int* __restrict__ sel,   // (n_sel,)
                                  int* __restrict__ out_dist,    // (n_q, n_sel)
                                  int* __restrict__ out_row,     // (n_q, n_sel)
                                  int n_q, int n_sel, int n_obj) {
  const int c = blockIdx.y;
  const int o = sel[c];            // the same for the whole block
  if (o >= 0 && o < n_obj) {
    object_tile_top1(query, db, norm_sq, obj_start[o], n_rows[o], out_dist,
                     out_row, n_q, n_sel, c);
    return;
  }
  const int qi = blockIdx.x * kTcQTile + threadIdx.x;   // a hole
  if (qi < n_q) {
    const size_t cell = static_cast<size_t>(qi) * n_sel + c;
    out_dist[cell] = kDistInvalid;
    out_row[cell] = 0;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError(); none allocates or synchronises.
extern "C" int tod_object_top1_l2(const void* query, const void* db,
                                  const void* norm_sq, const void* obj_start,
                                  const void* n_rows, void* out_dist,
                                  void* out_row, int n_q, int n_cols,
                                  int n_obj, void* stream) {
  if (n_cols != n_obj) return static_cast<int>(cudaErrorInvalidValue);
  if (n_q > 0 && n_obj > 0) {
    const dim3 grid((n_q + kTcQTile - 1) / kTcQTile, n_obj);
    object_top1_l2_tc_kernel<<<grid, kTcThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(norm_sq), static_cast<const int*>(obj_start),
        static_cast<const int*>(n_rows), static_cast<int*>(out_dist),
        static_cast<int*>(out_row), n_q, n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tod_object_top1_l2_gathered(
    const void* query, const void* db, const void* norm_sq,
    const void* obj_start, const void* n_rows, const void* sel,
    void* out_dist, void* out_row, int n_q, int n_sel, int n_obj,
    void* stream) {
  if (n_q > 0 && n_sel > 0) {
    const dim3 grid((n_q + kTcQTile - 1) / kTcQTile, n_sel);
    object_top1_l2_gathered_tc_kernel<<<grid, kTcThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(norm_sq), static_cast<const int*>(obj_start),
        static_cast<const int*>(n_rows), static_cast<const int*>(sel),
        static_cast<int*>(out_dist), static_cast<int*>(out_row), n_q, n_sel,
        n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}
