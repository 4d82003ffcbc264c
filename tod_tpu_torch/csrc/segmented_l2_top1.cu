// Per-(query, object) nearest model row by squared L2 distance between
// int8-quantised SIFT descriptors on Hopper.
//
// Two entry points, one design:
//
// B3 tod_object_top1_l2 replaces the TPU kernel
// tod_tpu/ops/pallas/segmented_l2.py _object_top1_l2_kernel (called through
// object_top1_l2_fused): for every query q and object o, the minimum over
// the object's real rows r of
//     |q|^2 + |r|^2 - 2 q.r
// in exact int32 arithmetic, and the lowest row that attains it. The TPU
// kernel also visits each segment's padding rows, whose stored norm is 2^28
// and whose vector is zero, so an object with no real rows reports
// (|q|^2 + 2^28, row 0) there; this kernel starts every cell from that
// value and visits real rows only, which gives the same cell.
//
// B4 tod_object_top1_l2_gathered replaces _gathered_l2_kernel (called
// through object_top1_l2_gathered_fused), the fine pass of coarse->fine
// matching: the same cell, but only for the objects of a selection sel (C,),
// one output column per slot, so each column is bitwise B3's column sel[c].
// A slot outside [0, O) (-1 = empty) reports (0x7FFFFFFF, row 0), what a
// never-written lane of the TPU kernel holds. The TPU kernel walked
// per-step scalar-prefetch tables over a static grid with a trash lane;
// here a block reads sel[c] itself and loops over that object's real rows.
//
// Both write int32 squared distances and rows; the conversion to L2 units,
// sqrt(d) / 256, is applied by the caller, as it is outside the TPU kernel.
//
// Design. The int8 product q.r is computed here, with __dp4a (four int8
// multiply-adds into an int32 per instruction). DB rows are row-major, 128
// contiguous bytes each (the TPU kept the transpose for its matrix unit).
// A block is one (query tile, column) pair: each thread holds one query's
// 128 values as 32 packed words in registers and its |q|^2, the block
// stages tiles of the object's rows and their norms in shared memory (every
// thread reads the same row, a broadcast), and each thread keeps its
// running (distance, row), taking a row only when strictly closer: rows are
// visited in ascending order, so ties go to the lowest row. The block
// writes its cells directly: no atomics and no cross-block fold.
//
// Bound on the H100: operations. One (query, row) pair costs 32 __dp4a on
// the CUDA cores' integer pipe, against 2 x 128 int8 operations on the
// tensor cores, whose dense int8 rate is more than 50 times higher; the
// DB's 132 bytes a row are read once per query tile, mostly from L2. The
// mma/wgmma int8 design is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 128;     // queries per block, one per thread
constexpr int kRowTile = 128;   // DB rows staged in shared memory per step
constexpr int kVecs = 8;        // 16-byte vectors per 128-byte row
constexpr int kPadNorm = 1 << 28;           // the TPU DB's padding-row norm
constexpr int kDistInvalid = 0x7FFFFFFF;    // a hole's squared distance

struct Best {
  int dist;
  int row;
};

// The nearest row to this thread's query among rows [start, start + n) of
// the DB. Every thread of the block must call it (it synchronises the
// block).
__device__ __forceinline__ Best object_best(
    const int (&w)[4 * kVecs], int q_norm, const uint4* __restrict__ db,
    const int* __restrict__ norm_sq, int start, int n, uint4* tile,
    int* tile_norm) {
  Best best{q_norm + kPadNorm, 0};
  for (int base = 0; base < n; base += kRowTile) {
    const int count = min(kRowTile, n - base);
    const size_t first = static_cast<size_t>(start) + base;
    __syncthreads();   // the previous tile is no longer read
    const uint4* src = db + kVecs * first;
    for (int i = threadIdx.x; i < kVecs * count; i += kQTile) tile[i] = src[i];
    for (int i = threadIdx.x; i < count; i += kQTile)
      tile_norm[i] = norm_sq[first + i];
    __syncthreads();
    for (int r = 0; r < count; ++r) {
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const uint4 v = tile[kVecs * r + k];
        a0 = __dp4a(static_cast<int>(v.x), w[4 * k + 0], a0);
        a1 = __dp4a(static_cast<int>(v.y), w[4 * k + 1], a1);
        a2 = __dp4a(static_cast<int>(v.z), w[4 * k + 2], a2);
        a3 = __dp4a(static_cast<int>(v.w), w[4 * k + 3], a3);
      }
      const int d = q_norm + tile_norm[r] - 2 * ((a0 + a1) + (a2 + a3));
      if (d < best.dist) {
        best.dist = d;
        best.row = base + r;
      }
    }
  }
  return best;
}

// This thread's query as 32 packed words (zeros past n_q) and its |q|^2.
__device__ __forceinline__ int load_query(const uint4* __restrict__ query,
                                          int qi, int n_q,
                                          int (&w)[4 * kVecs]) {
  int q_norm = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint4 v = qi < n_q ? query[kVecs * static_cast<size_t>(qi) + k]
                             : make_uint4(0u, 0u, 0u, 0u);
    w[4 * k + 0] = static_cast<int>(v.x);
    w[4 * k + 1] = static_cast<int>(v.y);
    w[4 * k + 2] = static_cast<int>(v.z);
    w[4 * k + 3] = static_cast<int>(v.w);
  }
#pragma unroll
  for (int i = 0; i < 4 * kVecs; ++i) q_norm = __dp4a(w[i], w[i], q_norm);
  return q_norm;
}

__device__ __forceinline__ void store_best(int* out_dist, int* out_row,
                                           int qi, int n_q, int n_cols, int c,
                                           Best best) {
  if (qi < n_q) {
    const size_t cell = static_cast<size_t>(qi) * n_cols + c;
    out_dist[cell] = best.dist;
    out_row[cell] = best.row;
  }
}

// B3: grid (query tiles, objects).
__global__ void __launch_bounds__(kQTile)
object_top1_l2_kernel(const uint4* __restrict__ query,    // (n_q, 8) x 16 B
                      const uint4* __restrict__ db,       // (n_db, 8) x 16 B
                      const int* __restrict__ norm_sq,    // (n_db,)
                      const int* __restrict__ obj_start,  // (n_obj,)
                      const int* __restrict__ n_rows,     // (n_obj,)
                      int* __restrict__ out_dist,         // (n_q, n_obj)
                      int* __restrict__ out_row,          // (n_q, n_obj)
                      int n_q, int n_obj) {
  __shared__ uint4 tile[kRowTile * kVecs];
  __shared__ int tile_norm[kRowTile];
  const int o = blockIdx.y;
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  int w[4 * kVecs];
  const int q_norm = load_query(query, qi, n_q, w);
  const Best best = object_best(w, q_norm, db, norm_sq, obj_start[o],
                                n_rows[o], tile, tile_norm);
  store_best(out_dist, out_row, qi, n_q, n_obj, o, best);
}

// B4: grid (query tiles, slots); the object of slot c is sel[c].
__global__ void __launch_bounds__(kQTile)
object_top1_l2_gathered_kernel(const uint4* __restrict__ query,
                               const uint4* __restrict__ db,
                               const int* __restrict__ norm_sq,
                               const int* __restrict__ obj_start,
                               const int* __restrict__ n_rows,
                               const int* __restrict__ sel,     // (n_sel,)
                               int* __restrict__ out_dist,      // (n_q, n_sel)
                               int* __restrict__ out_row,       // (n_q, n_sel)
                               int n_q, int n_sel, int n_obj) {
  __shared__ uint4 tile[kRowTile * kVecs];
  __shared__ int tile_norm[kRowTile];
  const int c = blockIdx.y;
  const int o = sel[c];            // the same for the whole block
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  Best best{kDistInvalid, 0};
  if (o >= 0 && o < n_obj) {
    int w[4 * kVecs];
    const int q_norm = load_query(query, qi, n_q, w);
    best = object_best(w, q_norm, db, norm_sq, obj_start[o], n_rows[o], tile,
                       tile_norm);
  }
  store_best(out_dist, out_row, qi, n_q, n_sel, c, best);
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
    const dim3 grid((n_q + kQTile - 1) / kQTile, n_obj);
    object_top1_l2_kernel<<<grid, kQTile, 0,
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
    const dim3 grid((n_q + kQTile - 1) / kQTile, n_sel);
    object_top1_l2_gathered_kernel<<<grid, kQTile, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(norm_sq), static_cast<const int*>(obj_start),
        static_cast<const int*>(n_rows), static_cast<const int*>(sel),
        static_cast<int*>(out_dist), static_cast<int*>(out_row), n_q, n_sel,
        n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}
