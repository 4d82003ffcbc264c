// Per-(query, object) nearest model row by Hamming distance on Hopper.
//
// Two entry points, one design:
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
// column per slot, so each column is bitwise B1's column sel[c]. A slot
// outside [0, O) (-1 = empty) reports the invalid key 0x7FFFFFFF, i.e.
// (8191, 262143). The TPU kernel walked per-step scalar-prefetch tables
// (chunk, output slot, row base) over a static grid with a trash lane for
// padding steps; here a block reads sel[c] itself and loops over that
// object's real rows only, so there are no tables and no padding reads.
//
// Design. The TPU kernel unpacks descriptors to 256 int8 lanes so the
// matrix unit can compute q.r; the card has no such need. Each DB row stays
// packed as 8 32-bit words, and the distance is popc(q ^ r) summed over the
// words. A block is one (query tile, column) pair: each thread holds one
// query's 8 words in registers, the block stages tiles of the object's rows
// in shared memory (every thread reads the same row, a broadcast), and each
// thread keeps its running min key. The block writes its cells directly: no
// atomics and no cross-block fold.
//
// Bound on the H100: integer popc throughput. One (query, row) pair costs
// 8 XOR + 8 POPC + 8 adds and a min; at Q = 2048 against ~2.2M rows that is
// ~36 G popc per frame, while the DB's 32 bytes per row are read once per
// query tile from L2. B2's work is the selected objects' rows only (~64
// objects of ~21k rows at the coarse->fine operating point). The int8
// tensor-core product on unpacked bits (the TPU design) and the 1-bit
// mma.sync XOR/AND-popc path are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 128;     // queries per block, one per thread
constexpr int kRowTile = 512;   // DB rows staged in shared memory per step
constexpr int kRowBits = 18;
constexpr uint32_t kRowMask = (1u << kRowBits) - 1u;
constexpr uint32_t kEmptyKey = 511u << kRowBits;   // (511, row 0)
constexpr uint32_t kHoleKey = 0x7FFFFFFFu;         // (8191, 262143)

// The min key of this thread's query over rows [start, start + n) of the
// DB. Every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ uint32_t object_min_key(
    const uint32_t (&w)[8], const uint4* __restrict__ db, int start, int n,
    uint4* tile) {
  uint32_t best = kEmptyKey;
  for (int base = 0; base < n; base += kRowTile) {
    const int count = min(kRowTile, n - base);
    __syncthreads();   // the previous tile is no longer read
    const uint4* src = db + 2 * (static_cast<size_t>(start) + base);
    for (int i = threadIdx.x; i < 2 * count; i += kQTile) tile[i] = src[i];
    __syncthreads();
    for (int r = 0; r < count; ++r) {
      const uint4 a = tile[2 * r];
      const uint4 b = tile[2 * r + 1];
      const uint32_t d = __popc(w[0] ^ a.x) + __popc(w[1] ^ a.y)
                       + __popc(w[2] ^ a.z) + __popc(w[3] ^ a.w)
                       + __popc(w[4] ^ b.x) + __popc(w[5] ^ b.y)
                       + __popc(w[6] ^ b.z) + __popc(w[7] ^ b.w);
      // d <= 256 < 511, so the clamp of the TPU key never binds here
      best = min(best, (d << kRowBits) | static_cast<uint32_t>(base + r));
    }
  }
  return best;
}

__device__ __forceinline__ void load_query(const uint4* __restrict__ query,
                                           int qi, int n_q, uint32_t (&w)[8]) {
  if (qi < n_q) {
    const uint4 a = query[2 * qi];
    const uint4 b = query[2 * qi + 1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
}

__device__ __forceinline__ void store_key(float* out_dist, int* out_row,
                                          int qi, int n_q, int n_cols, int c,
                                          uint32_t key) {
  if (qi < n_q) {
    const size_t cell = static_cast<size_t>(qi) * n_cols + c;
    out_dist[cell] = static_cast<float>(key >> kRowBits);
    out_row[cell] = static_cast<int>(key & kRowMask);
  }
}

// B1: grid (query tiles, objects).
__global__ void __launch_bounds__(kQTile)
object_top1_kernel(const uint4* __restrict__ query,   // (n_q, 2) x 16 bytes
                   const uint4* __restrict__ db,      // (n_db, 2) x 16 bytes
                   const int* __restrict__ obj_start, // (n_obj,)
                   const int* __restrict__ n_rows,    // (n_obj,)
                   float* __restrict__ out_dist,      // (n_q, n_obj)
                   int* __restrict__ out_row,         // (n_q, n_obj)
                   int n_q, int n_obj) {
  __shared__ uint4 tile[kRowTile * 2];
  const int o = blockIdx.y;
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  load_query(query, qi, n_q, w);
  const uint32_t best = object_min_key(w, db, obj_start[o], n_rows[o], tile);
  store_key(out_dist, out_row, qi, n_q, n_obj, o, best);
}

// B2: grid (query tiles, slots); the object of slot c is sel[c].
__global__ void __launch_bounds__(kQTile)
object_top1_gathered_kernel(const uint4* __restrict__ query,
                            const uint4* __restrict__ db,
                            const int* __restrict__ obj_start,
                            const int* __restrict__ n_rows,
                            const int* __restrict__ sel,      // (n_sel,)
                            float* __restrict__ out_dist,     // (n_q, n_sel)
                            int* __restrict__ out_row,        // (n_q, n_sel)
                            int n_q, int n_sel, int n_obj) {
  __shared__ uint4 tile[kRowTile * 2];
  const int c = blockIdx.y;
  const int o = sel[c];            // the same for the whole block
  const int qi = blockIdx.x * kQTile + threadIdx.x;
  uint32_t best = kHoleKey;
  if (o >= 0 && o < n_obj) {
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    load_query(query, qi, n_q, w);
    best = object_min_key(w, db, obj_start[o], n_rows[o], tile);
  }
  store_key(out_dist, out_row, qi, n_q, n_sel, c, best);
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
    const dim3 grid((n_q + kQTile - 1) / kQTile, n_obj);
    object_top1_kernel<<<grid, kQTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(db),
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
    const dim3 grid((n_q + kQTile - 1) / kQTile, n_sel);
    object_top1_gathered_kernel<<<grid, kQTile, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(query), static_cast<const uint4*>(db),
        static_cast<const int*>(obj_start), static_cast<const int*>(n_rows),
        static_cast<const int*>(sel), static_cast<float*>(out_dist),
        static_cast<int*>(out_row), n_q, n_sel, n_obj);
  }
  return static_cast<int>(cudaGetLastError());
}
