// The ORB keypoint orientation on Hopper, fused from the level image, bit
// for bit.
//
// L1 tod_orb_angles replaces, on the card, the reference's keypoint
// orientation (tod_tpu/ops/orb.py:112-163, orientation_moments and
// keypoint_angles): not a Pallas kernel, but XLA's cumsums of the
// integral images, the shifted differences of the 31x31 circular patch,
// the fused multiply-adds of each moment and the call of the host libm's
// atan2f. The reference computes the moments densely over the level; the
// card computes them at the keypoints only, from the same integral images
// and with the same arithmetic, so every angle keeps its bits. The plain
// version is tod_tpu_torch/ops/orb.py keypoint_moments_torch followed by
// ops/libm.py atan2f_torch.
//
// Two kernels, queued by one call:
// 1. integral_kernel: v, the prefix sums down each column of the image with
//    a zero first row ((h + 1) x w), and hc, along each row with a zero
//    first column (h x (w + 1)), rounded as the compiled reference's
//    cumsum (ops/orb.py scan_sum): each block of 16 summed in order, the
//    blocks' totals scanned by the same rule, recursively, and each block's
//    exclusive offset added once. A block of threads takes a tile of up to
//    16 lines (columns of v, rows of hc) into shared memory, read and
//    written coalesced; a thread sums a (line, block of 16) in order; a
//    thread a line then scans the line's block totals, keeping one running
//    sum, count and offset a level of the recursion in registers (when a
//    block of a level completes, its total goes up a level, and the
//    scanned value that comes back is the next block's offset); each
//    element then takes its block's offset.
// 2. angles_kernel: at each keypoint, the 30 column sums v[y + hw + 1, x +
//    d] - v[y - hw, x + d] and the 30 row sums hc[y + d, x + hw + 1] -
//    hc[y + d, x - hw] (hw the circle's half-width at d; reads outside
//    the integral images give 0, as the reference's zero padding does),
//    each moment chained as fma(t(-15), -15, t(-14) * -14), then fma(t(d),
//    d, acc) for d = -13 .. -1, 1 .. 15; then atan2f(m01, m10), glibc's
//    (libm_f32.cuh). A thread a keypoint, both chains interleaved.

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kTileThreads = 512;
constexpr int kTileLines = 16;     // lines of a tile at most
constexpr int kLoadsAhead = 8;     // a thread's loads in flight
constexpr int kTileBytes = 200 * 1024;   // a tile's shared memory at most
constexpr int kAngleThreads = 128;
constexpr int kScanBlock = 16;     // scan_sum's block
constexpr int kLevels = 8;         // recursion levels: lines up to 16^8
constexpr int kHalfPatch = 15;

// the circle's half-width at row offset d = -15 .. 15 (ops/orb.py
// _circle_half_widths, cv::ORB's u_max)
__constant__ int kHalfWidth[2 * kHalfPatch + 1] = {
    0, 5, 7, 9, 10, 11, 12, 13, 13, 14, 14, 14, 15, 15, 15, 15,
    15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 7, 5, 0};

// The recursion's top level for a line of n: the first whose length (n,
// then ceil(n / 16) a level) is 16 or less; it is summed in order, with no
// offset.
__device__ __forceinline__ int scan_top(int n) {
  int top = 0;
  for (int m = n; m > kScanBlock; m = (m + kScanBlock - 1) / kScanBlock)
    ++top;
  return top;
}

struct ScanState {      // levels 1 .. top of the recursion (0 unused)
  float p[kLevels];     // running in-block sum of each level
  float off[kLevels];   // the current block's offset (0 for block 0)
  int c[kLevels];       // elements of the current block seen
};

// A completed level-0 block's total T goes up the levels 1 .. top; returns
// its scanned value at level 1, the next level-0 block's offset. The
// unrolled loop keeps every index a constant, so the state stays in
// registers.
__device__ __forceinline__ float carry_up(float T, ScanState& st, int top) {
  float result = 0.0f;
  float carry = T;
#pragma unroll
  for (int L = 1; L < kLevels; ++L) {
    st.p[L] = st.c[L] == 0 ? carry : __fadd_rn(st.p[L], carry);
    st.c[L] += 1;
    const float s = L == top ? st.p[L] : __fadd_rn(st.p[L], st.off[L]);
    if (L == 1) {
      result = s;
    } else {
      st.off[L - 1] = s;
    }
    if (L == top || st.c[L] < kScanBlock) break;
    st.c[L] = 0;
    carry = st.p[L];
  }
  return result;
}

// The smallest pitch >= n that is 1 mod 32: a line's elements in shared
// memory, so that 32 lines at one element fall in 32 banks
__host__ __device__ __forceinline__ int pitch_of(int n) {
  return (n + 30) / 32 * 32 + 1;
}

// Element i of line l of a tile at address l * s_line + i * s_elem: (l, i)
// of a loop's step t, consecutive t along whichever has stride 1, so that a
// warp's accesses coalesce
__device__ __forceinline__ void tile_index(int t, int lines, int n,
                                           bool across, int* l, int* i) {
  if (across) {
    *i = t / lines;
    *l = t % lines;
  } else {
    *l = t / n;
    *i = t % n;
  }
}

// Blocks [0, vtiles) scan tiles of lv columns of v, the rest tiles of lh
// rows of hc; each tile's lines in shared memory (lines x pitch_of(n)) with
// their block totals (lines x pitch_of(m)): load coalesced, the in-block
// prefixes a thread a (line, block), the totals' scan a thread a line
// (carry_up), the offsets added, stored coalesced. The image's element (r,
// c) is img[r * sr + c * sc] (a pyramid level may be transposed).
__global__ void __launch_bounds__(kTileThreads)
integral_kernel(const float* __restrict__ img, float* __restrict__ v,
                float* __restrict__ hc, int h, int w, int sr, int sc,
                int vtiles, int lv, int lh) {
  extern __shared__ float smem[];
  const bool down = blockIdx.x < vtiles;
  const int L = down ? lv : lh;
  const int line0 = (down ? blockIdx.x : blockIdx.x - vtiles) * L;
  const int lines = min(L, (down ? w : h) - line0);
  const int n = (down ? h : w) + 1;       // with the zero first element
  const int P = pitch_of(n), m = (n + kScanBlock - 1) / kScanBlock;
  const int Pm = pitch_of(m);
  float* x = smem;                        // L x P
  float* tot = smem + L * P;              // L x Pm
  // 1. load: v's element i of column c is img[i - 1, c], hc's of row r
  // img[r, i - 1], element 0 zero
  const int64_t s_line = down ? sc : sr, s_elem = down ? sr : sc;
  const float* src = img + static_cast<int64_t>(line0) * s_line;
  const bool across_in = s_line == 1 && s_elem != 1;
  for (int t0 = threadIdx.x; t0 < n * lines;
       t0 += kLoadsAhead * kTileThreads) {
    float val[kLoadsAhead];
    int at[kLoadsAhead];
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u) {   // the loads first, then the
      const int t = t0 + u * kTileThreads;    // stores: kLoadsAhead loads
      int l = 0, i = 0;                        // in flight a thread
      if (t < n * lines) tile_index(t, lines, n, across_in, &l, &i);
      at[u] = t < n * lines ? l * P + i : -1;
      val[u] = at[u] >= 0 && i > 0
          ? __ldg(src + l * s_line + (i - 1) * s_elem) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadsAhead; ++u)
      if (at[u] >= 0) x[at[u]] = val[u];
  }
  __syncthreads();
  // 2. each block of 16 summed in order, in place; its total aside
  for (int t = threadIdx.x; t < L * m; t += kTileThreads) {
    const int l = t % L, j = t / L;
    if (l >= lines) continue;
    float* row = x + l * P + kScanBlock * j;
    const int len = min(kScanBlock, n - kScanBlock * j);
    float p = row[0];
    for (int k = 1; k < len; ++k) {
      p = __fadd_rn(p, row[k]);
      row[k] = p;
    }
    tot[l * Pm + j] = p;
  }
  __syncthreads();
  // 3. a line's block totals scanned up the levels: tot[j] becomes block
  // j's offset (0 for block 0; the last block's total is never needed)
  const int top = scan_top(n);
  if (top > 0 && static_cast<int>(threadIdx.x) < lines) {
    float* t = tot + threadIdx.x * Pm;
    ScanState st;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      st.p[l] = 0.0f;
      st.off[l] = 0.0f;
      st.c[l] = 0;
    }
    float off = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float total = t[j];
      t[j] = off;
      if (kScanBlock * (j + 1) <= n) off = carry_up(total, st, top);
    }
  }
  __syncthreads();
  // 4. the offsets added once (none where the line is one block), stored:
  // v row-major ((h + 1) x w, its lines adjacent), hc row-major (h x (w +
  // 1), its elements adjacent)
  float* dst = down ? v + line0 : hc + static_cast<int64_t>(line0) * (w + 1);
  const int64_t o_line = down ? 1 : w + 1, o_elem = down ? w : 1;
  for (int t = threadIdx.x; t < n * lines; t += kTileThreads) {
    int l, i;
    tile_index(t, lines, n, down, &l, &i);
    float p = x[l * P + i];
    if (top > 0) p = __fadd_rn(p, tot[l * Pm + i / kScanBlock]);
    dst[l * o_line + i * o_elem] = p;
  }
}

// Lines of n a tile: up to kTileLines, as many as kTileBytes of shared
// memory hold
int tile_lines(int n) {
  const int per = 4 * (pitch_of(n) + pitch_of((n + kScanBlock - 1)
                                              / kScanBlock));
  return kTileBytes / per < kTileLines ? kTileBytes / per : kTileLines;
}

// An integral image: a[r * stride + c] for 0 <= r <= rmax, 0 <= c <= cmax
struct Integral {
  const float* __restrict__ a;
  int stride, rmax, cmax;
};

__device__ __forceinline__ float at(const Integral& g, int r, int c) {
  return (r >= 0 && r <= g.rmax && c >= 0 && c <= g.cmax)
             ? __ldg(g.a + static_cast<int64_t>(r) * g.stride + c) : 0.0f;
}

// The moment's term at offset d: the column sum v[y + hw + 1, x + d] -
// v[y - hw, x + d] (col, m10) or the row sum hc[y + d, x + hw + 1] - hc[y
// + d, x - hw] (m01).
__device__ __forceinline__ float term(const Integral& g, bool col, int x,
                                      int y, int d) {
  const int hw = kHalfWidth[d + kHalfPatch];
  const int r1 = y + (col ? hw + 1 : d), c1 = x + (col ? d : hw + 1);
  const int r2 = y + (col ? -hw : d), c2 = x + (col ? d : -hw);
  return __fsub_rn(at(g, r1, c1), at(g, r2, c2));
}

// The moment's chain, in the compiled reference's order
__device__ __forceinline__ float moment(const Integral& g, bool col, int x,
                                        int y) {
  float t[2 * kHalfPatch + 1];
#pragma unroll
  for (int d = -kHalfPatch; d <= kHalfPatch; ++d)
    t[d + kHalfPatch] = d ? term(g, col, x, y, d) : 0.0f;
  float acc = __fmaf_rn(t[0], -15.0f, __fmul_rn(t[1], -14.0f));
#pragma unroll
  for (int d = -13; d <= kHalfPatch; ++d)
    if (d) acc = __fmaf_rn(t[d + kHalfPatch], static_cast<float>(d), acc);
  return acc;
}

__global__ void __launch_bounds__(kAngleThreads)
angles_kernel(const float* __restrict__ v, const float* __restrict__ hc,
              const int32_t* __restrict__ xy, float* __restrict__ out,
              int h, int w, int k) {
  const int64_t kp = static_cast<int64_t>(blockIdx.x) * kAngleThreads
                     + threadIdx.x;
  if (kp >= k) return;
  const int x = __ldg(xy + 2 * kp), y = __ldg(xy + 2 * kp + 1);
  const Integral gv = {v, w, h, w - 1};        // (h + 1) x w
  const Integral gh = {hc, w + 1, h - 1, w};   // h x (w + 1)
  const float m10 = moment(gv, true, x, y);
  const float m01 = moment(gh, false, x, y);
  out[kp] = tod_libm::atan2f_libm(m01, m10);
}

}  // namespace

// The orientation angles of k keypoints of an h x w float32 level image
// (pixel (r, c) at img[r * sr + c * sc]): out[i] = atan2f(m01, m10) at
// xy[i] (int32 (x, y) pairs in the image),
// through the integral images v ((h + 1) x w floats) and hc (h x (w + 1)),
// which the caller allocates and this call overwrites. Queues two kernels
// on `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_orb_angles(const void* img, const void* xy, void* v,
                              void* hc, void* out, int h, int w, int sr,
                              int sc, int k, void* stream) {
  if (h <= 0 || w <= 0 || k < 0) return static_cast<int>(
      cudaErrorInvalidValue);
  if (k == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lv = tile_lines(h + 1), lh = tile_lines(w + 1);
  if (lv < 1 || lh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vtiles = (w + lv - 1) / lv, htiles = (h + lh - 1) / lh;
  const int bytes_v = 4 * lv * (pitch_of(h + 1) + pitch_of((h + 16) / 16));
  const int bytes_h = 4 * lh * (pitch_of(w + 1) + pitch_of((w + 16) / 16));
  const int bytes = bytes_v > bytes_h ? bytes_v : bytes_h;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        integral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  integral_kernel<<<vtiles + htiles, kTileThreads, bytes, s>>>(
      static_cast<const float*>(img), static_cast<float*>(v),
      static_cast<float*>(hc), h, w, sr, sc, vtiles, lv, lh);
  const int blocks = static_cast<int>((static_cast<int64_t>(k)
                                       + kAngleThreads - 1) / kAngleThreads);
  angles_kernel<<<blocks, kAngleThreads, 0, s>>>(
      static_cast<const float*>(v), static_cast<const float*>(hc),
      static_cast<const int32_t*>(xy), static_cast<float*>(out), h, w, k);
  return static_cast<int>(cudaGetLastError());
}
