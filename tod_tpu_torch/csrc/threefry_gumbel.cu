// Threefry-2x32 random bits and Gumbel noise on Hopper, drawn as
// jax.random draws them.
//
// N1 tod_threefry_gumbel replaces, on the card, the reference's
// jax.random.gumbel (tod_tpu/geometry/ransac.py:127,136, _masked_gumbel_argmax
// and _masked_weighted_argmax): not a Pallas kernel, but the threefry that
// XLA fuses into one kernel there. For each key (k0, k1) of a batch of keys
// and each flat index i < n of the draw's shape:
//     bits = x0 ^ x1 of threefry-2x32 (20 rounds, a key injection after
//            every 4) of the count (hi, lo) = (i >> 32, i & 0xFFFFFFFF),
//            JAX's partitionable layout (jax_threefry_partitionable), so
//            hi = 0 for every i < 2^31 that the entry point takes;
//     f    = the float of (bits >> 9) | 0x3F800000, less 1.0f;
//     u    = max(f * span + tiny, tiny), span = 1.0f - tiny = 1.0f;
//     g    = -log(-log(u)).
// Mode "bits" writes bits (as int32), mode "gumbel" g (float32), a row of
// n per key. The plain version is tod_tpu_torch/utils/prng.py: bits equal
// random_bits bit for bit; the float steps are those of gumbel_torch in its
// order, each rounded once (__fmul_rn / __fadd_rn: no contraction into an
// FMA), and logf is the correctly rounded-within-an-ulp library log that
// PyTorch's float32 torch.log calls on the card (never __logf; the build
// has no --use_fast_math).
//
// Design: a thread draws 4 consecutive counts of one key in registers, in
// native uint32 arithmetic (the rotation is one funnel shift), and stores
// them as one 16-byte vector (a warp writes 512 contiguous bytes; a row of
// n % 4 != 0 is stored element by element). A block is 256 threads over
// 1024 counts of the keys blockIdx.y, blockIdx.y + gridDim.y, ... (one key
// a block wherever a batch has at most 65535 keys, the grid's y extent),
// whose 8 bytes every thread reads (one broadcast load a warp). The keys
// are split on the host and sent up with the launch; nothing is read but
// them.
//
// Bound on the H100: 4 bytes written a draw, against about 100 instructions
// a draw (the threefry's adds, funnel shifts and xors, the mantissa fill,
// two logf); the instructions bound it. chip_smoke.py counts them in the
// compiled kernel, by pipe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                    // counts a thread, one uint4
constexpr int kPerBlock = kThreads * kPerThread;
constexpr uint32_t kParity = 0x1BD11BDAu;        // threefry's key parity
constexpr uint32_t kOneBits = 0x3F800000u;       // 1.0f
constexpr float kTiny = 1.17549435e-38f;         // float32's smallest normal
constexpr float kSpan = 1.0f - kTiny;            // = 1.0f in float32

// bits of the count (0, lo) under the key (k0, k1), k2 = k0 ^ k1 ^ parity
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t lo) {
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k2};
  uint32_t x0 = ks[0];          // hi + k0, hi = 0
  uint32_t x1 = lo + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, kRot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __uint_as_float((bits >> 9) | kOneBits) - 1.0f;  // exact
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, kSpan), kTiny), kTiny);
  return -logf(-logf(u));
}

// grid (ceil(n / 1024), min(keys, 65535)); out is (keys, n) of 32-bit
// values
template <bool kBits>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const uint2* __restrict__ keys, uint32_t* __restrict__ out,
                int n_keys, int n) {
  const uint32_t n_u = static_cast<uint32_t>(n);
  const uint32_t i0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i0 >= n_u) return;
  for (int k = blockIdx.y; k < n_keys; k += gridDim.y) {
    const uint2 key = keys[k];           // the same for the whole block
    const uint32_t k2 = key.x ^ key.y ^ kParity;
    uint32_t v[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const uint32_t bits = threefry_bits(key.x, key.y, k2, i0 + j);
      v[j] = kBits ? bits : __float_as_uint(gumbel_of(bits));
    }
    uint32_t* row = out + static_cast<size_t>(k) * n_u;
    if ((n_u & (kPerThread - 1)) == 0) {   // rows 16-byte aligned, i0 + 3 < n
      *reinterpret_cast<uint4*>(row + i0) =
          make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (i0 + j < n_u) row[i0 + j] = v[j];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): keys (n_keys, 2) uint32 words,
// out (n_keys, n) int32 bits (bits != 0) or float32 Gumbel values; n <
// 2^31. Launches on `stream` and returns cudaGetLastError(); it neither
// allocates nor synchronises.
extern "C" int tod_threefry_gumbel(const void* keys, void* out, int n_keys,
                                   int n, int bits, void* stream) {
  if (n_keys > 0 && n > 0) {
    const dim3 grid((n - 1) / kPerBlock + 1, n_keys < 65535 ? n_keys : 65535);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto k = static_cast<const uint2*>(keys);
    const auto o = static_cast<uint32_t*>(out);
    if (bits)
      threefry_kernel<true><<<grid, kThreads, 0, s>>>(k, o, n_keys, n);
    else
      threefry_kernel<false><<<grid, kThreads, 0, s>>>(k, o, n_keys, n);
  }
  return static_cast<int>(cudaGetLastError());
}
