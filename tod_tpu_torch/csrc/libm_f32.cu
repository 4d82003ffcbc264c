// The host C library's float32 atan2f on Hopper, bit for bit.
//
// L1 tod_atan2f replaces, on the card, the reference's XLA atan2
// (tod_tpu/ops/orb.py:163, the keypoint orientation, and
// tod_tpu/ops/sift.py:105, the gradient orientation): not a Pallas kernel,
// but an elementwise op that XLA's CPU backend lowers to a call of the C
// library's atan2f by name: glibc's on x86-64 (2.36), fdlibm's
// e_atan2f.c over s_atanf.c, which libm_f32.cuh transcribes (shared with
// the fused SIFT descriptor, sift_descriptor.cu). The plain version is
// tod_tpu_torch/ops/libm.py atan2f_torch.
//
// Design: one thread an element, grid-stride; about 40 float operations
// (two divisions) an element against 12 bytes moved. On the H100 the bytes
// bound it at the features' sizes (3.35 TB/s against ~30 T simple float
// operations a second at 67 TFLOP/s FMA-equivalent).

#include <cuda_runtime.h>
#include <stdint.h>

#include "libm_f32.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
atan2f_kernel(const float* __restrict__ y, const float* __restrict__ x,
              float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n; i += stride) {
    out[i] = tod_libm::atan2f_libm(__ldg(y + i), __ldg(x + i));
  }
}

}  // namespace

// out[i] = atan2f(y[i], x[i]) for i < n, float32. Launches on `stream` and
// returns cudaGetLastError(); it neither allocates nor synchronises.
extern "C" int tod_atan2f(const void* y, const void* x, void* out, int n,
                          void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads < 132 * 32
                         ? (n + kThreads - 1) / kThreads : 132 * 32;
  atan2f_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
