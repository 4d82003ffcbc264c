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
//
// tod_libm_f32 (kernel L4) evaluates glibc's FMA builds of cosf, sincosf and
// powf and XLA's inline log (libm_f32.cuh) elementwise, the same design: the 2D-only path's
// elementwise transcendentals outside the P3P kernel (the mirror's and the
// refinement's rotations, the eigen-solve's cosine, the log-ratios), whose
// reference calls the C library by name. Plain versions: ops/libm.py.

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

// fn 0: out = cosf(x); 1: out = sinf(x), out2 = cosf(x) (sincosf); 2: out
// = powf(x, y); 3: out = XLA's log(x)
__global__ void __launch_bounds__(kThreads)
libm_kernel(int fn, const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, float* __restrict__ out2, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n; i += stride) {
    const float v = __ldg(x + i);
    if (fn == 0) {
      out[i] = tod_libm::cosf_libm(v);
    } else if (fn == 1) {
      tod_libm::sincosf_libm(v, out + i, out2 + i);
    } else if (fn == 2) {
      out[i] = tod_libm::powf_libm(v, __ldg(y + i));
    } else {
      out[i] = tod_libm::log_xla(v);
    }
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

// The function `fn` (above) of x[i] (and y[i]) for i < n, float32, into out
// (and out2). Launches on `stream` and returns cudaGetLastError().
extern "C" int tod_libm_f32(const void* x, const void* y, void* out,
                            void* out2, int fn, int n, void* stream) {
  if (n <= 0) return 0;
  if (fn < 0 || fn > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads < 132 * 32
                         ? (n + kThreads - 1) / kThreads : 132 * 32;
  libm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fn, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), static_cast<float*>(out2), n);
  return static_cast<int>(cudaGetLastError());
}
