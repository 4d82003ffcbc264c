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
// powf and XLA's inline log (libm_f32.cuh) elementwise: the 2D-only path's
// elementwise transcendentals outside the P3P kernel (the mirror's and the
// refinement's rotations, the eigen-solve's cosine, the log-ratios) and the
// log-weights of every RANSAC path, whose reference calls the C library by
// name. Plain versions: ops/libm.py. Design: one instantiation a function
// (a template parameter, so no branch on it in the loop); where every
// array is 16-byte aligned a thread takes four elements by 16-byte loads
// and stores (the last 1-3 elements one at a time), else one; a block of
// 256 threads for each 256 such steps (a grid capped at one wave of the
// card took 10 % longer at the 2D path's largest call, 14.7 M floats, and
// tied elsewhere). The tables that a thread indexes by its argument
// (powf's, and sincosf's for |x| >= 120) are read through the read-only
// cache, where a warp's distinct indices cost one transaction a line, not
// one each as in the constant cache (libm_f32.cuh).

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
template <int kFn>
__device__ __forceinline__ void libm_one(float v, float w, float* o,
                                         float* o2) {
  if (kFn == 0) {
    *o = tod_libm::cosf_libm(v);
  } else if (kFn == 1) {
    tod_libm::sincosf_libm(v, o, o2);
  } else if (kFn == 2) {
    *o = tod_libm::powf_libm(v, w);
  } else {
    *o = tod_libm::log_xla(v);
  }
}

template <int kFn>
__device__ __forceinline__ void libm_at(const float* __restrict__ x,
                                        const float* __restrict__ y,
                                        float* __restrict__ out,
                                        float* __restrict__ out2, int64_t i) {
  float o, o2;
  libm_one<kFn>(__ldg(x + i), kFn == 2 ? __ldg(y + i) : 0.0f, &o, &o2);
  out[i] = o;
  if (kFn == 1) out2[i] = o2;
}

// Unless `vec`, every element one at a time. Else (every array 16-byte
// aligned) the first 4 nv elements in float4s, the last (fewer than 4) one
// at a time by the first threads
template <int kFn>
__global__ void __launch_bounds__(kThreads)
libm_kernel(const float* __restrict__ x, const float* __restrict__ y,
            float* __restrict__ out, float* __restrict__ out2, int64_t n,
            bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (!vec) {
    for (int64_t i = gid; i < n; i += stride)
      libm_at<kFn>(x, y, out, out2, i);
    return;
  }
  const int64_t nv = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  float4* p4 = reinterpret_cast<float4*>(out2);
  for (int64_t v = gid; v < nv; v += stride) {
    const float4 a = __ldg(x4 + v);
    const float4 b = kFn == 2 ? __ldg(y4 + v) : make_float4(0, 0, 0, 0);
    float4 o, o2;
    libm_one<kFn>(a.x, b.x, &o.x, &o2.x);
    libm_one<kFn>(a.y, b.y, &o.y, &o2.y);
    libm_one<kFn>(a.z, b.z, &o.z, &o2.z);
    libm_one<kFn>(a.w, b.w, &o.w, &o2.w);
    o4[v] = o;
    if (kFn == 1) p4[v] = o2;
  }
  if (gid < n - 4 * nv) libm_at<kFn>(x, y, out, out2, 4 * nv + gid);
}

template <int kFn>
int launch_libm(const float* x, const float* y, float* out, float* out2,
                int64_t n, cudaStream_t stream) {
  // the vector path when every array is 16-byte aligned
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = aligned(x) && aligned(out) && (kFn != 2 || aligned(y))
                   && (kFn != 1 || aligned(out2));
  const int64_t work = vec ? (n / 4 > 4 ? n / 4 : 4) : n;  // >= the tail
  const int blocks = static_cast<int>((work + kThreads - 1) / kThreads);
  libm_kernel<kFn><<<blocks, kThreads, 0, stream>>>(x, y, out, out2, n, vec);
  return static_cast<int>(cudaGetLastError());
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
// (and out2); any 4-byte aligned pointers. Launches on
// `stream` and returns cudaGetLastError(); it neither allocates nor
// synchronises.
extern "C" int tod_libm_f32(const void* x, const void* y, void* out,
                            void* out2, int fn, int n, void* stream) {
  if (n <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  float* o2 = static_cast<float*>(out2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (fn) {
    case 0: return launch_libm<0>(xf, yf, of, o2, n, s);
    case 1: return launch_libm<1>(xf, yf, of, o2, n, s);
    case 2: return launch_libm<2>(xf, yf, of, o2, n, s);
    case 3: return launch_libm<3>(xf, yf, of, o2, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
