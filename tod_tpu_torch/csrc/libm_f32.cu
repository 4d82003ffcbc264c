// The host C library's float32 atan2f on Hopper, bit for bit.
//
// L1 tod_atan2f replaces, on the card, the reference's XLA atan2
// (tod_tpu/ops/orb.py:163, the keypoint orientation, and
// tod_tpu/ops/sift.py:105, the gradient orientation): not a Pallas kernel,
// but an elementwise op that XLA's CPU backend lowers to a call of the C
// library's atan2f by name. That libm is glibc's on x86-64 (2.36), whose
// atan2f is fdlibm's sysdeps/ieee754/flt-32/e_atan2f.c over s_atanf.c:
// this file transcribes both, branch for branch (the reduction by bit
// pattern, the odd and even polynomials, the atanhi / atanlo split, the
// quadrant fix with pi_lo). Every float operation is rounded on its own,
// as glibc's x86-64 build rounds it: __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which nvcc never contracts into an FMA. The constants are the
// C source's decimal literals rounded to float. The plain version is
// tod_tpu_torch/ops/libm.py atan2f_torch.
//
// Design: one thread an element, grid-stride; about 40 float operations
// (two divisions) an element against 12 bytes moved. On the H100 the bytes
// bound it at the features' sizes (3.35 TB/s against ~30 T simple float
// operations a second at 67 TFLOP/s FMA-equivalent).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t bits_of(float v) {
  return __float_as_int(v);
}

// s_atanf.c for a non-negative, non-NaN x
__device__ float atanf_abs(float x) {
  const float atanhi[4] = {4.6364760399e-01f, 7.8539812565e-01f,
                           9.8279368877e-01f, 1.5707962513e+00f};
  const float atanlo[4] = {5.0121582440e-09f, 3.7748947079e-08f,
                           3.4473217170e-08f, 7.5497894159e-08f};
  const float aT[11] = {3.3333334327e-01f, -2.0000000298e-01f,
                        1.4285714924e-01f, -1.1111110449e-01f,
                        9.0908870101e-02f, -7.6918758452e-02f,
                        6.6610731184e-02f, -5.8335702866e-02f,
                        4.9768779427e-02f, -3.6531571299e-02f,
                        1.6285819933e-02f};
  const int32_t ix = bits_of(x);
  if (ix >= 0x4c000000) return __fadd_rn(atanhi[3], atanlo[3]);  // 2^25
  int id;
  if (ix < 0x3ee00000) {                  // |x| < 7/16
    if (ix < 0x31000000) return x;        // |x| < 2^-29
    id = -1;
  } else if (ix < 0x3f980000) {           // |x| < 19/16
    if (ix < 0x3f300000) {                // 7/16 <= |x| < 11/16
      id = 0;
      x = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, x), 1.0f), __fadd_rn(2.0f, x));
    } else {                              // 11/16 <= |x| < 19/16
      id = 1;
      x = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
    }
  } else if (ix < 0x401c0000) {           // |x| < 2.4375
    id = 2;
    x = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
  } else {                                // 2.4375 <= |x| < 2^25
    id = 3;
    x = __fdiv_rn(-1.0f, x);
  }
  const float z = __fmul_rn(x, x);
  const float w = __fmul_rn(z, z);
  // s1 = z * (aT0 + w * (aT2 + w * (aT4 + w * (aT6 + w * (aT8 + w aT10)))))
  float s1 = __fadd_rn(aT[8], __fmul_rn(w, aT[10]));
  s1 = __fadd_rn(aT[6], __fmul_rn(w, s1));
  s1 = __fadd_rn(aT[4], __fmul_rn(w, s1));
  s1 = __fadd_rn(aT[2], __fmul_rn(w, s1));
  s1 = __fmul_rn(z, __fadd_rn(aT[0], __fmul_rn(w, s1)));
  // s2 = w * (aT1 + w * (aT3 + w * (aT5 + w * (aT7 + w aT9))))
  float s2 = __fadd_rn(aT[7], __fmul_rn(w, aT[9]));
  s2 = __fadd_rn(aT[5], __fmul_rn(w, s2));
  s2 = __fadd_rn(aT[3], __fmul_rn(w, s2));
  s2 = __fmul_rn(w, __fadd_rn(aT[1], __fmul_rn(w, s2)));
  const float poly = __fmul_rn(x, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(x, poly);
  return __fsub_rn(atanhi[id], __fsub_rn(__fsub_rn(poly, atanlo[id]), x));
}

// e_atan2f.c
__device__ float atan2f_libm(float y, float x) {
  const float pi_o_4 = 7.8539818525e-01f;
  const float pi_o_2 = 1.5707963705e+00f;
  const float pi = 3.1415927410e+00f;
  const float pi_lo = -8.7422776573e-08f;
  const int32_t hx = bits_of(x), hy = bits_of(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);  // NaN
  if (hx == 0x3f800000) {                                 // x = 1.0
    const float a = atanf_abs(fabsf(y));
    return hy < 0 ? -a : a;
  }
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);    // 2 sign(x) + sign(y)
  if (iy == 0) {                                          // y = +-0
    if (m < 2) return y;
    return m == 2 ? pi : -pi;
  }
  if (ix == 0) return hy < 0 ? -pi_o_2 : pi_o_2;        // x = +-0
  if (ix == 0x7f800000) {                                 // x = +-inf
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return pi_o_4;
        case 1: return -pi_o_4;
        case 2: return __fmul_rn(3.0f, pi_o_4);
        default: return __fmul_rn(-3.0f, pi_o_4);
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi;
      default: return -pi;
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 : pi_o_2;   // y = +-inf
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {                                           // |y/x| > 2^60
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  } else if (hx < 0 && k < -60) {                         // |y|/x < -2^-60
    z = 0.0f;
  } else {
    z = atanf_abs(fabsf(__fdiv_rn(y, x)));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

__global__ void __launch_bounds__(kThreads)
atan2f_kernel(const float* __restrict__ y, const float* __restrict__ x,
              float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x; i < n; i += stride) {
    out[i] = atan2f_libm(__ldg(y + i), __ldg(x + i));
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
