// The host C library's float32 atan2f as a device function, bit for bit:
// glibc's fdlibm e_atan2f.c over s_atanf.c (2.36, x86-64), transcribed
// branch for branch (the reduction by bit pattern, the odd and even
// polynomials, the atanhi / atanlo split, the quadrant fix with pi_lo).
// Every float operation is rounded on its own, as glibc's x86-64 build
// rounds it: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc
// never contracts into an FMA. The constants are the C source's decimal
// literals rounded to float. The plain version is
// tod_tpu_torch/ops/libm.py atan2f_torch. Included by libm_f32.cu (kernel
// L1) and sift_descriptor.cu (the fused SIFT descriptor, kernel L2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tod_libm {

__device__ __forceinline__ int32_t bits_of(float v) {
  return __float_as_int(v);
}

// s_atanf.c for a non-negative, non-NaN x
__device__ inline float atanf_abs(float x) {
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
  if (ix < 0x31000000) return x;          // |x| < 2^-29
  // the reduction by range, -1: |x| < 7/16 keeps x; 0: (2x - 1) / (2 + x);
  // 1: (x - 1) / (x + 1); 2: (x - 1.5) / (1 + 1.5x); 3: -1 / x. Its
  // operands are selected, so a warp divides once whatever its ranges
  const int id = ix < 0x3ee00000 ? -1 : ix < 0x3f300000 ? 0
      : ix < 0x3f980000 ? 1 : ix < 0x401c0000 ? 2 : 3;
  if (id >= 0) {
    const float num = id == 0 ? __fsub_rn(__fmul_rn(2.0f, x), 1.0f)
        : id == 1 ? __fsub_rn(x, 1.0f) : id == 2 ? __fsub_rn(x, 1.5f) : -1.0f;
    const float den = id == 0 ? __fadd_rn(2.0f, x)
        : id == 1 ? __fadd_rn(x, 1.0f)
        : id == 2 ? __fadd_rn(1.0f, __fmul_rn(1.5f, x)) : x;
    x = __fdiv_rn(num, den);
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
__device__ inline float atan2f_libm(float y, float x) {
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

}  // namespace tod_libm
