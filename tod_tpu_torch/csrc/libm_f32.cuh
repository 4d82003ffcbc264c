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
//
// Below atan2f: glibc 2.36's FMA builds of cosf, sincosf and powf (the
// ifuncs' variants that x86-64 with FMA runs; optimized-routines' s_cosf.c,
// s_sincosf.c, e_powf.c), read off the object code of
// libm.so.6: computed in double with the library's tables, each place where
// GCC contracted a multiply-add into vfmadd/vfnmadd an __fma_rn, every other
// double operation an explicit __dmul_rn / __dadd_rn / __dsub_rn; then
// XLA's own inline log. The plain versions are ops/libm.py cosf_torch,
// sincosf_torch, powf_torch and log_xla_torch. Used by the P3P kernel
// (p3p.cu, kernel P1) and L4 (libm_f32.cu).

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

// ---------------------------------------------------------------------------
// glibc 2.36's FMA builds of sincosf / cosf and powf
// ---------------------------------------------------------------------------

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// __sincosf_table[0]: the cosine's c0..c4 and the sine's s1..s3 (table 1
// negates c0..c4), read at indices that every thread shares: constant
// memory; __inv_pio4, read at an index of the argument's bits: global
// memory through the read-only cache (__ldg), where a warp's divergent
// indices cost one transaction a line and not one a distinct address, as
// in the constant cache; pi / 2^62
__device__ __constant__ double kCosC[5] = {
    0x1.0000000000000p+0, -0x1.ffffffd0c621cp-2, 0x1.55553e1068f19p-5,
    -0x1.6c087e89a359dp-10, 0x1.99343027bf8c3p-16};
__device__ __constant__ double kSinS[3] = {
    -0x1.555545995a603p-3, 0x1.1107605230bc4p-7, -0x1.994eb3774cf24p-13};
__device__ const uint32_t kInvPio4[24] = {
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;   // 2/pi * 2^24
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kPi63 = 0x1.921fb54442d18p-62;

__device__ __forceinline__ double sin_poly(double xs, double x2) {
  const double s1p = dfma(x2, kSinS[2], kSinS[1]);
  const double x3 = dmul(x2, xs);
  const double x7 = dmul(x2, x3);
  const double s = dfma(x3, kSinS[0], xs);
  return dfma(s1p, x7, s);
}

__device__ __forceinline__ double cos_poly(double x2, bool neg) {
  const double c0 = neg ? -kCosC[0] : kCosC[0];
  const double c1 = neg ? -kCosC[1] : kCosC[1];
  const double c2 = neg ? -kCosC[2] : kCosC[2];
  const double c3 = neg ? -kCosC[3] : kCosC[3];
  const double c4 = neg ? -kCosC[4] : kCosC[4];
  const double x4 = dmul(x2, x2);
  const double c1p = dfma(x2, c1, c0);
  const double c2p = dfma(x2, c4, c3);
  const double x6 = dmul(x2, x4);
  const double c = dfma(x4, c2, c1p);
  return dfma(c2p, x6, c);
}

// reduce_large (|x| >= 120): x mod pi/2 from the mantissa times 4/pi
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = ((xi & 0x7fffff) | 0x800000) << shift;
  uint64_t res0 = xi * __ldg(arr);
  const uint64_t res1 = static_cast<uint64_t>(xi) * __ldg(arr + 4);
  const uint64_t res2 = static_cast<uint64_t>(xi) * __ldg(arr + 8);
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return dmul(__ll2double_rn(static_cast<int64_t>(res0)), kPi63);
}

// sincosf(y): both outputs; sinf and cosf round as these
__device__ inline void sincosf_libm(float y, float* sinp, float* cosp) {
  const uint32_t ix = static_cast<uint32_t>(bits_of(y));
  const uint32_t top = (ix >> 20) & 0x7ff;
  const double x = static_cast<double>(y);
  if (top < 0x3f4) {                                   // |y| < pi/4
    if (top < 0x398) {                                 // |y| < 2^-12
      *sinp = y;
      *cosp = 1.0f;
      return;
    }
    const double x2 = dmul(x, x);
    *sinp = __double2float_rn(sin_poly(x, x2));
    *cosp = __double2float_rn(cos_poly(x2, false));
    return;
  }
  if (top >= 0x7f8) {                                  // inf, NaN
    *sinp = *cosp = __fsub_rn(y, y);
    return;
  }
  int n, sn;
  double xr;
  if (top < 0x42f) {                                   // |y| < 120
    const double r = dmul(x, kHpiInv);
    n = (static_cast<int>(r) + 0x800000) >> 24;
    xr = dfma(-static_cast<double>(n), kHpi, x);
    sn = n;
  } else {
    xr = reduce_large(ix, &n);
    sn = n + static_cast<int>(ix >> 31);
  }
  const double sgn = (sn & 3) == 0 || (sn & 3) == 3 ? 1.0 : -1.0;
  const double x2 = dmul(xr, xr);
  const double sp = sin_poly(dmul(xr, sgn), x2);
  const double cp = cos_poly(x2, (sn & 2) != 0);
  const bool odd = (n & 1) != 0;
  *sinp = __double2float_rn(odd ? cp : sp);
  *cosp = __double2float_rn(odd ? sp : cp);
}

__device__ inline float cosf_libm(float y) {
  float s, c;
  sincosf_libm(y, &s, &c);
  return c;
}

// __powf_log2_data's (invc, logc) pairs and __exp2f_data's table, read at
// indices of the argument's bits (a warp's 32 threads up to 16 and 32
// distinct entries): global memory through the read-only cache, 256 bytes
// each, a pair in one 16-byte load; the polynomials, read at indices every
// thread shares, in constant memory
__device__ const double2 kPowLog2[16] = {
    {0x1.661ec79f8f3bep+0, -0x1.efec65b963019p-2},
    {0x1.571ed4aaf883dp+0, -0x1.b0b6832d4fca4p-2},
    {0x1.49539f0f010b0p+0, -0x1.7418b0a1fb77bp-2},
    {0x1.3c995b0b80385p+0, -0x1.39de91a6dcf7bp-2},
    {0x1.30d190c8864a5p+0, -0x1.01d9bf3f2b631p-2},
    {0x1.25e227b0b8ea0p+0, -0x1.97c1d1b3b7af0p-3},
    {0x1.1bb4a4a1a343fp+0, -0x1.2f9e393af3c9fp-3},
    {0x1.12358f08ae5bap+0, -0x1.960cbbf788d5cp-4},
    {0x1.0953f419900a7p+0, -0x1.a6f9db6475fcep-5},
    {0x1.0000000000000p+0, 0x0.0p+0},
    {0x1.e608cfd9a47acp-1, 0x1.338ca9f24f53dp-4},
    {0x1.ca4b31f026aa0p-1, 0x1.476a9543891bap-3},
    {0x1.b2036576afce6p-1, 0x1.e840b4ac4e4d2p-3},
    {0x1.9c2d163a1aa2dp-1, 0x1.40645f0c6651cp-2},
    {0x1.886e6037841edp-1, 0x1.88e9c2c1b9ff8p-2},
    {0x1.767dcf5534862p-1, 0x1.ce0a44eb17bccp-2}};
__device__ const unsigned long long kExp2fT[32] = {
    0x3ff0000000000000ULL, 0x3fefd9b0d3158574ULL, 0x3fefb5586cf9890fULL,
    0x3fef9301d0125b51ULL, 0x3fef72b83c7d517bULL, 0x3fef54873168b9aaULL,
    0x3fef387a6e756238ULL, 0x3fef1e9df51fdee1ULL, 0x3fef06fe0a31b715ULL,
    0x3feef1a7373aa9cbULL, 0x3feedea64c123422ULL, 0x3feece086061892dULL,
    0x3feebfdad5362a27ULL, 0x3feeb42b569d4f82ULL, 0x3feeab07dd485429ULL,
    0x3feea47eb03a5585ULL, 0x3feea09e667f3bcdULL, 0x3fee9f75e8ec5f74ULL,
    0x3feea11473eb0187ULL, 0x3feea589994cce13ULL, 0x3feeace5422aa0dbULL,
    0x3feeb737b0cdc5e5ULL, 0x3feec49182a3f090ULL, 0x3feed503b23e255dULL,
    0x3feee89f995ad3adULL, 0x3feeff76f2fb5e47ULL, 0x3fef199bdd85529cULL,
    0x3fef3720dcef9069ULL, 0x3fef5818dcfba487ULL, 0x3fef7c97337b9b5fULL,
    0x3fefa4afa2a490daULL, 0x3fefd0765b6e4540ULL};
__device__ __constant__ double kPowA[5] = {0x1.27616c9496e0bp-2, -0x1.71969a075c67ap-2,
                             0x1.ec70a6ca7baddp-2, -0x1.7154748bef6c8p-1,
                             0x1.71547652ab82bp+0};
__device__ __constant__ double kExp2C[3] = {0x1.c6af84b912394p-5, 0x1.ebfce50fac4f3p-3,
                              0x1.62e42ff0c52d6p-1};
constexpr double kExp2Shift = 0x1.8p+47;

__device__ __forceinline__ int powf_checkint(uint32_t iy) {
  const int e = (iy >> 23) & 0xff;
  if (e < 0x7f) return 0;
  if (e > 0x7f + 23) return 2;
  if (iy & ((1u << (0x7f + 23 - e)) - 1)) return 0;
  if (iy & (1u << (0x7f + 23 - e))) return 1;
  return 2;
}

__device__ __forceinline__ bool zeroinfnan(uint32_t i) {
  return 2 * i - 1 >= 2u * 0x7f800000 - 1;
}

__device__ inline float powf_libm(float x, float y) {
  uint32_t ix = static_cast<uint32_t>(bits_of(x));
  const uint32_t iy = static_cast<uint32_t>(bits_of(y));
  uint32_t sign_bias = 0;
  if (ix - 0x00800000 >= 0x7f800000 - 0x00800000 || zeroinfnan(iy)) {
    if (zeroinfnan(iy)) {
      if (2 * iy == 0) return 1.0f;
      if (ix == 0x3f800000) return 1.0f;
      if (2 * ix > 2u * 0x7f800000 || 2 * iy > 2u * 0x7f800000)
        return __fadd_rn(x, y);
      if (2 * ix == 2 * 0x3f800000) return 1.0f;
      if ((2 * ix < 2 * 0x3f800000) == !(iy & 0x80000000)) return 0.0f;
      return __fmul_rn(y, y);
    }
    if (zeroinfnan(ix)) {
      float x2 = __fmul_rn(x, x);
      if ((ix & 0x80000000) && powf_checkint(iy) == 1) x2 = -x2;
      return (iy & 0x80000000) ? __fdiv_rn(1.0f, x2) : x2;
    }
    if (ix & 0x80000000) {                       // finite x < 0
      const int yint = powf_checkint(iy);
      if (yint == 0) return __int_as_float(0x7fc00000);
      if (yint == 1) sign_bias = 0x10000;
      ix &= 0x7fffffff;
    }
    if (ix < 0x00800000) {                       // subnormal x
      ix = static_cast<uint32_t>(bits_of(__fmul_rn(x, 0x1p23f)));
      ix &= 0x7fffffff;
      ix -= 23 << 23;
    }
  }
  // log2_inline
  const uint32_t tmp = ix - 0x3f330000;
  const int i = (tmp >> 19) & 15;
  const uint32_t top = tmp & 0xff800000;
  const uint32_t iz = ix - top;
  const int k = static_cast<int32_t>(top) >> 23;
  const double z = static_cast<double>(__int_as_float(static_cast<int>(iz)));
  const double2 c = __ldg(&kPowLog2[i]);
  const double r = dfma(z, c.x, -1.0);
  const double y0 = dadd(__int2double_rn(k), c.y);
  const double r2 = dmul(r, r);
  const double ya = dfma(r, kPowA[0], kPowA[1]);
  const double p = dfma(r, kPowA[2], kPowA[3]);
  const double r4 = dmul(r2, r2);
  double q = dfma(r, kPowA[4], y0);
  q = dfma(r2, p, q);
  const double logx = dfma(ya, r4, q);
  const double ylogx = dmul(static_cast<double>(y), logx);
  if (((__double_as_longlong(ylogx) >> 47) & 0xffff) > 0x80be) {
    const float sgn = sign_bias ? -1.0f : 1.0f;
    if (ylogx > 0x1.fffffffd1d571p+6) return sgn * __int_as_float(0x7f800000);
    if (ylogx <= -150.0) return sgn * 0.0f;
    if (ylogx < -149.0) return sgn * 0x1p-149f;
  }
  // exp2_inline
  double kd = dadd(ylogx, kExp2Shift);
  const uint64_t ki = static_cast<uint64_t>(__double_as_longlong(kd));
  kd = dsub(kd, kExp2Shift);
  const double rr = dsub(ylogx, kd);
  uint64_t t = __ldg(&kExp2fT[ki % 32]);
  t += (ki + sign_bias) << 47;
  const double s = __longlong_as_double(static_cast<long long>(t));
  const double zz = dfma(rr, kExp2C[0], kExp2C[1]);
  const double rr2 = dmul(rr, rr);
  double yy = dfma(rr, kExp2C[2], 1.0);
  yy = dfma(zz, rr2, yy);
  return __double2float_rn(dmul(yy, s));
}

// XLA's own float32 log (ops/libm.py log_xla_torch): Eigen's plog,
// Cephes' polynomial in three interleaved chains, the multiply-adds that
// LLVM contracts fused; subnormal arguments as zero (the runtime's DAZ)
__device__ inline float log_xla(float x) {
  if (x != x) return x;
  if (fabsf(x) < 0x1p-126f) return __int_as_float(0xff800000);  // -inf
  if (x < 0.0f) return __int_as_float(0x7fc00000);
  if (x == __int_as_float(0x7f800000)) return x;
  const int bits = __float_as_int(x);
  float e = __int2float_rn((bits >> 23) - 127);
  const float m = __int_as_float((bits & -2139095041) | 0x3f000000);
  const bool below = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(__fadd_rn(1.0f, e), below ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  const float c0 = __fmaf_rn(__fmaf_rn(z, 0x1.204376p-4f, -0x1.d7a37p-4f), z,
                             0x1.de4a34p-4f);
  const float c1 = __fmaf_rn(__fmaf_rn(z, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), z,
                             -0x1.555ca0p-3f);
  const float c2 = __fmaf_rn(__fmaf_rn(z, 0x1.999d58p-3f, -0x1.fffff8p-3f), z,
                             0x1.555554p-2f);
  float y = __fmaf_rn(__fmaf_rn(c0, z3, c1), z3, c2);
  y = __fmaf_rn(y, z3, __fmul_rn(-0x1.bd0106p-13f, e));
  const float r = __fadd_rn(__fmaf_rn(-0.5f, z2, z), y);
  return __fmaf_rn(0x1.63p-1f, e, r);
}

// jnp.arccos as XLA compiles chlo.acos: atan2f(sqrt((1 - x)(1 + x)), x)
__device__ inline float acosf_xla(float x) {
  return atan2f_libm(__fsqrt_rn(__fmul_rn(__fsub_rn(1.0f, x),
                                          __fadd_rn(1.0f, x))), x);
}

}  // namespace tod_libm
