// float32 exp / expm1 / tanh / log / log1p as XLA's CPU backend computes
// them, and the jitted counter graph built from them: the device side of
// repro_torch/core/xla_f32.py, operation for operation and constant for
// constant.
//
// The build is -fmad=false without fast math (kernels/build.py), so nvcc
// contracts nothing: each `a * b + c` below rounds twice, and an FMA is
// exactly where this file writes __fmaf_rn -- where XLA's LLVM contracted
// a single-use multiply into its add.  Division and floorf are IEEE.  The
// constants are the float32 values of the Python replica's, written in hex
// so no decimal rounding stands between them.
//
// Denormals: XLA's CPU flushes them.  None reaches these functions on the
// counters' domain (integral states >= 0 times log b, v * (b - 1) with v a
// decode plus a weight that cml_nfold_log flushes, `flush` below); a
// denormal log1p argument would floor to state 0 either way.
#pragma once

#include <cstdint>

namespace xla_f32 {

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ((c0 x + c1) x + c2) ... with every step one FMA.
template <int N>
__device__ __forceinline__ float horner(float x, const float (&c)[N]) {
  float p = __fmaf_rn(x, c[0], c[1]);
#pragma unroll
  for (int k = 2; k < N; ++k) p = __fmaf_rn(p, x, c[k]);
  return p;
}

// 2^n for integral n in [-127, 127], from its bits (n = -127 gives 0).
__device__ __forceinline__ float pow2(float n) {
  return __int_as_float(((int)n + 127) << 23);
}

// Cephes expf: range reduction by ln 2 in two parts, a degree-5
// polynomial.
__device__ __forceinline__ float exp(float x) {
  constexpr float P[6] = {0x1.a0d2cep-13f, 0x1.6e879cp-10f, 0x1.111210p-7f,
                          0x1.555382p-5f, 0x1.555554p-3f, 0x1.0p-1f};
  x = clampf(x, -0x1.5f3334p+6f, 0x1.633334p+6f);  // -87.8, 88.8
  const float fx =
      clampf(floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f)), -127.0f, 127.0f);
  float r = __fmaf_rn(fx, -0x1.63p-1f, x);          // ln 2, high part
  r = __fmaf_rn(fx, 0x1.bd0106p-13f, r);            // ln 2, low part
  const float p = horner(r, P);
  const float y = __fmaf_rn(p, r * r, r) + 1.0f;
  return y * pow2(fx);
}

// XLA's rational tanh.
__device__ __forceinline__ float tanh(float x) {
  constexpr float NUM[7] = {-0x1.3e4b8p-52f,  0x1.c266fcp-43f,
                            -0x1.7a6ffep-34f, 0x1.b80082p-25f,
                            0x1.f28694p-17f,  0x1.4e1bdap-11f,
                            0x1.40b3b8p-8f};
  constexpr float DEN[4] = {0x1.41a7bp-20f, 0x1.f12bacp-14f, 0x1.29540ap-9f,
                            0x1.40b3bap-8f};
  const float ax = fabsf(x);
  const float c = clampf(x, -0x1.ffec88p+2f, 0x1.ffec88p+2f);  // 7.9988117
  const float x2 = c * c;
  float res = (c * horner(x2, NUM)) / horner(x2, DEN);
  res = ax < 0x1.a36e2ep-12f ? x : res;  // 0.0004
  return ax >= 20.0f ? copysignf(1.0f, x) : res;
}

// exp(x) - 1 above |x| = 0.5, else tanh(x / 2) * (exp(x) + 1).
__device__ __forceinline__ float expm1(float x) {
  const float e = xla_f32::exp(x);
  const float h = x * 0.5f;
  const float small = xla_f32::tanh(h) * (e + 1.0f);
  const float res = fabsf(x) > 0.5f ? e - 1.0f : small;
  return h == 0.0f ? x : res;
}

// Cephes logf on the mantissa in [sqrt(1/2), sqrt(2)) and the exponent.
__device__ __forceinline__ float log(float u) {
  constexpr float P0[3] = {0x1.204376p-4f, -0x1.d7a37p-4f, 0x1.de4a34p-4f};
  constexpr float P1[3] = {-0x1.fcba9ep-4f, 0x1.23d37ep-3f, -0x1.555ca0p-3f};
  constexpr float P2[3] = {0x1.999d58p-3f, -0x1.fffff8p-3f, 0x1.555554p-2f};
  constexpr float MIN_NORM = 0x1.0p-126f;
  const float t0 = u > MIN_NORM ? u : MIN_NORM;
  const int32_t bits = __float_as_int(t0);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);
  const bool mask = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  const float e = ((float)((bits >> 23) - 127) + 1.0f) - (mask ? 1.0f : 0.0f);
  const float t = (m - 1.0f) + (mask ? m : 0.0f);
  const float x2 = t * t;
  const float x3 = x2 * t;
  float y = __fmaf_rn(__fmaf_rn(horner(t, P0), x3, horner(t, P1)), x3,
                      horner(t, P2));
  y = __fmaf_rn(y, x3, e * -0x1.bd0106p-13f);
  const float r = __fmaf_rn(e, 0x1.63p-1f, (t - x2 * 0.5f) + y);
  if (u == 0.0f) return __uint_as_float(0xFF800000u);  // -inf
  if (u == __uint_as_float(0x7F800000u)) return u;     // +inf
  if (u <= 0.0f || u != u) return __int_as_float(-1);
  return r;
}

// log1p: a rational approximation below sqrt(2) - 1, log(x + 1) above.
__device__ __forceinline__ float log1p(float x) {
  constexpr float DEN[5] = {0x1.4c30b6p+6f, 0x1.bb865ap+7f, 0x1.351946p+8f,
                            0x1.b0db14p+7f, 0x1.e0f304p+5f};
  constexpr float NUM[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                            0x1.de9738p+4f,  0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                            0x1.40a202p+4f};
  const float large = xla_f32::log(x + 1.0f);
  const float x2 = x * x;
  float den = x + 0x1.e2035ap+3f;  // (0 x + 1) x + 15.062909
#pragma unroll
  for (int k = 0; k < 5; ++k) den = __fmaf_rn(den, x, DEN[k]);
  const float q = horner(x, NUM) / den;
  const float small = x + __fmaf_rn(x2, -0.5f, (x * x2) * q);
  return fabsf(x) < 0x1.a8279ap-2f ? small : large;  // sqrt(2) - 1
}

// A weight as XLA's CPU reads it: a denormal is a zero of its sign.
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < 0x1.0p-126f ? x * 0.0f : x;
}

}  // namespace xla_f32
