// The port's device random numbers: jax's threefry2x32 stream and the
// bits -> sample chains, shared by defended_encode.cu and prng_draw.cu.
//
// Stream: jax 0.9.0's partitionable threefry (utils/prng.py). Element i of
// bits(key) is x0 ^ x1 of threefry2x32(key, hi32(i), lo32(i)), i the 64-bit
// flat counter. 20 rounds, rotations (13,15,26,6)/(17,29,16,24), the key
// injected after every 4 rounds with ks[2] = k0 ^ k1 ^ 0x1BD11BDA. Per
// 32-bit word: 20 x (add, rotate, xor) + 5 x 2 injections + 2 initial adds
// + the final xor = 73 integer operations, each rotate one funnel shift.
//
// Samples: uniform = mantissa fill to [1, 2) minus 1; the open interval
// (-1 + 2^-24, 1) by an exact x2 and one rounded add; normal = sqrt(2) *
// erf_inv(u); laplace = sign(u) * log1p(-|u|). erf_inv, log1p and log are
// XLA's own f32 formulas (Giles' erf_inv polynomial; Cephes log1p and logf,
// with FMAs exactly where the XLA CPU backend emits them), the same as the
// plain torch version in repro_torch/utils/xla_math.py. Every rounding is
// an __f*_rn intrinsic, and the files that include this one are built with
// --fmad=false, so nothing is contracted behind the code's back.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace prng {

// ---- threefry2x32 ----------------------------------------------------------
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// the stream's word at 64-bit flat counter i
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            unsigned long long i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// ---- XLA's f32 log (Cephes logf) --------------------------------------------
__device__ __forceinline__ float xla_log(float x) {
  constexpr float kSqrtHalf = (float)0.707106781186547524;
  float xc = x > FLT_MIN ? x : FLT_MIN;
  uint32_t xb = __float_as_uint(xc);
  int ei = (int)(xb >> 23) - 127;
  float m = __uint_as_float((xb & ~0x7F800000u) | 0x3F000000u);
  float e = __fadd_rn(1.0f, (float)ei);
  bool small = m < kSqrtHalf;
  float t = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float x2 = __fmul_rn(t, t);
  float x3 = __fmul_rn(x2, t);
  float y = __fmaf_rn(__fmaf_rn((float)7.0376836292E-2, t,
                                (float)-1.1514610310E-1), t,
                      (float)1.1676998740E-1);
  float y1 = __fmaf_rn(__fmaf_rn((float)-1.2420140846E-1, t,
                                 (float)1.4249322787E-1), t,
                       (float)-1.6668057665E-1);
  float y2 = __fmaf_rn(__fmaf_rn((float)2.0000714765E-1, t,
                                 (float)-2.4999993993E-1), t,
                       (float)3.3333331174E-1);
  y = __fmaf_rn(x3, y, y1);
  y = __fmaf_rn(x3, y, y2);
  y = __fmaf_rn(y, x3, __fmul_rn((float)-2.12194440e-4, e));
  float r = __fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, x2)), y);
  r = __fmaf_rn((float)0.693359375, e, r);
  if (x < 0.0f || x != x) r = __int_as_float(-1);  // XLA's all-ones NaN
  if (x == INFINITY) r = INFINITY;
  if (fabsf(x) < FLT_MIN) r = -INFINITY;  // XLA CPU: subnormals are zero
  return r;
}

// ---- XLA's f32 log1p ---------------------------------------------------------
__device__ __forceinline__ float xla_log1p(float x) {
  float x2 = __fmul_rn(x, x);
  float p = (float)4.5270000862445199635215E-5;
  p = __fmaf_rn(p, x, (float)4.9854102823193375972212E-1);
  p = __fmaf_rn(p, x, (float)6.5787325942061044846969E0);
  p = __fmaf_rn(p, x, (float)2.9911919328553073277375E1);
  p = __fmaf_rn(p, x, (float)6.0949667980987787057556E1);
  p = __fmaf_rn(p, x, (float)5.7112963590585538103336E1);
  p = __fmaf_rn(p, x, (float)2.0039553499201281259648E1);
  float q = 1.0f;
  q = __fmaf_rn(q, x, (float)1.5062909083469192043167E1);
  q = __fmaf_rn(q, x, (float)8.3047565967967209469434E1);
  q = __fmaf_rn(q, x, (float)2.2176239823732856465394E2);
  q = __fmaf_rn(q, x, (float)3.0909872225312059774938E2);
  q = __fmaf_rn(q, x, (float)2.1642788614495947685003E2);
  q = __fmaf_rn(q, x, (float)6.0118660497603843919306E1);
  float s = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  float small = __fmaf_rn(-0.5f, x2, s);
  if (fabsf(x) < (float)0.41421356237309504880) return __fadd_rn(x, small);
  return xla_log(__fadd_rn(x, 1.0f));
}

// ---- XLA's f32 erf_inv (Giles) -----------------------------------------------
// Each coefficient is a select between two literals, so every lane reads
// immediates whichever branch of the polynomial it takes; the FMAs are the
// same sequence in the same order as with one table per branch.
__device__ __forceinline__ float xla_erfinv(float x) {
  float w = -xla_log1p(-__fmul_rn(x, x));
  bool lt = w < 5.0f;
  float ww = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? (float)2.81022636e-08 : (float)-0.000200214257;
  p = __fmaf_rn(p, ww, lt ? (float)3.43273939e-07 : (float)0.000100950558);
  p = __fmaf_rn(p, ww, lt ? (float)-3.5233877e-06 : (float)0.00134934322);
  p = __fmaf_rn(p, ww, lt ? (float)-4.39150654e-06 : (float)-0.00367342844);
  p = __fmaf_rn(p, ww, lt ? (float)0.00021858087 : (float)0.00573950773);
  p = __fmaf_rn(p, ww, lt ? (float)-0.00125372503 : (float)-0.0076224613);
  p = __fmaf_rn(p, ww, lt ? (float)-0.00417768164 : (float)0.00943887047);
  p = __fmaf_rn(p, ww, lt ? (float)0.246640727 : (float)1.00167406);
  p = __fmaf_rn(p, ww, lt ? (float)1.50140941 : (float)2.83297682);
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

// ---- bits -> samples (== jax.random's chains) --------------------------------
__device__ __forceinline__ float uniform01(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float open_interval(float u01) {
  constexpr float kOpenLo = -0.999999940395355224609375f;  // -1 + 2^-24
  float v = __fadd_rn(__fmul_rn(u01, 2.0f), kOpenLo);      // *2 is exact
  return v < kOpenLo ? kOpenLo : v;
}

__device__ __forceinline__ float normal(uint32_t b) {
  constexpr float kSqrt2 = (float)1.4142135623730951;
  return __fmul_rn(kSqrt2, xla_erfinv(open_interval(uniform01(b))));
}

__device__ __forceinline__ float laplace(uint32_t b) {
  float u = open_interval(uniform01(b));
  float sgn = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : u);
  return __fmul_rn(sgn, xla_log1p(-fabsf(u)));
}

__device__ __forceinline__ float rademacher(uint32_t b) {
  return (b & 1u) ? 1.0f : -1.0f;
}

}  // namespace prng
