// Defended up-link encode: clip -> DP noise -> codec, from raw PRNG bits.
//
// Replaces the Pallas kernel `_make_defend_kernel` / `_defend_call` /
// `_defended_encode_pallas` of the reference's
// src/repro/kernels/fused_round.py (reached through
// `defended_encode(impl="pallas")`). Per element: clip to [-clip, clip],
// add noise_scale * N(0,1) (or Laplace) made from a uint32 bit, then
// encode: f32 copy, bf16 round-to-nearest-even, or int8 stochastic
// rounding against one per-tensor scale max(absmax, 1e-12) / 127.
//
// Bound: bytes. f32 reads 12 n bytes (c and two bit streams at most) and
// writes 4 n; int8 reads c and the dp bits twice (pass 1 and pass 2) and
// the rounding bits once, and writes n bytes, against some 60 flops of
// erf_inv or log1p per element, far below the card's f32 rate. The
// roofline counts each input once: 4n (c) + 4n (dp bits) + 4n (rnd bits)
// + n (q) = 13 n bytes, 21 n with the second pass's re-read counted.
//
// Design: the TPU kernel walks a sequential grid and carries nothing
// between steps; here blocks run in any order, so the int8 path is two
// launches on one stream with no host sync between them. Pass 1
// recomputes the defended value, reduces |x| in the block (warp shuffles,
// then shared memory) and atomicMax-es its bit pattern into one device
// word: for non-negative floats the max of the bit patterns is the bit
// pattern of the max, so the result is deterministic. Pass 2 reads that
// word, forms qscale with a true division, recomputes the defended value
// in registers and quantizes; one thread writes the scale. No
// intermediate (clipped, noised or scaled) array touches device memory.
//
// Rounding: every operation is written with an __f*_rn intrinsic in the
// order the reference rounds it, and the file is built with --fmad=false,
// so nothing is contracted behind the code's back. erf_inv, log1p and log
// are XLA's own f32 formulas (Giles' erf_inv polynomial; Cephes log1p and
// logf, with FMAs exactly where the XLA CPU backend emits them), shared
// with the plain torch version in repro_torch/utils/xla_math.py.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kOpenLo = -0.999999940395355224609375f;  // -1 + 2^-24
constexpr float kSqrt2 = (float)1.4142135623730951;

// ---- XLA's f32 log (Cephes logf) ------------------------------------------
constexpr float kLogP0 = (float)7.0376836292E-2;
constexpr float kLogP1 = (float)-1.1514610310E-1;
constexpr float kLogP2 = (float)1.1676998740E-1;
constexpr float kLogP3 = (float)-1.2420140846E-1;
constexpr float kLogP4 = (float)1.4249322787E-1;
constexpr float kLogP5 = (float)-1.6668057665E-1;
constexpr float kLogP6 = (float)2.0000714765E-1;
constexpr float kLogP7 = (float)-2.4999993993E-1;
constexpr float kLogP8 = (float)3.3333331174E-1;
constexpr float kLogQ1 = (float)-2.12194440e-4;
constexpr float kLogQ2 = (float)0.693359375;
constexpr float kSqrtHalf = (float)0.707106781186547524;

__device__ __forceinline__ float xla_log(float x) {
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
  float y = __fmaf_rn(__fmaf_rn(kLogP0, t, kLogP1), t, kLogP2);
  float y1 = __fmaf_rn(__fmaf_rn(kLogP3, t, kLogP4), t, kLogP5);
  float y2 = __fmaf_rn(__fmaf_rn(kLogP6, t, kLogP7), t, kLogP8);
  y = __fmaf_rn(x3, y, y1);
  y = __fmaf_rn(x3, y, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(kLogQ1, e));
  float r = __fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, x2)), y);
  r = __fmaf_rn(kLogQ2, e, r);
  if (x < 0.0f || x != x) r = __int_as_float(-1);  // XLA's all-ones NaN
  if (x == INFINITY) r = INFINITY;
  if (fabsf(x) < FLT_MIN) r = -INFINITY;  // XLA CPU: subnormals are zero
  return r;
}

// ---- XLA's f32 log1p ------------------------------------------------------
__constant__ float kLog1pP[7] = {
    (float)4.5270000862445199635215E-5, (float)4.9854102823193375972212E-1,
    (float)6.5787325942061044846969E0,  (float)2.9911919328553073277375E1,
    (float)6.0949667980987787057556E1,  (float)5.7112963590585538103336E1,
    (float)2.0039553499201281259648E1};
__constant__ float kLog1pQ[7] = {
    1.0f,                               (float)1.5062909083469192043167E1,
    (float)8.3047565967967209469434E1,  (float)2.2176239823732856465394E2,
    (float)3.0909872225312059774938E2,  (float)2.1642788614495947685003E2,
    (float)6.0118660497603843919306E1};
constexpr float kLog1pSmall = (float)0.41421356237309504880;

__device__ __forceinline__ float xla_log1p(float x) {
  float x2 = __fmul_rn(x, x);
  float p = kLog1pP[0];
  float q = kLog1pQ[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    p = __fmaf_rn(p, x, kLog1pP[i]);
    q = __fmaf_rn(q, x, kLog1pQ[i]);
  }
  float s = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q));
  float small = __fmaf_rn(-0.5f, x2, s);
  if (fabsf(x) < kLog1pSmall) return __fadd_rn(x, small);
  return xla_log(__fadd_rn(x, 1.0f));
}

// ---- XLA's f32 erf_inv (Giles) ---------------------------------------------
__constant__ float kErfInvLt[9] = {
    (float)2.81022636e-08,  (float)3.43273939e-07, (float)-3.5233877e-06,
    (float)-4.39150654e-06, (float)0.00021858087,  (float)-0.00125372503,
    (float)-0.00417768164,  (float)0.246640727,    (float)1.50140941};
__constant__ float kErfInvGe[9] = {
    (float)-0.000200214257, (float)0.000100950558, (float)0.00134934322,
    (float)-0.00367342844,  (float)0.00573950773,  (float)-0.0076224613,
    (float)0.00943887047,   (float)1.00167406,     (float)2.83297682};

__device__ __forceinline__ float xla_erfinv(float x) {
  float w = -xla_log1p(-__fmul_rn(x, x));
  bool lt = w < 5.0f;
  float ww = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  const float* c = lt ? kErfInvLt : kErfInvGe;
  float p = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, ww, c[i]);
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

// ---- bits -> samples (== jax.random's chains) ------------------------------
__device__ __forceinline__ float uniform01(uint32_t b) {
  return __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float open_interval(float u01) {
  float v = __fadd_rn(__fmul_rn(u01, 2.0f), kOpenLo);  // *2 is exact
  return v < kOpenLo ? kOpenLo : v;
}

struct Defense {
  int has_dp;
  float clip;
  float noise_scale;
  int mechanism;  // 0 gaussian, 1 laplace
};

__device__ __forceinline__ float defend(float c, const uint32_t* dp_bits,
                                        long long i, const Defense& d) {
  if (!d.has_dp) return c;
  float x = c < -d.clip ? -d.clip : c;  // jnp.clip; NaN passes through
  x = x > d.clip ? d.clip : x;
  if (dp_bits == nullptr) return x;     // clip-only (sigma = 0)
  float u = open_interval(uniform01(dp_bits[i]));
  float z;
  if (d.mechanism == 0) {
    z = __fmul_rn(kSqrt2, xla_erfinv(u));
  } else {
    float sgn = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : u);
    z = __fmul_rn(sgn, xla_log1p(-fabsf(u)));
  }
  return __fadd_rn(x, __fmul_rn(d.noise_scale, z));
}

__global__ void cast_kernel(const float* __restrict__ c,
                            const uint32_t* __restrict__ dp_bits, Defense d,
                            int out_bf16, void* __restrict__ out,
                            long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = defend(c[i], dp_bits, i, d);
    if (out_bf16) {
      ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(v);
    } else {
      ((float*)out)[i] = v;
    }
  }
}

__global__ void absmax_kernel(const float* __restrict__ c,
                              const uint32_t* __restrict__ dp_bits,
                              Defense d, unsigned int* amax_word,
                              long long n) {
  // max over bit patterns of |x|: order-preserving for x >= 0, and a NaN
  // (exponent all ones, nonzero mantissa) wins, as jnp.max propagates it
  unsigned int m = 0u;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned int b = __float_as_uint(fabsf(defend(c[i], dp_bits, i, d)));
    m = b > m ? b : m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned int o = __shfl_down_sync(0xffffffffu, m, off);
    m = o > m ? o : m;
  }
  __shared__ unsigned int warp_max[kThreads / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      unsigned int o = __shfl_down_sync(0xffffffffu, m, off);
      m = o > m ? o : m;
    }
    if (lane == 0) atomicMax(amax_word, m);
  }
}

__global__ void quant_kernel(const float* __restrict__ c,
                             const uint32_t* __restrict__ dp_bits,
                             const uint32_t* __restrict__ rnd_bits, Defense d,
                             const unsigned int* __restrict__ amax_word,
                             int8_t* __restrict__ q,
                             float* __restrict__ scale_out, long long n) {
  float a = __uint_as_float(*amax_word);
  float am = (a != a || a > 1e-12f) ? a : 1e-12f;  // jnp.maximum(a, 1e-12)
  float qscale = __fdiv_rn(am, 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = qscale;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float x = __fdiv_rn(defend(c[i], dp_bits, i, d), qscale);
    if (rnd_bits != nullptr) {
      x = floorf(__fadd_rn(x, uniform01(rnd_bits[i])));
    } else {
      x = rintf(x);  // round half to even, as jnp.round
    }
    x = x < -127.0f ? -127.0f : (x > 127.0f ? 127.0f : x);
    q[i] = (int8_t)x;
  }
}

unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned int)(blocks > 132 * 8 ? 132 * 8 : blocks);
}

}  // namespace

extern "C" int defended_encode_cast(const void* c, const void* dp_bits,
                                    int has_dp, float clip, float noise_scale,
                                    int mechanism, int out_bf16, void* out,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  Defense d{has_dp, clip, noise_scale, mechanism};
  cast_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)c, (const uint32_t*)dp_bits, d, out_bf16, out, n);
  return (int)cudaGetLastError();
}

extern "C" int defended_encode_int8(const void* c, const void* dp_bits,
                                    const void* rnd_bits, int has_dp,
                                    float clip, float noise_scale,
                                    int mechanism, void* amax_word, void* q,
                                    void* scale_out, long long n,
                                    void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  Defense d{has_dp, clip, noise_scale, mechanism};
  cudaError_t err = cudaMemsetAsync(amax_word, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const float*)c, (const uint32_t*)dp_bits, d, (unsigned int*)amax_word,
      n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quant_kernel<<<grid_for(n), kThreads, 0, s>>>(
      (const float*)c, (const uint32_t*)dp_bits, (const uint32_t*)rnd_bits, d,
      (const unsigned int*)amax_word, (int8_t*)q, (float*)scale_out, n);
  return (int)cudaGetLastError();
}
