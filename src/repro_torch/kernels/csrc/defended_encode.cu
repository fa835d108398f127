// Defended up-link encode: clip -> DP noise -> codec, in one launch, with
// the noise and rounding bits drawn in registers from their keys.
//
// Replaces the Pallas kernel `_make_defend_kernel` / `_defend_call` /
// `_defended_encode_pallas` of the reference's
// src/repro/kernels/fused_round.py (reached through
// `defended_encode(impl="pallas")`), and from keys the one dispatch of its
// `_encode_up_jit` (key folds, both `jax.random.bits` draws and the chain).
// Per element: clip to [-clip, clip], add noise_scale * N(0,1) (or Laplace)
// made from the dp stream's word, then encode: f32 copy, bf16
// round-to-nearest-even, or int8 stochastic rounding (floor(x/s + u) with u
// from the rounding stream's word, round-half-even without a rounding key)
// against one per-tensor scale s = max(absmax, 1e-12) / 127.
//
// Bits: the TPU kernel's bits come from the on-chip PRNG; here each
// element's words are threefry2x32 of (key, element index), computed in
// registers (prng.cuh). The same kernels also take the bits as int32
// tensors (`MemBits`), the entry that mirrors the reference's signature.
//
// Bound: operations. Per element the kernel reads c (4 bytes) and writes 4,
// 2 or 1 byte, but makes up to two threefry words of 73 integer operations
// each, 41 of them (rotates and xors) on the INT32 pipe alone (64 lanes an
// SM; the compiler issues most adds as IMAD on the FMA pipe), and the noise
// chain (~64 f32 operations). At 2^24 elements and two streams the INT32
// pipe needs 0.082 ms at the top clock, the bytes 0.025 ms.
//
// Design. f32 and bf16: one grid-stride pass, 4 elements a thread, c read
// with one 16-byte load (4-byte loads where a view leaves it unaligned),
// the output written with one 16- or 8-byte store.
//
// int8 needs the absmax of every defended value before any can be
// quantized. The TPU walks its grid in order, so its kernel runs two
// sequential passes over the blocks; CUDA blocks run in parallel and in no
// order, and a second launch would recompute or re-read everything. So the
// int8 kernel is one cooperative launch (cudaLaunchCooperativeKernel) of
// as many blocks as the card holds at once, whose grid-wide barrier
// (grid.sync()) takes the place of the pass boundary:
//   1. each block computes the defended values of its contiguous part of
//      c once, keeps them in shared memory, and reduces |x| over them;
//   2. each block writes its max, as the bit pattern of |x|, to its own
//      slot (for x >= 0 the max of the bit patterns is the bit pattern of
//      the max, and a NaN wins, as jnp.max propagates it);
//   3. grid.sync();
//   4. every block reduces all the slots itself, forms
//      qscale = __fdiv_rn(max(a, 1e-12), 127) and quantizes what it kept.
// No memset, no second kernel and no atomics: the result is deterministic.
// Where n exceeds what the resident grid keeps (the shared memory of every
// SM: ~7.5M values at 4 blocks of 512 an SM), the rest is split over all
// threads: its |x| is reduced in step 1 and its defended values are
// recomputed after the barrier, which gives the same bits.
//
// Rounding: every operation is written with an __f*_rn intrinsic in the
// order the reference rounds it, and the file is built with --fmad=false,
// so nothing is contracted behind the code's back.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // f32 and bf16
constexpr int kCoopThreads = 512;  // int8
enum Noise { kNone = 0, kGaussian = 1, kLaplace = 2 };

// ---- where a stream's words come from ---------------------------------------
struct KeyBits {  // threefry2x32(key, i), in registers
  uint32_t k0, k1;
  __device__ __forceinline__ uint32_t at(long long i) const {
    return prng::bits_at(k0, k1, (unsigned long long)i);
  }
  __device__ __forceinline__ uint4 at4(long long i, int) const {
    return make_uint4(at(i), at(i + 1), at(i + 2), at(i + 3));
  }
};

struct MemBits {  // an int32 tensor in device memory
  const uint32_t* p;
  __device__ __forceinline__ uint32_t at(long long i) const { return p[i]; }
  __device__ __forceinline__ uint4 at4(long long i, int vec) const {
    if (vec) return *reinterpret_cast<const uint4*>(p + i);
    return make_uint4(p[i], p[i + 1], p[i + 2], p[i + 3]);
  }
};

struct Defense {
  int has_dp;
  float clip;
  float noise_scale;
};

// ---- the defended value ------------------------------------------------------
template <int NOISE>
__device__ __forceinline__ float defend(float c, uint32_t b,
                                        const Defense& d) {
  if (!d.has_dp) return c;
  float x = c < -d.clip ? -d.clip : c;  // jnp.clip; NaN passes through
  x = x > d.clip ? d.clip : x;
  if (NOISE == kNone) return x;         // clip-only (sigma = 0)
  float z = NOISE == kGaussian ? prng::normal(b) : prng::laplace(b);
  return __fadd_rn(x, __fmul_rn(d.noise_scale, z));
}

__device__ __forceinline__ float4 load4(const float* c, long long i,
                                        int vec) {
  if (vec) return *reinterpret_cast<const float4*>(c + i);
  return make_float4(c[i], c[i + 1], c[i + 2], c[i + 3]);
}

template <int NOISE, class S>
__device__ __forceinline__ float4 defend4(const float* c, const S& dp,
                                          long long i, int vec,
                                          const Defense& d) {
  float4 v = load4(c, i, vec);
  uint4 b = NOISE == kNone ? make_uint4(0u, 0u, 0u, 0u) : dp.at4(i, vec);
  return make_float4(defend<NOISE>(v.x, b.x, d), defend<NOISE>(v.y, b.y, d),
                     defend<NOISE>(v.z, b.z, d), defend<NOISE>(v.w, b.w, d));
}

template <int NOISE, class S>
__device__ __forceinline__ float defend1(const float* c, const S& dp,
                                         long long i, const Defense& d) {
  return defend<NOISE>(c[i], NOISE == kNone ? 0u : dp.at(i), d);
}

// ---- f32 / bf16 ----------------------------------------------------------------
struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

template <class S, int NOISE>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const float* __restrict__ c, S dp, Defense d, int out_bf16,
                void* __restrict__ out, long long n, int vec) {
  const long long groups = n >> 2;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = first; g < groups; g += stride) {
    float4 v = defend4<NOISE>(c, dp, 4 * g, vec, d);
    if (out_bf16) {
      reinterpret_cast<Bf16x4*>(out)[g] =
          Bf16x4{__floats2bfloat162_rn(v.x, v.y),
                 __floats2bfloat162_rn(v.z, v.w)};
    } else {
      reinterpret_cast<float4*>(out)[g] = v;
    }
  }
  const long long i = 4 * groups + first;
  if (i < n) {
    float v = defend1<NOISE>(c, dp, i, d);
    if (out_bf16) {
      reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    } else {
      reinterpret_cast<float*>(out)[i] = v;
    }
  }
}

// ---- int8 ----------------------------------------------------------------------
__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

__device__ __forceinline__ unsigned int max_abs4(unsigned int m, float4 v) {
  m = max(m, abs_bits(v.x));
  m = max(m, abs_bits(v.y));
  m = max(m, abs_bits(v.z));
  return max(m, abs_bits(v.w));
}

// the block's max of m, valid in thread 0
__device__ __forceinline__ unsigned int block_max(unsigned int m,
                                                  unsigned int* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // warp_max may still be read by an earlier call
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kCoopThreads / 32 ? warp_max[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  return m;
}

__device__ __forceinline__ int8_t quant(float v, uint32_t r, int has_rnd,
                                        float qscale) {
  float x = __fdiv_rn(v, qscale);
  // floor(x + u) with a rounding key; round half to even (jnp.round) without
  x = has_rnd ? floorf(__fadd_rn(x, prng::uniform01(r))) : rintf(x);
  x = x < -127.0f ? -127.0f : (x > 127.0f ? 127.0f : x);
  return (int8_t)x;
}

template <class S>
__device__ __forceinline__ char4 quant4(float4 v, const S& rnd, int has_rnd,
                                        long long i, int vec, float qscale) {
  uint4 r = has_rnd ? rnd.at4(i, vec) : make_uint4(0u, 0u, 0u, 0u);
  return make_char4(quant(v.x, r.x, has_rnd, qscale),
                    quant(v.y, r.y, has_rnd, qscale),
                    quant(v.z, r.z, has_rnd, qscale),
                    quant(v.w, r.w, has_rnd, qscale));
}

// Block b keeps elements [b * per_block, (b + 1) * per_block) of the first
// gridDim.x * per_block (per_block a multiple of 4); the rest, if any, is
// shared out over all threads in groups of 4 and computed twice.
template <class S, int NOISE>
__global__ void __launch_bounds__(kCoopThreads)
    int8_kernel(const float* __restrict__ c, S dp, S rnd, int has_rnd,
                Defense d, unsigned int* slots, int8_t* __restrict__ q,
                float* __restrict__ scale_out, long long n,
                long long per_block, int vec) {
  extern __shared__ float4 keep[];
  __shared__ unsigned int warp_max[kCoopThreads / 32];
  __shared__ float block_qscale;
  float* keep1 = reinterpret_cast<float*>(keep);
  const int tid = threadIdx.x;
  const long long blocks = gridDim.x;
  const long long resident = min(n, blocks * per_block);
  const long long base = (long long)blockIdx.x * per_block;
  const long long len = base < resident ? min(per_block, resident - base) : 0;
  const long long groups = len >> 2;
  const long long tail = 4 * groups + tid;  // this thread's ragged element
  const long long rest0 = resident + 4 * ((long long)blockIdx.x * kCoopThreads
                                          + tid);
  const long long rest_stride = 4 * blocks * kCoopThreads;

  // 1. defended values, kept where they fit; |x| max over all of them
  unsigned int m = 0u;
  for (long long g = tid; g < groups; g += kCoopThreads) {
    float4 v = defend4<NOISE>(c, dp, base + 4 * g, vec, d);
    keep[g] = v;
    m = max_abs4(m, v);
  }
  if (tail < len) {
    keep1[tail] = defend1<NOISE>(c, dp, base + tail, d);
    m = max(m, abs_bits(keep1[tail]));
  }
  for (long long i = rest0; i < n; i += rest_stride) {
    if (i + 4 <= n) {
      m = max_abs4(m, defend4<NOISE>(c, dp, i, vec, d));
    } else {
      for (long long j = i; j < n; ++j)
        m = max(m, abs_bits(defend1<NOISE>(c, dp, j, d)));
    }
  }
  m = block_max(m, warp_max);
  // 2. the block's max into its own slot
  if (tid == 0) slots[blockIdx.x] = m;
  // 3. every block's slot is written
  cg::this_grid().sync();
  // 4. the grid's max, from L2 (another SM wrote it)
  unsigned int a = 0u;
  for (long long s = tid; s < blocks; s += kCoopThreads)
    a = max(a, __ldcg(slots + s));
  a = block_max(a, warp_max);
  if (tid == 0) {
    float af = __uint_as_float(a);
    float am = (af != af || af > 1e-12f) ? af : 1e-12f;  // maximum(a, 1e-12)
    block_qscale = __fdiv_rn(am, 127.0f);
    if (blockIdx.x == 0) *scale_out = block_qscale;
  }
  __syncthreads();
  const float qscale = block_qscale;
  for (long long g = tid; g < groups; g += kCoopThreads) {
    reinterpret_cast<char4*>(q + base)[g] =
        quant4(keep[g], rnd, has_rnd, base + 4 * g, vec, qscale);
  }
  if (tail < len) {
    q[base + tail] = quant(keep1[tail], has_rnd ? rnd.at(base + tail) : 0u,
                           has_rnd, qscale);
  }
  for (long long i = rest0; i < n; i += rest_stride) {
    if (i + 4 <= n) {
      reinterpret_cast<char4*>(q)[i >> 2] =
          quant4(defend4<NOISE>(c, dp, i, vec, d), rnd, has_rnd, i, vec,
                 qscale);
    } else {
      for (long long j = i; j < n; ++j) {
        q[j] = quant(defend1<NOISE>(c, dp, j, d),
                     has_rnd ? rnd.at(j) : 0u, has_rnd, qscale);
      }
    }
  }
}

// ---- launches --------------------------------------------------------------------
int sm_count() {
  static int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return sms;
}

int vec_ok(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

template <class S, int NOISE>
int launch_cast(const float* c, S dp, Defense d, int out_bf16, void* out,
                long long n, int vec, cudaStream_t s) {
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  long long cap = 8LL * sm_count();  // 2048 threads an SM
  unsigned int grid =
      (unsigned int)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
  cast_kernel<S, NOISE><<<grid, kThreads, 0, s>>>(c, dp, d, out_bf16, out, n,
                                                  vec);
  return (int)cudaGetLastError();
}

template <class S>
int encode_cast(const float* c, S dp, Defense d, int noise, int out_bf16, void* out,
         long long n, int vec, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)out & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (noise) {
    case kNone: return launch_cast<S, kNone>(c, dp, d, out_bf16, out, n, vec, s);
    case kGaussian:
      return launch_cast<S, kGaussian>(c, dp, d, out_bf16, out, n, vec, s);
    case kLaplace:
      return launch_cast<S, kLaplace>(c, dp, d, out_bf16, out, n, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// What one int8 instance can hold at once: the blocks an SM keeps resident
// (limited by registers), and the shared memory each then gets.
struct Plan {
  int max_grid;        // co-resident blocks on the whole card
  long long capacity;  // floats a block keeps, a multiple of 4
};

template <class S, int NOISE>
const Plan& coop_plan() {
  static const Plan plan = [] {
    Plan p{0, 0};
    const void* kernel = (const void*)int8_kernel<S, NOISE>;
    int dev = 0, per_sm = 0, optin = 0, reserved = 0, by_regs = 0, blocks = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                           dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                           dev);
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel,
                                                      kCoopThreads, 0) ==
            cudaSuccess &&
        by_regs > 0) {
      long long room = per_sm / by_regs - reserved - (long long)attr.sharedSizeBytes;
      long long most = optin - (long long)attr.sharedSizeBytes;
      long long dyn = (room < most ? room : most) / 16 * 16;
      if (dyn >= 16 &&
          cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn) == cudaSuccess &&
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, kernel, kCoopThreads, (size_t)dyn) == cudaSuccess &&
          blocks > 0) {
        p.max_grid = blocks * sm_count();
        p.capacity = dyn / 4;
      }
    }
    cudaGetLastError();  // the plan's own failures show as max_grid = 0
    return p;
  }();
  return plan;
}

template <class S, int NOISE>
int launch_int8(const float* c, S dp, S rnd, int has_rnd, Defense d,
                unsigned int* slots, int max_slots, int8_t* q,
                float* scale_out, long long n, int vec, cudaStream_t s) {
  const Plan& p = coop_plan<S, NOISE>();
  if (p.max_grid < 1) return (int)cudaErrorLaunchOutOfResources;
  long long blocks = p.max_grid < max_slots ? p.max_grid : max_slots;
  // equal parts over the resident grid, at least 4 elements a thread (one
  // block takes a D7 payload) and at most what a block keeps
  long long per = (n + blocks - 1) / blocks;
  per = (per + 3) / 4 * 4;
  if (per < 4 * kCoopThreads) per = 4 * kCoopThreads;
  if (per > p.capacity) per = p.capacity;
  long long need = (n + per - 1) / per;
  if (need < blocks) blocks = need;
  void* args[] = {&c, &dp, &rnd, &has_rnd, &d, &slots, &q, &scale_out,
                  &n, &per, &vec};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)int8_kernel<S, NOISE>, dim3((unsigned int)blocks),
      dim3(kCoopThreads), args, (size_t)(per * 4), s);
}

template <class S>
int encode_int8(const float* c, S dp, S rnd, int has_rnd, Defense d, int noise,
         void* slots, int max_slots, void* q, void* scale_out, long long n,
         int vec, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)q & 3u) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* sl = (unsigned int*)slots;
  int8_t* qq = (int8_t*)q;
  float* so = (float*)scale_out;
  switch (noise) {
    case kNone:
      return launch_int8<S, kNone>(c, dp, rnd, has_rnd, d, sl, max_slots, qq,
                                   so, n, vec, s);
    case kGaussian:
      return launch_int8<S, kGaussian>(c, dp, rnd, has_rnd, d, sl, max_slots,
                                       qq, so, n, vec, s);
    case kLaplace:
      return launch_int8<S, kLaplace>(c, dp, rnd, has_rnd, d, sl, max_slots,
                                      qq, so, n, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// noise: 0 none (dp off, or clip only: has_dp = 1), 1 gaussian, 2 laplace.
// The *_keyed entries draw each stream from its key (k0, k1); the others
// read it from an int32 tensor (dp_bits / rnd_bits, null when absent).
extern "C" int defended_encode_cast(const void* c, const void* dp_bits,
                                    int has_dp, int noise, float clip,
                                    float noise_scale, int out_bf16,
                                    void* out, long long n, void* stream) {
  return encode_cast(static_cast<const float*>(c),
              MemBits{static_cast<const uint32_t*>(dp_bits)},
              Defense{has_dp, clip, noise_scale}, noise, out_bf16, out, n,
              vec_ok(c, dp_bits, nullptr), stream);
}

extern "C" int defended_encode_cast_keyed(const void* c, unsigned int dp_k0,
                                          unsigned int dp_k1, int has_dp,
                                          int noise, float clip,
                                          float noise_scale, int out_bf16,
                                          void* out, long long n,
                                          void* stream) {
  return encode_cast(static_cast<const float*>(c), KeyBits{dp_k0, dp_k1},
              Defense{has_dp, clip, noise_scale}, noise, out_bf16, out, n,
              vec_ok(c, nullptr, nullptr), stream);
}

// The int8 entries are cooperative launches; ``slots`` holds max_slots
// uint32 (defended_encode_int8_slots() is enough) and needs no clearing.
extern "C" int defended_encode_int8(const void* c, const void* dp_bits,
                                    const void* rnd_bits, int has_dp,
                                    int noise, float clip, float noise_scale,
                                    void* slots, int max_slots, void* q,
                                    void* scale_out, long long n,
                                    void* stream) {
  return encode_int8(static_cast<const float*>(c),
              MemBits{static_cast<const uint32_t*>(dp_bits)},
              MemBits{static_cast<const uint32_t*>(rnd_bits)},
              rnd_bits != nullptr, Defense{has_dp, clip, noise_scale}, noise,
              slots, max_slots, q, scale_out, n,
              vec_ok(c, dp_bits, rnd_bits), stream);
}

extern "C" int defended_encode_int8_keyed(
    const void* c, unsigned int dp_k0, unsigned int dp_k1, unsigned int rnd_k0,
    unsigned int rnd_k1, int has_rnd, int has_dp, int noise, float clip,
    float noise_scale, void* slots, int max_slots, void* q, void* scale_out,
    long long n, void* stream) {
  return encode_int8(static_cast<const float*>(c), KeyBits{dp_k0, dp_k1},
              KeyBits{rnd_k0, rnd_k1}, has_rnd,
              Defense{has_dp, clip, noise_scale}, noise, slots, max_slots, q,
              scale_out, n, vec_ok(c, nullptr, nullptr), stream);
}

// The most blocks any int8 launch runs: the slots it needs.
extern "C" int defended_encode_int8_slots() {
  const int grids[] = {coop_plan<KeyBits, kNone>().max_grid,
                       coop_plan<KeyBits, kGaussian>().max_grid,
                       coop_plan<KeyBits, kLaplace>().max_grid,
                       coop_plan<MemBits, kNone>().max_grid,
                       coop_plan<MemBits, kGaussian>().max_grid,
                       coop_plan<MemBits, kLaplace>().max_grid};
  int most = 0;
  for (int g : grids) most = g > most ? g : most;
  return most;
}
