// Draws from (key, counter): jax's threefry2x32 bits, normal or rademacher
// values, in one pass.
//
// Replaces what XLA compiles for the reference's `jax.random.bits` and
// `jax.random.normal` (src/repro/utils/prng.py:23, `sample_direction`):
// the raw uint32 stream of a key, the gaussian chain on it, or the
// rademacher sign of its low bit. Element i takes the stream's word at
// counter offset + i (prng.cuh); the output is written once, and nothing
// else touches device memory.
//
// Bound: operations. Each 32-bit word costs 73 integer operations of
// threefry (prng.cuh), 41 of them (rotates and xors) on the INT32 pipe
// alone (64 lanes an SM; the compiler issues most adds as IMAD on the FMA
// pipe), against 4 bytes written: at 3.35 TB/s a word's store takes what
// 20 INT32 operations take on the whole card. The normal chain adds some
// 64 f32 operations per element.
//
// Design: a grid-stride loop over groups of 4 elements; each thread draws
// 4 independent threefry chains (instruction-level parallelism for the
// integer pipe) and writes them with one 16-byte store. The n % 4 tail is
// written by the first threads of the grid, one element each.
#include <cstdint>
#include <cuda_runtime.h>

#include "prng.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode { kBits = 0, kNormal = 1, kRademacher = 2 };

template <int MODE>
__device__ __forceinline__ uint32_t value(uint32_t b) {
  if (MODE == kNormal) return __float_as_uint(prng::normal(b));
  if (MODE == kRademacher) return __float_as_uint(prng::rademacher(b));
  return b;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    draw_kernel(uint32_t k0, uint32_t k1, unsigned long long offset,
                uint32_t* __restrict__ out, long long n) {
  const long long groups = n >> 2;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = first; g < groups; g += stride) {
    const unsigned long long i = offset + 4ull * (unsigned long long)g;
    uint4 v;
    v.x = value<MODE>(prng::bits_at(k0, k1, i));
    v.y = value<MODE>(prng::bits_at(k0, k1, i + 1));
    v.z = value<MODE>(prng::bits_at(k0, k1, i + 2));
    v.w = value<MODE>(prng::bits_at(k0, k1, i + 3));
    reinterpret_cast<uint4*>(out)[g] = v;
  }
  const long long i = 4 * groups + first;
  if (i < n) out[i] = value<MODE>(prng::bits_at(k0, k1, offset + i));
}

int sm_count() {
  static int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return sms;
}

}  // namespace

// out: n 4-byte words, 16-byte aligned; mode 0 bits (int32), 1 normal
// (f32), 2 rademacher (f32)
extern "C" int prng_draw(unsigned int k0, unsigned int k1,
                         unsigned long long offset, int mode, void* out,
                         long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  long long cap = 8LL * sm_count();  // 2048 threads an SM
  unsigned int grid = (unsigned int)(blocks < 1 ? 1 : (blocks > cap ? cap
                                                                  : blocks));
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  switch (mode) {
    case kBits:
      draw_kernel<kBits><<<grid, kThreads, 0, s>>>(k0, k1, offset, o, n);
      break;
    case kNormal:
      draw_kernel<kNormal><<<grid, kThreads, 0, s>>>(k0, k1, offset, o, n);
      break;
    case kRademacher:
      draw_kernel<kRademacher><<<grid, kThreads, 0, s>>>(k0, k1, offset, o,
                                                         n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
