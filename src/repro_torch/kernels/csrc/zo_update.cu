// Seed-replay ZO update: out = w - scale * u, u = +1 where (bits & 1) else -1.
//
// Replaces the Pallas kernel `_kernel` / `zo_update_pallas` of the
// reference's src/repro/kernels/zo_update.py (pallas_call in
// `_zo_update_jit`). scale = -mu perturbs a block, scale = lr * coeff
// applies an update; u never exists in device memory.
//
// Bound: bytes. Each element reads 4 bytes of w and 4 of bits and writes
// 4, against one multiply and one subtract: 12 N bytes at 3.35 TB/s on an
// H100 is the floor. Design: a grid-stride loop of coalesced 4-byte loads
// with a masked tail (any N, no padding copy), the scalar passed by
// value. Vectorised 16-byte loads are left for a later pass.
//
// Rounding: the product rounds on its own (__fmul_rn) and the subtract
// rounds once (__fsub_rn), exactly the reference's two IEEE operations;
// built with --fmad=false as well.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void zo_update_kernel(const float* __restrict__ w,
                                 const uint32_t* __restrict__ bits,
                                 float scale, float* __restrict__ out,
                                 long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float u = (bits[i] & 1u) ? 1.0f : -1.0f;
    out[i] = __fsub_rn(w[i], __fmul_rn(scale, u));
  }
}

}  // namespace

extern "C" int zo_update_f32(const void* w, const void* bits, float scale,
                             void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  zo_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const uint32_t*)bits, scale, (float*)out, n);
  return (int)cudaGetLastError();
}
