// Dual-evaluation matmul: y0 = x @ w and y1 = x @ (w + mu * u) in one pass.
//
// Replaces the Pallas kernel `_kernel` / `dual_matmul_pallas` of the
// reference's src/repro/kernels/dual_matmul.py (pallas_call in
// `dual_matmul_pallas`). AsyREVEL evaluates the party tower twice per
// round, at w and at the perturbed w + mu*u; both first-layer products
// share x and w, so one kernel reads them once and keeps two accumulators.
//
// Shapes and types: x (M, K) with unit column stride and row stride ldx;
// w (K, N) and u (K, N) row-major; x and w both f32 or both bf16, u f32;
// y0, y1 (M, N) row-major in x's type. Operands are widened to f32, the
// perturbed tile w + mu*u is formed in f32, and both sums run in f32.
//
// Bound: operations. The kernel does 4*M*K*N f32 operations (a multiply and
// an add per term, two products) against (M*K + 2*K*N + 2*M*N) * 4 bytes;
// at the main path's shape (x 2048 x 98, w 98 x 128) that is 102.8 MFLOP
// and 3.0 MB, 1.5 us at 67 TFLOP/s on an H100 SXM's CUDA cores against
// 0.90 us at 3.35 TB/s. Design: one block of 256 threads per 64 x 64
// output tile; the K loop stages a 64 x 16 tile of x (transposed) and the
// 16 x 64 tiles of w and of w + mu*u in shared memory; each thread holds a
// 4 x 4 tile of both accumulators, and every x value read from shared
// memory feeds both. IEEE f32 on the CUDA cores: no TF32, no tensor cores
// (wgmma and TMA are later work). Ragged M, N and K are masked here: the
// main path's K is 98.
//
// Rounding: the perturbed weight is __fadd_rn(w, __fmul_rn(mu, u)), the
// two roundings zo_update (at scale -mu) and the plain perturbation make,
// so the kernel's perturbed tile is bitwise the party's perturbed block.
// Every term is an explicit __fmaf_rn in ascending k, the same order for
// both accumulators; built with --fmad=false as well.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dual_matmul_kernel(const T* __restrict__ x, long long ldx,
                   const T* __restrict__ w, const float* __restrict__ u,
                   float mu, T* __restrict__ y0, T* __restrict__ y1, int M,
                   int N, int K) {
  // x tile stored transposed (xs[k][m]) so a thread's TM rows are adjacent;
  // the +4 keeps rows 16-byte aligned and off one bank
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ __align__(16) float wps[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column group, 0..15
  const int ty = tid / (BN / TN);   // row group, 0..15
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc0[i][j] = 0.0f;
      acc1[i][j] = 0.0f;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x: BM x BK values, 16 consecutive threads on one row's k run
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < M && gc < K) ? widen(x[(long long)gr * ldx + gc])
                                    : 0.0f;
    }
    // w and the perturbed w + mu*u: BK x BN values, formed once per load
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      float wv = 0.0f, wpv = 0.0f;
      if (gr < K && gc < N) {
        const long long off = (long long)gr * N + gc;
        wv = widen(w[off]);
        wpv = __fadd_rn(wv, __fmul_rn(mu, u[off]));
      }
      ws[r][c] = wv;
      wps[r][c] = wpv;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&wps[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv0[TN] = {b0.x, b0.y, b0.z, b0.w};
      const float bv1[TN] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] = __fmaf_rn(av[i], bv0[j], acc0[i][j]);
          acc1[i][j] = __fmaf_rn(av[i], bv1[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= N) continue;
      const long long off = (long long)gr * N + gc;
      y0[off] = narrow<T>(acc0[i][j]);
      y1[off] = narrow<T>(acc1[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, long long ldx, const void* w, const void* u,
           float mu, void* y0, void* y1, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const long long gy = (M + BM - 1) / BM;
  if (gy > 65535 || K < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)gy);
  dual_matmul_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, ldx, (const T*)w, (const float*)u, mu, (T*)y0, (T*)y1, M,
      N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dual_matmul_f32(const void* x, long long ldx, const void* w,
                               const void* u, float mu, void* y0, void* y1,
                               int M, int N, int K, void* stream) {
  return launch<float>(x, ldx, w, u, mu, y0, y1, M, N, K, stream);
}

extern "C" int dual_matmul_bf16(const void* x, long long ldx, const void* w,
                                const void* u, float mu, void* y0, void* y1,
                                int M, int N, int K, void* stream) {
  return launch<__nv_bfloat16>(x, ldx, w, u, mu, y0, y1, M, N, K, stream);
}
