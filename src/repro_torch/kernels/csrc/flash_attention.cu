// Blocked online-softmax (flash) attention, causal or full, with GQA.
//
// Replaces the Pallas kernel `_kernel` / `flash_attention_pallas` of the
// reference's src/repro/kernels/flash_attention.py (pallas_call in
// `flash_attention_pallas`), and with it the GQA expansion of
// src/repro/kernels/ops.py: query head h reads kv head h / (H / KV)
// directly, so no repeated or transposed copy of k and v is made.
//
// Shapes and types: q (B, S, H, hd), k and v (B, S, KV, hd), all
// contiguous and of one type (f32 or bf16), the layout the model's QKV
// projection and RoPE produce; out (B, S, H, hd) contiguous in the input
// type. hd is 64 or 128; any S.
// The math is the Pallas kernel's: operands widened to f32, s = q.k * scale
// with scale = 1/sqrt(hd) bound to f32, the causal mask by position
// (kv > q gets -1e30), f32 running max m, denominator l and accumulator
// acc, p kept in f32 for the PV product, and out = acc / max(l, 1e-30)
// rounded once to the input type.
//
// Bound: operations. Causal attention at the main path's shape (B 4,
// S 2048, H 16, hd 64) needs about 2*B*H*S^2*hd = 34.4 GFLOP (the two
// products over the lower triangle, 17.2 each) against 4 x 16.8 MB of bf16
// q, k, v and out. On an H100 SXM, q.k on bf16 operands with an f32 sum can
// run on the tensor cores (989 TFLOP/s) but p.v takes p in f32 (67 TFLOP/s
// on the CUDA cores): 0.017 + 0.257 = 0.27 ms, against 0.020 ms at
// 3.35 TB/s; in f32 both products count at 67 TFLOP/s, 0.51 ms. Design: one block of 256 threads per (64-row q tile, b*H+h),
// heaviest causal tiles launched first; the q tile is staged once, then a
// loop over 64-row kv tiles (only those at or left of the diagonal when
// causal, the ragged edge masked) stages k transposed and v in shared
// memory as f32. Each thread holds a 4 x 4 tile of scores and a 4-row x
// hd/16-column tile of acc; the row max and row sum reduce over the 16
// lanes that share a row with shuffles. f32 on the CUDA cores: no tensor
// cores, no TMA (the rewrite that makes it fast is later work).
//
// Rounding: every product-sum is an explicit __fmaf_rn, every other
// operation an __f*_rn intrinsic or expf (built with --fmad=false too).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // q rows per block
constexpr int BKV = 64;           // kv rows per tile
constexpr int THREADS = 256;
constexpr int PAD = 4;            // keeps float4 rows aligned
constexpr float NEG_INF = -1e30f;

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

template <int HD>
constexpr int smem_floats() {
  // qt[HD][BQ+PAD], kt[HD][BKV+PAD], vs[BKV][HD], pt[BKV][BQ+PAD]
  return HD * (BQ + PAD) + HD * (BKV + PAD) + BKV * HD + BKV * (BQ + PAD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int H, int group, float scale, int causal) {
  constexpr int CG = HD / 64;     // groups of 4 acc columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                              // [HD][BQ + PAD]
  float* kt = qt + HD * (BQ + PAD);              // [HD][BKV + PAD]
  float* vs = kt + HD * (BKV + PAD);             // [BKV][HD]
  float* pt = vs + BKV * HD;                     // [BKV][BQ + PAD]

  const int tid = threadIdx.x;
  const int tx = tid % 16;        // score columns tx*4.., acc column groups
  const int ty = tid / 16;        // rows ty*4 .. ty*4+3
  const int n_q = (S + BQ - 1) / BQ;
  const int qtile = n_q - 1 - (int)blockIdx.x;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = qtile * BQ;

  // element strides of the contiguous (B, S, heads, HD) layouts
  const long long q_s = (long long)H * HD, kv_s = (long long)(H / group) * HD;
  const T* qb = q + (long long)b * S * q_s + h * HD;
  const T* kb = k + (long long)b * S * kv_s + kvh * HD;
  const T* vb = v + (long long)b * S * kv_s + kvh * HD;

  // q tile, transposed: qt[d][r]
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int gr = q0 + r;
    qt[d * (BQ + PAD) + r] = gr < S ? widen(qb[gr * q_s + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][CG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CG * 4; ++c) acc[i][c] = 0.0f;
  }

  int n_kv = (S + BKV - 1) / BKV;
  if (causal) {
    const int last = min(q0 + BQ - 1, S - 1);    // the tile's last row
    n_kv = min(n_kv, last / BKV + 1);
  }

  for (int kt_i = 0; kt_i < n_kv; ++kt_i) {
    const int k0 = kt_i * BKV;
    __syncthreads();              // the previous tile's kt, vs, pt are done
    for (int i = tid; i < BKV * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const int gr = k0 + r;
      float kv_k = 0.0f, kv_v = 0.0f;
      if (gr < S) {
        kv_k = widen(kb[gr * kv_s + d]);
        kv_v = widen(vb[gr * kv_s + d]);
      }
      kt[d * (BKV + PAD) + r] = kv_k;
      vs[r * HD + d] = kv_v;
    }
    __syncthreads();

    // scores s = q . k over hd, in ascending d
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(&qt[d * (BQ + PAD) + ty * 4]);
      const float4 bb =
          *reinterpret_cast<const float4*>(&kt[d * (BKV + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
    }

    // scale, mask, and the online-softmax update of each row
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x = __fmul_rn(s[i][j], scale);
        if (kj >= S || (causal && kj > qi)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        s[i][j] = p;
        sum = __fadd_rn(sum, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      corr[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
      m[i] = m_new;
    }
    // p, transposed: pt[kv][r]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 col = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * (BQ + PAD) + ty * 4]) =
          col;
    }
    __syncthreads();

    // acc = acc * corr + p @ v, in ascending kv
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr[i]);
    float pv[4][CG * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CG * 4; ++c) pv[i][c] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < BKV; ++r) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(&pt[r * (BQ + PAD) + ty * 4]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&vs[r * HD + g * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pv[i][g * 4 + c] = __fmaf_rn(pr[i], vv[c], pv[i][g * 4 + c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CG * 4; ++c)
        acc[i][c] = __fadd_rn(acc[i][c], pv[i][c]);
  }

  // out = acc / max(l, 1e-30), contiguous (B, S, H, hd)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[g * 64 + tx * 4 + c] = narrow<T>(__fdiv_rn(acc[i][g * 4 + c], den));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int B, int S, int H, int KV, float scale, int causal,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const long long grid_y = (long long)B * H;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_floats<HD>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)grid_y);
  kern<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, H / KV, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int B, int S, int H, int KV, int hd, float scale, int causal,
             void* stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, B, S, H, KV, scale, causal, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, B, S, H, KV, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   int B, int S, int H, int KV, int hd,
                                   float scale, int causal, void* stream) {
  return dispatch<float>(q, k, v, out, B, S, H, KV, hd, scale, causal,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    int B, int S, int H, int KV, int hd,
                                    float scale, int causal, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale,
                                 causal, stream);
}
