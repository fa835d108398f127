// The gradient of flash_attention (csrc/flash_attention.cu): dq, dk and dv.
//
// Replaces no Pallas kernel. The reference trains through its pure-jnp
// `blocked_attention` (src/repro/models/attention.py:67) and XLA
// differentiates it; the port's forward is a hand-written kernel, so its
// gradient is one too, as prng_draw stands for XLA's jax.random.
//
// Shapes and types: q, o and dO (B, S, H, hd), k and v (B, S, KV, hd), all
// contiguous and of one type (f32 or bf16); lse (B, H, S) f32, each row's
// logsumexp of its scaled scores, written by the forward; q and kv positions
// (B, S) int32, both or neither. dq, dk and dv come out in the input type.
// hd is 64 or 128; any S; H a multiple of KV (GQA).
//
// The math, in f32 on the CUDA cores, per (b, query head h, row i, key j):
//   s = q_i . k_j * scale, at -1e30 where masked (causal: by index, j > i,
//       or by positions, kv_pos_j > q_pos_i; never without causal);
//   p = exp(s - lse_i);   D_i = dO_i . o_i;
//   dv_j += p dO_i;   ds = p (dO_i . v_j - D_i);
//   dq_i += ds k_j * scale;   dk_j += ds q_i * scale;
// and each kv head's dk and dv sum over its H / KV query heads. A row that
// saw no key (lse below -1e20: every score at the sentinel) attends to all S
// keys alike in the forward, so it has p = 1/S and, its scores being the
// constant sentinel, no ds; keys past S have neither.
//
// Design (simple, right and deterministic; speed on wgmma/TMA is later work):
// two passes and no atomics, so two calls give the same bits.
//  - dkdv: one block of 256 threads per (b, kv head, 64-row kv tile). It
//    keeps its k and v tile in shared memory and loops over the query heads
//    of its kv head and over the q tiles that can see the tile (from the
//    diagonal on, under the causal index mask; all of them with positions),
//    loading q and dO and computing D_i itself, and sums dk and dv in
//    registers in that fixed order.
//  - dq: one block per (b, h, 64-row q tile), looping over the kv tiles the
//    tile can see, summing dq in registers.
// Each tile product runs as 8 x 2 outputs a thread (rows ty + 8a, columns
// tx + 32b): row operands are read by all of a warp at one address
// (broadcast), column operands at consecutive addresses; rows of q, dO, k
// and v lie in shared memory with a stride of hd + 1 floats, so a column
// read is free of bank conflicts.
//
// Bound: operations. The backward needs 5 products of 2 B H hd pairs each
// (q.k for p, dO.v for dp, p^T dO, ds k, ds^T q), the pairs those the mask
// keeps; this kernel runs 7 (both passes recompute s and dp). At the vfl-zoo
// shape (B 4, S 2048, H 16, hd 64, causal) that is 5 x 17.2 = 86 GFLOP, 1.28
// ms at the 67 TFLOP/s of the f32 CUDA cores or 0.087 ms at the 989 of the
// bf16 tensor cores, against 6 x 16.8 MB of bf16 operands read or written
// (0.030 ms at 3.35 TB/s). Each multiply-add here takes about one
// shared-memory read, so shared memory, not the FMA units, sets its pace.
//
// Rounding: every f32 operation is an __f*_rn intrinsic or expf / __fdiv_rn
// (built with --fmad=false too).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float MASKED_LSE = -1e20f;
constexpr int BQ = 64, BK = 64;         // q rows, kv rows a tile
constexpr int THREADS = 256;            // 8 warps: ty = warp, tx = lane

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + ROWS) of a (B, S, heads, HD) operand at (b, head), as
// f32 into shared memory with a row stride of HD + 1; zeros past S
template <int HD, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int head, int heads,
                                          int row0, int S) {
  for (int e = threadIdx.x; e < ROWS * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, row = row0 + r;
    dst[r * (HD + 1) + d] =
        row < S ? load(src + (((long long)b * S + row) * heads + head) * HD + d)
                : 0.0f;
  }
}

// D_i = dO_i . o_i for the q tile's rows (in shared memory as dos; o read
// from device memory), one warp a row: lane-strided sums, then a fixed
// butterfly over the warp
template <int HD, typename T>
__device__ __forceinline__ void row_dots(float* D, const float* dos,
                                         const T* __restrict__ o, int b,
                                         int h, int H, int q0, int S) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < S) {
      const T* orow = o + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        acc = __fmaf_rn(dos[r * (HD + 1) + lane + 32 * c],
                        load(orow + lane + 32 * c), acc);
    }
#pragma unroll
    for (int w = 16; w >= 1; w /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, w));
    if (lane == 0) D[r] = acc;
  }
}

// The q-tile x kv-tile part both passes share: s = q.k and dp = dO.v for
// rows ty + 8a and columns tx + 32b, then p and ds; writes ds (and p when
// ps is given) into shared memory, BK floats a row.
template <int HD, bool POS>
__device__ __forceinline__ void p_and_ds(float* ps, float* dss,
                                         const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s, const float* D,
                                         const int* qpos, const int* kvpos,
                                         int q0, int k0, int S, int causal,
                                         float scale, float inv_s) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float s[8][2], dp[8][2];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float kb[2] = {ks[tx * (HD + 1) + d], ks[(tx + 32) * (HD + 1) + d]};
    const float vb[2] = {vs[tx * (HD + 1) + d], vs[(tx + 32) * (HD + 1) + d]};
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float qa = qs[(ty + 8 * a) * (HD + 1) + d];
      const float da = dos[(ty + 8 * a) * (HD + 1) + d];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        s[a][b] = __fmaf_rn(qa, kb[b], s[a][b]);
        dp[a][b] = __fmaf_rn(da, vb[b], dp[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = ty + 8 * a, i = q0 + r;
    const float lse = lse_s[r];
    const bool full = lse < MASKED_LSE;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = tx + 32 * b, j = k0 + c;
      bool seen = i < S && j < S;
      if (causal) seen = seen && (POS ? kvpos[c] <= qpos[r] : j <= i);
      float p = 0.0f, ds = 0.0f;
      if (i < S && j < S && full) {
        p = inv_s;
      } else if (seen) {
        p = expf(__fsub_rn(__fmul_rn(s[a][b], scale), lse));
        ds = __fmul_rn(p, __fsub_rn(dp[a][b], D[r]));
      }
      if (ps != nullptr) ps[r * BK + c] = p;
      dss[r * BK + c] = ds;
    }
  }
}

template <int HD>
struct Smem {
  static constexpr int ROW = HD + 1;
  // k, v (BK rows), q, dO (BQ rows), p, ds (BQ x BK), lse, D, q and kv
  // positions
  static constexpr int FLOATS = 2 * BK * ROW + 2 * BQ * ROW + 2 * BQ * BK +
                                2 * BQ;
  static constexpr int BYTES = FLOATS * 4 + (BQ + BK) * 4;
};

// dk and dv of one (b, kv head, kv tile)
template <int HD, typename T, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ o,
                                const T* __restrict__ dO,
                                const float* __restrict__ lse,
                                const int* __restrict__ q_pos,
                                const int* __restrict__ kv_pos,
                                T* __restrict__ dk, T* __restrict__ dv, int S,
                                int H, int KV, float scale, int causal) {
  constexpr int ROW = HD + 1, NC = HD / 32;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * ROW;
  float* qs = vs + BK * ROW;
  float* dos = qs + BQ * ROW;
  float* ps = dos + BQ * ROW;
  float* dss = ps + BQ * BK;
  float* lse_s = dss + BQ * BK;
  float* D = lse_s + BQ;
  int* qpos = reinterpret_cast<int*>(D + BQ);
  int* kvpos = qpos + BQ;

  const int n_k = (S + BK - 1) / BK;
  const int kt = n_k - 1 - (int)blockIdx.x;     // heaviest causal tiles first
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, group = H / KV;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float inv_s = __fdiv_rn(1.0f, (float)S);

  load_rows<HD, BK>(ks, k, b, kvh, KV, k0, S);
  load_rows<HD, BK>(vs, v, b, kvh, KV, k0, S);
  if (POS)
    for (int c = threadIdx.x; c < BK; c += THREADS)
      kvpos[c] = k0 + c < S ? kv_pos[(long long)b * S + k0 + c] : 0;

  float acc_k[8][NC], acc_v[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  const int n_q = (S + BQ - 1) / BQ;
  const int qt0 = (causal && !POS) ? k0 / BQ : 0;
  for (int h = kvh * group; h < (kvh + 1) * group; ++h) {
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();          // the previous tile's reads are done
      load_rows<HD, BQ>(qs, q, b, h, H, q0, S);
      load_rows<HD, BQ>(dos, dO, b, h, H, q0, S);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const int i = q0 + r;
        lse_s[r] = i < S ? lse[((long long)b * H + h) * S + i] : 0.0f;
        if (POS) qpos[r] = i < S ? q_pos[(long long)b * S + i] : 0;
      }
      __syncthreads();
      row_dots<HD>(D, dos, o, b, h, H, q0, S);
      __syncthreads();
      p_and_ds<HD, POS>(ps, dss, qs, dos, ks, vs, lse_s, D, qpos, kvpos, q0,
                        k0, S, causal, scale, inv_s);
      __syncthreads();
      // dv_j += p_ij dO_i, dk_j += ds_ij q_i: rows j = ty + 8a, columns
      // d = tx + 32c
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float dor[NC], qr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dor[c] = dos[r * ROW + tx + 32 * c];
          qr[c] = qs[r * ROW + tx + 32 * c];
        }
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float p = ps[r * BK + ty + 8 * a];
          const float ds = dss[r * BK + ty + 8 * a];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc_v[a][c] = __fmaf_rn(p, dor[c], acc_v[a][c]);
            acc_k[a][c] = __fmaf_rn(ds, qr[c], acc_k[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = k0 + ty + 8 * a;
    if (j >= S) continue;
    const long long row = (((long long)b * S + j) * KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + row + tx + 32 * c, __fmul_rn(acc_k[a][c], scale));
      store(dv + row + tx + 32 * c, acc_v[a][c]);
    }
  }
}

// dq of one (b, h, q tile)
template <int HD, typename T, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ o,
                              const T* __restrict__ dO,
                              const float* __restrict__ lse,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ kv_pos,
                              T* __restrict__ dq, int S, int H, int KV,
                              float scale, int causal) {
  constexpr int ROW = HD + 1, NC = HD / 32;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * ROW;
  float* qs = vs + BK * ROW;
  float* dos = qs + BQ * ROW;
  float* dss = dos + BQ * ROW + BQ * BK;      // p is not kept here
  float* lse_s = dss + BQ * BK;
  float* D = lse_s + BQ;
  int* qpos = reinterpret_cast<int*>(D + BQ);
  int* kvpos = qpos + BQ;

  const int n_q = (S + BQ - 1) / BQ;
  const int qt = n_q - 1 - (int)blockIdx.x;     // heaviest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float inv_s = __fdiv_rn(1.0f, (float)S);

  load_rows<HD, BQ>(qs, q, b, h, H, q0, S);
  load_rows<HD, BQ>(dos, dO, b, h, H, q0, S);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int i = q0 + r;
    lse_s[r] = i < S ? lse[((long long)b * H + h) * S + i] : 0.0f;
    if (POS) qpos[r] = i < S ? q_pos[(long long)b * S + i] : 0;
  }
  __syncthreads();
  row_dots<HD>(D, dos, o, b, h, H, q0, S);

  float acc[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  int n_k = (S + BK - 1) / BK;
  if (causal && !POS) n_k = min(n_k, min(q0 + BQ - 1, S - 1) / BK + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();            // the previous tile's reads are done
    load_rows<HD, BK>(ks, k, b, kvh, KV, k0, S);
    load_rows<HD, BK>(vs, v, b, kvh, KV, k0, S);
    if (POS)
      for (int c = threadIdx.x; c < BK; c += THREADS)
        kvpos[c] = k0 + c < S ? kv_pos[(long long)b * S + k0 + c] : 0;
    __syncthreads();
    p_and_ds<HD, POS>(nullptr, dss, qs, dos, ks, vs, lse_s, D, qpos, kvpos,
                      q0, k0, S, causal, scale, inv_s);
    __syncthreads();
    // dq_i += ds_ij k_j: rows i = ty + 8a, columns d = tx + 32c
#pragma unroll 2
    for (int c0 = 0; c0 < BK; ++c0) {
      float kr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kr[c] = ks[c0 * ROW + tx + 32 * c];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float ds = dss[(ty + 8 * a) * BK + c0];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[a][c] = __fmaf_rn(ds, kr[c], acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = q0 + ty + 8 * a;
    if (i >= S) continue;
    const long long row = (((long long)b * S + i) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dq + row + tx + 32 * c, __fmul_rn(acc[a][c], scale));
  }
}

template <int HD, typename T, bool POS>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, const int* q_pos,
           const int* kv_pos, void* dq, void* dk, void* dv, int B, int S,
           int H, int KV, float scale, int causal, cudaStream_t stream) {
  constexpr int SMEM = Smem<HD>::BYTES;
  auto dkdv = flash_attention_bwd_dkdv_kernel<HD, T, POS>;
  auto dqk = flash_attention_bwd_dq_kernel<HD, T, POS>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const T *q_ = (const T*)q, *k_ = (const T*)k, *v_ = (const T*)v,
          *o_ = (const T*)o, *do_ = (const T*)dO;
  dkdv<<<dim3((unsigned)((S + BK - 1) / BK), (unsigned)(B * KV)), THREADS,
         SMEM, stream>>>(q_, k_, v_, o_, do_, lse, q_pos, kv_pos, (T*)dk,
                         (T*)dv, S, H, KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)((S + BQ - 1) / BQ), (unsigned)(B * H)), THREADS, SMEM,
        stream>>>(q_, k_, v_, o_, do_, lse, q_pos, kv_pos, (T*)dq, S, H, KV,
                  scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const void* lse, const void* q_pos,
             const void* kv_pos, void* dq, void* dk, void* dv, int B, int S,
             int H, int KV, int hd, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)lse;
  const int *qp = (const int*)q_pos, *kp = (const int*)kv_pos;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return qp ? launch<64, T, true>(q, k, v, o, dO, l, qp, kp, dq, dk, dv, B,
                                    S, H, KV, scale, causal, st)
              : launch<64, T, false>(q, k, v, o, dO, l, qp, kp, dq, dk, dv,
                                     B, S, H, KV, scale, causal, st);
  if (hd == 128)
    return qp ? launch<128, T, true>(q, k, v, o, dO, l, qp, kp, dq, dk, dv,
                                     B, S, H, KV, scale, causal, st)
              : launch<128, T, false>(q, k, v, o, dO, l, qp, kp, dq, dk, dv,
                                      B, S, H, KV, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_pos and kv_pos both null or both (B, S) int32
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dO, const void* lse,
                                       const void* q_pos, const void* kv_pos,
                                       void* dq, void* dk, void* dv, int B,
                                       int S, int H, int KV, int hd,
                                       float scale, int causal,
                                       void* stream) {
  return dispatch<float>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk, dv, B,
                         S, H, KV, hd, scale, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dO, const void* lse,
                                        const void* q_pos, const void* kv_pos,
                                        void* dq, void* dk, void* dv, int B,
                                        int S, int H, int KV, int hd,
                                        float scale, int causal,
                                        void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dO, lse, q_pos, kv_pos, dq, dk,
                                 dv, B, S, H, KV, hd, scale, causal, stream);
}
