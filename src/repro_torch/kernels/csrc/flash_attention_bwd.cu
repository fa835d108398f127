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
// The math, per (b, query head h, row i, key j):
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
// Both types run two passes and no atomics, so two calls give the same bits.
// Bound: operations. The backward needs 5 products of 2 B H hd pairs each
// (q.k for p, dO.v for dp, p^T dO, ds k, ds^T q), the pairs those the mask
// keeps; both designs run 7 (each pass recomputes s and dp). At the vfl-zoo
// shape (B 4, S 2048, H 16, hd 64, causal) that is 5 x 17.2 = 86 GFLOP,
// 0.087 ms at the 989 TFLOP/s of the bf16 tensor cores (0.122 ms for the 7),
// against 6 x 16.8 MB of bf16 operands read or written (0.030 ms at 3.35
// TB/s).
//
// f32 (`flash_attention_bwd_f32_*`): the simple design, on the CUDA cores
// (1.28 ms for the 5 products at their 67 TFLOP/s).
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
// read is free of bank conflicts. Each multiply-add takes about one
// shared-memory read, so shared memory, not the FMA units, sets its pace.
// Rounding: every f32 operation is an __f*_rn intrinsic or expf / __fdiv_rn
// (built with --fmad=false too).
//
// bf16 (`flash_attention_bwd_bf16_*`): the FlashAttention-2/3 backward on
// Hopper's tensor cores, in the frame of the bf16 forward: blocks of 384
// threads, warpgroups 0 and 1 consumers of 64 rows each (240 registers a
// thread after setmaxnreg), warpgroup 2 the producer, whose first thread
// alone issues TMA loads (24 registers), 4-D tensor maps over (hd, heads,
// S, B) under the 128-byte swizzle (rows past S arrive as zeros), stages
// with full and empty mbarriers. Every product is a bf16 m64n64k16 `wgmma`
// with f32 accumulators (csrc/hopper.cuh): bf16 x bf16 products are exact
// in f32, so s and dp differ from the plain version only in the order of
// their sums.
//  1. dq pass, one block per (b*H + h, 128-row q tile), heaviest causal
//     tiles first. q and dO are loaded once. Each consumer computes D_i =
//     dO_i . o_i for its rows, and writes each row's record (off = -lse_i
//     log2(e), or -inf for a row that saw no key; D_i, or 1/S for such a
//     row; its q position) to a (B, H, S, 4) f32 scratch. Per 64-row kv
//     tile from a ring of k and v: s = q.k^T and dp = dO.v^T (both
//     operands in shared memory, K-major), p = 2^(s * c + off) with c =
//     scale log2(e) (one fma and one ex2.approx), ds = p (dp - D) in f32
//     registers, ds rounded once to bf16 as the register A operand of dq +=
//     ds . k, k read MN-major. dq is multiplied by scale once at the end.
//  2. dk/dv pass, one block per (b*KV + kv head, 128-row kv tile), heaviest
//     causal tiles first. k and v are loaded once; the block loops, in a
//     fixed order, over the kv head's query heads and the 64-row q tiles
//     that can see it, q, dO and the q rows' records (TMA, zeros past S)
//     through a ring. Per tile: s^T = k.q^T and dp^T = v.dO^T, p^T = 2^(s^T
//     c + off) and ds^T = p^T (dp^T - D), then dv += bf16(p^T + b) . dO and
//     dk += bf16(ds^T) . q with dO and q read MN-major. The transposed
//     products leave p^T and ds^T in the accumulator layout, which is the A
//     fragments' (as the forward's p goes from q.k to p.v), so nothing
//     goes through shared memory. dk and dv stay in registers for the
//     whole loop; dk is multiplied by scale at the end. At hd 64 each
//     consumer also holds its k and v rows as A fragments (ldmatrix, once).
//  Registers, tightest in the dk/dv pass at hd 128 (dk and dv 128 a
//  thread, s^T and dp^T 64): a wgmma's descriptors are formed as it is
//  issued, since a descriptor the compiler hoists out of the loop holds 2
//  registers for the whole of it (16 of them spilled); a record is read as
//  (off, D) and b is derived from off. The build shows 0 spill bytes.
//  Tried on the H100 and not kept: leaving a tile's second-stage products
//  to run under the next tile's s and dp (it spilled at hd 128), and
//  32-row q tiles at hd 128 (no spill, but slower than 64-row tiles).
//  benchmarks/torch_flash_bwd_variants.py times the choices kept against
//  their undoing, and another commit's kernel beside this one.
//  Masks: the causal index mask skips whole tiles and masks the diagonal
//  tile, which runs in its own loop; with positions (`POS`, a template
//  parameter) every tile is masked and none is skipped; a key past S is
//  masked in the dq pass (the ragged tail tile, in its own loop), and a q
//  row past S contributes nothing to dk and dv (its q, dO and record are
//  zeros: p = 1 against dO = 0, and ds = 0). lse, D and the positions are
//  never read past S. A row that saw no key gets p = 0 from its off of
//  -inf, so ds = 0, and p^T + b = 1/S in the dk/dv pass.
//  Numerics: p and ds are rounded once to bf16 for the three second-stage
//  products, as SDPA's backward does; tests/test_torch_flash_grad.py
//  emulates these numerics against the plain version.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float MASKED_LSE = -1e20f;
constexpr int BQ = 64, BK = 64;         // q rows, kv rows a tile
constexpr int THREADS = 256;            // 8 warps: ty = warp, tx = lane

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
flash_attention_bwd_f32_dkdv_kernel(const T* __restrict__ q,
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
flash_attention_bwd_f32_dq_kernel(const T* __restrict__ q,
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
  auto dkdv = flash_attention_bwd_f32_dkdv_kernel<HD, T, POS>;
  auto dqk = flash_attention_bwd_f32_dq_kernel<HD, T, POS>;
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

// ------------------------------------ bf16, on the tensor cores (Hopper) --

namespace tc {

using namespace hopper;

constexpr int THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr float LOG2E = 1.4426950408889634f;

// dq pass: 128 q rows a block (64 a consumer), 64 kv rows a tile
template <int HD>
struct DqTile {
  static constexpr int BQ = 128, BKV = 64, HALVES = HD / 64;
  static constexpr int STAGES = HD == 64 ? 4 : 3;   // the k/v ring
  static constexpr int Q_BYTES = BQ * HD * 2;       // one of q, dO
  static constexpr int KV_BYTES = BKV * HD * 2;     // one of k, v
  // q, dO, then k and v per stage, all 1024-aligned (the swizzle's
  // period); the mbarriers after; 1024 bytes of slack to align the base
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
};

// dk/dv pass: 128 kv rows a block (64 a consumer), 64 q rows a tile
template <int HD>
struct KvTile {
  static constexpr int BKV = 128, BQ = 64, HALVES = HD / 64;
  // at hd 64 each consumer holds its k and v rows as register A fragments
  // (32 registers), so the s^T and dp^T products read only q and dO from
  // shared memory; at hd 128 they would not fit beside dk and dv
  static constexpr bool AREG = HD == 64;
  static constexpr int STAGES = 4;                  // the q/dO/record ring
  static constexpr int KV_BYTES = BKV * HD * 2;     // one of k, v
  static constexpr int QS_BYTES = BQ * HD * 2;      // one of q, dO
  static constexpr int REC_BYTES = BQ * 16;         // the q rows' records
  static constexpr int STAGE_BYTES = 2 * QS_BYTES + REC_BYTES;
  // k, v, then q, dO and the records per stage, all 1024-aligned
  static constexpr int BAR_OFF = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
};

// d = A . B^T over hd, 16 columns a step: A the 64 rows at a within a
// 128-row tile, B the 64-row tile at b, both K-major ([HALVES][rows][64]).
// Each step's descriptors are the previous ones plus the step's offset
// (in 16-byte units), made opaque after each wgmma, so they are formed as
// they are issued and never held all at once.
template <int HD>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a,
                                          uint32_t b) {
  uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss(d, da, db, kk > 0);
    // the next 32 bytes of the row, or the next 64-column half
    da += kk % 4 < 3 ? 2 : (128 * ROW_BYTES - 3 * 32) >> 4;
    db += kk % 4 < 3 ? 2 : (64 * ROW_BYTES - 3 * 32) >> 4;
    opaque(da);
    opaque(db);
  }
}

// d = A . B^T over hd as issue_abt, A from its register fragments (AREG
// below): a[kk] the fragment of k16 step kk
template <int HD>
__device__ __forceinline__ void issue_abt(float (&d)[32],
                                          const uint32_t (&a)[HD / 16][4],
                                          uint32_t b) {
  uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_rs<0>(d, a[kk], db, kk > 0);
    db += kk % 4 < 3 ? 2 : (64 * ROW_BYTES - 3 * 32) >> 4;
    opaque(db);
  }
}

// acc += A . B: A the register fragments of a 64 x 64 operand (four k16
// steps), B the 64-row tile at b read MN-major, hd as 64-column halves;
// descriptors formed as they are issued (issue_abt)
template <int HD>
__device__ __forceinline__ void issue_ab(float (&acc)[HD / 64][32],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
  uint64_t db = sw128_desc(b);
#pragma unroll
  for (int hf = 0; hf < HD / 64; ++hf)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<1>(acc[hf], a[kk], db, 1);
      db += (16 * ROW_BYTES) >> 4;              // the next 16 rows
      opaque(db);
    }
}

// D_i = dO_i . o_i in f32 for a warp's 16 rows from row0 (element offset
// at, rows stride apart), one row at a time: a lane multiplies hd / 32
// pairs, a butterfly sums them over the warp; a thread keeps those of its
// rows row0 + lane / 4 and + 8. Zero past S.
template <int HD>
__device__ __forceinline__ void row_dots(float (&D)[2],
                                         const __nv_bfloat16* __restrict__ o,
                                         const __nv_bfloat16* __restrict__ dO,
                                         long long at, long long stride,
                                         int row0, int S, int lane) {
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    float acc = 0.0f;
    if (row0 + rr < S) {
      const long long e = at + rr * stride;
      const __nv_bfloat162* orow =
          reinterpret_cast<const __nv_bfloat162*>(o + e);
      const __nv_bfloat162* drow =
          reinterpret_cast<const __nv_bfloat162*>(dO + e);
#pragma unroll
      for (int hf = 0; hf < HD / 64; ++hf) {
        const float2 a = __bfloat1622float2(orow[lane + 32 * hf]);
        const float2 d = __bfloat1622float2(drow[lane + 32 * hf]);
        acc = __fmaf_rn(a.x, d.x, acc);
        acc = __fmaf_rn(a.y, d.y, acc);
      }
    }
#pragma unroll
    for (int w = 16; w >= 1; w /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, w));
    if (rr % 8 == lane / 4) D[rr / 8] = acc;
  }
}

// The accumulator layout (x[4j + 2i + e]: row r0 + 8i, column 8j + c0 + e)
// is the A fragments' over those columns as the k of the next product:
// register 2 (j % 2) + i of k16 step j / 2 holds x[4j + 2i] (low half) and
// x[4j + 2i + 1]. So each value is rounded to bf16 into its fragment as
// soon as it and its neighbour are computed, and the f32 values die there.

// ds of one kv tile in the dq pass, as bf16 A fragments: p = 2^(s c + off)
// (0 for a row that saw no key: off = -inf), ds = p (dp - D). MASK: a key
// past S, or (causal) one the row does not see, gets p = 0.
template <bool MASK, bool POS>
__device__ __forceinline__ void dq_scores(const float (&s)[32],
                                          const float (&dp)[32],
                                          uint32_t (&ds)[4][4],
                                          const float (&off)[2],
                                          const float (&D)[2], float c,
                                          int k0, int r0, int c0, int S,
                                          int causal,
                                          const int* __restrict__ kvpos,
                                          const int (&qp)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int kp[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kv = k0 + 8 * j + c0 + e;
      if (MASK && POS) kp[e] = kv < S ? __ldg(kvpos + kv) : 0;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * ri + e, kv = k0 + 8 * j + c0 + e;
        float p = ex2(__fmaf_rn(s[x], c, off[ri]));
        if (MASK) {
          bool seen = kv < S;
          if (causal)
            seen = seen && (POS ? kp[e] <= qp[ri] : kv <= r0 + 8 * ri);
          p = seen ? p : 0.0f;
        }
        d[e] = __fmul_rn(p, __fsub_rn(dp[x], D[ri]));
      }
      ds[j / 2][2 * (j % 2) + ri] = bf16x2(d[0], d[1]);
    }
  }
}

// p^T + b and ds^T of one q tile in the dk/dv pass, as bf16 A fragments:
// kv row r0 + 8i against q row q0 + col, col = 8j + c0 + e, whose record
// (off, D, q position) lies at rec + 16 col; b = 1/S for a row that saw no
// key (off = -inf), whose record holds 1/S in place of D (its p is 0, so
// D is not needed), else 0. MASK (causal): a kv row the q row does not see
// gets p = 0.
template <bool MASK, bool POS>
__device__ __forceinline__ void kv_scores(const float (&st)[32],
                                          const float (&dpt)[32],
                                          uint32_t (&pa)[4][4],
                                          uint32_t (&da)[4][4],
                                          uint32_t rec, float c, int q0,
                                          int r0, int c0,
                                          const int (&kp)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 r[2];          // (off, D)
    int qpos[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r[e] = lds_f2(rec + 16 * (8 * j + c0 + e));
      if (MASK && POS) qpos[e] = lds_s32(rec + 16 * (8 * j + c0 + e) + 8);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float p[2], d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * ri + e, col = 8 * j + c0 + e;
        float pe = ex2(__fmaf_rn(st[x], c, r[e].x));
        if (MASK)
          pe = (POS ? kp[ri] <= qpos[e] : r0 + 8 * ri <= q0 + col) ? pe
                                                                  : 0.0f;
        d[e] = __fmul_rn(pe, __fsub_rn(dpt[x], r[e].y));
        p[e] = __fadd_rn(pe, __float_as_uint(r[e].x) == 0xff800000u ? r[e].y
                                                                 : 0.0f);
      }
      pa[j / 2][2 * (j % 2) + ri] = bf16x2(p[0], p[1]);
      da[j / 2][2 * (j % 2) + ri] = bf16x2(d[0], d[1]);
    }
  }
}

// One kv tile of the dq pass for one consumer warpgroup
template <int HD, bool MASK, bool POS>
__device__ __forceinline__ void dq_tile(float (&acc)[HD / 64][32],
                                        uint32_t q_wg, uint32_t do_wg,
                                        uint32_t k_st, uint32_t v_st,
                                        const float (&off)[2],
                                        const float (&D)[2], float c, int k0,
                                        int r0, int c0, int S, int causal,
                                        const int* __restrict__ kvpos,
                                        const int (&qp)[2]) {
  float s[32], dp[32];
  wgmma_fence();
  issue_abt<HD>(s, q_wg, k_st);
  issue_abt<HD>(dp, do_wg, v_st);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);
  reg_fence(dp);
  uint32_t a[4][4];
  dq_scores<MASK, POS>(s, dp, a, off, D, c, k0, r0, c0, S, causal, kvpos,
                       qp);
  reg_fence(acc);
  wgmma_fence();
  issue_ab<HD>(acc, a, k_st);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(a);             // read by the wgmmas until here
  reg_fence(acc);
}

// One q tile of the dk/dv pass for one consumer warpgroup
template <int HD, bool MASK, bool POS>
__device__ __forceinline__ void kv_tile(float (&dk)[HD / 64][32],
                                        float (&dv)[HD / 64][32],
                                        const uint32_t (&kf)[HD / 16][4],
                                        const uint32_t (&vf)[HD / 16][4],
                                        uint32_t k_wg, uint32_t v_wg,
                                        uint32_t q_st, uint32_t do_st,
                                        uint32_t rec, float c, int q0, int r0,
                                        int c0, const int (&kp)[2]) {
  float st[32], dpt[32];
  wgmma_fence();
  if constexpr (KvTile<HD>::AREG) {
    issue_abt<HD>(st, kf, q_st);
    issue_abt<HD>(dpt, vf, do_st);
  } else {
    issue_abt<HD>(st, k_wg, q_st);
    issue_abt<HD>(dpt, v_wg, do_st);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(st);
  reg_fence(dpt);
  uint32_t pa[4][4], da[4][4];
  kv_scores<MASK, POS>(st, dpt, pa, da, rec, c, q0, r0, c0, kp);
  reg_fence(dk);
  reg_fence(dv);
  wgmma_fence();
  issue_ab<HD>(dv, pa, do_st);
  issue_ab<HD>(dk, da, q_st);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(pa);            // read by the wgmmas until here
  reg_fence(da);
  reg_fence(dk);
  reg_fence(dv);
}

// rows r0 and r0 + 8 of an accumulator over hd, times mul, into bf16 rows
// at out + row * stride; rows past S skipped
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           long long stride,
                                           const float (&acc)[HD / 64][32],
                                           float mul, int r0, int c0,
                                           int S) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + 8 * ri;
    if (row >= S) continue;
    __nv_bfloat16* orow = out + row * stride;
#pragma unroll
    for (int hf = 0; hf < HD / 64; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + hf * 64 + 8 * j + c0) =
            __floats2bfloat162_rn(
                __fmul_rn(acc[hf][4 * j + 2 * ri], mul),
                __fmul_rn(acc[hf][4 * j + 2 * ri + 1], mul));
  }
}

template <int HD, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __nv_bfloat16* __restrict__ o,
                                   const __nv_bfloat16* __restrict__ dO,
                                   const float* __restrict__ lse,
                                   const int* __restrict__ q_pos,
                                   const int* __restrict__ kv_pos,
                                   __nv_bfloat16* __restrict__ dq,
                                   float4* __restrict__ rec, int S, int H,
                                   int group, float scale, int causal) {
  using T = DqTile<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, ST = T::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_smem = base;                        // [HALVES][BQ][64]
  const uint32_t do_smem = base + T::Q_BYTES;
  const uint32_t kv_smem = base + 2 * T::Q_BYTES;      // [ST][k, v]
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t full = q_full + 8;                    // [ST]
  const uint32_t empty = full + 8 * ST;                // [ST]
  auto k_tile = [&](int i) { return kv_smem + (i % ST) * 2 * T::KV_BYTES; };

  // blocks start in the order of their linear index, x fastest: every
  // head's heaviest causal q tile first
  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  int n_kv = (S + BKV - 1) / BKV;
  if (causal && !POS) n_kv = min(n_kv, min(q0 + BQ - 1, S - 1) / BKV + 1);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int hf = 0; hf < T::HALVES; ++hf) {
        tma_load_4d(q_smem + hf * BQ * ROW_BYTES, &map_q, q_full, hf * 64, h,
                    q0, b);
        tma_load_4d(do_smem + hf * BQ * ROW_BYTES, &map_do, q_full, hf * 64,
                    h, q0, b);
      }
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * st, ((i / ST) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * T::KV_BYTES);
        for (int hf = 0; hf < T::HALVES; ++hf) {
          const uint32_t at = k_tile(i) + hf * BKV * ROW_BYTES;
          tma_load_4d(at, &map_k, bar, hf * 64, kvh, i * BKV, b);
          tma_load_4d(at + T::KV_BYTES, &map_v, bar, hf * 64, kvh, i * BKV,
                      b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int row_first = q0 + wg * 64;
    const int r0 = row_first + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
    const long long row_stride = (long long)H * HD;
    const long long at0 = ((long long)b * S * H + h) * HD;   // (b, row 0, h)

    // each row's D and record; lse and the positions are read below S only
    float D[2] = {0.0f, 0.0f}, off[2];
    int qp[2] = {0, 0};
    row_dots<HD>(D, o, dO, at0 + (row_first + warp * 16) * row_stride,
                 row_stride, row_first + warp * 16, S, lane);
    const float inv_s = __fdiv_rn(1.0f, (float)S);
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int i = r0 + 8 * ri;
      off[ri] = __int_as_float(0xff800000);            // -inf
      if (i < S) {
        const float l = lse[(long long)bh * S + i];
        const bool blind = l < MASKED_LSE;
        if (!blind) off[ri] = __fmul_rn(l, -LOG2E);
        if (POS) qp[ri] = q_pos[(long long)b * S + i];
        if (lane % 4 == 0)
          rec[(long long)bh * S + i] = make_float4(
              off[ri], blind ? inv_s : D[ri], __int_as_float(qp[ri]), 0.0f);
      }
    }
    const float c = __fmul_rn(scale, LOG2E);
    const int* kvpos = POS ? kv_pos + (long long)b * S : nullptr;
    const uint32_t q_wg = q_smem + wg * 64 * ROW_BYTES;
    const uint32_t do_wg = do_smem + wg * 64 * ROW_BYTES;

    // kv tiles [0, n_full) unmasked, [n_full, n_end) masked (the causal
    // diagonal, or the ragged tail), [n_end, n_kv) only released: they lie
    // past this warpgroup's diagonal
    int n_full = n_kv, n_end = n_kv;
    if (causal && !POS) {
      if (row_first < S) n_full = row_first / BKV, n_end = n_full + 1;
    } else if (causal) {
      n_full = 0;
    } else if (S % BKV != 0) {
      n_full = n_kv - 1;
    }

    float acc[T::HALVES][32];
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[hf][x] = 0.0f;
    mbar_wait(q_full, 0);
    int i = 0;
    for (; i < n_full; ++i) {
      mbar_wait(full + 8 * (i % ST), (i / ST) & 1);
      dq_tile<HD, false, POS>(acc, q_wg, do_wg, k_tile(i),
                              k_tile(i) + T::KV_BYTES, off, D, c, i * BKV, r0,
                              c0, S, causal, kvpos, qp);
      mbar_arrive(empty + 8 * (i % ST));
    }
    for (; i < n_end; ++i) {
      mbar_wait(full + 8 * (i % ST), (i / ST) & 1);
      dq_tile<HD, true, POS>(acc, q_wg, do_wg, k_tile(i),
                             k_tile(i) + T::KV_BYTES, off, D, c, i * BKV, r0,
                             c0, S, causal, kvpos, qp);
      mbar_arrive(empty + 8 * (i % ST));
    }
    for (; i < n_kv; ++i) {
      mbar_wait(full + 8 * (i % ST), (i / ST) & 1);
      mbar_arrive(empty + 8 * (i % ST));
    }
    store_rows<HD>(dq + at0, row_stride, acc, scale, r0, c0, S);
  }
}

template <int HD, bool POS>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bwd_bf16_dkdv_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_rec,
    const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int KV, float scale,
    int causal) {
  using T = KvTile<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, ST = T::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_smem = base;                        // [HALVES][BKV][64]
  const uint32_t v_smem = base + T::KV_BYTES;
  const uint32_t stages = base + 2 * T::KV_BYTES;      // [ST][q, dO, rec]
  const uint32_t kv_full = base + T::BAR_OFF;
  const uint32_t full = kv_full + 8;                   // [ST]
  const uint32_t empty = full + 8 * ST;                // [ST]
  auto stage = [&](int n) { return stages + (n % ST) * T::STAGE_BYTES; };

  // kv tile 0 first: under the causal mask every q tile sees it
  const int k0 = (int)blockIdx.y * BKV;
  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int n_q = (S + BQ - 1) / BQ;
  // the first q tile that can see the kv tile
  const int u0 = (causal && !POS) ? k0 / BQ : 0;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int hf = 0; hf < T::HALVES; ++hf) {
        tma_load_4d(k_smem + hf * BKV * ROW_BYTES, &map_k, kv_full, hf * 64,
                    kvh, k0, b);
        tma_load_4d(v_smem + hf * BKV * ROW_BYTES, &map_v, kv_full, hf * 64,
                    kvh, k0, b);
      }
      int n = 0;
      for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        for (int u = u0; u < n_q; ++u, ++n) {
          const int st = n % ST;
          if (n >= ST) mbar_wait(empty + 8 * st, ((n / ST) - 1) & 1);
          const uint32_t bar = full + 8 * st, at = stage(n);
          mbar_expect_tx(bar, T::STAGE_BYTES);
          for (int hf = 0; hf < T::HALVES; ++hf) {
            tma_load_4d(at + hf * BQ * ROW_BYTES, &map_q, bar, hf * 64, h,
                        u * BQ, b);
            tma_load_4d(at + T::QS_BYTES + hf * BQ * ROW_BYTES, &map_do, bar,
                        hf * 64, h, u * BQ, b);
          }
          tma_load_3d(at + 2 * T::QS_BYTES, &map_rec, bar, 0, u * BQ,
                      b * H + h);
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = k0 + wg * 64 + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
    int kp[2] = {0, 0};
    if (POS)
      for (int ri = 0; ri < 2; ++ri)
        if (r0 + 8 * ri < S) kp[ri] = kv_pos[(long long)b * S + r0 + 8 * ri];
    const float c = __fmul_rn(scale, LOG2E);
    const uint32_t k_wg = k_smem + wg * 64 * ROW_BYTES;
    const uint32_t v_wg = v_smem + wg * 64 * ROW_BYTES;

    float dk_acc[T::HALVES][32], dv_acc[T::HALVES][32];
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk_acc[hf][x] = dv_acc[hf][x] = 0.0f;
    mbar_wait(kv_full, 0);
    uint32_t kf[HD / 16][4], vf[HD / 16][4];      // used under AREG only
    if constexpr (T::AREG)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_a(kf[kk], k_wg + (kk / 4) * BKV * ROW_BYTES, kk % 4, warp, lane);
        ldsm_a(vf[kk], v_wg + (kk / 4) * BKV * ROW_BYTES, kk % 4, warp, lane);
      }
    int n = 0;
    for (int g = 0; g < group; ++g) {
      int u = u0;
      if (causal && !POS) {
        // q tile u0 lies wholly above warpgroup 1's kv rows: released only
        if (wg == 1) {
          mbar_wait(full + 8 * (n % ST), (n / ST) & 1);
          mbar_arrive(empty + 8 * (n % ST));
          ++n, ++u;
        }
        // the diagonal tile
        if (u < n_q) {
          mbar_wait(full + 8 * (n % ST), (n / ST) & 1);
          const uint32_t at = stage(n);
          kv_tile<HD, true, POS>(dk_acc, dv_acc, kf, vf, k_wg, v_wg, at,
                                 at + T::QS_BYTES, at + 2 * T::QS_BYTES, c,
                                 u * BQ, r0, c0, kp);
          mbar_arrive(empty + 8 * (n % ST));
          ++n, ++u;
        }
      }
      if (POS && causal) {
        for (; u < n_q; ++u, ++n) {
          mbar_wait(full + 8 * (n % ST), (n / ST) & 1);
          const uint32_t at = stage(n);
          kv_tile<HD, true, POS>(dk_acc, dv_acc, kf, vf, k_wg, v_wg, at,
                                 at + T::QS_BYTES, at + 2 * T::QS_BYTES, c,
                                 u * BQ, r0, c0, kp);
          mbar_arrive(empty + 8 * (n % ST));
        }
      } else {
        for (; u < n_q; ++u, ++n) {
          mbar_wait(full + 8 * (n % ST), (n / ST) & 1);
          const uint32_t at = stage(n);
          kv_tile<HD, false, POS>(dk_acc, dv_acc, kf, vf, k_wg, v_wg, at,
                                  at + T::QS_BYTES, at + 2 * T::QS_BYTES, c,
                                  u * BQ, r0, c0, kp);
          mbar_arrive(empty + 8 * (n % ST));
        }
      }
    }
    const long long row_stride = (long long)KV * HD;
    const long long at0 = ((long long)b * S * KV + kvh) * HD;   // (b, 0, kvh)
    store_rows<HD>(dk + at0, row_stride, dk_acc, scale, r0, c0, S);
    store_rows<HD>(dv + at0, row_stride, dv_acc, 1.0f, r0, c0, S);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, const int* q_pos,
           const int* kv_pos, void* dq, void* dk, void* dv, void* rec, int B,
           int S, int H, int KV, float scale, int causal,
           cudaStream_t stream) {
  using DT = DqTile<HD>;
  using KT = KvTile<HD>;
  const void* ptrs[9] = {q, k, v, o, dO, dq, dk, dv, rec};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  // the dq pass reads q and dO in 128-row boxes, k and v in 64; the dk/dv
  // pass the other way round, and the records (B*H, S, 4) in 64 rows
  CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_q, kv_do, kv_k, kv_v, kv_rec;
  CUresult res = encode_rows(fn, &dq_q, q, B, S, H, HD, DT::BQ);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &dq_do, dO, B, S, H, HD, DT::BQ);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &dq_k, k, B, S, KV, HD, DT::BKV);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &dq_v, v, B, S, KV, HD, DT::BKV);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &kv_q, q, B, S, H, HD, KT::BQ);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &kv_do, dO, B, S, H, HD, KT::BQ);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &kv_k, k, B, S, KV, HD, KT::BKV);
  if (res == CUDA_SUCCESS) res = encode_rows(fn, &kv_v, v, B, S, KV, HD, KT::BKV);
  if (res == CUDA_SUCCESS)
    res = encode_f32_rows(fn, &kv_rec, rec, B * H, S, 4, KT::BQ);
  if (res != CUDA_SUCCESS) return (int)res;
  auto dqk = q_pos ? flash_attention_bwd_bf16_dq_kernel<HD, true>
                   : flash_attention_bwd_bf16_dq_kernel<HD, false>;
  auto dkdv = q_pos ? flash_attention_bwd_bf16_dkdv_kernel<HD, true>
                    : flash_attention_bwd_bf16_dkdv_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DT::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, KT::SMEM);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), (unsigned)((S + DT::BQ - 1) / DT::BQ)),
        THREADS, DT::SMEM, stream>>>(
      dq_q, dq_do, dq_k, dq_v, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dO, lse, q_pos, kv_pos, (__nv_bfloat16*)dq,
      (float4*)rec, S, H, H / KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((unsigned)(B * KV), (unsigned)((S + KT::BKV - 1) / KT::BKV)),
         THREADS, KT::SMEM, stream>>>(
      kv_q, kv_do, kv_k, kv_v, kv_rec, kv_pos, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, S, H, KV, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// scratch: (B, H, S, 4) f32, each q row's record, written by the dq pass
// and read by the dk/dv pass
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dO, const void* lse,
                                        const void* q_pos, const void* kv_pos,
                                        void* dq, void* dk, void* dv,
                                        void* scratch, int B, int S, int H,
                                        int KV, int hd, float scale,
                                        int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)lse;
  const int *qp = (const int*)q_pos, *kp = (const int*)kv_pos;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return tc::launch<64>(q, k, v, o, dO, l, qp, kp, dq, dk, dv, scratch, B,
                          S, H, KV, scale, causal, st);
  if (hd == 128)
    return tc::launch<128>(q, k, v, o, dO, l, qp, kp, dq, dk, dv, scratch, B,
                           S, H, KV, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
