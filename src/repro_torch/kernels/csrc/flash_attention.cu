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
// The math is the Pallas kernel's: s = q.k * scale with scale =
// 1/sqrt(hd) bound to f32, the causal mask by position (kv > q gets
// -1e30), f32 running max m, denominator l and accumulator acc, and
// out = acc / max(l, 1e-30) (__fdiv_rn) rounded once to the input type.
//
// Bound: operations. Causal attention at the main path's shape (B 4,
// S 2048, H 16, hd 64) is 2 * 2*B*H*hd*pairs = 34.4 GFLOP (q.k and p.v
// over the S(S+1)/2 pairs the mask keeps, 17.2 each) against 4 x 16.8 MB
// of bf16 q, k, v and out: 0.0348 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 0.020 ms for the bytes at 3.35 TB/s.
//
// Two kernels.
//
// bf16: Hopper's tensor cores (`flash_attention_bf16_kernel`). One block
// of 384 threads per (b*H+h, 128-row q tile), every head's heaviest causal
// tile launched first. Warpgroups 0 and 1 are consumers, 64 q rows each;
// warpgroup 2 is the producer, whose first thread alone issues the TMA
// loads (setmaxnreg works per warpgroup, so the producer is a whole
// warpgroup that gives its registers up: 24 a thread, the consumers 240).
// TMA reads 4-D tensor maps over (hd, heads, S, B) with boxes of (64, 1,
// rows, 1) under the 128-byte swizzle, so GQA is the kv-head coordinate,
// rows past S arrive as zeros (and are masked to -1e30 in the scores),
// and hd 128 is two 64-column boxes. q is loaded once; k and v go through
// a ring of 3 stages with full/empty mbarriers, so the producer's loads
// overlap the consumers' math. kv tiles are 128 rows at hd 64 and 64 rows
// at hd 128 (registers). Per kv tile, each consumer warpgroup:
//  - s = q.k^T on `wgmma` (m64nBKVk16, both operands in shared memory, f32
//    accumulators); bf16 x bf16 products are exact in f32, so only the
//    order of the f32 sums differs from the plain version;
//  - the mask, row max and sum over the 4 lanes sharing a row, and the
//    online softmax in registers, in base 2: p = 2^(s * c - m) with c =
//    scale * log2(e) and m the running max of s * c, corr = 2^(m_old -
//    m_new), l = l * corr + the sum of the f32 p. One fma and one
//    ex2.approx an element, where expf took ~9 instructions and the
//    softmax set the pace (benchmarks/torch_flash_variants.py times both).
//    Each p is within ~2^-22 (relative) of exp(s * scale - max) where p
//    is not tiny, and the rounding of m scales a whole row alike and
//    cancels in acc / l (the bound is worked out at `Consumer::softmax`);
//  - acc *= corr, then acc += p_hi.v + p_lo.v on `wgmma` with p from
//    registers (the accumulator layout is the A fragment's) and v the
//    shared-memory B operand read MN-major, where p_hi = bf16(p) and
//    p_lo = bf16(p - p_hi) (the subtraction is exact).
// Within a warpgroup, tile i's q.k is issued with tile i-1's p.v, and
// tile i's softmax runs while that p.v is on the tensor cores; the other
// warpgroup's products fill the tensor cores while this one's softmax
// runs.
// Why p is split: p rounded once to bf16 (what SDPA does) puts outputs
// 25-78x the allowance of half a bf16 ulp of the f32 result away; p_hi +
// p_lo keeps p to about 2^-18 and the outputs as close as f32 p does
// (tests/test_torch_flash.py emulates both). It costs a
// third product: 3 x 17.2 = 51.6 GFLOP, 0.052 ms at the tensor-core rate,
// 1.5x the bound. Tried on the H100 and not kept, as no faster: the two
// consumer warpgroups taking turns to issue (named barriers) and a
// persistent grid of one block per SM. Left for later: a second s so
// tile i+1's q.k is issued before tile i's split, a third consumer
// warpgroup, part of the exponentials on the FMA units (at hd 64 a tile
// pair's 16384 ex2 take 1024 clocks at 16 a clock per SM, two thirds of
// its 1536 clocks of products), clusters that share k and v loads, a TMA
// store of out.
//
// f32: the CUDA cores (`flash_attention_f32_kernel`); the tensor cores
// give no f32 products at its 1e-5 tolerance short of a 3 x TF32 scheme.
// Both products count at 67 TFLOP/s, 0.51 ms at the vfl-zoo shape. One
// block of 256 threads per (64-row q tile, b*H+h), heaviest causal tiles
// first; the q tile is staged once, then a loop over 64-row kv tiles
// (only those at or left of the diagonal when causal, the ragged edge
// masked) stages k transposed and v in shared memory. Each thread holds
// a 4 x 4 tile of scores and a 4-row x hd/16-column tile of acc; the row
// max and row sum reduce over the 16 lanes that share a row with
// shuffles.
//
// Rounding: every CUDA-core product-sum is an explicit __fmaf_rn, every
// other operation an __f*_rn intrinsic or expf (built with --fmad=false
// too).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------- f32, on the CUDA cores --

constexpr int F32_BQ = 64;        // q rows per block
constexpr int F32_BKV = 64;       // kv rows per tile
constexpr int F32_THREADS = 256;
constexpr int PAD = 4;            // keeps float4 rows aligned

template <int HD>
constexpr int f32_smem_floats() {
  // qt[HD][BQ+PAD], kt[HD][BKV+PAD], vs[BKV][HD], pt[BKV][BQ+PAD]
  return HD * (F32_BQ + PAD) + HD * (F32_BKV + PAD) + F32_BKV * HD +
         F32_BKV * (F32_BQ + PAD);
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int H, int group,
                           float scale, int causal) {
  constexpr int BQ = F32_BQ, BKV = F32_BKV, THREADS = F32_THREADS;
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
  const float* qb = q + (long long)b * S * q_s + h * HD;
  const float* kb = k + (long long)b * S * kv_s + kvh * HD;
  const float* vb = v + (long long)b * S * kv_s + kvh * HD;

  // q tile, transposed: qt[d][r]
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    const int gr = q0 + r;
    qt[d * (BQ + PAD) + r] = gr < S ? qb[gr * q_s + d] : 0.0f;
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
        kv_k = kb[gr * kv_s + d];
        kv_v = vb[gr * kv_s + d];
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
    float* orow = out + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[g * 64 + tx * 4 + c] = __fdiv_rn(acc[i][g * 4 + c], den);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int S, int H, int KV, float scale, int causal,
               void* stream) {
  constexpr int smem = f32_smem_floats<HD>() * (int)sizeof(float);
  auto kern = flash_attention_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((S + F32_BQ - 1) / F32_BQ), (unsigned)(B * H));
  kern<<<grid, F32_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H,
      H / KV, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------ bf16, on the tensor cores (Hopper) --

constexpr int BQ = 128;           // q rows per block, 64 per consumer
constexpr int THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int STAGES = 3;         // the k/v ring
constexpr int ROW_BYTES = 128;    // one swizzled box row: 64 bf16

template <int HD>
struct Tile {
  static constexpr int BKV = HD == 64 ? 128 : 64;   // kv rows per tile
  static constexpr int HALVES = HD / 64;            // 64-column boxes
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;     // one of k, v
  // q, then k and v per stage, all 1024-aligned (the swizzle's period);
  // the mbarriers after; 1024 bytes of slack to align the base
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile under the 128-byte swizzle:
// 8-row groups 1024 bytes apart (the stride byte offset); the leading
// byte offset is unused by a K-major operand, and by an MN-major one
// whose 64 columns fit one swizzle atom. Offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous region
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// m64nNk16 with bf16 operands and f32 accumulators. ss: A (64 x 16, K-major)
// and B (16 x N, K-major) from shared memory; accumulate = 0 overwrites d.
// rs: A from registers (the m64k16 fragment), B from shared memory read
// MN-major (transposed); always accumulates.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// What one consumer warpgroup computes with one kv tile. Its thread holds
// rows r0 and r0 + 8 of the warpgroup's 64; s[4j + 2i + e] is row r0 + 8i,
// kv column k0 + 8j + c0 + e (the wgmma accumulator layout).
template <int HD>
struct Consumer {
  using T = Tile<HD>;
  static constexpr int BKV = T::BKV, NS = BKV / 2, KSTEPS = BKV / 16;

  // s = q . k^T, 16 columns of hd a step (4 steps in each 64-column half)
  static __device__ __forceinline__ void issue_qk(float (&s)[NS],
                                                  uint32_t q_wg,
                                                  uint32_t k_st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t hf = kk / 4, byte = (kk % 4) * 32;
      const uint64_t da = sw128_desc(q_wg + hf * BQ * ROW_BYTES + byte);
      const uint64_t db = sw128_desc(k_st + hf * BKV * ROW_BYTES + byte);
      if constexpr (BKV == 128)
        wgmma_ss_n128(s, da, db, kk > 0);
      else
        wgmma_ss_n64(s, da, db, kk > 0);
    }
  }

  // acc += p_hi . v + p_lo . v, 16 kv rows a step
  static __device__ __forceinline__ void issue_pv(
      float (&o)[T::HALVES][32], const uint32_t (&p_hi)[KSTEPS][4],
      const uint32_t (&p_lo)[KSTEPS][4], uint32_t v_st) {
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs_n64(o[hf], p_hi[kk],
                     sw128_desc(v_st + (hf * BKV + kk * 16) * ROW_BYTES));
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_rs_n64(o[hf], p_lo[kk],
                     sw128_desc(v_st + (hf * BKV + kk * 16) * ROW_BYTES));
  }

  // mask, and the online-softmax update in base 2: s becomes p (f32), and
  // l = l * corr + the row sum of that p. m is kept as max(s) * c with c =
  // scale * log2(e) (an f32 constant), so p = 2^(s * c - m) is one fma and
  // one ex2.approx, which is exp(s * scale - max(s * scale)) up to: the
  // rounding of m, a factor common to a row's p's that cancels in acc / l;
  // the roundings of c and of the fma, together at most ~2^-23 |s * c - m|
  // in the exponent, so ~2^-23 ln2 |s * c - m| relative on p (p < 2^-23
  // wherever that exceeds 2^-19); and ex2.approx's relative error, about
  // 2^-22 (PTX ISA). Against the half bf16 ulp (2^-9 relative) that the
  // element check allows each output, that is at most ~2^-10 of it.
  template <bool MASK>
  static __device__ __forceinline__ void softmax(float (&s)[NS], float (&m)[2],
                                                 float (&l)[2],
                                                 float (&corr)[2], int k0,
                                                 int r0, int c0, int S,
                                                 int causal, float c) {
    float mx[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * ri + e];
          if (MASK) {
            const int kv = k0 + 8 * j + c0 + e;
            if (kv >= S || (causal && kv > r0 + 8 * ri)) x = NEG_INF;
          }
          mx[ri][j % 2] = fmaxf(mx[ri][j % 2], x);
        }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float t = fmaxf(mx[ri][0], mx[ri][1]);
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
      const float m_new = fmaxf(m[ri], __fmul_rn(t, c));
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * ri + e];
          x = ex2(__fmaf_rn(x, c, -m_new));
          sum[j % 2] = __fadd_rn(sum[j % 2], x);
        }
      float total = __fadd_rn(sum[0], sum[1]);
      total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, 1));
      total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, 2));
      corr[ri] = ex2(__fsub_rn(m[ri], m_new));
      l[ri] = __fadd_rn(__fmul_rn(l[ri], corr[ri]), total);
      m[ri] = m_new;
    }
  }

  static __device__ __forceinline__ void softmax(float (&s)[NS], float (&m)[2],
                                                 float (&l)[2],
                                                 float (&corr)[2], int k0,
                                                 int r0, int c0, bool edge,
                                                 int S, int causal, float c) {
    if (edge)
      softmax<true>(s, m, l, corr, k0, r0, c0, S, causal, c);
    else
      softmax<false>(s, m, l, corr, k0, r0, c0, S, causal, c);
  }

  // p as two bf16 halves in the A fragments: register r of k step kk holds
  // p[8kk + 2r] (low half) and p[8kk + 2r + 1] (high)
  static __device__ __forceinline__ void split(const float (&p)[NS],
                                               uint32_t (&p_hi)[KSTEPS][4],
                                               uint32_t (&p_lo)[KSTEPS][4]) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = p[8 * kk + 2 * r], c = p[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        p_hi[kk][r] = bf16x2_bits(hi);
        p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
            __fsub_rn(a, __low2float(hi)), __fsub_rn(c, __high2float(hi))));
      }
  }

  static __device__ __forceinline__ void rescale(float (&o)[T::HALVES][32],
                                                 const float (&corr)[2]) {
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[hf][i] = __fmul_rn(o[hf][i], corr[(i / 2) % 2]);
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            __nv_bfloat16* __restrict__ out, int S, int H,
                            int group, float scale, int causal) {
  using T = Tile<HD>;
  using C = Consumer<HD>;
  constexpr int BKV = T::BKV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_smem = base;                        // [HALVES][BQ][64]
  const uint32_t k_smem = base + T::Q_BYTES;           // [STAGES][HALVES]
  const uint32_t v_smem = k_smem + STAGES * T::KV_BYTES;   // [BKV][64]
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t full = q_full + 8;                    // [STAGES]
  const uint32_t empty = full + 8 * STAGES;            // [STAGES]

  // blocks start in the order of their linear index, x fastest: every
  // head's heaviest causal q tile first
  const int n_q = (S + BQ - 1) / BQ;
  const int qtile = n_q - 1 - (int)blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = qtile * BQ;
  int n_kv = (S + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, min(q0 + BQ - 1, S - 1) / BKV + 1);

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int hf = 0; hf < T::HALVES; ++hf)
        tma_load(q_smem + hf * BQ * ROW_BYTES, &map_q, q_full, hf * 64, h,
                 q0, b);
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * T::KV_BYTES);
        for (int hf = 0; hf < T::HALVES; ++hf) {
          const uint32_t off = st * T::KV_BYTES + hf * BKV * ROW_BYTES;
          tma_load(k_smem + off, &map_k, bar, hf * 64, kvh, i * BKV, b);
          tma_load(v_smem + off, &map_v, bar, hf * 64, kvh, i * BKV, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row_first = q0 + wg * 64;
    // the last kv tile this warpgroup's rows can see; later tiles are
    // only waited for and released
    int n_kv_wg = n_kv;
    if (causal) n_kv_wg = min(n_kv, min(row_first + 63, S - 1) / BKV + 1);
    const uint32_t q_wg = q_smem + wg * 64 * ROW_BYTES;
    const float c = __fmul_rn(scale, 1.4426950408889634f);     // log2(e)
    auto k_tile = [&](int i) { return k_smem + (i % STAGES) * T::KV_BYTES; };
    auto v_tile = [&](int i) { return v_smem + (i % STAGES) * T::KV_BYTES; };
    auto edge = [&](int i) {
      return (i + 1) * BKV > S || (causal && (i + 1) * BKV - 1 > row_first);
    };

    float o[T::HALVES][32];
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hf][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, corr[2];
    float s[C::NS];
    uint32_t p_hi[C::KSTEPS][4], p_lo[C::KSTEPS][4];

    // Software pipeline: tile i's q.k runs on the tensor cores, then tile
    // i-1's p.v under tile i's softmax. Tile i-1's stage is released once
    // its p.v is done, so the ring holds tiles i-1, i and the load of i+1.
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    wgmma_fence();
    C::issue_qk(s, q_wg, k_tile(0));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);
    C::softmax(s, m, l, corr, 0, r0, c0, edge(0), S, causal, c);
    C::split(s, p_hi, p_lo);
    for (int i = 1; i < n_kv_wg; ++i) {
      mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
#pragma unroll
      for (int hf = 0; hf < T::HALVES; ++hf) reg_fence(o[hf]);
      wgmma_fence();
      C::issue_qk(s, q_wg, k_tile(i));
      wgmma_commit();
      C::issue_pv(o, p_hi, p_lo, v_tile(i - 1));
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      reg_fence(s);
      C::softmax(s, m, l, corr, i * BKV, r0, c0, edge(i), S, causal,
                 c);
      // the softmax, in PTX before the wait (the fences), and two code
      // paths behind a branch (edge or not) that ptxas does not schedule
      // across, so it runs under the p.v wgmmas
      reg_fence(s);
      reg_fence(corr);
      reg_fence(l);
      wgmma_wait_all();
      reg_fence(p_hi);          // read by the p.v wgmmas until here
      reg_fence(p_lo);
#pragma unroll
      for (int hf = 0; hf < T::HALVES; ++hf) reg_fence(o[hf]);
      mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      C::rescale(o, corr);
      C::split(s, p_hi, p_lo);
    }
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf) reg_fence(o[hf]);
    wgmma_fence();
    C::issue_pv(o, p_hi, p_lo, v_tile(n_kv_wg - 1));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(p_hi);
    reg_fence(p_lo);
#pragma unroll
    for (int hf = 0; hf < T::HALVES; ++hf) reg_fence(o[hf]);
    mbar_arrive(empty + 8 * ((n_kv_wg - 1) % STAGES));
    for (int i = n_kv_wg; i < n_kv; ++i) {
      mbar_wait(full + 8 * (i % STAGES), (i / STAGES) & 1);
      mbar_arrive(empty + 8 * (i % STAGES));
    }

    // out = acc / max(l, 1e-30), rounded once to bf16; ragged rows skipped
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = r0 + 8 * ri;
      if (qi >= S) continue;
      const float den = fmaxf(l[ri], 1e-30f);
      __nv_bfloat16* orow = out + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
      for (int hf = 0; hf < T::HALVES; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + hf * 64 + 8 * j + c0) =
              __floats2bfloat162_rn(
                  __fdiv_rn(o[hf][4 * j + 2 * ri], den),
                  __fdiv_rn(o[hf][4 * j + 2 * ri + 1], den));
    }
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the build
// links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled find_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

EncodeTiled encoder() {
  static const EncodeTiled fn = find_encoder();    // looked up once
  return fn;
}

// a 4-D map over a contiguous (B, S, heads, hd) bf16 tensor, in TMA's
// order (hd, heads, S, B), read in boxes of (64, 1, rows, 1)
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                int S, int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int KV, float scale, int causal,
                void* stream) {
  using T = Tile<HD>;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_q, map_k, map_v;
  CUresult res = encode(fn, &map_q, q, B, S, H, HD, BQ);
  if (res == CUDA_SUCCESS) res = encode(fn, &map_k, k, B, S, KV, HD, T::BKV);
  if (res == CUDA_SUCCESS) res = encode(fn, &map_v, v, B, S, KV, HD, T::BKV);
  if (res != CUDA_SUCCESS) return (int)res;
  auto kern = flash_attention_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, T::SMEM, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)out, S, H, H / KV, scale,
      causal);
  return (int)cudaGetLastError();
}

// the checks both types share; 0 when there is nothing to launch, -1 to
// launch
int check(int B, int S, int H, int KV) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return -1;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out,
                                   int B, int S, int H, int KV, int hd,
                                   float scale, int causal, void* stream) {
  const int c = check(B, S, H, KV);
  if (c >= 0) return c;
  if (hd == 64)
    return launch_f32<64>(q, k, v, out, B, S, H, KV, scale, causal, stream);
  if (hd == 128)
    return launch_f32<128>(q, k, v, out, B, S, H, KV, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out,
                                    int B, int S, int H, int KV, int hd,
                                    float scale, int causal, void* stream) {
  const int c = check(B, S, H, KV);
  if (c >= 0) return c;
  if (hd == 64)
    return launch_bf16<64>(q, k, v, out, B, S, H, KV, scale, causal, stream);
  if (hd == 128)
    return launch_bf16<128>(q, k, v, out, B, S, H, KV, scale, causal,
                            stream);
  return (int)cudaErrorInvalidValue;
}
