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
// tensor cores, against 0.020 ms for the bytes at 3.35 TB/s. In f32 the
// same work as 3xTF32 is 3 x 34.4 GFLOP at the 495 TFLOP/s of the TF32
// tensor cores, 0.208 ms (0.513 ms at the CUDA cores' 67 TFLOP/s).
//
// Two kernels, both on Hopper's tensor cores with the same frame: one block
// of 384 threads per (b*H+h, 128-row q tile), every head's heaviest causal
// tile launched first. Warpgroups 0 and 1 are consumers, 64 q rows each;
// warpgroup 2 is the producer, which gives registers up to them
// (setmaxnreg works per warpgroup). Per kv tile, each consumer warpgroup
// runs s = q.k^T on `wgmma` with f32 accumulators, the mask, row max and
// sum over the 4 lanes sharing a row and the online softmax in registers,
// in base 2 (`online_softmax`: p = 2^(s * c - m) with c = scale * log2(e)
// and m the running max of s * c, corr = 2^(m_old - m_new), l = l * corr +
// the sum of the f32 p; one fma and one ex2.approx an element, where expf
// took ~9 instructions and set the pace), then p.v on `wgmma` with p from
// registers (the accumulator layout is the A fragment's, up to the order of
// columns). Only the kv tiles at or left of the diagonal are loaded when
// causal; the ragged edge is masked.
//
// f32 (`flash_attention_f32_kernel`): 3xTF32. Each f32 operand a is split
// into hi = tf32(a) and lo = tf32(a - hi), both rounded to nearest, ties
// away (cvt.rna.tf32.f32's rounding, on the bits), and a product is hi.hi +
// hi.lo + lo.hi on `wgmma.m64nNk8.f32.tf32.tf32` (the lo.lo term is below
// f32's precision; one tf32 product misses the 1e-5 check, which
// tests/test_torch_flash.py shows on an emulation of this kernel).
//  - tf32 `wgmma` takes no transpose and the split passes through
//    registers, so there is no TMA: the producer's 128 threads load q once
//    and, per kv tile, k and v from device memory (16-byte loads for q and
//    k, 4-byte ones for v, each warp's contiguous), split them and store
//    them K-major under the 128-byte swizzle: q_hi and q_lo, and per set
//    k_hi, k_lo and v^T's hi and lo. v^T's rows are stored in the order the
//    p fragments hold the kv columns (`F32Consumer::split_p`), so p goes
//    from the q.k accumulators to the p.v A fragments with no shuffle.
//  - k and v^T have a full and an empty mbarrier each per set: the
//    producer stores tile i+1's k while the consumers run tile i's softmax
//    and p.v, and its v^T while they run tile i+1's q.k.
//  - The tensor cores truncate their sums (as dual_matmul.cu measures). So
//    q.k (q and k both from shared memory) runs each 32-deep chunk of hd
//    into fresh accumulators, added into s with __fadd_rn, and each kv
//    tile's p.v runs into fresh accumulators o_t that are folded into the
//    f32 totals as o = fma(o, corr, o_t), the online softmax's own rescale.
//  - Within a warpgroup a tile is serial: q.k, wait, softmax and split,
//    p.v, wait, fold. The two warpgroups take turns to issue their
//    products (named barriers), so one's softmax runs under the other's
//    products: 5-9% faster at hd 64, ~1% slower at hd 128
//    (benchmarks/torch_flash_variants.py, f32_no_turns).
//  - Tiles: 64 kv rows and two sets at hd 64 (q 64 KB + 2 x 64 KB of shared
//    memory); 32 kv rows and one set at hd 128 (q 128 KB + 64 KB). The
//    consumers hold s, p_hi, p_lo, o_t and o in registers (200 a thread at
//    hd 64, 208 at hd 128, after setmaxnreg; no spills).
//  - What bounds it (H100, benchmarks/torch_flash_variants.py): at the
//    vfl-zoo shape the products alone take ~63% of its time, and the
//    producer's loads, split and stores are the largest piece of the rest.
//
// bf16 (`flash_attention_bf16_kernel`): TMA, with the producer's first
// thread alone issuing the loads (24 registers a thread for the producer,
// 240 for the consumers). TMA reads 4-D tensor maps over (hd, heads, S, B)
// with boxes of (64, 1, rows, 1) under the 128-byte swizzle, so GQA is the
// kv-head coordinate, rows past S arrive as zeros (and are masked to -1e30
// in the scores), and hd 128 is two 64-column boxes. q is loaded once; k
// and v go through a ring of 3 stages with full/empty mbarriers. kv tiles
// are 128 rows at hd 64 and 64 rows at hd 128 (registers). Per kv tile,
// each consumer warpgroup:
//  - s = q.k^T (m64nBKVk16, both operands in shared memory); bf16 x bf16
//    products are exact in f32, so only the order of the f32 sums differs
//    from the plain version;
//  - the online softmax (above);
//  - acc *= corr, then acc += p_hi.v + p_lo.v on `wgmma` with p from
//    registers and v the shared-memory B operand read MN-major, where p_hi
//    = bf16(p) and p_lo = bf16(p - p_hi) (the subtraction is exact).
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
// Rounding: every f32 operation outside the tensor cores is an __f*_rn
// intrinsic or ex2.approx, and the tf32 and bf16 roundings are spelled out
// (built with --fmad=false too).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------- shared by both kernels --

constexpr int BQ = 128;           // q rows per block, 64 per consumer
constexpr int THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int ROW_BYTES = 128;    // one swizzled row: 64 bf16 or 32 f32

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
template <int M, int N>
__device__ __forceinline__ void reg_fence(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) reg_fence(r[i]);
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The mask, and the online-softmax update in base 2: s becomes p (f32), and
// l = l * corr + the row sum of that p. m is kept as max(s) * c with c =
// scale * log2(e) (an f32 constant), so p = 2^(s * c - m) is one fma and
// one ex2.approx, which is exp(s * scale - max(s * scale)) up to: the
// rounding of m, a factor common to a row's p's that cancels in acc / l;
// the roundings of c and of the fma, together at most ~2^-23 |s * c - m|
// in the exponent, so ~2^-23 ln2 |s * c - m| relative on p (p < 2^-23
// wherever that exceeds 2^-19); and ex2.approx's relative error, about
// 2^-22 (PTX ISA). Against the half bf16 ulp (2^-9 relative) that the
// bf16 element check allows each output, that is at most ~2^-10 of it;
// against the f32 check's 1e-5 of the largest output, ~1/40 of it.
// s[4j + 2i + e] is row r0 + 8i, kv column k0 + 8j + c0 + e (the wgmma
// accumulator layout); NS = kv columns / 2.
template <bool MASK, int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               int k0, int r0, int c0, int S,
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

// two code paths behind a branch (edge: the tile is ragged or crosses the
// diagonal), which ptxas does not schedule across
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int r0, int c0,
                                             bool edge, int S, int causal,
                                             float c) {
  if (edge)
    online_softmax<true>(s, m, l, corr, k0, r0, c0, S, causal, c);
  else
    online_softmax<false>(s, m, l, corr, k0, r0, c0, S, causal, c);
}

// ------------------------------ f32, 3xTF32 on the tensor cores (Hopper) --

template <int HD>
struct F32Tile {
  static constexpr int BKV = HD == 64 ? 64 : 32;    // kv rows per tile
  static constexpr int SETS = HD == 64 ? 2 : 1;     // k and v^T sets
  static constexpr int NS = BKV / 2;                // s registers a thread
  static constexpr int KSTEPS = BKV / 8;            // k8 steps of p.v
  static constexpr int NO = HD / 2;                 // o registers a thread
  // registers a thread after setmaxnreg (128 x producer + 256 x consumer =
  // the 64512 of 384 threads at 168): at hd 128 the consumers hold o and
  // o_t of 64 each, at hd 64 the producer gets the rest
  static constexpr int PRODUCER_REGS = HD == 64 ? 104 : 88;
  static constexpr int CONSUMER_REGS = HD == 64 ? 200 : 208;
  static constexpr int Q_BYTES = BQ * HD * 4;       // one of q_hi, q_lo
  static constexpr int OP_BYTES = BKV * HD * 4;     // k_hi, k_lo, vt_hi, vt_lo
  // q_hi and q_lo, then per set k_hi, k_lo, vt_hi, vt_lo, all 1024-aligned
  // (the swizzle's period); the mbarriers after: full and empty of k and of
  // v^T per set; 1024 bytes of slack to align the base
  static constexpr int BAR_OFF = 2 * Q_BYTES + SETS * 4 * OP_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 4 * SETS * 8;
};

// a = hi + lo to ~2^-22: hi = tf32(a), lo = tf32(a - hi), both rounded to
// nearest, ties away from zero (cvt.rna.tf32.f32's rounding, done on the
// bits with two integer operations); a - hi is exact in f32
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// The consumer warpgroups' turns: named barrier 1 + wg completes when
// warpgroup wg waits on it and the other warpgroup has passed it the turn
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");
}

// generic-proxy writes to shared memory visible to wgmma's (async) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// m64nNk8 with tf32 operands and f32 accumulators; accumulate = 0
// overwrites d. ss: A (64 x 8) and B (8 x N) from shared memory, both
// K-major. rs: A from registers, the m64k8 fragment a[i] = row r0 + 8 (i %
// 2), column t + 4 (i / 2); B from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The producer's work on a (rows, HD) operand that lies row-major with row
// stride `stride`: rows [row0, row0 + ROWS), zeros from row S on, split into
// tf32 hi and lo and stored K-major under the 128-byte swizzle, (r, d) at
// (d / 32) * ROWS * 128 + r * 128 + (((d % 32) / 4) ^ (r % 8)) * 16 + (d % 4)
// * 4. A thread takes 8 pieces of 16 bytes a batch, all 8 loaded before the
// first is split; eight consecutive threads store one 128-byte row
// (conflict-free), a warp reads whole rows, 512 bytes.
template <int HD, int ROWS>
struct Rows {
  static constexpr int PER_ROW = HD / 4;              // 16-byte pieces a row
  static constexpr int BATCHES = ROWS * PER_ROW / (128 * 8);
  static_assert(BATCHES * 128 * 8 == ROWS * PER_ROW, "rows do not divide");

  static __device__ __forceinline__ void load(float4 (&x)[8],
                                              const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, int pt, int batch) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = pt + 128 * (8 * batch + j);
      const int r = row0 + u / PER_ROW;
      x[j] = r < S ? __ldg(reinterpret_cast<const float4*>(
                         src + r * stride + 4 * (u % PER_ROW)))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  static __device__ __forceinline__ void store(const float4 (&x)[8],
                                               uint32_t hi, uint32_t lo,
                                               int pt, int batch) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = pt + 128 * (8 * batch + j);
      const int r = u / PER_ROW, c4 = u % PER_ROW;
      const uint32_t off = (c4 / 8) * ROWS * ROW_BYTES + r * ROW_BYTES +
                           (((c4 % 8) ^ (r % 8)) << 4);
      const float a[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], h[e], l[e]);
      st_shared_v4(hi + off, h);
      st_shared_v4(lo + off, l);
    }
  }
};

// The producer's work on v: kv rows [row0, row0 + BKV), zeros from row S
// on, as v^T (tf32 `wgmma` takes no transpose), split and stored K-major
// under the swizzle, with each k8 step's kv rows in the order the p
// fragments hold them: fragment column c is kv 2c for c < 4 and kv 2(c - 4)
// + 1 for c >= 4 (see F32Consumer::split_p). So (n, kv 8j + e) lies at (j /
// 4) * HD * 128 + n * 128 + ((2 (j % 4) + e % 2) ^ (n % 8)) * 16 + (e / 2) *
// 4. A thread takes one column n and 4 k8 steps, 32 loads of 4 bytes (a
// warp's are 128 contiguous bytes); eight consecutive threads store eight
// rows n (conflict-free).
template <int HD, int BKV>
struct VT {
  static constexpr int G = 128 / HD;                  // threads per column
  static_assert(BKV / 8 == 4 * G, "a thread takes 4 k8 steps");

  static __device__ __forceinline__ void load(float (&x)[32],
                                              const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, int pt) {
    const int n = pt % HD, j0 = pt / HD;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = row0 + 8 * (j0 + G * a) + e;
        x[8 * a + e] = r < S ? __ldg(src + r * stride + n) : 0.0f;
      }
  }

  static __device__ __forceinline__ void store(const float (&x)[32],
                                               uint32_t hi, uint32_t lo,
                                               int pt) {
    const int n = pt % HD, j0 = pt / HD;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + G * a;
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const uint32_t off = (j / 4) * HD * ROW_BYTES + n * ROW_BYTES +
                             (((2 * (j % 4) + odd) ^ (n % 8)) << 4);
        uint32_t h[4], l[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split(x[8 * a + 2 * c + odd], h[c], l[c]);
        st_shared_v4(hi + off, h);
        st_shared_v4(lo + off, l);
      }
    }
  }
};

// What one consumer warpgroup computes with one kv tile, in the accumulator
// layout of the bf16 kernel: s[4j + 2i + e] is row r0 + 8i, kv column k0 +
// 8j + c0 + e; o and the tile's o_t likewise with hd columns.
template <int HD>
struct F32Consumer {
  using T = F32Tile<HD>;
  static constexpr int BKV = T::BKV, NS = T::NS, KSTEPS = T::KSTEPS,
                       NO = T::NO, CHUNKS = HD / 32;

  // s = q . k^T: q_hi.k_hi + q_hi.k_lo + q_lo.k_hi per k8 step of hd, each
  // 32-deep chunk of hd into fresh accumulators (the tensor cores truncate
  // their sums: one accumulator over hd 128 would spend half the f32 check's
  // 1e-5 at full attention, tests/test_torch_flash.py); `sum_chunks` adds
  // them into s in f32
  static __device__ __forceinline__ void issue_qk(float (&sc)[CHUNKS][NS],
                                                  uint32_t q_hi, uint32_t q_lo,
                                                  uint32_t k_hi,
                                                  uint32_t k_lo) {
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t byte = (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * BQ * ROW_BYTES + byte;
      const uint32_t ko = (kk / 4) * BKV * ROW_BYTES + byte;
      const uint64_t qh = sw128_desc(q_hi + qo), ql = sw128_desc(q_lo + qo);
      const uint64_t kh = sw128_desc(k_hi + ko), kl = sw128_desc(k_lo + ko);
      wgmma_tf32_ss(sc[kk / 4], qh, kh, kk % 4 > 0);
      wgmma_tf32_ss(sc[kk / 4], qh, kl, 1);
      wgmma_tf32_ss(sc[kk / 4], ql, kh, 1);
    }
  }

  static __device__ __forceinline__ void sum_chunks(float (&sc)[CHUNKS][NS]) {
#pragma unroll
    for (int ch = 1; ch < CHUNKS; ++ch)
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[0][i] = __fadd_rn(sc[0][i], sc[ch][i]);
  }

  // p, split into tf32 hi and lo, as the A fragments of the p.v k8 steps,
  // with no data moved between threads: a thread holds kv columns 2t and 2t
  // + 1 of each k8 step (t = lane % 4) where the fragment wants columns t
  // and t + 4, so fragment column t takes kv 2t and column t + 4 kv 2t + 1,
  // and v^T's rows are stored in that order (VT)
  static __device__ __forceinline__ void split_p(const float (&p)[NS],
                                                 uint32_t (&p_hi)[KSTEPS][4],
                                                 uint32_t (&p_lo)[KSTEPS][4]) {
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      const float a[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) split(a[r], p_hi[j][r], p_lo[j][r]);
    }
  }

  // o_t = p . v into fresh accumulators (a sum BKV deep): p_hi.v_hi +
  // p_hi.v_lo + p_lo.v_hi per k8 step of kv
  static __device__ __forceinline__ void issue_pv(
      float (&o_t)[NO], const uint32_t (&p_hi)[KSTEPS][4],
      const uint32_t (&p_lo)[KSTEPS][4], uint32_t vt_hi, uint32_t vt_lo) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk / 4) * HD * ROW_BYTES + (kk % 4) * 32;
      const uint64_t vh = sw128_desc(vt_hi + off), vl = sw128_desc(vt_lo + off);
      wgmma_tf32_rs(o_t, p_hi[kk], vh, kk > 0);
      wgmma_tf32_rs(o_t, p_hi[kk], vl, 1);
      wgmma_tf32_rs(o_t, p_lo[kk], vh, 1);
    }
  }

  // o = o * corr + o_t, one rounding: the online softmax's own rescale
  // takes the tile's sums into the f32 totals
  static __device__ __forceinline__ void fold(float (&o)[NO],
                                              const float (&corr)[2],
                                              const float (&o_t)[NO]) {
#pragma unroll
    for (int i = 0; i < NO; ++i)
      o[i] = __fmaf_rn(o[i], corr[(i / 2) % 2], o_t[i]);
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int H, int group,
                           float scale, int causal) {
  using T = F32Tile<HD>;
  using C = F32Consumer<HD>;
  constexpr int BKV = T::BKV, SETS = T::SETS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_hi = base, q_lo = base + T::Q_BYTES;
  const uint32_t bars = base + T::BAR_OFF;
  // operand w (0 k_hi, 1 k_lo, 2 vt_hi, 3 vt_lo) of kv tile i
  auto op = [&](int i, int w) {
    return base + 2 * T::Q_BYTES + ((i % SETS) * 4 + w) * T::OP_BYTES;
  };
  auto k_full = [&](int i) { return bars + 8 * (i % SETS); };
  auto v_full = [&](int i) { return bars + 8 * (SETS + i % SETS); };
  auto k_empty = [&](int i) { return bars + 8 * (2 * SETS + i % SETS); };
  auto v_empty = [&](int i) { return bars + 8 * (3 * SETS + i % SETS); };

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
    for (int st = 0; st < SETS; ++st) {
      mbar_init(k_full(st), 128);
      mbar_init(v_full(st), 128);
      mbar_init(k_empty(st), 256);
      mbar_init(v_empty(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: loads, splits and stores every operand ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 :: "n"(T::PRODUCER_REGS));
    const int pt = threadIdx.x - 256;
    // element strides of the contiguous (B, S, heads, HD) layouts
    const long long q_s = (long long)H * HD, kv_s = (long long)(H / group) * HD;
    const float* qb = q + (long long)b * S * q_s + h * HD;
    const float* kb = k + (long long)b * S * kv_s + kvh * HD;
    const float* vb = v + (long long)b * S * kv_s + kvh * HD;
    float4 x[8];
    // q once; the consumers see it with tile 0's k
#pragma unroll 1
    for (int batch = 0; batch < Rows<HD, BQ>::BATCHES; ++batch) {
      Rows<HD, BQ>::load(x, qb, q_s, q0, S, pt, batch);
      Rows<HD, BQ>::store(x, q_hi, q_lo, pt, batch);
    }
    // tile i's k goes into its set once both consumers are done with tile
    // i - SETS's q.k, its v^T once they are done with that tile's p.v; the
    // loads are issued before the waits
    for (int i = 0; i < n_kv; ++i) {
      const uint32_t parity = ((i / SETS) - 1) & 1;
      Rows<HD, BKV>::load(x, kb, kv_s, i * BKV, S, pt, 0);
      if (i >= SETS) mbar_wait(k_empty(i), parity);
      Rows<HD, BKV>::store(x, op(i, 0), op(i, 1), pt, 0);
      fence_proxy_async();
      mbar_arrive(k_full(i));
      float y[32];
      VT<HD, BKV>::load(y, vb, kv_s, i * BKV, S, pt);
      if (i >= SETS) mbar_wait(v_empty(i), parity);
      VT<HD, BKV>::store(y, op(i, 2), op(i, 3), pt);
      fence_proxy_async();
      mbar_arrive(v_full(i));
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(T::CONSUMER_REGS));
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const int row_first = q0 + wg * 64;
    // the last kv tile this warpgroup's rows can see; later tiles are only
    // waited for and released
    int n_kv_wg = n_kv;
    if (causal) n_kv_wg = min(n_kv, min(row_first + 63, S - 1) / BKV + 1);
    const uint32_t qh = q_hi + wg * 64 * ROW_BYTES;
    const uint32_t ql = q_lo + wg * 64 * ROW_BYTES;
    const float c = __fmul_rn(scale, 1.4426950408889634f);     // log2(e)
    auto edge = [&](int i) {
      return (i + 1) * BKV > S || (causal && (i + 1) * BKV - 1 > row_first);
    };

    float o[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) o[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, corr[2];
    // The two warpgroups take turns to issue their products, q.k and p.v
    // alike, warpgroup 0 first: each waits for its turn, issues, and passes
    // the turn on. So the tensor cores run one's products while the other
    // waits for its own q.k and runs its softmax. Past its own last tile a
    // warpgroup only takes and passes its turns, and releases the tiles;
    // warpgroup 1's last turn has no taker.
    if (wg == 1) turn_pass(wg);
    for (int i = 0; i < n_kv_wg; ++i) {
      const uint32_t parity = (i / SETS) & 1;
      float sc[C::CHUNKS][C::NS], o_t[C::NO];
      uint32_t p_hi[C::KSTEPS][4], p_lo[C::KSTEPS][4];
      mbar_wait(k_full(i), parity);
      turn_wait(wg);
      wgmma_fence();
      C::issue_qk(sc, qh, ql, op(i, 0), op(i, 1));
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      reg_fence(sc);
      mbar_arrive(k_empty(i));
      C::sum_chunks(sc);
      float (&s)[C::NS] = sc[0];
      softmax_step(s, m, l, corr, i * BKV, r0, c0, edge(i), S, causal, c);
      C::split_p(s, p_hi, p_lo);
      mbar_wait(v_full(i), parity);
      turn_wait(wg);
      wgmma_fence();
      C::issue_pv(o_t, p_hi, p_lo, op(i, 2), op(i, 3));
      wgmma_commit();
      if (wg == 0 || i + 1 < n_kv) turn_pass(wg);
      wgmma_wait_all();
      reg_fence(o_t);
      reg_fence(p_hi);          // read by the p.v wgmmas until here
      reg_fence(p_lo);
      mbar_arrive(v_empty(i));
      C::fold(o, corr, o_t);
    }
    for (int i = n_kv_wg; i < n_kv; ++i) {
      const uint32_t parity = (i / SETS) & 1;
      mbar_wait(k_full(i), parity);
      turn_wait(wg);
      turn_pass(wg);
      mbar_arrive(k_empty(i));
      mbar_wait(v_full(i), parity);
      turn_wait(wg);
      if (wg == 0 || i + 1 < n_kv) turn_pass(wg);
      mbar_arrive(v_empty(i));
    }

    // out = o / max(l, 1e-30); ragged rows skipped
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int qi = r0 + 8 * ri;
      if (qi >= S) continue;
      const float den = fmaxf(l[ri], 1e-30f);
      float* orow = out + (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + c0) =
            make_float2(__fdiv_rn(o[4 * j + 2 * ri], den),
                        __fdiv_rn(o[4 * j + 2 * ri + 1], den));
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int S, int H, int KV, float scale, int causal,
               void* stream) {
  using T = F32Tile<HD>;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  auto kern = flash_attention_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, T::SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, H,
      H / KV, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------ bf16, on the tensor cores (Hopper) --

constexpr int STAGES = 3;         // the k/v ring

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

  // the mask and the online softmax (online_softmax)
  static __device__ __forceinline__ void softmax(float (&s)[NS], float (&m)[2],
                                                 float (&l)[2],
                                                 float (&corr)[2], int k0,
                                                 int r0, int c0, bool edge,
                                                 int S, int causal, float c) {
    softmax_step(s, m, l, corr, k0, r0, c0, edge, S, causal, c);
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
