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
// f32 (`flash_attention_bwd_f32_*`): the same two passes on Hopper's tensor
// cores as 3xTF32, in the frame of the bf16 backward below and with the
// arithmetic of the f32 forward (csrc/flash_attention.cu). The same records
// (a (B, H, S, 4) f32 scratch from the wrapper) carry -lse log2(e), D and
// each q row's position from the dq pass to the dk/dv pass. At the lm shape
// in f32 the 5 products take 0.521 ms as 3xTF32 at 495 TFLOP/s (1.28 ms at
// the CUDA cores' 67 TFLOP/s).
//  1. Splitting. Each f32 operand value a becomes hi = tf32(a) and lo =
//     tf32(a - hi), rounded as cvt.rna rounds (hopper.cuh `split`); each
//     product is hi.hi + hi.lo + lo.hi on `wgmma.m64nNk8.f32.tf32.tf32`,
//     lo.lo dropped. One tf32 product misses the 1e-4 check by 6-10x
//     (tests/test_torch_flash_grad_f32.py).
//  2. Operand layout. tf32 `wgmma` takes K-major operands only. The dq pass
//     runs s = q.k^T and dp = dO.v^T on q, k, dO and v as stored (`Rows`),
//     and dq += ds.k on k^T (`Cols`); the dk/dv pass runs s^T = k.q^T and
//     dp^T = v.dO^T as stored, dv += p^T.dO on dO^T and dk += ds^T.q on
//     q^T. ds, p^T and ds^T go from the accumulators to register A
//     fragments with no trip through shared memory (`split_frags`): each
//     transposed operand stores the rows of each k8 step in the order the
//     fragments hold the accumulator's columns, as the forward stores v^T.
//  3. Truncating sums. The tensor cores truncate their sums, so s, dp, s^T
//     and dp^T run each 32-deep chunk of hd into fresh accumulators, added
//     with __fadd_rn; each tile's second-stage products (dq over a kv tile,
//     dv and dk over a q tile) run into fresh accumulators added into the
//     f32 totals with __fadd_rn. The CPU emulation keeps every gradient
//     within 3.1e-6 of its largest (32x inside 1e-4); one accumulator over
//     a kv head's q tiles spends more than a quarter of it (5.3e-5 at 4096
//     rows, hd 128).
//  4. Shared memory. Every operand is held split, hi and lo, so a 64-row
//     tile at hd 64 takes 32 KB. The producer splits in registers, so there
//     is no pre-pass and no extra launch; the budget is met with narrower
//     tiles where it must be:
//     - dq pass: q and dO of the block's rows stay (128 KB); one set of k,
//       v and k^T (96 KB) with its own full and empty mbarriers each, so
//       the producer stores tile i + 1's k and v while the consumers finish
//       tile i. hd 64: two consumer warpgroups, 128 q rows, 64-row kv
//       tiles; hd 128: one consumer warpgroup, 64 q rows, 32-row kv tiles.
//       225 KB either way.
//     - dk/dv pass: 64 kv rows a block, k and v held split (64 KB at hd
//       64, 128 at hd 128) for one consumer warpgroup, which takes the q
//       tiles of each query head in turn through one slot of q and dO (set
//       A) and q^T and dO^T (set B), released apart, so the next tile's set
//       A refills while a tile's second stage runs. hd 64: 32-row q tiles
//       and two raw stages (below), 162 KB; hd 128: 16-row q tiles (q^T
//       half fills its rows), 225 KB. 64-row blocks keep the positions
//       shape's dk/dv grid at 128 blocks. A second consumer warpgroup at hd
//       64, sharing k and v and taking every other q tile, was no faster
//       (the producer's loads set the pace, item 5).
//  5. The producer. One warpgroup loads (16-byte loads for the row layout,
//     4-byte ones, a warp's 128 contiguous bytes, for the transposed one),
//     splits each value with two integer operations and a subtraction, and
//     stores conflict-free; each operand's loads are issued before it waits
//     for a buffer. In the dk/dv pass it has a q tile's q and dO to split
//     twice, both layouts, per 7 tile products, and there its loads set the
//     pace. So at hd 64 it stages each tile's q and dO rows raw, by
//     cp.async a tile ahead into one of two stages, and splits both layouts
//     from shared memory; the records come a tile ahead in registers
//     (benchmarks/torch_flash_bwd_variants.py times it against
//     f32_no_staging).
//  6. Registers. The dq pass's block at hd 64 is compiled at 168 a thread;
//     setmaxnreg gives its two consumer warpgroups 216 of what the producer
//     gives up (it keeps 72, and loads in batches that fit); one consumer
//     warpgroup (the dq pass at hd 128, the dk/dv pass) has the 255 of a
//     256-thread block. The dq pass runs s and then dp (both in flight
//     would not fit beside dq at hd 64); the dk/dv pass runs dv's and dk's
//     second-stage products one after the other into one set of fresh
//     accumulators (at hd 128 dk and dv hold 64 each). Descriptors are
//     formed as they are issued. The build shows 0 spill bytes. Every f32
//     operation outside the tensor cores is an __f*_rn intrinsic or
//     ex2.approx (built with --fmad=false too).
//  Masks and rows past S as in bf16: the causal index mask skips whole
//  tiles and masks the diagonal ones in their own loops, positions mask
//  every tile, a key past S is masked in the dq pass, a q row past S
//  contributes nothing (zeros and a record of zeros), a row that saw no key
//  has p = 0 and p^T + 1/S.
//  Tried on the H100 and not kept: a second consumer warpgroup in the
//  dk/dv pass at hd 64 (item 4), with producer warps of its own for each
//  warpgroup's slot (spilled, slower), the tiles of a head in the grid's x
//  (slower dq pass), all of a tile's loads before the producer's first
//  wait (no faster).
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

// ------------------------------ f32, 3xTF32 on the tensor cores (Hopper) --

namespace tf32 {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;

// ROWS rows from row0 of an operand that lies row-major in device memory
// (HD floats a row, rows `stride` floats apart), zeros from row S on,
// split and stored K-major under the 128-byte swizzle for a product over
// hd, lo BYTES after hi: (r, d) at (d / 32) * ROWS * 128 + r * 128 + (((d
// % 32) / 4) ^ (r % 8)) * 16 + (d % 4) * 4. A thread takes PIECES pieces
// of 16 bytes, in batches of up to MAX_BATCH all loaded before the first is
// split; eight consecutive threads store one 128-byte row (conflict-free).
template <int HD, int ROWS, int MAX_BATCH = 8>
struct Rows {
  static constexpr int PER_ROW = HD / 4;              // 16-byte pieces a row
  static constexpr int PIECES = ROWS * PER_ROW / 128;
  static constexpr int BATCH = PIECES < MAX_BATCH ? PIECES : MAX_BATCH;
  static constexpr int BATCHES = PIECES / BATCH;
  static constexpr int BYTES = ROWS * HD * 4;         // one of hi, lo
  static_assert(BATCHES * BATCH * 128 == ROWS * PER_ROW,
                "rows do not divide");

  static __device__ __forceinline__ void load(float4 (&x)[BATCH],
                                              const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, int pt, int batch) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int u = pt + 128 * (BATCH * batch + j);
      const int r = row0 + u / PER_ROW;
      x[j] = r < S ? __ldg(reinterpret_cast<const float4*>(
                         src + r * stride + 4 * (u % PER_ROW)))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // the same pieces from ROWS rows staged as they lie (HD floats a row)
  // in shared memory at raw
  static __device__ __forceinline__ void load_shared(float4 (&x)[BATCH],
                                                     uint32_t raw, int pt,
                                                     int batch) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      x[j] = lds_f4(raw + 16 * (pt + 128 * (BATCH * batch + j)));
  }

  static __device__ __forceinline__ void store(const float4 (&x)[BATCH],
                                               uint32_t hi, int pt,
                                               int batch) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int u = pt + 128 * (BATCH * batch + j);
      const int r = u / PER_ROW, c4 = u % PER_ROW;
      const uint32_t off = (c4 / 8) * ROWS * ROW_BYTES + r * ROW_BYTES +
                           (((c4 % 8) ^ (r % 8)) << 4);
      const float a[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], h[e], l[e]);
      st_shared_v4(hi + off, h);
      st_shared_v4(hi + BYTES + off, l);
    }
  }

  // every batch, loaded and stored; wait() runs before the first store
  template <typename Wait>
  static __device__ __forceinline__ void copy(const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, uint32_t hi, int pt,
                                              Wait wait) {
    float4 x[BATCH];
#pragma unroll 1
    for (int batch = 0; batch < BATCHES; ++batch) {
      load(x, src, stride, row0, S, pt, batch);
      if (batch == 0) wait();
      store(x, hi, pt, batch);
    }
  }
};

// The transpose, (HD, ROWS), of ROWS rows from row0 of such an operand,
// zeros from row S on, split and stored K-major under the swizzle for a
// product over the rows (tf32 wgmma takes no transpose), lo BYTES after
// hi. Each k8 step's rows lie in the order in which split_frags hands an
// accumulator's columns to the A fragments: fragment column c holds row 2c
// for c < 4 and 2 (c - 4) + 1 for c >= 4. So (n, row 8j + e) lies at (j /
// 4) * HD * 128 + n * 128 + ((2 (j % 4) + e % 2) ^ (n % 8)) * 16 + (e / 2)
// * 4; under 32 rows half of each 128-byte row is unused. A thread takes
// one column n and STEPS k8 steps, 8 STEPS loads of 4 bytes (a warp's are
// 128 contiguous bytes); eight consecutive threads store eight rows n
// (conflict-free).
template <int HD, int ROWS, int MAX_PART = 4>
struct Cols {
  static constexpr int G = 128 / HD;                  // threads a column
  static constexpr int STEPS = ROWS / 8 / G;          // k8 steps a thread
  static constexpr int BYTES = (ROWS < 32 ? 32 : ROWS) * HD * 4;
  static_assert(STEPS >= 1 && STEPS * G * 8 == ROWS, "rows do not divide");

  // k8 steps [a0, a0 + PART) of the thread's
  template <int PART>
  static __device__ __forceinline__ void load(float (&x)[8 * PART],
                                              const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, int pt, int a0 = 0) {
    const int n = pt % HD, j0 = pt / HD;
#pragma unroll
    for (int a = 0; a < PART; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = row0 + 8 * (j0 + G * (a0 + a)) + e;
        x[8 * a + e] = r < S ? __ldg(src + r * stride + n) : 0.0f;
      }
  }

  // the same values from ROWS rows staged as they lie (HD floats a row) in
  // shared memory at raw: a warp reads 32 consecutive floats of a row
  template <int PART>
  static __device__ __forceinline__ void load_shared(float (&x)[8 * PART],
                                                     uint32_t raw, int pt,
                                                     int a0 = 0) {
    const int n = pt % HD, j0 = pt / HD;
#pragma unroll
    for (int a = 0; a < PART; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = 8 * (j0 + G * (a0 + a)) + e;
        x[8 * a + e] = lds_f32(raw + 4 * (r * HD + n));
      }
  }

  template <int PART>
  static __device__ __forceinline__ void store(const float (&x)[8 * PART],
                                               uint32_t hi, int pt,
                                               int a0 = 0) {
    const int n = pt % HD, j0 = pt / HD;
#pragma unroll
    for (int a = 0; a < PART; ++a) {
      const int j = j0 + G * (a0 + a);
#pragma unroll
      for (int odd = 0; odd < 2; ++odd) {
        const uint32_t off = (j / 4) * HD * ROW_BYTES + n * ROW_BYTES +
                             (((2 * (j % 4) + odd) ^ (n % 8)) << 4);
        uint32_t h[4], l[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split(x[8 * a + 2 * c + odd], h[c], l[c]);
        st_shared_v4(hi + off, h);
        st_shared_v4(hi + BYTES + off, l);
      }
    }
  }

  // every k8 step, up to MAX_PART at a time; wait() runs before the first
  // store
  template <typename Wait>
  static __device__ __forceinline__ void copy(const float* __restrict__ src,
                                              long long stride, int row0,
                                              int S, uint32_t hi, int pt,
                                              Wait wait) {
    constexpr int PART = STEPS < MAX_PART ? STEPS : MAX_PART;
    float x[8 * PART];
#pragma unroll 1
    for (int a0 = 0; a0 < STEPS; a0 += PART) {
      load<PART>(x, src, stride, row0, S, pt, a0);
      if (a0 == 0) wait();
      store<PART>(x, hi, pt, a0);
    }
  }
};

// sc[ch] = A . B^T over hd chunk ch (32 columns), 3xTF32 (hi.hi + hi.lo +
// lo.hi each k8 step), each chunk into fresh accumulators: the tensor cores
// truncate their sums. A: the 64 rows at a of a Rows tile of A_ROWS rows,
// its lo A_LO bytes on; B: a Rows tile of N rows at b, its lo B_LO bytes
// on. Each step's descriptors are the previous ones plus the step's offset
// (in 16-byte units), made opaque after each step, so they are formed as
// they are issued and never held all at once.
template <int HD, int A_ROWS, int N, int A_LO, int B_LO>
__device__ __forceinline__ void issue_over_hd(float (&sc)[HD / 32][N / 2],
                                              uint32_t a, uint32_t b) {
  uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    wgmma_tf32_ss(sc[kk / 4], da, db, kk % 4 > 0);
    wgmma_tf32_ss(sc[kk / 4], da, db + (B_LO >> 4), 1);
    wgmma_tf32_ss(sc[kk / 4], da + (A_LO >> 4), db, 1);
    // the next 32 bytes of the row, or the next 32-column chunk
    da += kk % 4 < 3 ? 2 : (A_ROWS * ROW_BYTES - 3 * 32) >> 4;
    db += kk % 4 < 3 ? 2 : (N * ROW_BYTES - 3 * 32) >> 4;
    opaque(da);
    opaque(db);
  }
}

// sc[0] = the sum of the chunks, in f32
template <int CH, int NS>
__device__ __forceinline__ void sum_chunks(float (&sc)[CH][NS]) {
#pragma unroll
  for (int ch = 1; ch < CH; ++ch)
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[0][i] = __fadd_rn(sc[0][i], sc[ch][i]);
}

// An accumulator (x[4j + 2i + e]: row r0 + 8i, column 8j + c0 + e) as the
// tf32 hi and lo A fragments of a product over its columns, with no data
// moved between threads: a thread holds columns 2t and 2t + 1 of each k8
// step (t = lane % 4) where the fragment wants t and t + 4, so fragment
// column t takes column 2t and t + 4 column 2t + 1, the order in which
// Cols stores the other operand's rows
template <int NS>
__device__ __forceinline__ void split_frags(const float (&x)[NS],
                                            uint32_t (&hi)[NS / 4][4],
                                            uint32_t (&lo)[NS / 4][4]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float a[4] = {x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) split(a[r], hi[j][r], lo[j][r]);
  }
}

// acc = A . B into fresh accumulators over 8 KSTEPS rows of k, 3xTF32: A
// the hi and lo fragments; B a Cols tile of N columns at b, its lo B_LO
// bytes on, k8 step kk at (kk / 4) * N * 128 + (kk % 4) * 32; descriptors
// formed as they are issued (issue_over_hd)
template <int N, int KSTEPS, int B_LO>
__device__ __forceinline__ void issue_frags(float (&acc)[N / 2],
                                            const uint32_t (&ah)[KSTEPS][4],
                                            const uint32_t (&al)[KSTEPS][4],
                                            uint32_t b) {
  uint64_t db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    wgmma_tf32_rs(acc, ah[kk], db, kk > 0);
    wgmma_tf32_rs(acc, ah[kk], db + (B_LO >> 4), 1);
    wgmma_tf32_rs(acc, al[kk], db, 1);
    db += kk % 4 < 3 ? 2 : (N * ROW_BYTES - 3 * 32) >> 4;
    opaque(db);
  }
}

// D_i = dO_i . o_i in f32 for a warp's 16 rows from row0 (element offset
// at, rows stride apart), one row at a time: a lane multiplies hd / 32
// pairs, a butterfly sums them over the warp; a thread keeps those of its
// rows row0 + lane / 4 and + 8. Zero past S.
template <int HD>
__device__ __forceinline__ void row_dots(float (&D)[2],
                                         const float* __restrict__ o,
                                         const float* __restrict__ dO,
                                         long long at, long long stride,
                                         int row0, int S, int lane) {
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    float acc = 0.0f;
    if (row0 + rr < S) {
      const long long e = at + rr * stride + lane;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        acc = __fmaf_rn(__ldg(o + e + 32 * c), __ldg(dO + e + 32 * c), acc);
    }
#pragma unroll
    for (int w = 16; w >= 1; w /= 2)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, w));
    if (rr % 8 == lane / 4) D[rr / 8] = acc;
  }
}

// rows r0 and r0 + 8 of an accumulator over hd, times mul, to rows at out
// + row * stride; rows past S skipped
template <int NO>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           long long stride,
                                           const float (&acc)[NO], float mul,
                                           int r0, int c0, int S) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + 8 * ri;
    if (row >= S) continue;
    float* orow = out + row * stride;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + c0) =
          make_float2(__fmul_rn(acc[4 * j + 2 * ri], mul),
                      __fmul_rn(acc[4 * j + 2 * ri + 1], mul));
  }
}

// dq pass: BQ q rows a block, 64 a consumer warpgroup; kv tiles of BKV rows
// through one set of k, v and k^T, each with a full and an empty mbarrier
template <int HD>
struct DqF32 {
  static constexpr int NWG = HD == 64 ? 2 : 1;        // 64 q rows each
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int BQ = 64 * NWG, BKV = HD == 64 ? 64 : 32;
  static constexpr int NS = BKV / 2, NO = HD / 2, KSTEPS = BKV / 8;
  // the producer loads in pieces that fit its 72 registers beside two
  // consumer warpgroups, in larger ones beside one
  using QRows = Rows<HD, BQ, NWG == 2 ? 4 : 8>;
  using KRows = Rows<HD, BKV, NWG == 2 ? 4 : 8>;
  using KCols = Cols<HD, BKV, NWG == 2 ? 2 : 4>;
  // q, dO, k, v (hi then lo each), k^T, all 1024-aligned (the swizzle's
  // period); 7 mbarriers after; 1024 bytes of slack to align the base
  static constexpr int DO = 2 * QRows::BYTES, K = 2 * DO;
  static constexpr int V = K + 2 * KRows::BYTES, KT = V + 2 * KRows::BYTES;
  static constexpr int BAR_OFF = KT + 2 * KCols::BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 7 * 8;
  // registers a thread after setmaxnreg, two consumer warpgroups only
  // (the block is compiled at 168: the consumers take what the producer
  // gives up)
  static constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
  static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * 168,
                "setmaxnreg.inc would wait for registers no one gives up");
};

// dk/dv pass: 64 kv rows a block, held by its one consumer warpgroup,
// which takes the q tiles (BQ rows) of each query head in turn through one
// slot: set A (q, dO) and set B (q^T, dO^T, the q rows' records), each
// with a full and an empty mbarrier
template <int HD>
struct KvF32 {
  static constexpr int THREADS = 256;
  static constexpr int BKV = 64, BQ = HD == 64 ? 32 : 16;
  static constexpr int NS = BQ / 2, NO = HD / 2, KSTEPS = BQ / 8;
  using KRows = Rows<HD, BKV>;
  using QRows = Rows<HD, BQ>;
  using QCols = Cols<HD, BQ>;
  static_assert(QRows::BATCHES == 1, "a q tile loads in one batch");
  // at hd 64 the producer stages each q tile's q and dO rows as they lie,
  // two tiles deep, by cp.async, and splits them from there: their loads
  // fly while it splits the tile before (at hd 128 there is no room)
  static constexpr bool STAGED = HD == 64;
  // k, v (hi then lo each), then the slot (q, dO, q^T, dO^T, hi then lo
  // each), all 1024-aligned; the raw stages; the slot's records (BQ rows
  // of 16 bytes); 5 mbarriers
  static constexpr int V = 2 * KRows::BYTES, SLOTS = 2 * V;
  static constexpr int DO = 2 * QRows::BYTES, QT = 2 * DO;
  static constexpr int DOT = QT + 2 * QCols::BYTES;
  static constexpr int SLOT_BYTES = DOT + 2 * QCols::BYTES;
  static constexpr int RAW = SLOTS + SLOT_BYTES;
  static constexpr int RAW_OP = BQ * HD * 4;           // one of q, dO
  static constexpr int RAW_BYTES = STAGED ? 2 * RAW_OP : 0;
  static constexpr int RECS = RAW + 2 * RAW_BYTES;
  static constexpr int BAR_OFF = RECS + BQ * 16;
  static constexpr int SMEM = 1024 + BAR_OFF + 5 * 8;
};

// ds of one kv tile in the dq pass, in place of s: p = 2^(s c + off) (0
// for a row that saw no key or lies past S: off = -inf), ds = p (dp - D).
// MASK: a key past S, or (causal) one the row does not see, gets p = 0.
template <bool MASK, bool POS, int NS>
__device__ __forceinline__ void dq_scores(float (&s)[NS], const float (&dp)[NS],
                                          const float (&off)[2],
                                          const float (&D)[2], float c,
                                          int k0, int r0, int c0, int S,
                                          int causal,
                                          const int* __restrict__ kvpos,
                                          const int (&qp)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    int kp[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kv = k0 + 8 * j + c0 + e;
      if (MASK && POS) kp[e] = kv < S ? __ldg(kvpos + kv) : 0;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
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
        s[x] = __fmul_rn(p, __fsub_rn(dp[x], D[ri]));
      }
  }
}

// p^T + b and ds^T of one q tile in the dk/dv pass, in place of s^T and
// dp^T: kv row r0 + 8i against q row q0 + col, col = 8j + c0 + e, whose
// record (off, D, q position) lies at rec + 16 col; b = 1/S for a row that
// saw no key (off = -inf), whose record holds 1/S in place of D, else 0. A
// q row past S has a record of zeros and q and dO rows of zeros: p = 1
// against dO = 0, and ds = 0. MASK (causal): a kv row the q row does not
// see gets p = 0.
template <bool MASK, bool POS, int NS>
__device__ __forceinline__ void kv_scores(float (&st)[NS], float (&dpt)[NS],
                                          uint32_t rec, float c, int q0,
                                          int r0, int c0,
                                          const int (&kp)[2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    float2 r[2];          // (off, D)
    int qpos[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r[e] = lds_f2(rec + 16 * (8 * j + c0 + e));
      if (MASK && POS) qpos[e] = lds_s32(rec + 16 * (8 * j + c0 + e) + 8);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * ri + e, col = 8 * j + c0 + e;
        float pe = ex2(__fmaf_rn(st[x], c, r[e].x));
        if (MASK)
          pe = (POS ? kp[ri] <= qpos[e] : r0 + 8 * ri <= q0 + col) ? pe
                                                                  : 0.0f;
        dpt[x] = __fmul_rn(pe, __fsub_rn(dpt[x], r[e].y));
        st[x] = __fadd_rn(pe, __float_as_uint(r[e].x) == 0xff800000u ? r[e].y
                                                                     : 0.0f);
      }
  }
}

// One kv tile of the dq pass for one consumer warpgroup; bars: the full and
// empty mbarriers of k, v and k^T, 8 bytes apart
template <int HD, bool MASK, bool POS>
__device__ __forceinline__ void dq_tile(float (&acc)[HD / 2], uint32_t q_wg,
                                        uint32_t do_wg, uint32_t k_s,
                                        uint32_t v_s, uint32_t kt_s,
                                        uint32_t bars, int i,
                                        const float (&off)[2],
                                        const float (&D)[2], float c, int r0,
                                        int c0, int S, int causal,
                                        const int* __restrict__ kvpos,
                                        const int (&qp)[2]) {
  using T = DqF32<HD>;
  const uint32_t parity = i & 1;
  // s, then dp: the chunks of both would not fit in flight beside dq
  float sc[HD / 32][T::NS], dc[HD / 32][T::NS];
  mbar_wait(bars, parity);                  // k
  wgmma_fence();
  issue_over_hd<HD, T::BQ, T::BKV, T::QRows::BYTES, T::KRows::BYTES>(
      sc, q_wg, k_s);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(sc);
  mbar_arrive(bars + 8);
  sum_chunks(sc);
  mbar_wait(bars + 16, parity);             // v
  wgmma_fence();
  issue_over_hd<HD, T::BQ, T::BKV, T::QRows::BYTES, T::KRows::BYTES>(
      dc, do_wg, v_s);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(dc);
  mbar_arrive(bars + 24);
  sum_chunks(dc);
  dq_scores<MASK, POS>(sc[0], dc[0], off, D, c, i * T::BKV, r0, c0, S,
                       causal, kvpos, qp);
  uint32_t ah[T::KSTEPS][4], al[T::KSTEPS][4];
  split_frags(sc[0], ah, al);
  float t[T::NO];
  mbar_wait(bars + 32, parity);             // k^T
  wgmma_fence();
  issue_frags<HD, T::KSTEPS, T::KCols::BYTES>(t, ah, al, kt_s);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(t);
  reg_fence(ah);            // read by the wgmmas until here
  reg_fence(al);
  mbar_arrive(bars + 40);
#pragma unroll
  for (int x = 0; x < T::NO; ++x) acc[x] = __fadd_rn(acc[x], t[x]);
}

// One q tile of the dk/dv pass, in the slot (its records at rec); bars:
// the slot's full and empty mbarriers of set A, then of set B
template <int HD, bool MASK, bool POS>
__device__ __forceinline__ void kv_tile(float (&dk)[HD / 2],
                                        float (&dv)[HD / 2], uint32_t k_s,
                                        uint32_t v_s, uint32_t slot,
                                        uint32_t rec, uint32_t bars, int n,
                                        float c, int q0, int r0, int c0,
                                        const int (&kp)[2]) {
  using T = KvF32<HD>;
  const uint32_t parity = n & 1;
  float sc[HD / 32][T::NS], dc[HD / 32][T::NS];
  mbar_wait(bars, parity);                  // q, dO
  wgmma_fence();
  issue_over_hd<HD, T::BKV, T::BQ, T::KRows::BYTES, T::QRows::BYTES>(
      sc, k_s, slot);
  issue_over_hd<HD, T::BKV, T::BQ, T::KRows::BYTES, T::QRows::BYTES>(
      dc, v_s, slot + T::DO);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(sc);
  reg_fence(dc);
  mbar_arrive(bars + 8);
  sum_chunks(sc);
  sum_chunks(dc);
  mbar_wait(bars + 16, parity);             // q^T, dO^T, records
  kv_scores<MASK, POS>(sc[0], dc[0], rec, c, q0, r0, c0, kp);
  // dv += p^T . dO, then dk += ds^T . q, each into fresh accumulators
  // (one at a time: at hd 128 both would not fit beside dk and dv)
  uint32_t ah[T::KSTEPS][4], al[T::KSTEPS][4];
  float t[T::NO];
  split_frags(sc[0], ah, al);
  wgmma_fence();
  issue_frags<HD, T::KSTEPS, T::QCols::BYTES>(t, ah, al, slot + T::DOT);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(t);
  reg_fence(ah);
  reg_fence(al);
#pragma unroll
  for (int x = 0; x < T::NO; ++x) dv[x] = __fadd_rn(dv[x], t[x]);
  split_frags(dc[0], ah, al);
  wgmma_fence();
  issue_frags<HD, T::KSTEPS, T::QCols::BYTES>(t, ah, al, slot + T::QT);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(t);
  reg_fence(ah);
  reg_fence(al);
  mbar_arrive(bars + 24);
#pragma unroll
  for (int x = 0; x < T::NO; ++x) dk[x] = __fadd_rn(dk[x], t[x]);
}

template <int HD, bool POS>
__global__ void __launch_bounds__(DqF32<HD>::THREADS, 1)
flash_attention_bwd_f32_dq_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ o,
                                  const float* __restrict__ dO,
                                  const float* __restrict__ lse,
                                  const int* __restrict__ q_pos,
                                  const int* __restrict__ kv_pos,
                                  float* __restrict__ dq,
                                  float4* __restrict__ rec, int S, int H,
                                  int group, float scale, int causal) {
  using T = DqF32<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV, NWG = T::NWG;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + T::DO, k_s = base + T::K;
  const uint32_t v_s = base + T::V, kt_s = base + T::KT;
  // q's full barrier, then the full and empty barriers of k, v and k^T
  const uint32_t q_full = base + T::BAR_OFF, bars = q_full + 8;

  // blocks start in the order of their linear index, x fastest: every
  // head's heaviest causal q tile first
  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  int n_kv = (S + BKV - 1) / BKV;
  if (causal && !POS) n_kv = min(n_kv, min(q0 + BQ - 1, S - 1) / BKV + 1);
  const long long q_st = (long long)H * HD, kv_st = (long long)(H / group) * HD;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int w = 0; w < 3; ++w) {
      mbar_init(bars + 16 * w, 128);
      mbar_init(bars + 16 * w + 8, 128 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: loads, splits and stores every operand ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                   :: "n"(T::PRODUCER_REGS));
    const int pt = threadIdx.x - 128 * NWG;
    const long long at = (long long)b * S * q_st + h * HD;
    const float* kb = k + (long long)b * S * kv_st + kvh * HD;
    const float* vb = v + (long long)b * S * kv_st + kvh * HD;
    auto now = [] {};
    T::QRows::copy(q + at, q_st, q0, S, q_s, pt, now);
    T::QRows::copy(dO + at, q_st, q0, S, do_s, pt, now);
    fence_proxy_async();
    mbar_arrive(q_full);
    // tile i's k and v go in once the consumers are done with tile i - 1's
    // s and dp, its k^T once they are done with its dq product; each load
    // is issued before the wait
    for (int i = 0; i < n_kv; ++i) {
      const uint32_t parity = (i - 1) & 1;
      T::KRows::copy(kb, kv_st, i * BKV, S, k_s, pt, [&] {
        if (i > 0) mbar_wait(bars + 8, parity);
      });
      fence_proxy_async();
      mbar_arrive(bars);
      T::KRows::copy(vb, kv_st, i * BKV, S, v_s, pt, [&] {
        if (i > 0) mbar_wait(bars + 24, parity);
      });
      fence_proxy_async();
      mbar_arrive(bars + 16);
      T::KCols::copy(kb, kv_st, i * BKV, S, kt_s, pt, [&] {
        if (i > 0) mbar_wait(bars + 40, parity);
      });
      fence_proxy_async();
      mbar_arrive(bars + 32);
    }
  } else {
    // ---- consumers: 64 q rows each ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                   :: "n"(T::CONSUMER_REGS));
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int row_first = q0 + wg * 64;
    const int r0 = row_first + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
    const long long at0 = (long long)b * S * q_st + h * HD;   // (b, 0, h)

    // each row's D and record; lse and the positions are read below S only
    float D[2] = {0.0f, 0.0f}, off[2];
    int qp[2] = {0, 0};
    row_dots<HD>(D, o, dO, at0 + (row_first + warp * 16) * q_st, q_st,
                 row_first + warp * 16, S, lane);
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
    const uint32_t q_wg = q_s + wg * 64 * ROW_BYTES;
    const uint32_t do_wg = do_s + wg * 64 * ROW_BYTES;

    // kv tiles [0, n_full) unmasked, [n_full, n_end) masked (the causal
    // diagonal, or the ragged tail), [n_end, n_kv) only released: they lie
    // past this warpgroup's rows
    int n_full = n_kv, n_end = n_kv;
    if (causal && !POS) {
      n_full = n_end = 0;
      if (row_first < S) {
        n_full = row_first / BKV;
        n_end = min(n_kv, min(row_first + 63, S - 1) / BKV + 1);
      }
    } else if (causal) {
      n_full = 0;
    } else if (S % BKV != 0) {
      n_full = n_kv - 1;
    }

    float acc[T::NO];
#pragma unroll
    for (int x = 0; x < T::NO; ++x) acc[x] = 0.0f;
    mbar_wait(q_full, 0);
    int i = 0;
    for (; i < n_full; ++i)
      dq_tile<HD, false, POS>(acc, q_wg, do_wg, k_s, v_s, kt_s, bars, i, off,
                              D, c, r0, c0, S, causal, kvpos, qp);
    for (; i < n_end; ++i)
      dq_tile<HD, true, POS>(acc, q_wg, do_wg, k_s, v_s, kt_s, bars, i, off,
                             D, c, r0, c0, S, causal, kvpos, qp);
    for (; i < n_kv; ++i)
      for (int w = 0; w < 3; ++w) {
        mbar_wait(bars + 16 * w, i & 1);
        mbar_arrive(bars + 16 * w + 8);
      }
    store_rows(dq + at0, q_st, acc, scale, r0, c0, S);
  }
}

template <int HD, bool POS>
__global__ void __launch_bounds__(KvF32<HD>::THREADS, 1)
flash_attention_bwd_f32_dkdv_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dO,
                                    const float4* __restrict__ rec,
                                    const int* __restrict__ kv_pos,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int S, int H,
                                    int KV, float scale, int causal) {
  using T = KvF32<HD>;
  constexpr int BQ = T::BQ, BKV = T::BKV;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + T::V, slot = base + T::SLOTS;
  const uint32_t rec_s = base + T::RECS;
  // k and v's full barrier, then the slot's full and empty barriers of set
  // A and of set B
  const uint32_t kv_full = base + T::BAR_OFF, bars = kv_full + 8;

  // kv tile 0 first: under the causal mask every q tile sees it
  const int k0 = (int)blockIdx.y * BKV;
  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV, group = H / KV;
  const int n_q = (S + BQ - 1) / BQ;
  // the first q tile that can see the kv tile
  const int u0 = (causal && !POS) ? k0 / BQ : 0;
  const long long q_st = (long long)H * HD, kv_st = (long long)KV * HD;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 5; ++w) mbar_init(kv_full + 8 * w, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {
    // ---- producer: loads, splits and stores every operand ----
    const int pt = threadIdx.x - 128;
    const long long kat = (long long)b * S * kv_st + kvh * HD;
    auto now = [] {};
    T::KRows::copy(k + kat, kv_st, k0, S, k_s, pt, now);
    T::KRows::copy(v + kat, kv_st, k0, S, v_s, pt, now);
    fence_proxy_async();
    mbar_arrive(kv_full);
    // q tile t goes into set A once the consumers are done with tile t -
    // 1's s^T and dp^T, into set B once they are done with that tile.
    // Tiles in order: t = g * per_head + u - u0 for query head g of the kv
    // head.
    const int per_head = n_q - u0, tiles = group * per_head;
    auto head_rows = [&](const float* x, int t) {
      return x + (long long)b * S * q_st + (kvh * group + t / per_head) * HD;
    };
    // tile t's records, for its first BQ producer threads (zeros past S)
    auto record = [&](int t) {
      const int row = (u0 + t % per_head) * BQ + pt;
      float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (pt < BQ && row < S)
        r = __ldg(rec + ((long long)b * H + kvh * group + t / per_head) * S +
                  row);
      return r;
    };
    // STAGED: tile t's q and dO rows, by cp.async into stage t % 2 (zeros
    // past S), one commit group a tile
    auto stage = [&](int t) { return base + T::RAW + (t % 2) * T::RAW_BYTES; };
    auto fetch = [&](int t) {
      const int row0 = (u0 + t % per_head) * BQ;
#pragma unroll
      for (int op = 0; op < 2; ++op) {
        const float* src = head_rows(op == 0 ? q : dO, t);
#pragma unroll
        for (int j = 0; j < T::QRows::PIECES; ++j) {
          const int piece = pt + 128 * j;
          const int r = row0 + piece / (HD / 4);
          cp_async16(stage(t) + op * T::RAW_OP + 16 * piece,
                     src + (r < S ? r : 0) * q_st + 4 * (piece % (HD / 4)),
                     r < S);
        }
      }
      cp_async_commit();
    };
    float4 next_rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (T::STAGED) {
      if (tiles > 0) {
        fetch(0);
        next_rec = record(0);
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const int u = u0 + t % per_head;
      const uint32_t parity = (t - 1) & 1;
      const float* qh = head_rows(q, t);
      const float* doh = head_rows(dO, t);
      float4 r;
      if constexpr (T::STAGED) {
        // every producer thread's copies of tile t have landed, and none
        // reads stage t + 1 any more (it held tile t - 1)
        cp_async_wait_all();
        named_sync(2, 128);
        r = next_rec;
        if (t + 1 < tiles) {
          fetch(t + 1);
          next_rec = record(t + 1);
        }
      } else {
        r = record(t);
      }
      {
        float4 x[T::QRows::BATCH], y[T::QRows::BATCH];
        if constexpr (T::STAGED) {
          T::QRows::load_shared(x, stage(t), pt, 0);
          T::QRows::load_shared(y, stage(t) + T::RAW_OP, pt, 0);
        } else {
          T::QRows::load(x, qh, q_st, u * BQ, S, pt, 0);
          T::QRows::load(y, doh, q_st, u * BQ, S, pt, 0);
        }
        if (t > 0) mbar_wait(bars + 8, parity);
        T::QRows::store(x, slot, pt, 0);
        T::QRows::store(y, slot + T::DO, pt, 0);
        fence_proxy_async();
        mbar_arrive(bars);
      }
      {
        constexpr int STEPS = T::QCols::STEPS;
        float x[8 * STEPS], y[8 * STEPS];
        if constexpr (T::STAGED) {
          T::QCols::template load_shared<STEPS>(x, stage(t), pt);
          T::QCols::template load_shared<STEPS>(y, stage(t) + T::RAW_OP, pt);
        } else {
          T::QCols::template load<STEPS>(x, qh, q_st, u * BQ, S, pt);
          T::QCols::template load<STEPS>(y, doh, q_st, u * BQ, S, pt);
        }
        if (t > 0) mbar_wait(bars + 24, parity);
        T::QCols::template store<STEPS>(x, slot + T::QT, pt);
        T::QCols::template store<STEPS>(y, slot + T::DOT, pt);
        if (pt < BQ) {
          const uint32_t rv[4] = {__float_as_uint(r.x), __float_as_uint(r.y),
                                  __float_as_uint(r.z), __float_as_uint(r.w)};
          st_shared_v4(rec_s + 16 * pt, rv);
        }
        fence_proxy_async();
        mbar_arrive(bars + 16);
      }
    }
  } else {
    // ---- the consumer warpgroup: all 64 kv rows, every q tile ----
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = k0 + warp * 16 + lane / 4, c0 = 2 * (lane % 4);
    int kp[2] = {0, 0};
    if (POS)
      for (int ri = 0; ri < 2; ++ri)
        if (r0 + 8 * ri < S) kp[ri] = kv_pos[(long long)b * S + r0 + 8 * ri];
    const float c = __fmul_rn(scale, LOG2E);

    float dk_acc[T::NO], dv_acc[T::NO];
#pragma unroll
    for (int x = 0; x < T::NO; ++x) dk_acc[x] = dv_acc[x] = 0.0f;
    mbar_wait(kv_full, 0);
    // q tiles [u0, u_mask) see the kv rows only in part: under the causal
    // index mask those within BKV rows of k0, with positions all of them
    const int u_mask = !causal ? u0 : (POS ? n_q : min(n_q, u0 + BKV / BQ));
    int n = 0;
    for (int g = 0; g < group; ++g) {
      int u = u0;
      for (; u < u_mask; ++u, ++n)
        kv_tile<HD, true, POS>(dk_acc, dv_acc, k_s, v_s, slot, rec_s, bars,
                               n, c, u * BQ, r0, c0, kp);
      for (; u < n_q; ++u, ++n)
        kv_tile<HD, false, POS>(dk_acc, dv_acc, k_s, v_s, slot, rec_s, bars,
                                n, c, u * BQ, r0, c0, kp);
    }
    const long long at0 = (long long)b * S * kv_st + kvh * HD;   // (b, 0, kvh)
    store_rows(dk + at0, kv_st, dk_acc, scale, r0, c0, S);
    store_rows(dv + at0, kv_st, dv_acc, 1.0f, r0, c0, S);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, const int* q_pos,
           const int* kv_pos, void* dq, void* dk, void* dv, void* rec, int B,
           int S, int H, int KV, float scale, int causal,
           cudaStream_t stream) {
  using DT = DqF32<HD>;
  using KT = KvF32<HD>;
  const void* ptrs[9] = {q, k, v, o, dO, dq, dk, dv, rec};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  auto dqk = q_pos ? flash_attention_bwd_f32_dq_kernel<HD, true>
                   : flash_attention_bwd_f32_dq_kernel<HD, false>;
  auto dkdv = q_pos ? flash_attention_bwd_f32_dkdv_kernel<HD, true>
                    : flash_attention_bwd_f32_dkdv_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DT::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, KT::SMEM);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((unsigned)(B * H), (unsigned)((S + DT::BQ - 1) / DT::BQ)),
        DT::THREADS, DT::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dO, lse, q_pos, kv_pos, (float*)dq, (float4*)rec, S, H,
      H / KV, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((unsigned)(B * KV), (unsigned)((S + KT::BKV - 1) / KT::BKV)),
         KT::THREADS, KT::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float4*)rec, kv_pos, (float*)dk, (float*)dv, S, H, KV, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tf32

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

// q_pos and kv_pos both null or both (B, S) int32; scratch: (B, H, S, 4)
// f32, each q row's record, written by the dq pass and read by the dk/dv
// pass
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
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
    return tf32::launch<64>(q, k, v, o, dO, l, qp, kp, dq, dk, dv, scratch,
                            B, S, H, KV, scale, causal, st);
  if (hd == 128)
    return tf32::launch<128>(q, k, v, o, dO, l, qp, kp, dq, dk, dv, scratch,
                             B, S, H, KV, scale, causal, st);
  return (int)cudaErrorInvalidValue;
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
