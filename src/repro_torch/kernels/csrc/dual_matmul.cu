// Dual-evaluation matmul: y0 = x @ w and y1 = x @ (w + mu * u) in one pass,
// on Hopper's tensor cores.
//
// Replaces the Pallas kernel `_kernel` / `dual_matmul_pallas` of the
// reference's src/repro/kernels/dual_matmul.py (pallas_call in
// `dual_matmul_pallas`). AsyREVEL evaluates the party tower twice per
// round, at w and at the perturbed w + mu*u; both first-layer products
// share x and w, so one kernel reads them once and keeps two accumulators.
//
// Shapes and types: x (M, K) with unit column stride and row stride ldx;
// w (K, N) and u (K, N) row-major; x and w both f32 or both bf16, u f32;
// y0, y1 (M, N) row-major in x's type. The perturbed weight is formed in
// f32 and both sums are f32.
//
// Arithmetic: 3xTF32. Each f32 operand a is split into a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), both rounded to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding; a - a_hi is exact in f32), and x.w is
// x_hi.w_hi + x_hi.w_lo + x_lo.w_hi on tf32 `wgmma` (the x_lo.w_lo term is
// below f32's precision). bf16 x and w are exact in tf32: their lo parts are
// zero and those products are skipped; w + mu*u is f32 and keeps its split.
// The tensor cores do not round their sums to nearest: one wgmma
// accumulator over K = 4096 ends 3.2e-5 of the largest output away from
// the f32 product on an H100 (benchmarks/torch_dual_variants.py,
// no_promote), as truncating each k8 step's sum predicts. So each BK = 32
// stage runs into fresh wgmma accumulators that are then added into f32
// totals with __fadd_rn, and the error is that of a 32-deep sum: 3.5e-6 at
// 4096^3, within the 1e-5 check.
//
// Bound: at 4096^3 operations, 3 x 4*M*K*N on the tensor cores at 495
// TFLOP/s (1.67 ms); at the main path's shape (x 2048 x 98, w 98 x 128) the
// bytes, (M*K + 2*K*N + 2*M*N) * 4 = 3.0 MB at 3.35 TB/s (0.90 us).
//
// Design: one block per BM x BN output tile of both products, BM = 64 per
// consumer warpgroup. The launcher picks (BM, BN) from M and N: 128 x 64
// (two warpgroups) when that grid fills the card's 132 SMs, else 64 x 32
// (the D7 shape: 128 blocks). Per stage of BK = 32 k:
//  - w and u tiles go by `cp.async` (16 bytes where their rows are 16-byte
//    aligned, else 4; zero-filled past N and K) into a ring of 4 stages;
//  - the block forms w + mu*u, splits w and w + mu*u into tf32 hi and lo and
//    stores the four K-major (tf32 `wgmma` takes no transpose) under the
//    128-byte swizzle, in one of two sets: stage s + 1's set is formed while
//    stage s's products run;
//  - each thread loads its own x fragments straight from device memory into
//    registers, one stage ahead (16-byte loads where x's rows are 16-byte
//    aligned: k is permuted inside a stage so that a thread's four values of
//    two k8 steps are adjacent, see phys_k), and splits them there (A from
//    registers);
//  - per k8 step 6 `wgmma.m64nBNk8` (3 into each accumulator), then the
//    stage's sums are added into the totals.
// Ragged M, N and K are zeros in registers and shared memory, and zeros add
// exactly.
//
// Rounding: the perturbed weight is __fadd_rn(w, __fmul_rn(mu, u)), the two
// roundings zo_update (at scale -mu) and the plain perturbation make, and
// acc0 and acc1 run the identical instruction sequence, so y1 at (w, u) is
// bitwise y0 at the party's perturbed block (w_p, 0). Built with
// --fmad=false.
#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;            // k per stage: one 128-byte row of tf32
constexpr int STAGES = 4;         // the cp.async ring of w and u tiles
constexpr int ROW_BYTES = BK * 4;
constexpr int GROUP_M = 8;        // block raster: 8 row tiles per column sweep
constexpr int SMS = 132;          // H100 SXM

template <typename T, int WGS, int BN>
struct Cfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int NACC = BN / 2;            // per thread, per product
  static constexpr int BT_BYTES = BN * ROW_BYTES;  // one K-major B operand
  static constexpr int W_FLOATS = BK * BN;
  static constexpr int STAGE_FLOATS = 2 * W_FLOATS;   // w, then u
  // two sets of the four B operands (1024-aligned: the swizzle's period),
  // then the stages; 1024 bytes of slack to align the base
  static constexpr int SMEM = 1024 + 8 * BT_BYTES + STAGES * STAGE_FLOATS * 4;
  // every thread takes the same number of elements of each copy and of
  // the split
  static_assert((BK * BN / 4) % THREADS == 0, "tile and block do not divide");
};

// The k order inside a stage. A thread's x fragments of k8 steps 2j and
// 2j + 1 (columns t and t + 4 of each) are the 4 adjacent floats 16j + 4t
// .. 16j + 4t + 3 of x's row, one 16-byte load: logical k 8kk + c (c = t +
// 4h) sits at physical k 16 (kk / 2) + 4t + 2 (kk % 2) + h. w and u rows
// are read in the same order, so the products pair the same k; only the
// grouping of terms into k8 steps differs from k's natural order.
__host__ __device__ constexpr int phys_k(int kk, int c) {
  return 16 * (kk / 2) + 4 * (c % 4) + 2 * (kk % 2) + c / 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0..4) of a 4-byte word, zero-filling the rest
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// copy `bytes` (0..16) of a 16-byte chunk, zero-filling the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

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

// A wgmma shared-memory descriptor for a K-major tile under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused. Offsets in 16 bytes.
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
// generic-proxy writes to shared memory visible to wgmma's (async) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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

// m64nNk8 with tf32 operands and f32 accumulators: A (64 x 8) from
// registers, the m64k8 fragment a[i] = row r0 + 8 (i % 2), column t + 4 (i
// / 2); B (8 x N) from shared memory, K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

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

// Copies one stage of w and u, rows [k0, k0 + BK) x columns [col0, col0
// + BN), into ws and us (row stride BN) by cp.async (16-byte chunks where
// vec_w says the rows allow it), zeros outside the matrices. bf16 w is
// loaded, widened and stored, and is visible after the next barrier like
// the copies.
template <typename T, int WGS, int BN>
__device__ __forceinline__ void load_stage(float* st, const T* __restrict__ w,
                                           const float* __restrict__ u,
                                           int col0, int k0, int N, int K,
                                           bool vec_w, int tid) {
  using C = Cfg<T, WGS, BN>;
  constexpr bool F32 = std::is_same<T, float>::value;
  float* ws = st;
  float* us = st + C::W_FLOATS;
  if (vec_w) {
#pragma unroll
    for (int j = 0; j < (BK * BN / 4) / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const int gr = k0 + r, gc = col0 + c;
      const int n = gr < K ? min(max(N - gc, 0), 4) : 0;
      const long long off = n ? (long long)gr * N + gc : 0;
      if constexpr (F32) cp_async16(smem_addr(ws + r * BN + c), w + off, 4 * n);
      cp_async16(smem_addr(us + r * BN + c), u + off, 4 * n);
    }
  } else {
#pragma unroll
    for (int j = 0; j < (BK * BN) / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      const bool ok = gr < K && gc < N;
      const long long off = ok ? (long long)gr * N + gc : 0;
      if constexpr (F32) cp_async4(smem_addr(ws + r * BN + c), w + off,
                                   ok ? 4 : 0);
      cp_async4(smem_addr(us + r * BN + c), u + off, ok ? 4 : 0);
    }
  }
  if constexpr (!F32) {
#pragma unroll
    for (int j = 0; j < (BK * BN) / C::THREADS; ++j) {
      const int i = tid + j * C::THREADS;
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      const bool ok = gr < K && gc < N;
      ws[r * BN + c] = ok ? widen(w[(long long)gr * N + gc]) : 0.0f;
    }
  }
}

// This thread's raw x of one stage: rows gr and gr + 8, physical k k0 + 16j
// + 4t .. + 3 for j = 0, 1 (see phys_k), zeros outside x. One 16-byte load
// each where vec_x says x's rows allow it.
template <typename T>
__device__ __forceinline__ void load_x(float4 (&xv)[2][2],
                                       const T* __restrict__ x, long long ldx,
                                       int gr, int k0, int t, int M, int K,
                                       bool vec_x) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = gr + 8 * i, c = k0 + 16 * j + 4 * t;
      const T* src = x + (long long)r * ldx + c;
      if (std::is_same<T, float>::value && vec_x && r < M && c + 3 < K) {
        xv[i][j] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = r < M && c + e < K ? widen(__ldg(src + e)) : 0.0f;
        xv[i][j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
}

// The x fragments of one stage's four k8 steps, split: a[kk][i + 2h] is row
// r0 + 8i, logical column t + 4h of k8 step kk (the m64k8 fragment).
template <typename T>
__device__ __forceinline__ void split_x(const float4 (&xv)[2][2],
                                        uint32_t (&ah)[BK / 8][4],
                                        uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float v[4] = {xv[i][j].x, xv[i][j].y, xv[i][j].z, xv[i][j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // physical 16j + 4t + e: k8 step 2j + e / 2, column t + 4 (e % 2)
        const int kk = 2 * j + e / 2, reg = i + 2 * (e % 2);
        if constexpr (std::is_same<T, float>::value)
          split(v[e], ah[kk][reg], al[kk][reg]);
        else
          ah[kk][reg] = __float_as_uint(v[e]);   // bf16: exact in tf32
      }
    }
}

// The four B operands of one stage at bt, from its raw w and u tiles in
// st: w + mu*u formed, w and w + mu*u split, stored K-major under the
// 128-byte swizzle, logical k in the k8 steps' order: (n, k) at n * 128 +
// ((k / 4) ^ (n % 8)) * 16 + (k % 4) * 4.
template <typename T, int WGS, int BN>
__device__ __forceinline__ void prepare_b(const float* st, uint32_t bt,
                                          float mu, int tid) {
  using C = Cfg<T, WGS, BN>;
  constexpr bool F32 = std::is_same<T, float>::value;
  const float* ws = st;
  const float* us = st + C::W_FLOATS;
#pragma unroll
  for (int j = 0; j < (BN * (BK / 4)) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int n = i % BN, q = i / BN;     // logical k 4q .. 4q + 3
    uint32_t wh[4], wl[4], ph[4], pl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = phys_k(q / 2, 4 * (q % 2) + e);
      const float wv = ws[k * BN + n];
      const float pv = __fadd_rn(wv, __fmul_rn(mu, us[k * BN + n]));
      if constexpr (F32)
        split(wv, wh[e], wl[e]);
      else
        wh[e] = __float_as_uint(wv);    // bf16: exact in tf32
      split(pv, ph[e], pl[e]);
    }
    const uint32_t off = n * ROW_BYTES + ((q ^ (n & 7)) << 4);
    st_shared_v4(bt + off, wh);
    if constexpr (F32) st_shared_v4(bt + C::BT_BYTES + off, wl);
    st_shared_v4(bt + 2 * C::BT_BYTES + off, ph);
    st_shared_v4(bt + 3 * C::BT_BYTES + off, pl);
  }
}

// One stage's products, into fresh accumulators: the same sequence for
// both, hi.hi, hi.lo, lo.hi per k8 step (bf16: hi.hi, and hi.lo for wp)
template <typename T, int BN>
__device__ __forceinline__ void mma_stage(float (&acc0)[BN / 2],
                                          float (&acc1)[BN / 2], uint32_t bt,
                                          const uint32_t (&ah)[BK / 8][4],
                                          const uint32_t (&al)[BK / 8][4]) {
  constexpr uint32_t BT_BYTES = BN * ROW_BYTES;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t k_off = kk * 32;
    const uint64_t d_wh = sw128_desc(bt + k_off);
    const uint64_t d_ph = sw128_desc(bt + 2 * BT_BYTES + k_off);
    const uint64_t d_pl = sw128_desc(bt + 3 * BT_BYTES + k_off);
    wgmma_tf32(acc0, ah[kk], d_wh, kk > 0);
    wgmma_tf32(acc1, ah[kk], d_ph, kk > 0);
    if constexpr (std::is_same<T, float>::value) {
      const uint64_t d_wl = sw128_desc(bt + BT_BYTES + k_off);
      wgmma_tf32(acc0, ah[kk], d_wl, 1);
      wgmma_tf32(acc1, ah[kk], d_pl, 1);
      wgmma_tf32(acc0, al[kk], d_wh, 1);
      wgmma_tf32(acc1, al[kk], d_ph, 1);
    } else {
      wgmma_tf32(acc1, ah[kk], d_pl, 1);
    }
  }
}

template <typename T, int WGS, int BN>
__global__ void __launch_bounds__(128 * WGS, 1)
dual_matmul_kernel(const T* __restrict__ x, long long ldx,
                   const T* __restrict__ w, const float* __restrict__ u,
                   float mu, T* __restrict__ y0, T* __restrict__ y1, int M,
                   int N, int K, int tiles_m, int tiles_n, int vec_x,
                   int vec_w) {
  using C = Cfg<T, WGS, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // two sets of B operands (w_hi, w_lo, wp_hi, wp_lo; w_lo unused in bf16),
  // stage s's in set s % 2, then the ring of raw w and u stages
  const uint32_t bt = smem_addr(base);
  float* stages = reinterpret_cast<float*>(base + 8 * C::BT_BYTES);

  // grouped raster: GROUP_M row tiles sweep the column tiles together, so
  // a wave's x rows and w columns stay in L2
  const int bid = blockIdx.x;
  const int group = GROUP_M * tiles_n;
  const int first_m = (bid / group) * GROUP_M;
  const int gm = min(tiles_m - first_m, GROUP_M);
  const int row0 = (first_m + (bid % group) % gm) * C::BM;
  const int col0 = ((bid % group) / gm) * BN;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;
  // this thread's rows r0 and r0 + 8 of the block tile
  const int r0 = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4;

  float acc0[C::NACC], acc1[C::NACC], tot0[C::NACC], tot1[C::NACC];
#pragma unroll
  for (int i = 0; i < C::NACC; ++i) {
    acc0[i] = acc1[i] = 0.0f;
    tot0[i] = tot1[i] = 0.0f;
  }
  uint32_t ah[BK / 8][4], al[BK / 8][4];   // this thread's x fragments
  float4 xv[2][2];                         // the next stage's raw x

  const int steps = (K + BK - 1) / BK;
  auto stage = [&](int s) { return stages + (s % STAGES) * C::STAGE_FLOATS; };
  auto load = [&](int s) {
    if (s < steps)
      load_stage<T, WGS, BN>(stage(s), w, u, col0, s * BK, N, K, vec_w, tid);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  if (steps > 0) {
    load_x<T>(xv, x, ldx, row0 + r0, 0, t, M, K, vec_x);
    split_x<T>(xv, ah, al);
    if (steps > 1) load_x<T>(xv, x, ldx, row0 + r0, BK, t, M, K, vec_x);
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    prepare_b<T, WGS, BN>(stage(0), bt, mu, tid);
    fence_proxy_async();
    __syncthreads();
  }

  // Stage s: its products go out on B set s % 2; stage s + 3's copies go
  // into the slot stage s - 1 used; stage s + 1's B operands are formed
  // under the products, into the other set; then the products are summed
  // into the totals, stage s + 1's x fragments formed and stage s + 2's x
  // loaded.
  for (int s = 0; s < steps; ++s) {
    const uint32_t b_set = bt + (s & 1) * 4 * C::BT_BYTES;
    wgmma_fence();
    mma_stage<T, BN>(acc0, acc1, b_set, ah, al);
    wgmma_commit();
    load(s + STAGES - 1);
    const bool next = s + 1 < steps;
    if (next) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // stage s + 1 landed; the other set free
      prepare_b<T, WGS, BN>(stage(s + 1), bt + ((s + 1) & 1) * 4 * C::BT_BYTES,
                            mu, tid);
      fence_proxy_async();
    }
    wgmma_wait_all();
    reg_fence(acc0);
    reg_fence(acc1);
    reg_fence(ah);
    reg_fence(al);
    // the stage's sums into the f32 totals, rounded to nearest
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) {
      tot0[i] = __fadd_rn(tot0[i], acc0[i]);
      tot1[i] = __fadd_rn(tot1[i], acc1[i]);
    }
    if (next) {
      split_x<T>(xv, ah, al);
      if (s + 2 < steps)
        load_x<T>(xv, x, ldx, row0 + r0, (s + 2) * BK, t, M, K, vec_x);
    }
    __syncthreads();     // the other set stored; this one read by all
  }
  cp_async_wait<0>();

  // tot[4j + 2i + e] is row r0 + 8i, column 8j + 2t + e of the tile
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = row0 + r0 + 8 * i;
      if (gr >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = col0 + 8 * j + 2 * t + e;
        if (gc >= N) continue;
        const long long off = (long long)gr * N + gc;
        y0[off] = narrow<T>(tot0[4 * j + 2 * i + e]);
        y1[off] = narrow<T>(tot1[4 * j + 2 * i + e]);
      }
    }
}

template <typename T, int WGS, int BN>
int launch_tile(const void* x, long long ldx, const void* w, const void* u,
                float mu, void* y0, void* y1, int M, int N, int K,
                void* stream) {
  using C = Cfg<T, WGS, BN>;
  auto kern = dual_matmul_kernel<T, WGS, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles_m = (M + C::BM - 1) / C::BM;
  const long long tiles_n = (N + BN - 1) / BN;
  if (tiles_m * tiles_n > INT_MAX) return (int)cudaErrorInvalidValue;
  // 16-byte loads and copies need 16-byte aligned rows
  const int vec_x = std::is_same<T, float>::value && ldx % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                    (!std::is_same<T, float>::value ||
                     reinterpret_cast<uintptr_t>(w) % 16 == 0);
  kern<<<(unsigned)(tiles_m * tiles_n), C::THREADS, C::SMEM,
         (cudaStream_t)stream>>>(
      (const T*)x, ldx, (const T*)w, (const float*)u, mu, (T*)y0, (T*)y1, M,
      N, K, (int)tiles_m, (int)tiles_n, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// 128 x 64 tiles when their grid fills the SMs, else 64 x 32: a function
// of (M, N) alone
template <typename T>
int launch(const void* x, long long ldx, const void* w, const void* u,
           float mu, void* y0, void* y1, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (((M + 127LL) / 128) * ((N + 63LL) / 64) >= SMS)
    return launch_tile<T, 2, 64>(x, ldx, w, u, mu, y0, y1, M, N, K, stream);
  return launch_tile<T, 1, 32>(x, ldx, w, u, mu, y0, y1, M, N, K, stream);
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
