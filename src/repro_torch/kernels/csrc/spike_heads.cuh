// The bf16 spike matmul for small per-batch products on Hopper: a unit is
// whole output rows of one batch, a persistent block walks the units, the
// products run on wgmma, and each unit's rows leave shared memory by one
// bulk copy.
//
//   out[g][m][n] = sum_c bit(x[g][m], c) * w[g][c][n]     (w, out bf16)
//
// Replaces, at a bf16 weight, the reference's _spike_bmm_kernel
// (src/repro/kernels/spike_matmul.py:139) where spike_matmul.py's rule sends
// a call here: at most 512 rows a product, a weight TMA can read, C <= 128
// and K <= 256 (kMaxC, kMaxK; HEADS_MAX_C, HEADS_MAX_K there). That is the
// per-head Q K^T at attn_qk: G = T*B*h products of 196 x 64 x 196, the
// weight the K^T view of k (unit stride along c, 128-byte rows at a
// 1,024-byte pitch). The function is the reference's at a bf16 weight: the
// spikes unpacked to bf16 (exactly 0 or 1), every product exact, the sums
// in fp32 in the order of the contraction, each result rounded to bf16
// once.
//
// What bounds it: bytes. At attn_qk the output is 39.3 MB, k 12.9 MB and
// the packed q 0.8 MB, 0.0158 ms at 3.35 TB/s; the products, 2.5 GFLOP,
// take 2.5 us at the tensor cores' rate. The one-plane mma.sync tile it
// replaces there (spike_mma_mainloop.cuh, Small) ran 4.8x off those bytes:
// one 64-wide contraction chunk a block, so nothing overlapped its load,
// product and store; 256 x 256 padded outputs for 196 x 196; k read twice
// and the packed rows four times; 4-byte stores along 392-byte rows.
//
// The design, for the bytes:
// - A unit is `rows` whole rows of one batch (all 196 at attn_qk: 76,832
//   contiguous bytes of out). The block stages them in shared memory in
//   the output's own row-major layout, at the unit's address modulo 16, and
//   one thread stores them with cp.async.bulk: the 16-byte aligned middle in
//   one copy, the few bf16 before and after it by plain stores. Two output
//   stages: unit u's copy drains while unit u + 1 computes, and the SM
//   spends no instruction on it.
// - Persistent blocks, one an SM, walk the units. While unit u computes, one
//   thread has TMA bring unit u + 1's weight (all C x K of its batch, in the
//   128-byte swizzle, zeros past C and K) into the other of two weight
//   stages, and the first 256 threads hold unit u + 1's packed rows (one a
//   thread) in registers.
// - The product: wgmma with the spikes expanded into its register A
//   fragments (expand_word, wgmma_mainloop.cuh) and B the weight in shared
//   memory, read where TMA left it (K-major for K^T, MN-major where n has
//   unit stride). Four warpgroups, one for each 64 rows of the unit; each
//   walks the unit's columns in blocks of N (40 for attn_qk's K = 196, so
//   200 columns, not 256; else 64): the block's wgmmas, then its
//   accumulators rounded to bf16 and written into the output stage by
//   predicated 4-byte stores, while the other warpgroups' wgmmas run.
//   With mma.sync, or with a second accumulator set in flight in the same
//   warpgroup (which ptxas serialises), the issue of the products and of
//   their stores, not the bytes, set a unit's time.
//
// Barriers: two mbarriers (the weight stages' "full", one arrival with the
// bytes); the stages' reuse is ordered by two __syncthreads a unit and, for
// the output stages, by the storing thread's wait on its bulk groups.
#pragma once

#include "spike_tile_mma.cuh"   // bf16x2_rn
#include "wgmma_mainloop.cuh"   // TMA, mbarriers, expand_word, tma_suits

namespace e2a {
namespace hd {

using namespace wg;

// The kernel's limits (spike_matmul.py: HEADS_MAX_C, HEADS_MAX_K): the
// contraction and the output columns of one product.
constexpr int kMaxC = 128, kMaxK = 256;
constexpr int kThreads = 512;         // 4 warpgroups of 64 rows: 256 a unit
constexpr int kMaxRows = 256;
constexpr int kXPitch = kMaxC / 8;    // bytes of a staged packed row
constexpr int kXBytes = kMaxRows * kXPitch;
constexpr int kSmemMax = 232448;      // a block's dynamic shared memory
constexpr int kSteps = kMaxC / 16;    // k16 steps at most

// The kernel's arguments besides its tensor map (element strides; out's
// rows are K contiguous elements, its batches at o_g1, o_g2).
struct Args {
  const uint8_t* x;
  bf16* out;
  int G, G2, M, C, K;
  long long x_g1, x_g2, x_m, x_b;
  long long o_g1, o_g2;
  int w_g1, w_g2;   // 1 where the weight map's batch level moves with g
  int n_major;      // 1: w has unit stride along n; 0: along c (K^T)
  int rows, slabs;  // rows a unit (the last of a batch may have fewer)
  int w_stage, o_stage;   // bytes of a weight stage, of an output stage
};

// The shared memory of one call: two weight stages (whole boxes of 64
// elements along the unit-stride dim, each 1,024-byte aligned for the
// swizzle), the staged packed rows, two output stages of `rows` rows and 16
// bytes of slack (the unit's address modulo 16), the two mbarriers.
struct Layout {
  int rows, slabs, w_stage, o_stage, smem;
};

inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The columns of one wgmma (its N): 64 for an n-major weight (a box of 64
// n), and for K^T 40 where blocks of 40 pad K less than blocks of 64 do
// (attn_qk's K = 196: 200 columns, not 256), else 64.
inline int cols_of(int K, bool n_major) {
  return !n_major && round_up(K, 40) < round_up(K, 64) ? 40 : 64;
}

// Rows of the weight box along its outer dim: K padded to the wgmma's
// columns (K^T: n rows of 64 c; a block of N columns reads N of them), or
// C padded to the instance's 64 or 128 (n-major: c rows of 64 n; the
// instance reads all).
inline int box_rows(int C, int K, bool n_major) {
  return n_major ? (C <= 64 ? 64 : 128) : round_up(K, cols_of(K, n_major));
}

inline Layout layout_of(int M, int C, int K, bool n_major) {
  Layout l;
  l.w_stage = (int)cdiv(n_major ? K : C, 64) * box_rows(C, K, n_major) * 128;
  const int fixed = 1024 + 2 * l.w_stage + kXBytes + 16;
  const int per_stage = (kSmemMax - fixed) / 2 / 16 * 16;
  const int fit = (per_stage - 16) / (2 * K);
  l.rows = M < kMaxRows ? M : kMaxRows;
  if (fit < l.rows) l.rows = fit;
  l.slabs = (int)cdiv(M, l.rows);
  l.o_stage = round_up(l.rows * 2 * K + 16, 16);
  l.smem = fixed + 2 * l.o_stage;
  return l;
}

// Whether the kernel takes the call: C and K within the limits, a weight
// TMA reads (wg::tma_suits) and output rows of K contiguous elements.
inline bool suits(int C, int K, bool tma_ok, long long o_m, long long o_k) {
  return C > 0 && C <= kMaxC && K <= kMaxK && C % 8 == 0 && tma_ok &&
         o_k == 1 && o_m == K;
}

// ---- PTX ----

__device__ __forceinline__ void sts16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ uint16_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}
// A 4-byte store to shared memory where `on`, as one predicated instruction.
__device__ __forceinline__ void sts32_if(uint32_t addr, uint32_t v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.shared.u32 [%0], %1;\n}\n" ::"r"(addr),
      "r"(v), "r"((int)on)
      : "memory");
}
__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
// `bytes` (a multiple of 16) from shared memory to device memory, both
// 16-byte aligned, as one bulk copy of this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read their
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ---- the kernel ----

// Where unit u lies: batch g (levels g1, g2), rows r0 .. r0 + n - 1.
struct Unit {
  int g1, g2, r0, n;
  __device__ __forceinline__ Unit(const Args& a, int u) {
    const int g = u / a.slabs;
    g1 = g / a.G2;
    g2 = g % a.G2;
    r0 = (u % a.slabs) * a.rows;
    n = a.M - r0 < a.rows ? a.M - r0 : a.rows;
  }
};

// Unit u's packed row `tid` (zeros past its rows and past C / 8 bytes), as
// the four words of a staged row: whole words where the row's bytes are
// contiguous and 4-byte aligned (nothing then waits for the loads until
// the words are staged), else byte by byte.
__device__ __forceinline__ void fetch_row(const Args& a, int u, int tid,
                                          uint32_t (&v)[4]) {
  const Unit un(a, u);
  v[0] = v[1] = v[2] = v[3] = 0;
  if (tid >= un.n) return;
  const uint8_t* const src = a.x + un.g1 * a.x_g1 + un.g2 * a.x_g2 +
                             (long long)(un.r0 + tid) * a.x_m;
  const int cb = a.C / 8;
  if (a.x_b == 1 && cb % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 4 == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * q < cb) v[q] = __ldg(reinterpret_cast<const uint32_t*>(src) + q);
    return;
  }
#pragma unroll
  for (int b = 0; b < kXPitch; ++b)
    if (b < cb) v[b / 4] |= (uint32_t)__ldg(src + b * a.x_b) << (8 * (b % 4));
}

// One thread has TMA bring unit u's weight (all of batch g's C x K) into
// the weight stage at ws, counted on the stage's full barrier.
template <bool N_MAJOR>
__device__ __forceinline__ void load_weight(const CUtensorMap& wmap,
                                            const Args& a, int u, uint32_t ws,
                                            uint32_t full) {
  const Unit un(a, u);
  const int c2 = a.w_g2 ? un.g2 : 0, c3 = a.w_g1 ? un.g1 : 0;
  const int boxes = (N_MAJOR ? a.K + 63 : a.C + 63) / 64;
  const int box = a.w_stage / boxes;
  bar_arrive_tx(full, a.w_stage);
  for (int q = 0; q < boxes; ++q)
    tma_load(ws + q * box, &wmap, full, 64 * q, 0, c2, c3);
}

// d = a * b + (add ? d : 0) for one m64n64k16 step: a the four bf16x2
// registers of the lane's A fragment, b from shared memory (TRANS_B 1:
// MN-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add),
        "n"(TRANS_B));
}

// The same for one m64n40k16 step.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n40(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add),
        "n"(TRANS_B));
}

// The A fragments of row group rg's 16 rows of warp wi (rows 64 rg + 16 wi
// + gq and + 8 of the staged packed rows), every k16 step: step s is bytes
// 2s, 2s + 1 of a row (word s / 2); wgmma's register A layout is
// mma.m16n8k16's, warp wi of the group holding rows 16 wi .. 16 wi + 15.
__device__ __forceinline__ void a_fragments(uint32_t x_off, int rg, int wi,
                                            int gq, int t4,
                                            uint32_t (&af)[kSteps][4]) {
  const int r = 64 * rg + 16 * wi + gq;
  uint32_t w0[4], w8[4];
  lds128(w0, x_off + r * kXPitch);
  lds128(w8, x_off + (r + 8) * kXPitch);
#pragma unroll
  for (int q = 0; q < kSteps / 2; ++q) {
    uint32_t e0[4], e8[4];
    expand_word(w0[q], t4, e0);
    expand_word(w8[q], t4, e8);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      af[2 * q + e][0] = e0[2 * e];
      af[2 * q + e][1] = e8[2 * e];
      af[2 * q + e][2] = e0[2 * e + 1];
      af[2 * q + e][3] = e8[2 * e + 1];
    }
  }
}

// The wgmmas of one tile, 64 rows by the N columns N nb .. N nb + N - 1,
// over the contraction's S steps, from the weight stage at ws: K^T
// (K-major B), step s at 32 (s % 4) bytes into the swizzled rows of box
// s / 4, the block nb * N rows on; n-major (MN-major B, N = 64), box nb,
// step s 16 c-rows on. Rows and columns past the operands' are zeros of
// the staging.
template <bool N_MAJOR, int S, int N>
__device__ __forceinline__ void tile_mma(float (&acc)[N / 2],
                                         const uint32_t (&af)[kSteps][4],
                                         uint32_t ws, int nb, int box) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint64_t desc =
        N_MAJOR ? desc_b128(ws + nb * box + s * 16 * 128, box, 1024)
                : desc_b128(ws + (s / 4) * box + nb * N * 128 + (s % 4) * 32,
                            16, 1024);
    if constexpr (N == 64)
      wgmma_m64n64<N_MAJOR ? 1 : 0>(acc, af[s], desc, s > 0);
    else
      wgmma_m64n40<N_MAJOR ? 1 : 0>(acc, af[s], desc, s > 0);
  }
}

// One tile's results into the output stage (the unit's first element at
// base): thread (warp wi, lane 4 gq + t4) holds acc[4 j + 2 h + e], row 64
// rg + 16 wi + gq + 8 h and column N nb + 8 j + 2 t4 + e, each pair
// rounded to bf16 and stored by one 4-byte store where the pair is
// 4-byte aligned, else two 2-byte ones; rows past n and columns past K
// are dropped.
template <int N>
__device__ __forceinline__ void tile_out(const float (&acc)[N / 2],
                                         uint32_t base, int rg, int nb,
                                         int wi, int gq, int t4, int n,
                                         int K) {
  const bool pairs = K % 2 == 0 && base % 4 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * rg + 16 * wi + gq + 8 * h;
    const uint32_t at = base + 2 * (uint32_t)(row * K + N * nb + 2 * t4);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = N * nb + 8 * j + 2 * t4;
      const uint32_t v = mma::bf16x2_rn(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1]);
      const bool on = row < n && col < K;
      if (pairs) {
        sts32_if(at + 16 * j, v, on);
      } else if (on) {
        sts16(at + 16 * j, (uint16_t)(v & 0xFFFF));
        if (col + 1 < K) sts16(at + 16 * j + 2, (uint16_t)(v >> 16));
      }
    }
  }
}

template <bool N_MAJOR, int S, int N>
__global__ void __launch_bounds__(kThreads, 1)
    spike_heads_kernel(const __grid_constant__ CUtensorMap wmap,
                       const Args a) {
  const uint32_t s0 = smem_addr(smem_base());
  const uint32_t x_off = s0 + 2 * a.w_stage, o_off = x_off + kXBytes;
  const uint32_t full0 = o_off + 2 * a.o_stage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4, gq = lane / 4, t4 = lane % 4;
  if (tid == 0) {
    bar_init(full0, 1);
    bar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_weight<N_MAJOR>(wmap, a, blockIdx.x, s0, full0);   // the first unit's
  }
  uint32_t xr[4];
  fetch_row(a, blockIdx.x, tid, xr);
  __syncthreads();

  const int units = a.G * a.slabs;
  const int box = a.w_stage / ((N_MAJOR ? a.K + 63 : a.C + 63) / 64);
  int u = blockIdx.x;
  bool committed = false;   // the last unit's store made a bulk group
  for (int k = 0; u < units; ++k, u += gridDim.x) {
    const int st = k & 1, next = u + gridDim.x;
    const uint32_t ws = s0 + st * a.w_stage, os = o_off + st * a.o_stage;
    // ---- unit u's rows into the staging; unit next's weight and rows on
    // their way (the last unit's reads of both stages ended at its second
    // barrier) ----
    if (tid < kMaxRows) sts128(x_off + tid * kXPitch, xr);
    if (next < units) {
      if (tid == 0)
        load_weight<N_MAJOR>(wmap, a, next, s0 + (st ^ 1) * a.w_stage,
                             full0 + 8 * (st ^ 1));
      fetch_row(a, next, tid, xr);
    }
    // the store of unit k - 2 has read this output stage
    if (tid == 0) {
      if (committed) bulk_wait_read_n<1>();
      else bulk_wait_read_n<0>();
    }
    __syncthreads();
    bar_wait(full0 + 8 * st, (k >> 1) & 1);

    const Unit un(a, u);
    bf16* const out = a.out + un.g1 * a.o_g1 + un.g2 * a.o_g2 +
                      (long long)un.r0 * a.K;
    const int phase = (int)(reinterpret_cast<uintptr_t>(out) % 16);
    // ---- the products: warpgroup wg takes the unit's row group wg (64
    // rows; warp wi of the group rows 16 wi .. 16 wi + 15 of it) and each
    // block of N columns of it in turn: its wgmmas, then its accumulators
    // rounded and written into the output stage while the other
    // warpgroups' wgmmas run ----
    if (64 * wg < un.n) {
      uint32_t af[kSteps][4];
      a_fragments(x_off, wg, wi, gq, t4, af);
      const int blocks = (a.K + N - 1) / N;
      for (int nb = 0; nb < blocks; ++nb) {
        float acc[N / 2];
        wgmma_fence();
        tile_mma<N_MAJOR, S, N>(acc, af, ws, nb, box);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        tile_out<N>(acc, os + phase, wg, nb, wi, gq, t4, un.n, a.K);
      }
    }
    // ---- the unit's rows out: the aligned middle by one bulk copy, the
    // bf16 before and after it by the last warp ----
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int bytes = 2 * un.n * a.K;
    const int head = (16 - phase) % 16 < bytes ? (16 - phase) % 16 : bytes;
    const int mid = (bytes - head) / 16 * 16;
    if (tid == 0) {
      committed = mid > 0;
      if (committed) {
        bulk_store(reinterpret_cast<char*>(out) + head, os + phase + head,
                   mid);
        bulk_commit();
      }
    }
    if (tid >= kThreads - 32) {
      const int l = tid - (kThreads - 32);
      const int e = l < 8 ? l : (head + mid) / 2 + l - 8;
      if (l < 16 && (l < 8 ? 2 * e < head : 2 * e < bytes))
        out[e] = __ushort_as_bfloat16(lds16(os + phase + 2 * e));
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- host ----

// The weight's 4-D tensor map: its unit-stride dim first (n, or c for
// K^T), then the other, then the two batch levels (extent 1 where a level
// does not move); boxes of 64 x box_rows in the 128-byte swizzle, zeros
// past the extents. Returns a cudaError_t.
inline int encode_weight(CUtensorMap* map, Args& a, const bf16* w, int G1,
                         long long w_g1, long long w_g2, long long w_c,
                         long long w_k) {
  a.n_major = w_k == 1 && w_c * 2 % 16 == 0;
  a.w_g2 = a.G2 > 1 && w_g2 != 0;
  a.w_g1 = G1 > 1 && w_g1 != 0;
  const long long inner = a.n_major ? a.K : a.C, outer = a.n_major ? a.C : a.K;
  const long long pitch = 2 * (a.n_major ? w_c : w_k);   // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)(a.w_g2 ? a.G2 : 1),
                              (cuuint64_t)(a.w_g1 ? G1 : 1)};
  cuuint64_t strides[3];
  strides[0] = pitch;
  strides[1] = a.w_g2 ? 2 * w_g2 : pitch * outer;
  strides[2] = a.w_g1 ? 2 * w_g1 : strides[1] * dims[2];
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows(a.C, a.K, a.n_major), 1,
                             1};
  const CUresult r = encode_cached(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(w), dims,
      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The one launch: a block on each SM (at most one a unit) walking the
// units, numbered along axis 0 (tile 1, extent the units, strided).
// Returns a cudaError_t.
inline int heads_plan(int M, int C, int K, long long G, bool n_major,
                      int kernel, Launch& l) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Layout lay = layout_of(M, C, K, n_major);
  const long long units = G * lay.slabs;
  if (units > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  l = launch_of(kThreads, 1, lay.smem, kernel);
  const long long blocks = units < sms ? units : sms;
  axis(l, 0, blocks, 1, units, blocks < units);
  return 0;
}

template <bool N_MAJOR, int S, int N>
int launch_major(const CUtensorMap& map, const Args& a, const Launch& l,
                 cudaStream_t stream) {
  // the attribute is raised once to the most any call asks for
  static bool raised[kMaxDevices] = {};
  Launch most = l;
  most.smem = kSmemMax;
  most.opt_in = 1;
  const int err = raise_smem(
      most, reinterpret_cast<const void*>(spike_heads_kernel<N_MAJOR, S, N>),
      raised);
  if (err != 0) return err;
  spike_heads_kernel<N_MAJOR, S, N>
      <<<grid_of(l), block_of(l), l.smem, stream>>>(map, a);
  return (int)cudaGetLastError();
}

// Encodes the weight's tensor map and launches. Returns a cudaError_t.
inline int launch(Args a, const bf16* w, int G1, long long w_g1,
                  long long w_g2, long long w_c, long long w_k,
                  const Launch& l, cudaStream_t stream) {
  CUtensorMap map;
  const int err = encode_weight(&map, a, w, G1, w_g1, w_g2, w_c, w_k);
  if (err != 0) return err;
  const Layout lay = layout_of(a.M, a.C, a.K, a.n_major);
  a.rows = lay.rows;
  a.slabs = lay.slabs;
  a.w_stage = lay.w_stage;
  a.o_stage = lay.o_stage;
  // the instance: an n-major or K^T weight, at most 4 or 8 k16 steps,
  // wgmmas of 64 or 40 columns (cols_of)
  const bool small_c = a.C <= 64, n40 = cols_of(a.K, a.n_major) == 40;
  if (a.n_major)
    return small_c ? launch_major<true, 4, 64>(map, a, l, stream)
                   : launch_major<true, 8, 64>(map, a, l, stream);
  if (n40)
    return small_c ? launch_major<false, 4, 40>(map, a, l, stream)
                   : launch_major<false, 8, 40>(map, a, l, stream);
  return small_c ? launch_major<false, 4, 64>(map, a, l, stream)
                 : launch_major<false, 8, 64>(map, a, l, stream);
}

}  // namespace hd
}  // namespace e2a
