// The mainloop of the bf16 spike products on Hopper, shared by every kernel
// that multiplies packed spikes by a bf16 weight on wgmma: the bf16 spike
// matmul (spike_wgmma.cuh) and, at bf16, the neuron layer's train z pass
// and eval arm (neuron_layer.cu), as spike_mma_mainloop.cuh is the one
// contraction loop of their mma.sync arms. One source, so the spike
// matmul's bitwise checks on the card hold the neuron layer's product too.
//
//   acc[n] = sum_c bit(x[g][m], c) * w[g][c][n]   (w bf16, acc fp32)
//
// mainloop<T, N_MAJOR, BATCH_INNER>(wmap, xmap, a, epi) runs the whole
// kernel body: a persistent block on each SM walks output tiles of BM = 64 *
// CWG rows x BN = 128 columns (walk: by default the batch outermost; with
// BATCH_INNER a block owns a unit of rows and columns and walks its G
// batches in order, which the eval neuron layer's time steps need).
// Warpgroup 0 is the producer: one of its warps keeps a ring of STAGES
// stages full (the other three leave at once, or, for rows
// TMA cannot read, copy them with it), and setmaxnreg hands the consumers
// its spare registers. Warpgroups 1 .. CWG are the consumers, 64 rows each.
// Each consumer hands every tile's accumulators to the kernel's epilogue,
// epi.tile(acc, at), and, when its walk ends, epi.done(sink).
//
// - A stage holds one BK = 128 chunk of the contraction: the BK x BN bf16
//   weight tile and the tile's BM packed rows of that chunk (16 bytes a
//   row), both by TMA (cp.async.bulk.tensor over 4-D tensor maps: the
//   matrix dims and the two batch levels); the weight in the 128-byte
//   swizzle. Its full barrier takes one arrival, with the bytes; its empty
//   barrier one from each consumer. Rows whose pitch is no multiple of 16
//   bytes (C = 520: 65), which TMA cannot read, the producer's four warps
//   copy themselves, byte by byte.
// - A consumer builds the A fragments of its 64 rows from the staged bits
//   in registers (expand_word: the register-A layout of wgmma m64nNk16 is
//   mma.m16n8k16's, warp w of the group holding rows 16w .. 16w + 15; see
//   spike_tile_mma.cuh) and issues one wgmma m64n128k16 per k16 step, B
//   read from shared memory through a descriptor in the TMA's swizzle.
//   The four steps of a half chunk are one group; a group reads its A
//   registers until it completes, so the halves build into two register
//   slots in turn, and a group is waited for (wait_group 1) only once the
//   next is issued: a consumer's fragments for the next group are built
//   while its last one runs.
// - The weight is read where it lies, in either layout: n with unit stride
//   (an MN-major B, the descriptor's transpose bit set) or c with unit
//   stride (a K^T view: K-major B). Rows past M, columns past K and
//   contraction indices past C are zero-filled by TMA.
// - The accumulator of a consumer is wgmma's m64n128 D fragment: thread
//   (warp w, lane 4 gq + t4) holds acc[4 j + 2 h + e] of row 16 w + gq + 8 h
//   and column 8 j + 2 t4 + e of its 64 rows, mma.m16n8's layout per warp.
//
// The tensor cores add the exact products of each k16 step into the fp32
// accumulators in the order of the contraction, as the one-plane arm does;
// where every partial sum is exact (dyadic weights) the bits are the
// oracle's.
#pragma once

#include <cuda.h>            // CUtensorMap and the encoder's enums only
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "elem.cuh"
#include "launch_plan.cuh"

namespace e2a {
namespace wg {

// The kernel's tile: CWG consumer warpgroups of 64 rows, BN = 128 output
// columns, the contraction staged BK = 128 at a time in a ring of STAGES,
// and EPI bytes of shared memory for the epilogue (by default a bf16
// output tile of each consumer's).
template <int CWG_, int STAGES_, int EPI_ = 64 * 128 * 2 * CWG_>
struct WTile {
  static constexpr int CWG = CWG_, STAGES = STAGES_, EPI = EPI_;
  static constexpr int BM = 64 * CWG, BN = 128, BK = 128;
  static constexpr int THREADS = 128 * (1 + CWG);   // + the producer's
  // Registers a thread: at launch (the launch bounds' share), the
  // producer's after setmaxnreg.dec and the consumers' after .inc. An
  // .inc waits until the block's own pool holds the registers, so the
  // consumers take no more than the producer's warpgroup gave up: a larger
  // count would wait forever.
  static constexpr int LAUNCH_REGS = (65536 / THREADS) & ~7;
  static constexpr int PRODUCER_REGS = 56;
  static constexpr int CONSUMER_REGS =
      ((1 + CWG) * LAUNCH_REGS - PRODUCER_REGS) / CWG & ~7;
  static_assert(CONSUMER_REGS > LAUNCH_REGS && CONSUMER_REGS <= 240,
                "setmaxnreg");
  static constexpr int XBYTES = BK / 8;             // packed bytes a row
  static constexpr int W_STAGE = BK * BN * 2;       // weight bytes a stage
  static constexpr int X_STAGE = BM * XBYTES;       // packed bytes a stage
  static constexpr int X_OFF = STAGES * W_STAGE;
  static constexpr int E_OFF = X_OFF + STAGES * X_STAGE;   // the epilogue's
  static constexpr int BAR_OFF = E_OFF + EPI;
  // + 1024: the dynamic shared memory is aligned to 1024 bytes by hand
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(W_STAGE % 1024 == 0 && E_OFF % 1024 == 0, "swizzle atoms");
  static_assert(SMEM <= 232448, "shared memory");
};

// The kernel's arguments besides its tensor maps (element strides; the
// output's are the spike matmul epilogue's, unused by the neuron layer's,
// whose outputs go out by their own tensor maps).
struct Args {
  const uint8_t* x;
  bf16* out;
  int G, G2, M, C, K;
  long long x_g1, x_g2, x_m, x_b;
  long long o_g1, o_g2, o_m, o_n;
  int w_g1, w_g2;   // 1 where the weight map's batch level moves with g
  int n_major;      // 1: w has unit stride along n; 0: along c (K^T)
  int x_tma;        // 1: the packed rows come by TMA (xmap)
  int x_l1, x_l2;   // as w_g1, w_g2 for xmap
  int o_tma;        // 1: the outputs go out by TMA (omap)
};

// ---- PTX ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from shared memory at a shared-space address; 4 bytes to one.
__device__ __forceinline__ void lds128(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier `id` of `threads` threads (a consumer warpgroup's own).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of a 4-D tensor map into shared memory, its bytes counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// One box of shared memory to a 3-D tensor map's place (a bulk group).
__device__ __forceinline__ void tma_store(uint32_t src, const CUtensorMap* map,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma issue or wait (no instruction).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The shared-memory descriptor of a B operand in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d = a * b + (add ? d : 0) for one m64n128k16 step: a the four bf16x2
// registers of the lane's A fragment, b from shared memory (TRANS_B 1:
// MN-major).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(add),
        "n"(TRANS_B));
}

// The A-fragment registers of one 32-bit word of a packed row: for each
// byte j, the bf16x2 pair {bit 2t, bit 2t + 1} of that byte as 1.0 or 0
// (the lane's two contraction indices of that byte; t = lane % 4). The
// word shifted left by 7 - 2t puts bit 2t of every byte at its byte's
// top, by 6 - 2t bit 2t + 1; prmt's sign mode spreads a byte's top bit
// over a whole byte, so bytes j, j, 4 + j, 4 + j with the sign bit set give
// 0xFF where a spike is, and the mask leaves bf16 1.0 (0x3F80) in each half.
// bits_to_bf16x2 in spike_tile_mma.cuh is the same map, a bit pair at a
// time.
__device__ __forceinline__ void expand_word(uint32_t w, int t,
                                            uint32_t (&r)[4]) {
  const uint32_t lo = w << (7 - 2 * t), hi = w << (6 - 2 * t);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sel = 0xCC88u | (j * 0x1111u);
    uint32_t v;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(v) : "r"(lo), "r"(hi), "r"(sel));
    r[j] = v & 0x3F803F80u;
  }
}

// The XOR of a slot's registers: a read of each.
__device__ __forceinline__ uint32_t fold(const uint32_t (&af)[4][4]) {
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) v ^= af[s][0] ^ af[s][1] ^ af[s][2] ^ af[s][3];
  return v;
}

// The descriptor of k16 step s of a stage at w_stage. MN-major (the
// weight's n has unit stride): BN / 64 boxes of BK c-rows x 64 n, each
// c-row 128 bytes, eight of them a 1024-byte swizzle atom; a k16 step is
// two atoms on (SBO 1024), the next 64 n a box on (LBO). K-major (K^T):
// two boxes of BN n-rows x 64 c; step s lies in box s / 4 at 32 (s % 4)
// bytes into the swizzled rows, the next 8 n-rows 1024 bytes on (SBO).
template <class T, bool N_MAJOR>
__device__ __forceinline__ uint64_t step_desc(uint32_t w_stage, int s) {
  if constexpr (N_MAJOR) {
    return desc_b128(w_stage + s * 16 * 128, T::BK * 128, 1024);
  } else {
    return desc_b128(w_stage + (s / 4) * T::BN * 128 + (s % 4) * 32, 16,
                     1024);
  }
}
// Where a consumer's tile lies: row tile tm (rows m0 .. m0 + BM - 1 of
// batch g = g1 * G2 + g2), columns n0 .. n0 + BN - 1.
struct TileAt {
  int tm, g, g1, g2;
  long long m0;
  int n0;
};

// The block's tiles in its walk order, f(tm, tn, g) for each (row tile,
// column tile, batch). By default tile t = b, b + gridDim.x, ... of the
// tiles numbered with the row tiles fastest, then the column tiles, then
// the batch, so that the blocks at work at once share weight columns. With
// BATCH_INNER, unit u = b, b + gridDim.x, ... of the (row tile, column
// tile) units, each walked over its G batches in order: the block that
// owns a unit sees every batch of its outputs, one after the other (the
// eval neuron layer's batch is the time step, and its membranes stay with
// the consumer across the steps).
template <bool BATCH_INNER, class F>
__device__ __forceinline__ void walk(int tiles_m, int tiles_n, int G, F&& f) {
  if constexpr (BATCH_INNER) {
    const int units = tiles_m * tiles_n;
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      for (int g = 0; g < G; ++g) f(u % tiles_m, u / tiles_m, g);
  } else {
    const int tiles = tiles_m * tiles_n * G;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      f(t % tiles_m, t / tiles_m % tiles_n, t / (tiles_m * tiles_n));
  }
}

// The block's dynamic shared memory, aligned to 1024 bytes by hand (the
// 128-byte swizzle's atoms).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

template <class T, bool N_MAJOR, bool BATCH_INNER = false, class Epilogue>
__device__ __forceinline__ void mainloop(const CUtensorMap& wmap,
                                         const CUtensorMap& xmap,
                                         const Args& a, Epilogue& epi) {
  unsigned char* const smem = smem_base();
  const uint32_t s0 = smem_addr(smem);
  const uint32_t full0 = s0 + T::BAR_OFF, empty0 = full0 + 8 * T::STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      bar_init(full0 + 8 * s, 1);         // the producer's lane 0
      bar_init(empty0 + 8 * s, T::CWG);   // one from each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks its tiles in walk<BATCH_INNER>'s order: tile (tm, tn,
  // g) is rows BM tm, columns BN tn of batch g.
  const int tiles_m = (a.M + T::BM - 1) / T::BM;
  const int tiles_n = (a.K + T::BN - 1) / T::BN;
  const int chunks = (a.C + T::BK - 1) / T::BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  // it counts the chunks this block has staged (producer) or consumed:
  // stage it % STAGES, in its (it / STAGES)-th round.
  int it = 0;

  if (wg == 0) {
    // ---- producer: one warp keeps the ring full; all four copy rows
    // that TMA cannot read ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     T::PRODUCER_REGS) : "memory");
    if (a.x_tma && tid >= 32) return;
    const int lane = tid, C8 = a.C / 8;
    walk<BATCH_INNER>(tiles_m, tiles_n, a.G, [&](int tm, int tn, int g) {
      const int g1 = g / a.G2, g2 = g % a.G2;
      const long long m0 = (long long)tm * T::BM;
      const int n0 = tn * T::BN;
      const uint8_t* const x = a.x + g1 * a.x_g1 + g2 * a.x_g2;
      const int wc2 = a.w_g2 ? g2 : 0, wc3 = a.w_g1 ? g1 : 0;
      const int xc2 = a.x_l2 ? g2 : 0, xc3 = a.x_l1 ? g1 : 0;
      for (int i = 0; i < chunks; ++i, ++it) {
        const int st = it % T::STAGES;
        const uint32_t full = full0 + 8 * st;
        bar_wait(empty0 + 8 * st, ((it / T::STAGES) & 1) ^ 1);
        const uint32_t ws = s0 + st * T::W_STAGE;
        const uint32_t xs = s0 + T::X_OFF + st * T::X_STAGE;
        const int cb0 = i * T::XBYTES;
        if (lane == 0) {
          // the stage's one arrival, with the bytes its copies bring
          if (a.x_tma) {
            bar_arrive_tx(full, T::W_STAGE + T::X_STAGE);
            tma_load(xs, &xmap, full, cb0, (int)m0, xc2, xc3);
          } else {
            bar_expect_tx(full, T::W_STAGE);
          }
          if (a.n_major) {
#pragma unroll
            for (int j = 0; j < T::BN / 64; ++j)
              tma_load(ws + j * T::BK * 128, &wmap, full, n0 + 64 * j,
                       i * T::BK, wc2, wc3);
          } else {
#pragma unroll
            for (int q = 0; q < T::BK / 64; ++q)
              tma_load(ws + q * T::BN * 128, &wmap, full, i * T::BK + 64 * q,
                       n0, wc2, wc3);
          }
        }
        if (!a.x_tma) {
          // rows whose pitch TMA cannot take: the warpgroup's 128 threads,
          // a row at a time each, byte by byte (all of a thread's loads in
          // flight together), zeros past M and C
          unsigned char* const xp = smem + T::X_OFF + st * T::X_STAGE;
#pragma unroll
          for (int j = 0; j < (T::BM + 127) / 128; ++j) {
            const int r = tid + 128 * j;
            if (r >= T::BM) break;
            const long long row = m0 + r;
            const uint8_t* const src = x + row * a.x_m + cb0 * a.x_b;
            uint8_t v[T::XBYTES];
#pragma unroll
            for (int b = 0; b < T::XBYTES; ++b)
              v[b] = row < a.M && cb0 + b < C8 ? src[b * a.x_b] : 0;
#pragma unroll
            for (int b = 0; b < T::XBYTES; ++b) xp[r * T::XBYTES + b] = v[b];
          }
          __threadfence_block();
          named_sync(15, 128);       // the warpgroup's rows are all in
          if (tid == 0) bar_arrive(full);
        }
      }
    });
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::CONSUMER_REGS) : "memory");
    const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
    const int r0 = (wg - 1) * 64 + warp * 16 + gq;   // rows r0, r0 + 8
    uint32_t af[2][4][4];   // the two fragment slots of the half chunks
    uint32_t sink = 0;
    walk<BATCH_INNER>(tiles_m, tiles_n, a.G, [&](int tm, int tn, int g) {
      const int g1 = g / a.G2, g2 = g % a.G2;
      const long long m0 = (long long)tm * T::BM;
      const int n0 = tn * T::BN;
      // No instruction but a wgmma writes the accumulators: the tile's
      // first step overwrites them (add = 0).
      float acc[T::BN / 2];
      // Group 2i + h is steps 4h .. 4h + 3 of chunk i, built into slot h
      // while the group before, in the other slot, may still run. Each
      // slot is read again once the wait ends its group (folded into
      // `sink`, stored where no run reaches): the slot stays live until
      // then, so no value built meanwhile is given its registers.
      for (int i = 0; i < chunks; ++i) {
        const int st = (it + i) % T::STAGES;
        bar_wait(full0 + 8 * st, ((it + i) / T::STAGES) & 1);
        const uint32_t xs = s0 + T::X_OFF + st * T::X_STAGE;
        uint32_t w0[4], w8[4];   // the chunk's 16 bytes of rows r0, r0 + 8
        lds128(w0, xs + r0 * T::XBYTES);
        lds128(w8, xs + (r0 + 8) * T::XBYTES);
        const uint32_t ws = s0 + st * T::W_STAGE;
        const auto half = [&](auto half_index) {
          constexpr int h = decltype(half_index)::value;
#pragma unroll
          for (int q = 2 * h; q < 2 * h + 2; ++q) {   // bytes 4q .. 4q + 3
            uint32_t a0[4], a8[4];
            expand_word(w0[q], t4, a0);
            expand_word(w8[q], t4, a8);
#pragma unroll
            for (int e = 0; e < 2; ++e) {   // step 2q + e: bytes 4q + 2e, + 1
              const int s = 2 * (q - 2 * h) + e;
              af[h][s][0] = a0[2 * e];
              af[h][s][1] = a8[2 * e];
              af[h][s][2] = a0[2 * e + 1];
              af[h][s][3] = a8[2 * e + 1];
            }
          }
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_m64n128<N_MAJOR ? 1 : 0>(
                acc, af[h][s], step_desc<T, N_MAJOR>(ws, 4 * h + s),
                i > 0 || h > 0 || s > 0);
          wgmma_commit();
          wgmma_wait<1>();                  // the other slot's group is done
          if (h == 1 || i > 0) sink ^= fold(af[1 - h]);
          // chunk i - 1's groups are done: every warp of this consumer
          // issued them, so its reads of that stage are done too
          if (h == 0 && i > 0 && tid == 0)
            bar_arrive(empty0 + 8 * ((it + i - 1) % T::STAGES));
        };
        half(std::integral_constant<int, 0>{});
        half(std::integral_constant<int, 1>{});
      }
      wgmma_wait<0>();
      sink ^= fold(af[1]);
      if (tid == 0) bar_arrive(empty0 + 8 * ((it + chunks - 1) % T::STAGES));
      it += chunks;
      fence_acc(acc);

      epi.tile(acc, TileAt{tm, g, g1, g2, m0, n0});
    });
    epi.done(sink);
  }
}

// ---- host: the rule's operand check, the tensor map, the launch ----

// Whether TMA can read the weight (G1, G2, C, K) with these element strides
// and the kernel can take the call: a 16-byte aligned base, unit stride
// along n (then c's stride a multiple of 16 bytes) or along c (then n's), a
// batch level that moves (more than one batch) with a stride of 0 or a
// multiple of 16 bytes, and C > 0. spike_matmul.tma_suits is its twin.
inline bool tma_suits(const void* w, int G1, int G2, int C, int K,
                      long long w_g1, long long w_g2, long long w_c,
                      long long w_k) {
  if (C <= 0 || K <= 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return false;
  const bool n_major = w_k == 1 && w_c > 0 && w_c * 2 % 16 == 0;
  const bool c_major = w_c == 1 && w_k > 0 && w_k * 2 % 16 == 0;
  if (!n_major && !c_major) return false;
  const auto level_ok = [](int n, long long s) {
    return n <= 1 || (s >= 0 && s * 2 % 16 == 0);
  };
  return level_ok(G1, w_g1) && level_ok(G2, w_g2);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda); null where the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled through a cache: a map is a function of the
// encoder's arguments alone, so a call whose arguments (base address,
// extents, strides, box, swizzle) match an entry's takes its map, bit for
// bit what the encoder would give. The model's calls repeat theirs: the
// weight stays put and the caching allocator hands the same blocks back
// for the packed rows and the output. A direct-mapped table under a mutex.
struct MapKey {
  uint64_t v[20];
  bool operator==(const MapKey& o) const {
    for (int i = 0; i < 20; ++i)
      if (v[i] != o.v[i]) return false;
    return true;
  }
};

inline CUresult encode_cached(CUtensorMap* map, CUtensorMapDataType type,
                              cuuint32_t rank, void* base,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle,
                              CUtensorMapL2promotion l2) {
  constexpr int kEntries = 64;
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool valid;
  };
  static Entry table[kEntries];
  static std::mutex lock;
  MapKey key = {};
  key.v[0] = reinterpret_cast<uintptr_t>(base);
  key.v[1] = ((uint64_t)type << 32) | ((uint64_t)swizzle << 16) |
             ((uint64_t)l2 << 8) | rank;
  for (cuuint32_t i = 0; i < rank; ++i) {
    key.v[2 + i] = dims[i];
    key.v[7 + i] = box[i];
    if (i + 1 < rank) key.v[12 + i] = strides[i];
  }
  uint64_t h = 1469598103934665603ull;
  for (uint64_t x : key.v) h = (h ^ x) * 1099511628211ull;
  Entry& e = table[h % kEntries];
  {
    std::lock_guard<std::mutex> guard(lock);
    if (e.valid && e.key == key) {
      *map = e.map;
      return CUDA_SUCCESS;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, base, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) {
    std::lock_guard<std::mutex> guard(lock);
    e = {key, *map, true};
  }
  return r;
}

// The weight's 4-D tensor map: its unit-stride dim first (n, or c for
// K^T), then the other, then the two batch levels; a level that does not
// move (one batch, or stride 0: one weight shared by every batch) has
// extent 1 and coordinate 0. Boxes: 64 x BK (n-major) or 64 x BN (K^T),
// the 128-byte swizzle, zeros past the extents. Returns a cudaError_t.
template <class T>
int encode_weight(CUtensorMap* map, Args& a, const bf16* w, int G1, int G2,
                  long long w_g1, long long w_g2, long long w_c,
                  long long w_k) {
  a.n_major = w_k == 1 && w_c * 2 % 16 == 0;
  a.w_g2 = G2 > 1 && w_g2 != 0;
  a.w_g1 = G1 > 1 && w_g1 != 0;
  const long long inner = a.n_major ? a.K : a.C, outer = a.n_major ? a.C : a.K;
  const long long pitch = 2 * (a.n_major ? w_c : w_k);   // bytes
  cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)outer,
                        (cuuint64_t)(a.w_g2 ? G2 : 1),
                        (cuuint64_t)(a.w_g1 ? G1 : 1)};
  cuuint64_t strides[3];
  strides[0] = pitch;
  strides[1] = a.w_g2 ? 2 * w_g2 : pitch * outer;
  strides[2] = a.w_g1 ? 2 * w_g1 : strides[1] * dims[2];
  const cuuint32_t box[4] = {64, (cuuint32_t)(a.n_major ? T::BK : T::BN), 1,
                             1};
  const CUresult r = encode_cached(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(w), dims,
      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The one launch: a block on each SM (at most one a tile), each walking
// the tiles of BM rows x BN columns x one batch, numbered along axis 0
// (tile 1, extent the tiles, strided). Returns a cudaError_t.
template <class T>
int wgmma_plan(int M, int K, long long G, int kernel, Launch& l) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = cdiv(M, T::BM) * cdiv(K, T::BN) * G;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  l = launch_of(T::THREADS, 1, T::SMEM, kernel);
  const long long blocks = tiles < sms ? tiles : sms;
  axis(l, 0, blocks, 1, tiles, blocks < tiles);
  return 0;
}

// The packed rows' 4-D tensor map where TMA can read them (bytes with
// unit stride, a row pitch and moving batch strides of multiples of 16
// bytes, a 16-byte aligned base): the row's bytes, the rows, the two batch
// levels as for the weight; boxes of 16 bytes x BM rows, zeros past the
// extents. Elsewhere a.x_tma stays 0 and the producer stages the rows
// itself. Returns a cudaError_t.
template <class T>
int encode_rows(CUtensorMap* map, Args& a, int G1) {
  const auto moves = [](int n, long long s) { return n > 1 && s != 0; };
  a.x_l2 = moves(a.G2, a.x_g2);
  a.x_l1 = moves(G1, a.x_g1);
  const bool ok = a.x_b == 1 && a.x_m > 0 && a.x_m % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                  (!a.x_l2 || (a.x_g2 > 0 && a.x_g2 % 16 == 0)) &&
                  (!a.x_l1 || (a.x_g1 > 0 && a.x_g1 % 16 == 0));
  a.x_tma = 0;
  if (!ok) return 0;
  cuuint64_t dims[4] = {(cuuint64_t)(a.C / 8), (cuuint64_t)a.M,
                        (cuuint64_t)(a.x_l2 ? a.G2 : 1),
                        (cuuint64_t)(a.x_l1 ? G1 : 1)};
  cuuint64_t strides[3];
  strides[0] = a.x_m;
  strides[1] = a.x_l2 ? a.x_g2 : a.x_m * a.M;
  strides[2] = a.x_l1 ? a.x_g1 : strides[1] * dims[2];
  const cuuint32_t box[4] = {T::XBYTES, T::BM, 1, 1};
  const CUresult r = encode_cached(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<uint8_t*>(a.x), dims,
      strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  a.x_tma = 1;
  return 0;
}

}  // namespace wg
}  // namespace e2a
