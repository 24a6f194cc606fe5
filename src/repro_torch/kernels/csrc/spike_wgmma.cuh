// The bf16 spike matmul for Hopper: a TMA ring, warp specialisation, and
// wgmma with the spike operand expanded in registers.
//
//   out[g][m][n] = sum_c bit(x[g][m], c) * w[g][c][n]     (w, out bf16)
//
// Replaces, at a bf16 weight, the reference's _spike_mm_kernel
// (src/repro/kernels/spike_matmul.py:80) and _spike_bmm_kernel (:139) where
// spike_matmul.py's rule sends a call here (more than 512 rows, a weight
// TMA can read); the one-plane arm of spike_mma_mainloop.cuh takes the
// rest. The function is the reference's at a bf16 weight: the spikes
// unpacked to bf16 (exactly 0 or 1), every product exact, the sums kept in
// fp32 and each result rounded to bf16 once, at the store.
//
// What bounds it: one dense bf16 pass, 2MCK operations at the tensor
// cores' rate, at pssa.proj, smlp.b and tokenizer.conv.3, with the
// output's bytes close behind at C = 512. The one-plane mma.sync arm
// reached a fifth of that: its weight went through registers into shared
// memory behind two barriers a chunk, with nothing in flight while the
// tensor cores waited.
//
// The producer (a TMA ring of weight chunks and packed rows) and the
// consumers (the spikes expanded into wgmma's register A fragments, the
// persistent tile walk) are the mainloop of wgmma_mainloop.cuh, which the
// train-mode neuron layer's bf16 z pass runs too. This file holds the
// spike matmul's epilogue (OutEpilogue) and its host side:
// - The outputs go through shared memory, in the output's 128-byte
//   swizzle, and out by TMA, which runs on while the consumer starts its
//   next tile (where TMA cannot write the output, the consumers store 16
//   bytes a lane). The TMA store clips rows past M and columns past K.
// - The weight is read where it lies, in either layout: n with unit stride
//   (pssa.proj, smlp.b, the tokenizer's shared weight: an MN-major B, the
//   descriptor's transpose bit set) or c with unit stride (a K^T view:
//   K-major B).
//
// The tile: at M = 12,544 rows and 512 columns, 192 x 128 makes 264 tiles,
// two for each of the H100's 132 SMs; 128 x 128 makes 392 (2.97 a SM) and
// 128 x 256 makes 196 (1.48 a SM, the last round half empty). A weight
// chunk staged once serves 192 rows (PERF.md, section 6).
#pragma once

#include "spike_tile_mma.cuh"   // bf16x2_rn
#include "wgmma_mainloop.cuh"

namespace e2a {
namespace wg {

using Wide = WTile<3, 4>;
static_assert(Wide::SMEM == 193600, "the spike matmul's shared memory");

// Byte offset of 16-byte piece p (columns 8p .. 8p + 7) of row r in a
// consumer's staged outputs: 64-column boxes of 64 rows x 128 bytes, the
// pieces of a row in the 128-byte swizzle (piece ^ row % 8), as TMA reads
// a box of the output's tensor map. A warp's 4-byte writes of one piece
// index over its eight rows fall in 32 distinct banks.
__device__ __forceinline__ uint32_t e_offset(int r, int p) {
  return (p / 8) * 64 * 128 + r * 128 + (((p % 8) ^ (r % 8)) * 16);
}

// The spike matmul's epilogue of one consumer (a bf16 output tile of 64
// rows x BN columns, at E_OFF + (wg - 1) * E_WG).
template <class T>
struct OutEpilogue {
  static constexpr int E_WG = 64 * T::BN * 2;
  static_assert(T::EPI == T::CWG * E_WG, "a bf16 output tile a consumer");
  const CUtensorMap& omap;
  const Args& a;

  __device__ __forceinline__ void tile(float (&acc)[T::BN / 2],
                                       const TileAt& at) {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
    const uint32_t ebuf = smem_addr(smem_base()) + T::E_OFF + (wg - 1) * E_WG;
    const int g = at.g, g1 = at.g1, g2 = at.g2, n0 = at.n0;
    const long long m0 = at.m0;
    // ---- epilogue: each result rounded to bf16 once, staged in shared
    // memory in the 128-byte swizzle (64-column boxes of 64 rows), then
    // stored by TMA, which clips rows past M and columns past K and runs
    // on while this consumer goes on to its next tile; where TMA cannot
    // write the output, 16 bytes a lane along its rows ----
    if (a.o_tma && tid == 0) bulk_wait_read();   // the last store has read it
    named_sync(wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j)
        sts32(ebuf + e_offset(r, j) + 4 * t4,
              mma::bf16x2_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
    if (a.o_tma) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int q = 0; q < T::BN / 64; ++q)
          tma_store(ebuf + q * 64 * 128, &omap, n0 + 64 * q,
                    (int)m0 + (wg - 1) * 64, g);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      return;
    }
    named_sync(wg, 128);
    bf16* const out = a.out + g1 * a.o_g1 + g2 * a.o_g2;
    const long long o_m = a.o_m, o_n = a.o_n;
    const bool vec = o_n == 1 && o_m % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    constexpr int PER_ROW = T::BN / 8;            // 16-byte pieces a row
    for (int q = tid; q < 64 * PER_ROW; q += 128) {
      const int rl = q / PER_ROW, piece = q % PER_ROW;
      const long long row = m0 + (wg - 1) * 64 + rl;
      const int col = n0 + 8 * piece;
      if (row >= a.M || col >= a.K) continue;
      uint4 v;
      lds128(reinterpret_cast<uint32_t(&)[4]>(v), ebuf + e_offset(rl, piece));
      bf16* const o = out + row * o_m + col * o_n;
      if (vec && col + 8 <= a.K) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const bf16* const e = reinterpret_cast<const bf16*>(&v);
        for (int u = 0; u < 8 && col + u < a.K; ++u) o[u * o_n] = e[u];
      }
    }
  }

  __device__ __forceinline__ void done(uint32_t sink) {
    if (a.o_tma && threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (a.M < 0)
      a.out[threadIdx.x] = __ushort_as_bfloat16((unsigned short)sink);
  }
};

template <class T, bool N_MAJOR>
__global__ void __launch_bounds__(T::THREADS, 1)
    spike_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap omap,
                       const Args a) {
  OutEpilogue<T> epi{omap, a};
  mainloop<T, N_MAJOR>(wmap, xmap, a, epi);
}

// The output's 3-D tensor map where TMA can write it (unit stride along
// K, a row pitch and batch stride of multiples of 16 bytes, the two batch
// levels one stride apart, a 16-byte aligned base): K, M, the batches;
// boxes of 64 columns x 64 rows in the 128-byte swizzle. Elsewhere
// a.o_tma stays 0 and the consumers store the rows themselves. Returns a
// cudaError_t.
inline int encode_out(CUtensorMap* map, Args& a, int G1) {
  const long long o_g = a.G2 > 1 ? a.o_g2 : a.o_g1;
  const bool ok = a.o_n == 1 && a.o_m > 0 && a.o_m * 2 % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.out) % 16 == 0 &&
                  (a.G <= 1 || (o_g > 0 && o_g * 2 % 16 == 0)) &&
                  (G1 <= 1 || a.G2 <= 1 || a.o_g1 == a.G2 * a.o_g2);
  a.o_tma = 0;
  if (!ok) return 0;
  const cuuint64_t dims[3] = {(cuuint64_t)a.K, (cuuint64_t)a.M,
                              (cuuint64_t)a.G};
  const cuuint64_t strides[2] = {(cuuint64_t)(2 * a.o_m),
                                 (cuuint64_t)(a.G > 1 ? 2 * o_g
                                                      : 2 * a.o_m * a.M)};
  const cuuint32_t box[3] = {64, 64, 1};
  const CUresult r = encode_cached(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.out, dims, strides, box,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  a.o_tma = 1;
  return 0;
}

template <class T, bool N_MAJOR>
int launch_major(const CUtensorMap& map, const CUtensorMap& xmap,
                 const CUtensorMap& omap, const Args& a, const Launch& l,
                 cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(
      l, reinterpret_cast<const void*>(spike_wgmma_kernel<T, N_MAJOR>),
      raised);
  if (err != 0) return err;
  spike_wgmma_kernel<T, N_MAJOR>
      <<<grid_of(l), block_of(l), l.smem, stream>>>(map, xmap, omap, a);
  return (int)cudaGetLastError();
}

// Encodes the tensor maps and launches. Returns a cudaError_t.
template <class T>
int launch(Args a, const bf16* w, int G1, long long w_g1, long long w_g2,
           long long w_c, long long w_k, const Launch& l,
           cudaStream_t stream) {
  CUtensorMap map, xmap = {}, omap = {};
  int err = encode_weight<T>(&map, a, w, G1, a.G2, w_g1, w_g2, w_c, w_k);
  if (err == 0) err = encode_rows<T>(&xmap, a, G1);
  if (err == 0) err = encode_out(&omap, a, G1);
  if (err != 0) return err;
  return a.n_major ? launch_major<T, true>(map, xmap, omap, a, l, stream)
                   : launch_major<T, false>(map, xmap, omap, a, l, stream);
}

}  // namespace wg
}  // namespace e2a
