// Tensor-core tile of the bit-packed spike matmul (mma.sync, bf16 in, fp32
// accumulate).
//
//   out[m][n] = sum_c bit(x[m], c) * w[c][n]
//
// A spike is exactly 0 or 1 in bf16. An fp32 weight is exactly the sum of
// three bf16 values (split_bf16x3 below), so each product of a spike and a
// plane is exact and three m16n8k16 MMAs per fragment, accumulated in fp32
// (spike_matmul.cu: hi in one accumulator, mid and lo in another), give the
// fp32 product up to the order of the fp32 sums and the MMA's truncation of
// the sum it adds to.
//
// Fragment mapping (PTX ISA, mma.m16n8k16 with .bf16 operands; lane =
// 4 * g + t, g = lane / 4, t = lane % 4; a register holds two bf16, the one
// of lower column / contraction index in its low half):
//   A (16 x 16, row):  a0 = row g,   cols 2t, 2t+1     a1 = row g+8, same cols
//                      a2 = row g,   cols 2t+8, 2t+9   a3 = row g+8, same cols
//   B (16 x 8, col):   b0 = contraction 2t, 2t+1 of column g; b1 = +8
//   C/D (16 x 8 fp32): d0, d1 = row g, cols 2t, 2t+1; d2, d3 = row g+8
// A is never in shared memory as bf16: byte j of a packed row holds the
// contraction indices 8j .. 8j+7 (LSB first), so for the k16 step s a lane
// takes bits 2t, 2t+1 of bytes 2s (a0, a1) and 2s+1 (a2, a3) of its two rows
// and maps each bit to 0x3F80 (bf16 1.0) or 0 (bits_to_bf16x2).
//
// Shared-memory layout of one stage:
//   xs: the block's packed rows for a BK-wide contraction chunk, BK / 8
//       bytes per row, rows contiguous (filled by cp.async where a row's
//       bytes are contiguous and aligned). For k16 step s a lane reads
//       the 32-bit word holding bytes 2s and 2s+1 of each of its rows; the
//       rows g = 0..7 of a tile lie BK / 8 bytes apart, so the eight words
//       a warp reads fall in distinct banks.
//   ws: three bf16 planes hi, mid, lo of the BK x BN weight chunk, each
//       [c][n] with n contiguous and a row pitch of BN + 8 elements. B
//       fragments come from ldmatrix.x4.trans: the 8 rows (c) of each 8x8
//       matrix start 16 bytes apart modulo 128, so the eight 16-byte rows hit
//       distinct bank groups and the load is conflict-free.
//
// The PTX wrappers (cp_async, cp_async_commit, cp_async_wait,
// cp_async_wait_all, ldmatrix_x4_trans, mma_bf16) are all the inline
// assembly there is; a host emulation of the thread model can define
// E2A_HOST_EMULATION and supply them (lif_soma.cu uses the cp.async three
// alone).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace e2a {
namespace mma {

// Two bf16 in one register, a in the low half: the layout of a bf16x2
// fragment register and of two neighbouring elements of a plane.
__device__ __forceinline__ uint32_t bf16x2_rn(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // one cvt
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float low_float(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float high_float(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// The exact split of two weights (a, b) into the bf16x2 words of the three
// planes, plane[0] = hi, plane[1] = mid, plane[2] = lo, with
// w == hi + mid + lo for each: hi rounds w to nearest and keeps its leading
// 8 significant bits, the residual w - hi (exact in fp32) has at most 16,
// mid rounds it to 8 of them and w - hi - mid (exact) holds the last 8,
// which lo keeps exactly. Exact for 0 and |w| in [2^-110, 2^127]: below, lo
// would need bf16 subnormals finer than 2^-133; above, hi rounds to
// infinity. The plain version is split_bf16x3 in kernels/spike_matmul.py.
__device__ __forceinline__ void split_bf16x3(float a, float b,
                                             uint32_t (&plane)[3]) {
  plane[0] = bf16x2_rn(a, b);
  const float ra = __fsub_rn(a, low_float(plane[0]));
  const float rb = __fsub_rn(b, high_float(plane[0]));
  plane[1] = bf16x2_rn(ra, rb);
  plane[2] = bf16x2_rn(__fsub_rn(ra, low_float(plane[1])),
                       __fsub_rn(rb, high_float(plane[1])));
}

// Bits 0 and 1 of b -> a bf16x2 register {bit0 ? 1.0 : 0, bit1 ? 1.0 : 0}.
__device__ __forceinline__ uint32_t bits_to_bf16x2(uint32_t b) {
  return (b & 1u) * 0x3F80u | (b & 2u) * 0x1FC00000u;
}

#ifndef E2A_HOST_EMULATION

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four transposed 8x8 bf16 matrices; lane i gives the address of row i % 8
// of matrix i / 8 and receives r[q] = the pair of matrix q it holds.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a * b on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#endif  // E2A_HOST_EMULATION

}  // namespace mma
}  // namespace e2a
