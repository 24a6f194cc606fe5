// The contraction loop of the bit-packed spike matmul on the tensor cores,
// shared by every kernel that multiplies packed spikes by an fp32 weight:
// e2a_spike_matmul (spike_matmul.cu) and the train-mode neuron layer's z
// pass (neuron_layer.cu). One source, so the spike matmul's bitwise checks
// on 21-bit integer weights also hold the neuron layer's product.
//
//   acc = sum_c bit(x[m], c) * w[c][n]   for the block's BM x BN tile
//
// mainloop<Tile>() leaves each thread two accumulator sets: acc[0] holds the
// hi plane's products, acc[1] those of mid and lo (an MMA truncates the sum
// it adds to, so the small planes get their own small accumulator).
// result() adds the two, rounded to nearest: every kernel's epilogue forms
// its output with it. The fragment mapping and the shared-memory layouts
// are in spike_tile_mma.cuh.
//
// - mma.sync.m16n8k16 bf16 -> fp32; each warp owns WM x WN tiles of 16 x 8.
// - A from bits: the block's packed rows of a BK-wide contraction chunk are
//   staged by cp.async (BK / 8 bytes a row), double-buffered; lanes build
//   their A fragments from those bytes in registers.
// - B: the next chunk's fp32 weights are loaded into registers while the
//   current chunk computes, then split exactly into three bf16 planes
//   (split_bf16x3) that ldmatrix.trans reads without bank conflicts. Loads
//   run along whichever axis of w has unit stride: n for (C, K) weights, c
//   for K^T and attn^T (16-byte loads where aligned, a scalar loader for
//   any other strides).
// - Rows at or past M and columns at or past K are staged as zero, so their
//   accumulators are 0; the epilogue masks them.
#pragma once

#include "spike_tile_mma.cuh"

namespace e2a {
namespace mma {

template <int WARPS_M_, int WARPS_N_, int WM_, int WN_, int BK_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WM = WM_, WN = WN_, BK = BK_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BM = 16 * WM * WARPS_M;
  static constexpr int BN = 8 * WN * WARPS_N;
  static constexpr int PITCH = BN + 8;      // bf16 per plane row (padding)
  static constexpr int PLANE = BK * PITCH;  // bf16 per plane
  static constexpr int XBYTES = BK / 8;     // packed bytes per row and chunk
  static constexpr int VEC = BK * BN / 4 / THREADS;  // float4 per thread
  static constexpr int SMEM = 3 * PLANE * 2 + 2 * BM * XBYTES;
  static_assert(WN % 2 == 0 && (XBYTES == 8 || XBYTES == 16), "tile");
  static_assert(BK * BN % (4 * THREADS) == 0 && VEC % 4 == 0, "loader");
};

// 256 x 64 outputs, 16 warps, BK = 128: a block's split of a weight chunk
// serves 256 rows (the projection sites, M = T*B*N rows, and the neuron
// layer's z pass over T*M rows). 128 x 64, 8 warps, BK = 64: per-head
// matrices (M <= 512). Each warp owns 32 x 32 outputs.
using Large = Tile<8, 2, 2, 4, 128, 1>;
using Small = Tile<4, 2, 2, 4, 64, 2>;

// One product's operands, element strides: x packed (M, C / 8) uint8, w
// (C, K) fp32. C is a multiple of 8.
struct Operands {
  const uint8_t* x;
  long long x_m, x_b;
  const float* w;
  long long w_c, w_n;
  int M, C, K;
};

template <class T>
using Acc = float[2][T::WM][T::WN][4];

// Where this thread's accumulators lie in the block's tile: acc[.][mt][nt][i]
// is row wm0 + 16 mt + g + 8 (i / 2), column wn0 + 8 nt + 2 t + i % 2.
template <class T>
struct Lane {
  int wm0, wn0, g, t;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    wm0 = (warp / T::WARPS_N) * T::WM * 16;
    wn0 = (warp % T::WARPS_N) * T::WN * 8;
    g = lane / 4;
    t = lane % 4;
  }
};

// The fp32 result of one output: hi + (mid + lo), rounded to nearest.
__device__ __forceinline__ float result(float hi, float mid_lo) {
  return __fadd_rn(hi, mid_lo);
}

// The product of the tile at rows m0.., columns n0.. into acc. smem holds
// T::SMEM bytes (dynamic shared memory, 16-byte aligned). Ends without a
// barrier: a kernel that reuses smem afterwards synchronises first.
template <class T>
__device__ __forceinline__ void mainloop(const Operands& a, long long m0,
                                         int n0, unsigned char* smem,
                                         Acc<T>& acc) {
  uint16_t* const ws = reinterpret_cast<uint16_t*>(smem);  // [3][BK][PITCH]
  unsigned char* const xs = smem + 3 * T::PLANE * 2;       // [2][BM][XBYTES]

  const uint8_t* const x = a.x;
  const float* const w = a.w;
  const int tid = threadIdx.x, lane = tid % 32;
  const Lane<T> L;
  const int g = L.g, t = L.t, wm0 = L.wm0, wn0 = L.wn0;
  const int C = a.C, K = a.K, C8 = a.C / 8;

  // ---- staging of the packed rows (A) ----
  const long long x_m = a.x_m, x_b = a.x_b;
  auto load_x = [&](int c0, int buf) {
    unsigned char* const dst = xs + buf * T::BM * T::XBYTES;
    const int cb0 = c0 / 8;
    for (int r = tid; r < T::BM; r += T::THREADS) {
      const long long row = m0 + r;
      unsigned char* const d = dst + r * T::XBYTES;
      const uint8_t* const src = x + row * x_m + cb0 * x_b;
      if (row < a.M && x_b == 1 && cb0 + T::XBYTES <= C8 &&
          reinterpret_cast<uintptr_t>(src) % T::XBYTES == 0) {
        cp_async<T::XBYTES>(d, src);
      } else {
#pragma unroll
        for (int j = 0; j < T::XBYTES; ++j)
          d[j] = (row < a.M && cb0 + j < C8) ? src[j * x_b] : 0;
      }
    }
    cp_async_commit();
  };

  // ---- staging of the weight (B): registers, then three bf16 planes ----
  const long long w_c = a.w_c, w_n = a.w_n;
  const bool c_major = w_c == 1 && w_n != 1;
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   (c_major ? w_n % 4 == 0 : (w_n == 1 && w_c % 4 == 0));
  float pre[4 * T::VEC];
  // c_major: each thread takes groups of 8 c x 2 n (neighbouring threads on
  // neighbouring n pairs, 32 contiguous bytes each); otherwise groups of
  // 1 c x 4 n (neighbouring threads on neighbouring n).
  auto load_w = [&](int c0) {
    if (c_major) {
#pragma unroll
      for (int j = 0; j < T::VEC / 4; ++j) {
        const int gi = tid + j * T::THREADS;
        const int np = gi % (T::BN / 2), c = c0 + 8 * (gi / (T::BN / 2));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 2 * np + e;
          float* const v = pre + 16 * j + 8 * e;
          const bool in = c < C && n < K;      // C % 8 == 0: all 8 c or none
          const float* const p = w + c + n * w_n;
          if (in && vec) {
            const float4 lo4 = __ldg(reinterpret_cast<const float4*>(p));
            const float4 hi4 = __ldg(reinterpret_cast<const float4*>(p) + 1);
            v[0] = lo4.x; v[1] = lo4.y; v[2] = lo4.z; v[3] = lo4.w;
            v[4] = hi4.x; v[5] = hi4.y; v[6] = hi4.z; v[7] = hi4.w;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = in ? __ldg(p + i) : 0.0f;
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::VEC; ++j) {
        const int gi = tid + j * T::THREADS;
        const int n = n0 + 4 * (gi % (T::BN / 4)), c = c0 + gi / (T::BN / 4);
        float* const v = pre + 4 * j;
        const float* const p = w + c * w_c + n * w_n;
        if (c < C && vec && n + 3 < K) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = (c < C && n + i < K) ? __ldg(p + i * w_n) : 0.0f;
        }
      }
    }
  };
  auto store_w = [&]() {
    uint16_t* const planes[3] = {ws, ws + T::PLANE, ws + 2 * T::PLANE};
    if (c_major) {
#pragma unroll
      for (int j = 0; j < T::VEC / 4; ++j) {
        const int gi = tid + j * T::THREADS;
        const int np = gi % (T::BN / 2), cl = 8 * (gi / (T::BN / 2));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint32_t words[3];   // (n, n + 1) at c = cl + i
          split_bf16x3(pre[16 * j + i], pre[16 * j + 8 + i], words);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            *reinterpret_cast<uint32_t*>(planes[p] + (cl + i) * T::PITCH +
                                         2 * np) = words[p];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::VEC; ++j) {
        const int gi = tid + j * T::THREADS;
        const int nl = 4 * (gi % (T::BN / 4)), cl = gi / (T::BN / 4);
        uint32_t w01[3], w23[3];   // (n, n + 1) and (n + 2, n + 3)
        split_bf16x3(pre[4 * j], pre[4 * j + 1], w01);
        split_bf16x3(pre[4 * j + 2], pre[4 * j + 3], w23);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(planes[p] + cl * T::PITCH + nl) =
              make_uint2(w01[p], w23[p]);
      }
    }
  };

  // ---- the tensor-core product of one staged chunk ----
#pragma unroll
  for (int mt = 0; mt < T::WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::WN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][mt][nt][i] = acc[1][mt][nt][i] = 0.0f;

  auto compute = [&](int buf, int steps) {
    const unsigned char* const xb = xs + buf * T::BM * T::XBYTES;
    const int q = lane / 8;
#pragma unroll
    for (int s = 0; s < T::BK / 16; ++s) {
      if (s >= steps) break;
      const int shift = (s & 1) * 16 + 2 * t;   // bits 2t, 2t+1 of byte 2s
      uint32_t af[T::WM][4];
#pragma unroll
      for (int mt = 0; mt < T::WM; ++mt) {
        // bytes 2s and 2s + 1 of this lane's rows g and g + 8 of the tile
        const uint32_t* const row = reinterpret_cast<const uint32_t*>(
            xb + (wm0 + mt * 16 + g) * T::XBYTES);
        const uint32_t r0 = row[s / 2], r8 = row[2 * T::XBYTES + s / 2];
        af[mt][0] = bits_to_bf16x2(r0 >> shift);
        af[mt][1] = bits_to_bf16x2(r8 >> shift);
        af[mt][2] = bits_to_bf16x2(r0 >> (shift + 8));
        af[mt][3] = bits_to_bf16x2(r8 >> (shift + 8));
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint16_t* const plane = ws + p * T::PLANE;
#pragma unroll
        for (int jp = 0; jp < T::WN / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, plane + (s * 16 + (q & 1) * 8 + (lane & 7)) * T::PITCH +
                     wn0 + (2 * jp + (q >> 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < T::WM; ++mt) {
            mma_bf16(acc[p > 0][mt][2 * jp], af[mt], b[0], b[1]);
            mma_bf16(acc[p > 0][mt][2 * jp + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
  };

  // ---- the contraction loop: one smem plane set, A double-buffered ----
  const int chunks = (C + T::BK - 1) / T::BK;
  if (chunks > 0) {
    load_x(0, 0);
    load_w(0);
  }
  for (int i = 0; i < chunks; ++i) {
    const int c0 = i * T::BK;
    __syncthreads();          // every warp is done with the planes of i - 1
    store_w();
    cp_async_wait_all();
    __syncthreads();          // planes and packed rows of chunk i visible
    if (i + 1 < chunks) {     // in flight while chunk i computes
      load_x(c0 + T::BK, (i + 1) & 1);
      load_w(c0 + T::BK);
    }
    compute(i & 1, (min(T::BK, C - c0) + 15) / 16);
  }
}

}  // namespace mma
}  // namespace e2a
