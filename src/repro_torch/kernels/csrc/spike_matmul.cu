// Bit-packed spike matmul on the tensor cores, 2-D and batched, one kernel.
//
//   out[g][m][n] = sum_c bit(packed[g][m], c) * w[g][c][n]
//
// Replaces the reference's two TPU kernels, _spike_mm_kernel
// (src/repro/kernels/spike_matmul.py:80, spike_matmul_packed) and
// _spike_bmm_kernel (:139, spike_matmul_packed_batched). packed is uint8
// with 8 contraction indices per byte, least significant bit first; w and
// out are fp32. The batch index g = g1 * G2 + g2 has two levels
// (blockIdx.z = g), and every operand comes with element strides for g1,
// g2 and its two matrix dims, so a transposed K^T or attn^T, a per-head
// slice of a (T*B, N, h*dh) tensor or a weight shared by all batches
// (stride 0) is read where it lies and never copied.
//
// Why the result is fp32: a spike is exactly 0 or 1 in bf16, and each
// fp32 weight is split once, when its chunk is staged, into three bf16
// planes with w == hi + mid + lo exactly (split_bf16x3 in
// spike_tile_mma.cuh). Every product on the tensor cores is then exact,
// but the sums are not rounded as fp32 FMAs round them: an MMA truncates
// the sum it adds to where an FMA rounds to nearest. The hi plane's MMAs
// add into one fp32 accumulator, the mid and lo planes' into a second,
// small one, because most of the bits an MMA would cut from the large sum
// are the small planes'; the two are added, rounded to nearest, at the
// end. So the result differs from an fp32 product in the order of the sums
// and in the truncation of each; where every partial sum is exact in fp32
// (integer and dyadic weights) it gives the same bits.
//
// Design (spike_tile_mma.cuh has the fragment mapping and the layouts):
// - mma.sync.m16n8k16 bf16 -> fp32; each warp owns WM x WN tiles of 16 x 8.
// - A from bits: the block's packed rows of a BK-wide contraction chunk are
//   staged by cp.async (BK / 8 bytes a row), double-buffered; lanes build
//   their A fragments from those bytes in registers.
// - B: the next chunk's fp32 weights are loaded into registers while the
//   current chunk computes, then split and stored as three bf16 planes that
//   ldmatrix.trans reads without bank conflicts. Loads run along whichever
//   axis of w has unit stride: n for the (C, K) weights and the tokenizer's
//   shared weight, c for K^T and attn^T (16-byte loads where aligned, a
//   scalar loader for any other strides).
// - Epilogue: float2 stores along out's unit-stride axis.
// - Two instantiations, chosen from M; each warp owns 32 x 32 outputs.
//   256 x 64 outputs with 16 warps and BK = 128 for the projection sites
//   (M = T*B*N rows): a block's split of a weight chunk serves 256 rows.
//   128 x 64 with 8 warps and BK = 64 for per-head matrices (M <= 512,
//   e.g. 196 x 196 at attn_qk: 60 of 256 rows masked). Half as many rows
//   per block ran 10-15 % slower at the model's shapes
//   (benchmarks/torch/bench_spike_matmul.py; PERF.md, section 6).
// What bounds it: at pssa.proj and smlp.b three dense bf16 passes, 3 * 2MCK
// operations at the tensor cores' rate; at attn_qk (C = 64) the bytes of
// the K^T operand and of out.
#include "spike_tile_mma.cuh"

namespace {

using namespace e2a::mma;

struct BatchStrides {
  long long g1, g2, row, col;   // two batch levels, then the two matrix dims
};

struct Args {
  const uint8_t* x;
  const float* w;
  float* out;
  int G2, M, C, K;
  BatchStrides xs, ws, os;      // x: (row, byte); w: (c, n); out: (m, n)
};

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

using Large = Tile<8, 2, 2, 4, 128, 1>;   // 256 x 64, 512 threads
using Small = Tile<4, 2, 2, 4, 64, 2>;    // 128 x 64, 256 threads

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    spike_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* const ws = reinterpret_cast<uint16_t*>(smem);  // [3][BK][PITCH]
  unsigned char* const xs = smem + 3 * T::PLANE * 2;       // [2][BM][XBYTES]

  const long long g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  const uint8_t* const x = a.x + g1 * a.xs.g1 + g2 * a.xs.g2;
  const float* const w = a.w + g1 * a.ws.g1 + g2 * a.ws.g2;
  float* const out = a.out + g1 * a.os.g1 + g2 * a.os.g2;
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / T::WARPS_N) * T::WM * 16;
  const int wn0 = (warp % T::WARPS_N) * T::WN * 8;
  const int g = lane / 4, t = lane % 4;
  const int C = a.C, K = a.K, C8 = a.C / 8;

  // ---- staging of the packed rows (A) ----
  const long long x_m = a.xs.row, x_b = a.xs.col;
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
  const long long w_c = a.ws.row, w_n = a.ws.col;
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
  // acc[0] sums the hi plane's products, acc[1] those of mid and lo. An
  // MMA truncates the sum it adds to, so the small planes get their own
  // small accumulator; the two meet once, rounded to nearest, at the end.
  float acc[2][T::WM][T::WN][4];
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

  // ---- epilogue ----
  const long long o_m = a.os.row, o_n = a.os.col;
  const bool vec2 = o_n == 1 && o_m % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
  for (int mt = 0; mt < T::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm0 + mt * 16 + g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < T::WN; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        const float v0 = __fadd_rn(acc[0][mt][nt][2 * h],
                                   acc[1][mt][nt][2 * h]);
        const float v1 = __fadd_rn(acc[0][mt][nt][2 * h + 1],
                                   acc[1][mt][nt][2 * h + 1]);
        float* const o = out + row * o_m + col * o_n;
        if (vec2 && col + 1 < K) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (col < K) o[0] = v0;
          if (col + 1 < K) o[o_n] = v1;
        }
      }
    }
}

template <class T>
int launch(const Args& a, unsigned G, cudaStream_t stream) {
  // Above 48 KB a kernel must ask for its dynamic shared memory, once per
  // device; a repeat of the request is harmless, so a race between two
  // host threads costs nothing.
  constexpr int kDevices = 64;
  static bool raised[kDevices] = {};
  if (T::SMEM > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(spike_mma_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 T::SMEM);
      if (err != cudaSuccess) return (int)err;
      if (dev < kDevices) raised[dev] = true;
    }
  }
  const dim3 grid((a.M + T::BM - 1) / T::BM, (a.K + T::BN - 1) / T::BN, G);
  spike_mma_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int e2a_spike_matmul(
    const uint8_t* packed, const float* w, float* out, int G1, int G2, int M,
    int C, int K, long long p_g1, long long p_g2, long long p_m,
    long long p_b, long long w_g1, long long w_g2, long long w_c,
    long long w_k, long long o_g1, long long o_g2, long long o_m,
    long long o_k, void* stream) {
  if (G1 <= 0 || G2 <= 0 || M <= 0 || K <= 0) return 0;
  const long long G = (long long)G1 * G2;
  if (G > 65535 || C < 0 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  const Args a = {packed, w, out, G2, M, C, K,
                  {p_g1, p_g2, p_m, p_b}, {w_g1, w_g2, w_c, w_k},
                  {o_g1, o_g2, o_m, o_k}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return M <= 512 ? launch<Small>(a, (unsigned)G, s)
                  : launch<Large>(a, (unsigned)G, s);
}
