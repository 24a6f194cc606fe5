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
// Design: the contraction loop is mainloop() of spike_mma_mainloop.cuh,
// shared with the train-mode neuron layer (spike_tile_mma.cuh has the
// fragment mapping and the layouts); this file adds the batch offsets and
// the epilogue, float2 stores along out's unit-stride axis. Two tiles, the
// caller names one (spike_matmul.py chooses from M unless a tuned table
// says otherwise): Large (256 x 64 outputs, 16 warps, BK = 128) for the
// projection sites (M = T*B*N rows): a block's split of a weight chunk
// serves 256 rows; Small (128 x 64, 8 warps, BK = 64) for per-head
// matrices (M <= 512, e.g. 196 x 196 at attn_qk: 60 of 256 rows masked).
// Both walk the contraction in the same k16 steps in the same order, so a
// product's bits do not depend on the tile.
// Half as many rows per block ran 10-15 % slower at the model's shapes
// (benchmarks/torch/bench_spike_matmul.py; PERF.md, section 6).
// What bounds it: at pssa.proj and smlp.b three dense bf16 passes, 3 * 2MCK
// operations at the tensor cores' rate; at attn_qk (C = 64) the bytes of
// the K^T operand and of out.
#include "launch_plan.cuh"
#include "spike_mma_mainloop.cuh"

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

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    spike_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  float* const out = a.out + g1 * a.os.g1 + g2 * a.os.g2;
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const Operands ops = {a.x + g1 * a.xs.g1 + g2 * a.xs.g2, a.xs.row,
                        a.xs.col, a.w + g1 * a.ws.g1 + g2 * a.ws.g2,
                        a.ws.row, a.ws.col, a.M, a.C, a.K};
  Acc<T> acc;
  mainloop<T>(ops, m0, n0, smem, acc);

  // ---- epilogue ----
  const Lane<T> L;
  const int K = a.K;
  const long long o_m = a.os.row, o_n = a.os.col;
  const bool vec2 = o_n == 1 && o_m % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
#pragma unroll
  for (int mt = 0; mt < T::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + L.wm0 + mt * 16 + L.g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < T::WN; ++nt) {
        const int col = n0 + L.wn0 + nt * 8 + 2 * L.t;
        const float v0 = result(acc[0][mt][nt][2 * h], acc[1][mt][nt][2 * h]);
        const float v1 = result(acc[0][mt][nt][2 * h + 1],
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

// The one launch of tile T: blocks of BM rows x BN columns, one batch a
// grid.z index.
template <class T>
e2a::Launch tile_plan(int M, int K, long long G, int kernel) {
  e2a::Launch l = e2a::launch_of(T::THREADS, 1, T::SMEM, kernel);
  e2a::axis(l, 0, e2a::cdiv(M, T::BM), T::BM, M);
  e2a::axis(l, 1, e2a::cdiv(K, T::BN), T::BN, K);
  return e2a::axis(l, 2, G, 1, G);
}

template <class T>
int launch(const Args& a, const e2a::Launch& l, cudaStream_t stream) {
  static bool raised[e2a::kMaxDevices] = {};
  const int err = e2a::raise_smem(
      l, reinterpret_cast<const void*>(spike_mma_kernel<T>), raised);
  if (err != 0) return err;
  spike_mma_kernel<T><<<e2a::grid_of(l), e2a::block_of(l), l.smem,
                        stream>>>(a);
  return (int)cudaGetLastError();
}

// The launches of e2a_spike_matmul (none for an empty output). Returns a
// cudaError_t.
int plan(int G1, int G2, int M, int C, int K, int tile, e2a::Launch* l,
         int& n) {
  n = 0;
  if (G1 <= 0 || G2 <= 0 || M <= 0 || K <= 0) return 0;
  const long long G = (long long)G1 * G2;
  if (G > 65535 || C < 0 || C % 8 != 0 || tile < 1 || tile > 2)
    return (int)cudaErrorInvalidValue;
  l[n++] = tile == 2 ? tile_plan<Small>(M, K, G, 2)
                     : tile_plan<Large>(M, K, G, 1);
  return 0;
}

}  // namespace

// tile picks the tile: 1 Large, 2 Small (the autotuner times both; a
// tuned table passes its winner).
extern "C" int e2a_spike_matmul(
    const uint8_t* packed, const float* w, float* out, int G1, int G2, int M,
    int C, int K, long long p_g1, long long p_g2, long long p_m,
    long long p_b, long long w_g1, long long w_g2, long long w_c,
    long long w_k, long long o_g1, long long o_g2, long long o_m,
    long long o_k, int tile, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = plan(G1, G2, M, C, K, tile, l, n);
  if (code != 0 || n == 0) return code;
  const Args a = {packed, w, out, G2, M, C, K,
                  {p_g1, p_g2, p_m, p_b}, {w_g1, w_g2, w_c, w_k},
                  {o_g1, o_g2, o_m, o_k}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return l[0].kernel == 2 ? launch<Small>(a, l[0], s)
                          : launch<Large>(a, l[0], s);
}

extern "C" int e2a_spike_matmul_plan(const uint8_t* packed, const float* w,
                                     float* out, int G1, int G2, int M, int C,
                                     int K, long long p_g1, long long p_g2,
                                     long long p_m, long long p_b,
                                     long long w_g1, long long w_g2,
                                     long long w_c, long long w_k,
                                     long long o_g1, long long o_g2,
                                     long long o_m, long long o_k, int tile,
                                     long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = plan(G1, G2, M, C, K, tile, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
