// Bit-packed spike matmul, 2-D and batched, one kernel.
//
//   out[g][m][k] = sum_c bit(packed[g][m], c) * w[g][c][k]
//
// packed is uint8 with 8 contraction indices per byte, least significant bit
// first; w and out are fp32. The batch index g = g1 * G2 + g2 has two levels
// (blockIdx.z = g), and every operand comes with element strides for g1, g2
// and its two matrix dims, so a transposed K^T, a per-head slice of a
// (T*B, N, h, dh) tensor or a weight shared by all batches (stride 0) is
// read where it lies and never copied.
//
// A spike is 0 or 1, so every product is exact and the kernel is a masked
// sum of rows of w in fp32, accumulated in ascending c (see spike_tile.cuh).
// A block owns ROW_TILES consecutive 64-row tiles of one 64-column strip, so
// each weight chunk staged in shared memory serves 256 rows.
// At the model's shapes the work is bound by fp32 operations outside the
// tensor cores, not by bytes: the spike operand crosses device memory at one
// bit per element.
#include "spike_tile.cuh"

namespace {

using namespace e2a;

constexpr int ROW_TILES = 4;

struct BatchStrides {
  long long g1, g2, r, c;   // two batch levels, then the two matrix dims
};

__global__ void __launch_bounds__(THREADS) spike_matmul_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ w,
    float* __restrict__ out, int G2, int M, int C, int K, BatchStrides ps,
    BatchStrides ws_, BatchStrides os) {
  constexpr int BC = ChunkOf<ROW_TILES>::value;
  __shared__ __align__(16) float xs[ROW_TILES][BC][XS];
  __shared__ __align__(16) float ws[BC][BN];

  const long long g1 = blockIdx.z / G2;
  const long long g2 = blockIdx.z % G2;
  TileArgs a;
  a.x = packed + g1 * ps.g1 + g2 * ps.g2;
  a.x_t = 0;
  a.x_m = ps.r;
  a.x_c = ps.c;
  a.row_step = BM;
  a.w = w + g1 * ws_.g1 + g2 * ws_.g2;
  a.w_c = ws_.r;
  a.w_k = ws_.c;
  a.m0 = (long long)blockIdx.x * (ROW_TILES * BM);
  a.M = M;
  a.k0 = blockIdx.y * BN;
  a.K = K;
  a.C = C;

  float acc[ROW_TILES][TM][TN];
  accumulate<ROW_TILES, BC, true>(a, xs, ws, acc);

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  float* o = out + g1 * os.g1 + g2 * os.g2;
#pragma unroll
  for (int t = 0; t < ROW_TILES; ++t) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = a.m0 + t * BM + ty * TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = a.k0 + tx * TN + j;
        if (col < K) o[row * os.r + col * os.c] = acc[t][i][j];
      }
    }
  }
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
  if (G > 65535 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  const BatchStrides ps = {p_g1, p_g2, p_m, p_b};
  const BatchStrides ws = {w_g1, w_g2, w_c, w_k};
  const BatchStrides os = {o_g1, o_g2, o_m, o_k};
  const int rows = ROW_TILES * BM;
  const dim3 grid((M + rows - 1) / rows, (K + BN - 1) / BN, (unsigned)G);
  spike_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, w, out, G2, M, C, K, ps, ws, os);
  return (int)cudaGetLastError();
}
