// fp32 tile loop (outside the tensor cores) of the dense arms of the neuron
// layer: neuron_layer_eval's and neuron_layer_train's at the first tokenizer
// stage (C = 27, a dense fp32 image). The packed arms and the spike matmul
// run the tensor-core mainloop of spike_mma_mainloop.cuh instead.
//
// A block of 256 threads owns T slices of BM x BN = 64 x 64 outputs (T time
// steps of one row tile); a thread owns a 4 x 4 patch of each slice in
// registers. The contraction dim C is walked in chunks of BC inside the
// block: the chunk of x and the chunk of w are staged in shared memory,
// every thread accumulates in fp32 in ascending order of c, and
// out-of-range rows, columns and contraction indices are loaded as zero, so
// ragged shapes need no special case. The weight chunk is fetched once per
// block and used by all T slices. The order of summation is fixed: results
// are deterministic and there are no atomics.
#pragma once

#include <cuda_runtime.h>

namespace e2a {

constexpr int BM = 64;           // output rows per block
constexpr int BN = 64;           // output columns per block
constexpr int TM = 4;            // rows per thread
constexpr int TN = 4;            // columns per thread
constexpr int THREADS = 256;     // (BM / TM) * (BN / TN)
constexpr int XS = BM + 4;       // padded row stride of the x tile (floats)

// Contraction chunk: 32 up to T = 4 (x tile 34 KB + w tile 8 KB), 16 above
// so that the static shared memory stays under 48 KB up to T = 8.
template <int T> struct ChunkOf { static constexpr int value = (T <= 4) ? 32 : 16; };

// x tile layout: xs[t][c][m], m fastest, so a thread reads its 4 rows as
// one float4. w tile layout: ws[c][k], k fastest.

// Dense x (T, M, C) with element strides; neighbouring threads take
// neighbouring c, so the global loads are coalesced.
template <int T, int BC>
__device__ __forceinline__ void load_x_dense(
    float (*xs)[BC][XS], const float* __restrict__ p, long long st_t,
    long long st_m, long long st_c, long long m0, long long M, int c0, int C,
    int tid) {
  for (int idx = tid; idx < T * BM * BC; idx += THREADS) {
    const int c = idx % BC;
    const int m = (idx / BC) % BM;
    const int t = idx / (BC * BM);
    const long long row = m0 + m;
    float v = 0.0f;
    if (row < M && c0 + c < C) v = p[t * st_t + row * st_m + (c0 + c) * st_c];
    xs[t][c][m] = v;
  }
}

template <int BC>
__device__ __forceinline__ void load_w(
    float (*ws)[BN], const float* __restrict__ w, long long st_c,
    long long st_k, int c0, int C, int k0, int K, int tid) {
  for (int idx = tid; idx < BC * BN; idx += THREADS) {
    const int k = idx % BN;
    const int c = idx / BN;
    float v = 0.0f;
    if (c0 + c < C && k0 + k < K) v = w[(c0 + c) * st_c + (k0 + k) * st_k];
    ws[c][k] = v;
  }
}

template <int T, int BC>
__device__ __forceinline__ void tile_fma(
    float (*xs)[BC][XS], float (*ws)[BN], float (&acc)[T][TM][TN], int tx,
    int ty) {
#pragma unroll
  for (int c = 0; c < BC; ++c) {
    const float4 wv = *reinterpret_cast<const float4*>(&ws[c][tx * TN]);
    const float wr[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[t][c][ty * TM]);
      const float xr[TM] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[t][i][j] = fmaf(xr[i], wr[j], acc[t][i][j]);
    }
  }
}

// Operand description for one block's accumulation: dense fp32 x, whose T
// slices are the time steps of the same rows (x_t the time stride); each
// weight chunk serves all T of them.
struct TileArgs {
  const float* x;
  long long x_t, x_m, x_c;   // element strides of x along t, row, c
  const float* w;
  long long w_c, w_k;
  long long m0, M;
  int k0, K, C;
};

// acc[t][i][j] = sum_c x[t][m0 + ty*4 + i][c] * w[c][k0 + tx*4 + j].
template <int T, int BC>
__device__ __forceinline__ void accumulate(
    const TileArgs& a, float (*xs)[BC][XS], float (*ws)[BN],
    float (&acc)[T][TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[t][i][j] = 0.0f;
  for (int c0 = 0; c0 < a.C; c0 += BC) {
    load_x_dense<T, BC>(xs, a.x, a.x_t, a.x_m, a.x_c, a.m0, a.M, c0, a.C,
                        tid);
    load_w<BC>(ws, a.w, a.w_c, a.w_k, c0, a.C, a.k0, a.K, tid);
    __syncthreads();
    tile_fma<T, BC>(xs, ws, acc, tx, ty);
    __syncthreads();
  }
}

}  // namespace e2a
