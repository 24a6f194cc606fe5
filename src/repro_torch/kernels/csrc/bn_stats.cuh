// Column statistics from per-chunk partial sums, and the vector loads and
// stores and the row-range grid of the passes that apply them, shared by the
// batch-norm kernels and the train-mode neuron layer.
//
// A column reduction over many rows cannot live in one block on this card,
// so the first pass of each kernel writes, for every chunk of rows, one
// partial sum per column into a scratch buffer laid out (chunk, column), and
// this pass reduces the partials of a column in a fixed order. No atomics:
// the statistics are the same on every run, so spikes downstream do not flip
// between identical runs. The chunks are summed in double and the result is
// rounded once to fp32; E[x^2] - mu^2 is then formed in fp32 as the
// reference does (eq. 13-16).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace e2a {

// The finalize passes run on blocks of STAT_COLS columns x STAT_LANES lanes:
// lane l of a column adds chunks l, l + STAT_LANES, ... (coalesced across
// the columns of a warp), then lane 0 adds the lanes' sums in lane order.
constexpr int STAT_COLS = 32;
constexpr int STAT_LANES = 8;

// sums[q] = sum over the n_parts chunks of part[(q * n_parts + c) * D + col],
// in double, the same order on every run; valid in lane 0. Every thread of
// the block must call it (it synchronises). The partials are read through
// L2 (ld.global.cg), so a block may reduce partials that other blocks of
// the same launch wrote before a __threadfence().
template <int NQ>
__device__ __forceinline__ void reduce_parts(const float* part, int n_parts,
                                             int D, int col,
                                             double (&sums)[NQ]) {
  __shared__ double sh[NQ][STAT_LANES][STAT_COLS];
  const int lane = threadIdx.y;
  double acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.0;
  // unrolled so that several chunks' loads are in flight at once; each
  // acc[q] still adds its chunks in ascending order
  if (col < D)
#pragma unroll 4
    for (int c = lane; c < n_parts; c += STAT_LANES)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        acc[q] += (double)__ldcg(part + ((long long)q * n_parts + c) * D +
                                 col);
#pragma unroll
  for (int q = 0; q < NQ; ++q) sh[q][lane][threadIdx.x] = acc[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    double s = 0.0;
    for (int l = 0; l < STAT_LANES; ++l) s += sh[q][l][threadIdx.x];
    sums[q] = s;
  }
}

// mu, var and sqrt(var + eps) from the sums of x and x^2 over count rows.
__device__ __forceinline__ void column_stats(double s, double q, double count,
                                             float eps, float& mu, float& var,
                                             float& sqrt_d) {
  mu = (float)(s / count);                                   // eq. 13
  const float ex2 = (float)(q / count);                      // eq. 14
  var = fmaxf(__fsub_rn(ex2, __fmul_rn(mu, mu)), 0.0f);      // eq. 15
  sqrt_d = __fsqrt_rn(__fadd_rn(var, eps));                  // eq. 16
}

// Data parallelism (the split path): each rank's first pass writes its
// column sums, in double, to a buffer of Q * D + 1 doubles, the last its row
// count; the wrapper all-reduces the buffer over the ranks, and the passes
// that apply the statistics form them from the global sums and count. At a
// world of 1 the buffer holds the very doubles the fused path forms, so the
// statistics are the fused path's bit for bit.

// mu, var and sqrt(var + eps) of one column from a (2, D) + 1 sums buffer.
__device__ __forceinline__ void stats_from_sums(const double* sums, int D,
                                                int col, float eps, float& mu,
                                                float& var, float& sqrt_d) {
  column_stats(sums[col], sums[D + col], sums[2 * D], eps, mu, var, sqrt_d);
}

// gridDim.y and gridDim.z are at most 65535, so a pass that puts its row
// ranges on grid.y launches at most MAX_ROW_BLOCKS of them and strides over
// the rest (more than 2 M rows at 32 rows a range).
constexpr long long MAX_ROW_BLOCKS = 65535;

inline unsigned row_blocks(long long rows, int rows_per_block) {
  const long long n = (rows + rows_per_block - 1) / rows_per_block;
  return (unsigned)(n < MAX_ROW_BLOCKS ? n : MAX_ROW_BLOCKS);
}

// V neighbouring elements at p as fp32, one vector access where V == 4
// (a float4, or 8 bytes of bf16; p aligned to it).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const bf16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xFFFF0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = to_f(p[j]);
  }
}

// V values to V neighbouring elements at p, each rounded to nearest once:
// one vector access where V == 4 (or, for bf16, V == 8: 16 bytes).
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

template <int V>
__device__ __forceinline__ void store_v(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&a);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                   *reinterpret_cast<const uint32_t*>(&b));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f<bf16>(v[j]);
  }
}

}  // namespace e2a
