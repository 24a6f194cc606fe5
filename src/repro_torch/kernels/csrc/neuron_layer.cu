// Eval-mode neuron layer: matmul + bias + LIF SOMA in one launch.
//
//   acc[t][m][k] = sum_c x[t][m][c] * w[c][k]            (fp32, ascending c)
//   u = alpha * u * (1 - s) + (acc[t] + bias[k]);  s = u >= th_fire
//
// x is (T, M, C) fp32, or its bit-packed form (T, M, C/8) uint8 (least
// significant bit first along C) when the input is a spike train; w is
// (C, K) with batch norm already folded in by the caller, bias (K,) fp32.
// Only the spikes (T, M, K) are written: the pre-activation lives in the T
// accumulators each thread keeps in registers and never reaches device
// memory. The weight chunk staged in shared memory is fetched once and used
// by all T steps (see spike_tile.cuh). Offsets are 64-bit: the first
// tokenizer stage writes more than 2^25 elements per time step.
//
// The packed arm is bound by fp32 operations outside the tensor cores; the
// dense arm at the first tokenizer stage (C = 27) by the bytes of its input
// and output.
//
// Train mode (batch statistics over all T * M rows of a column) cannot
// finish in the tile's epilogue: the statistics need every row tile first.
// The TPU kernel had one program own all rows of a feature block; here that
// would be one block per 64 columns. The train arm is therefore three
// launches behind one entry point:
//   (a) the same tile loop; its epilogue writes z = x @ w (T, M, K) fp32 once
//       and, per 64-row tile, the column sums of z and z^2 over the tile's
//       T * 64 values (a fixed order: no atomics, the same statistics on
//       every run);
//   (b) per column, the tiles' partials are added in order and mu, var,
//       sqrt(var + eps) formed (bn_stats.cuh);
//   (c) one pass reads z once, normalises (eq. 17-18) and runs SOMA over T
//       with (U, S) in registers, writing the spikes.
// The z round trip costs about 2 * T * M * K * 4 bytes (0.06 ms at smlp.a
// against a 0.39 ms fp32 bound); the alternative, recomputing the product
// in (c), would double the dominant fp32 work.
#include "bn_stats.cuh"
#include "spike_tile.cuh"

namespace {

using namespace e2a;

template <int T, bool PACKED>
__global__ void __launch_bounds__(THREADS) neuron_layer_eval_kernel(
    const void* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ s, long long M, int C,
    int K, float alpha, float th_fire) {
  constexpr int BC = ChunkOf<T>::value;
  __shared__ __align__(16) float xs[T][BC][XS];
  __shared__ __align__(16) float ws[BC][BN];

  const long long row_len = PACKED ? C / 8 : C;   // elements per (t, m) row
  TileArgs a;
  a.x = x;
  a.x_t = M * row_len;
  a.x_m = row_len;
  a.x_c = 1;
  a.row_step = 0;
  a.w = w;
  a.w_c = K;
  a.w_k = 1;
  a.m0 = (long long)blockIdx.x * BM;
  a.M = M;
  a.k0 = blockIdx.y * BN;
  a.K = K;
  a.C = C;

  float acc[T][TM][TN];
  accumulate<T, BC, PACKED>(a, xs, ws, acc);

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = a.k0 + tx * TN + j;
    if (col >= K) continue;
    const float b = bias[col];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = a.m0 + ty * TM + i;
      if (row >= M) continue;
      float u = 0.0f, sp = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float y = __fadd_rn(acc[t][i][j], b);
        u = __fadd_rn(__fmul_rn(__fmul_rn(alpha, u), __fsub_rn(1.0f, sp)), y);
        sp = (u >= th_fire) ? 1.0f : 0.0f;
        s[((long long)t * M + row) * K + col] = sp;
      }
    }
  }
}

template <int T>
int launch(const void* x, const float* w, const float* bias, float* s,
           long long M, int C, int K, int packed, float alpha, float th_fire,
           cudaStream_t st) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (K + BN - 1) / BN, 1);
  if (packed)
    neuron_layer_eval_kernel<T, true><<<grid, THREADS, 0, st>>>(
        x, w, bias, s, M, C, K, alpha, th_fire);
  else
    neuron_layer_eval_kernel<T, false><<<grid, THREADS, 0, st>>>(
        x, w, bias, s, M, C, K, alpha, th_fire);
  return (int)cudaGetLastError();
}

// (a): z and the per-row-tile column partials of sum(z) and sum(z^2).
template <int T, bool PACKED>
__global__ void __launch_bounds__(THREADS) neuron_layer_train_z(
    const void* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ z, float* __restrict__ part, long long M, int C,
    int K, int n_tiles) {
  constexpr int BC = ChunkOf<T>::value;
  __shared__ __align__(16) float xs[T][BC][XS];
  __shared__ __align__(16) float ws[BC][BN];

  const long long row_len = PACKED ? C / 8 : C;
  TileArgs a;
  a.x = x;
  a.x_t = M * row_len;
  a.x_m = row_len;
  a.x_c = 1;
  a.row_step = 0;
  a.w = w;
  a.w_c = K;
  a.w_k = 1;
  a.m0 = (long long)blockIdx.x * BM;
  a.M = M;
  a.k0 = blockIdx.y * BN;
  a.K = K;
  a.C = C;

  float acc[T][TM][TN];
  accumulate<T, BC, PACKED>(a, xs, ws, acc);   // ends with __syncthreads()

  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  // The x tile is free again: it holds the (BM / TM) x BN column partials
  // of sum(z) and sum(z^2) (2 * 16 * 64 floats; the tile has at least
  // 1 * 32 * 68).
  float* red = &xs[0][0][0];
  constexpr int ROWS = BM / TM;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = a.k0 + tx * TN + j;
    float cs = 0.0f, cq = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long row = a.m0 + ty * TM + i;
        if (row >= M || col >= K) continue;
        const float v = acc[t][i][j];
        z[((long long)t * M + row) * K + col] = v;
        cs = __fadd_rn(cs, v);
        cq = __fadd_rn(cq, __fmul_rn(v, v));
      }
    }
    red[ty * BN + tx * TN + j] = cs;
    red[(ROWS + ty) * BN + tx * TN + j] = cq;
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int q = threadIdx.x / BN;          // 0: sum(z), 1: sum(z^2)
    const int c = threadIdx.x % BN;
    const int col = a.k0 + c;
    if (col < K) {
      float v = 0.0f;
      for (int r = 0; r < ROWS; ++r) v = __fadd_rn(v, red[(q * ROWS + r) * BN + c]);
      part[((long long)q * n_tiles + blockIdx.x) * K + col] = v;
    }
  }
}

// (b): the statistics of each column.
__global__ void __launch_bounds__(STAT_COLS* STAT_LANES)
neuron_layer_train_stats(const float* __restrict__ part,
                         float* __restrict__ mu, float* __restrict__ var,
                         float* __restrict__ sqrt_d, int n_tiles, int K,
                         double count, float eps) {
  const int col = blockIdx.x * STAT_COLS + threadIdx.x;
  double sums[2];
  reduce_parts<2>(part, n_tiles, K, col, sums);
  if (threadIdx.y != 0 || col >= K) return;
  float m, v, sd;
  column_stats(sums[0], sums[1], count, eps, m, v, sd);
  mu[col] = m;
  var[col] = v;
  sqrt_d[col] = sd;
}

// (c): y = gamma * (z - mu) / sqrt_d + beta, then SOMA over T.
__global__ void __launch_bounds__(256) neuron_layer_train_soma(
    const float* __restrict__ z, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* __restrict__ s, long long n,
    int K, int T, float alpha, float th_fire) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % K);
  const float ga = gamma[c], be = beta[c], m = mu[c], sd = sqrt_d[c];
  float u = 0.0f, sp = 0.0f;
  for (int t = 0; t < T; ++t) {
    const long long at = (long long)t * n + i;
    const float y = __fadd_rn(__fdiv_rn(__fmul_rn(ga, __fsub_rn(z[at], m)), sd), be);
    u = __fadd_rn(__fmul_rn(__fmul_rn(alpha, u), __fsub_rn(1.0f, sp)), y);
    sp = (u >= th_fire) ? 1.0f : 0.0f;
    s[at] = sp;
  }
}

template <int T>
int launch_train_z(const void* x, const float* w, float* z, float* part,
                   long long M, int C, int K, int packed, int n_tiles,
                   cudaStream_t st) {
  const dim3 grid((unsigned)n_tiles, (K + BN - 1) / BN, 1);
  if (packed)
    neuron_layer_train_z<T, true><<<grid, THREADS, 0, st>>>(x, w, z, part, M,
                                                           C, K, n_tiles);
  else
    neuron_layer_train_z<T, false><<<grid, THREADS, 0, st>>>(x, w, z, part, M,
                                                            C, K, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int e2a_neuron_layer_eval(const void* x, const float* w,
                                     const float* bias, float* s, int T,
                                     long long M, int C, int K, int packed,
                                     float alpha, float th_fire,
                                     void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (packed && C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1: return launch<1>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 2: return launch<2>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 3: return launch<3>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 4: return launch<4>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 5: return launch<5>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 6: return launch<6>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 7: return launch<7>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    case 8: return launch<8>(x, w, bias, s, M, C, K, packed, alpha, th_fire, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Train mode: x (T, M, C) [packed: (T, M, C/8) uint8] @ w (C, K) -> batch
// statistics over T * M rows -> BN -> SOMA. Writes s (T, M, K) and mu, var
// (K); z (T, M, K), part (2, ceil(M / 64), K) and sqrt_d (K) are scratch.
extern "C" int e2a_neuron_layer_train(const void* x, const float* w,
                                      const float* gamma, const float* beta,
                                      float* z, float* part, float* mu,
                                      float* var, float* sqrt_d, float* s,
                                      int T, long long M, int C, int K,
                                      int packed, float alpha, float th_fire,
                                      float eps, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (packed && C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (int)((M + BM - 1) / BM);
  int code;
  switch (T) {
    case 1: code = launch_train_z<1>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 2: code = launch_train_z<2>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 3: code = launch_train_z<3>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 4: code = launch_train_z<4>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 5: code = launch_train_z<5>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 6: code = launch_train_z<6>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 7: code = launch_train_z<7>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    case 8: code = launch_train_z<8>(x, w, z, part, M, C, K, packed, n_tiles, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (code != 0) return code;
  neuron_layer_train_stats<<<(K + STAT_COLS - 1) / STAT_COLS,
                             dim3(STAT_COLS, STAT_LANES), 0, st>>>(
      part, mu, var, sqrt_d, n_tiles, K, (double)T * (double)M, eps);
  const long long n = M * K;
  neuron_layer_train_soma<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      z, gamma, beta, mu, sqrt_d, s, n, K, T, alpha, th_fire);
  return (int)cudaGetLastError();
}
