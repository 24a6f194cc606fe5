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
//   (a) z = x @ w, written once as (T * M, K) fp32, and per row tile the
//       column sums of z and z^2 (a fixed order: no atomics, the same
//       statistics on every run). In train mode T is only a row index, so
//       the packed arm's pass is the spike matmul over T * M rows: the
//       tensor-core mainloop of spike_mma_mainloop.cuh (one source with
//       e2a_spike_matmul, whose bitwise checks hold it), Large tile (256 x 64
//       outputs, 16 warps, BK = 128), with an epilogue that also forms the
//       tile's column partials. The dense arm (the first tokenizer stage:
//       C = 27, a dense fp32 image, one launch a step, bound by bytes) keeps
//       the fp32 tile loop of spike_tile.cuh, 64-row tiles over M, each
//       holding T * 64 values;
//   (b) per column, the tiles' partials are added in order and mu, var,
//       sqrt(var + eps) formed (bn_stats.cuh);
//   (c) one pass reads z once, normalises (eq. 17-18) and runs SOMA over T
//       with (U, S) in registers, writing the spikes; a 2-D grid (row range
//       x column block), float4 along K where K % 4 == 0.
// Bound on this card: the packed arm by three dense bf16 passes on the
// tensor cores (3 * 2 * T*M*C*K operations) plus the z round trip (2 * T *
// M * K * 4 bytes); recomputing the product in (c) instead of storing z
// would double the dominant work.
#include "bn_stats.cuh"
#include "spike_mma_mainloop.cuh"
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

// (a), dense arm: z and the per-row-tile column partials of sum(z) and
// sum(z^2) over the tile's T * BM values.
template <int T>
__global__ void __launch_bounds__(THREADS) neuron_layer_train_z(
    const void* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ z, float* __restrict__ part, long long M, int C,
    int K, int n_tiles) {
  constexpr int BC = ChunkOf<T>::value;
  __shared__ __align__(16) float xs[T][BC][XS];
  __shared__ __align__(16) float ws[BC][BN];

  TileArgs a;
  a.x = x;
  a.x_t = M * C;
  a.x_m = C;
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
  accumulate<T, BC, false>(a, xs, ws, acc);   // ends with __syncthreads()

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

// (a), packed arm: z (T * M, K) = x (T * M, C / 8) @ w on the tensor cores,
// and per 256-row tile the column partials of sum(z) and sum(z^2) of the
// rounded z, in a fixed order: each thread over its own four rows, then the
// eight g lanes of a warp by __shfl_xor in a fixed order, then the WARPS_M
// warps in shared memory in warp order.
using ZTile = e2a::mma::Large;

__global__ void __launch_bounds__(ZTile::THREADS, ZTile::MIN_BLOCKS)
    neuron_layer_train_z_mma(const e2a::mma::Operands a, float* __restrict__ z,
                             float* __restrict__ part, int n_tiles) {
  using T = ZTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  e2a::mma::Acc<T> acc;
  e2a::mma::mainloop<T>(a, m0, n0, smem, acc);

  const e2a::mma::Lane<T> L;
  const int K = a.K;
  const bool vec2 = K % 2 == 0;   // z is 256-byte aligned, rows K floats
  float sum[T::WN][2] = {}, sq[T::WN][2] = {};
#pragma unroll
  for (int mt = 0; mt < T::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + L.wm0 + mt * 16 + L.g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < T::WN; ++nt) {
        const int col = n0 + L.wn0 + nt * 8 + 2 * L.t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = e2a::mma::result(acc[0][mt][nt][2 * h + e],
                                  acc[1][mt][nt][2 * h + e]);
          sum[nt][e] = __fadd_rn(sum[nt][e], v[e]);
          sq[nt][e] = __fadd_rn(sq[nt][e], __fmul_rn(v[e], v[e]));
        }
        float* const o = z + row * K + col;
        if (vec2 && col + 1 < K) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
          if (col < K) o[0] = v[0];
          if (col + 1 < K) o[1] = v[1];
        }
      }
    }
  // the eight lanes g = 0..7 that share a column
#pragma unroll
  for (int nt = 0; nt < T::WN; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sum[nt][e] = __fadd_rn(sum[nt][e],
                               __shfl_xor_sync(0xffffffffu, sum[nt][e], off));
        sq[nt][e] = __fadd_rn(sq[nt][e],
                              __shfl_xor_sync(0xffffffffu, sq[nt][e], off));
      }
  // the WARPS_M warps that share a column, in warp order; the mainloop's
  // shared memory is free once every warp is past it
  float* const red = reinterpret_cast<float*>(smem);   // [2][WARPS_M][BN]
  static_assert(2 * T::WARPS_M * T::BN * 4 <= T::SMEM, "reduction space");
  __syncthreads();
  if (L.g == 0) {
    const int wm = (threadIdx.x / 32) / T::WARPS_N;
#pragma unroll
    for (int nt = 0; nt < T::WN; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = L.wn0 + nt * 8 + 2 * L.t + e;
        red[wm * T::BN + c] = sum[nt][e];
        red[(T::WARPS_M + wm) * T::BN + c] = sq[nt][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < 2 * T::BN) {
    const int q = threadIdx.x / T::BN, c = threadIdx.x % T::BN;
    const int col = n0 + c;
    if (col < K) {
      float v = 0.0f;
#pragma unroll
      for (int wm = 0; wm < T::WARPS_M; ++wm)
        v = __fadd_rn(v, red[(q * T::WARPS_M + wm) * T::BN + c]);
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

// (c): y = gamma * (z - mu) / sqrt_d + beta, then SOMA over T. A block of
// SOMA_COLS x SOMA_LANES threads covers SOMA_COLS * V columns of
// SOMA_ROWS rows; a thread takes V neighbouring columns (one float4 where
// V = 4) of every SOMA_LANES-th row of the range, its statistics loaded
// once. The per-element operations and their order are the plain
// version's, so equal statistics give equal spikes bit for bit.
constexpr int SOMA_COLS = 32, SOMA_LANES = 8, SOMA_ROWS = 32;

template <int V>
__global__ void __launch_bounds__(SOMA_COLS* SOMA_LANES)
    neuron_layer_train_soma(const float* __restrict__ z,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ mu,
                            const float* __restrict__ sqrt_d,
                            float* __restrict__ s, long long M, int K, int T,
                            float alpha, float th_fire) {
  const int c0 = (blockIdx.x * SOMA_COLS + threadIdx.x) * V;
  if (c0 >= K) return;                 // V = 4 only where K % 4 == 0
  float ga[V], be[V], m[V], sd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ga[j] = gamma[c0 + j];
    be[j] = beta[c0 + j];
    m[j] = mu[c0 + j];
    sd[j] = sqrt_d[c0 + j];
  }
  const long long plane = M * K;
  // grid.y is capped at MAX_ROW_BLOCKS: a block then takes every
  // gridDim.y-th row range
  for (long long r0 = (long long)blockIdx.y * SOMA_ROWS; r0 < M;
       r0 += (long long)gridDim.y * SOMA_ROWS) {
    const long long r1 = min(r0 + SOMA_ROWS, M);
    for (long long r = r0 + threadIdx.y; r < r1; r += SOMA_LANES) {
      float u[V] = {}, sp[V] = {};
      for (int t = 0; t < T; ++t) {
        const long long at = t * plane + r * K + c0;
        float zv[V];
        e2a::load_v<V>(z + at, zv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float y = __fadd_rn(
              __fdiv_rn(__fmul_rn(ga[j], __fsub_rn(zv[j], m[j])), sd[j]),
              be[j]);
          u[j] = __fadd_rn(__fmul_rn(__fmul_rn(alpha, u[j]),
                                     __fsub_rn(1.0f, sp[j])), y);
          sp[j] = (u[j] >= th_fire) ? 1.0f : 0.0f;
        }
        e2a::store_v<V>(s + at, sp);
      }
    }
  }
}

template <int T>
int launch_train_z_dense(const void* x, const float* w, float* z, float* part,
                         long long M, int C, int K, int n_tiles,
                         cudaStream_t st) {
  const dim3 grid((unsigned)n_tiles, (K + BN - 1) / BN, 1);
  neuron_layer_train_z<T><<<grid, THREADS, 0, st>>>(x, w, z, part, M, C, K,
                                                   n_tiles);
  return (int)cudaGetLastError();
}

int launch_train_z_packed(const e2a::mma::Operands& a, float* z, float* part,
                          int n_tiles, cudaStream_t st) {
  static bool raised[e2a::mma::kMaxDevices] = {};
  const int err = e2a::mma::allow_smem(
      reinterpret_cast<const void*>(neuron_layer_train_z_mma), ZTile::SMEM,
      raised);
  if (err != 0) return err;
  const dim3 grid((unsigned)n_tiles, (a.K + ZTile::BN - 1) / ZTile::BN, 1);
  neuron_layer_train_z_mma<<<grid, ZTile::THREADS, ZTile::SMEM, st>>>(
      a, z, part, n_tiles);
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
// (K); z (T, M, K), part and sqrt_d (K) are scratch. part holds
// (2, n_tiles, K) floats: n_tiles = ceil(T * M / 256) for the packed arm
// (ZTile::BM; kernels/neuron_layer.py TILE_ROWS), ceil(M / 64) for the dense
// arm (BM of spike_tile.cuh; DENSE_TILE_ROWS).
extern "C" int e2a_neuron_layer_train(const void* x, const float* w,
                                      const float* gamma, const float* beta,
                                      float* z, float* part, float* mu,
                                      float* var, float* sqrt_d, float* s,
                                      int T, long long M, int C, int K,
                                      int packed, float alpha, float th_fire,
                                      float eps, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (packed && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (T < 1 || T > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)T * M;
  int n_tiles, code;
  if (packed) {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // T is a row index here: x (T * M, C / 8) and z (T * M, K), contiguous
    const e2a::mma::Operands a = {static_cast<const uint8_t*>(x), C / 8, 1,
                                  w, K, 1, (int)rows, C, K};
    n_tiles = (int)((rows + ZTile::BM - 1) / ZTile::BM);
    code = launch_train_z_packed(a, z, part, n_tiles, st);
  } else {
    n_tiles = (int)((M + BM - 1) / BM);
    switch (T) {
      case 1: code = launch_train_z_dense<1>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 2: code = launch_train_z_dense<2>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 3: code = launch_train_z_dense<3>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 4: code = launch_train_z_dense<4>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 5: code = launch_train_z_dense<5>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 6: code = launch_train_z_dense<6>(x, w, z, part, M, C, K, n_tiles, st); break;
      case 7: code = launch_train_z_dense<7>(x, w, z, part, M, C, K, n_tiles, st); break;
      default: code = launch_train_z_dense<8>(x, w, z, part, M, C, K, n_tiles, st); break;
    }
  }
  if (code != 0) return code;
  neuron_layer_train_stats<<<(K + STAT_COLS - 1) / STAT_COLS,
                             dim3(STAT_COLS, STAT_LANES), 0, st>>>(
      part, mu, var, sqrt_d, n_tiles, K, (double)rows, eps);
  const dim3 block(SOMA_COLS, SOMA_LANES);
  const unsigned row_blocks = e2a::row_blocks(M, SOMA_ROWS);
  if (K % 4 == 0)
    neuron_layer_train_soma<4><<<dim3((K / 4 + SOMA_COLS - 1) / SOMA_COLS,
                                      row_blocks), block, 0, st>>>(
        z, gamma, beta, mu, sqrt_d, s, M, K, T, alpha, th_fire);
  else
    neuron_layer_train_soma<1><<<dim3((K + SOMA_COLS - 1) / SOMA_COLS,
                                      row_blocks), block, 0, st>>>(
        z, gamma, beta, mu, sqrt_d, s, M, K, T, alpha, th_fire);
  return (int)cudaGetLastError();
}
