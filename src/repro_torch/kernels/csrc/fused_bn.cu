// Training batch norm over (M, D), forward (eq. 13-18) and backward
// (eq. 19-23), each behind one C entry point.
//
// The TPU kernel had one program own all M rows of a feature block. At
// D = 512 that gives a handful of blocks for 132 SMs, so here the column
// reduction is split over row chunks (at least 128 rows, and at most 256
// chunks, so that adding the chunks stays short): a block of 32 columns x
// 8 row lanes walks one chunk; each lane sums its rows in order,
// the 8 lanes are added in order in shared memory, and one fp32 partial per
// (chunk, column) and quantity goes to scratch. The chunks of each column
// are then added in a fixed order in double (bn_stats.cuh): no atomics
// carry a sum, so the statistics are the same on every run.
//
// Forward, two launches:
//   1. bn_fwd_stats: the partials, one column per lane. The last block of
//      each group of 32 columns to finish reduces that group's partials to
//      mu and sqrt(var + eps): a per-group arrival counter in the wrapper's
//      scratch, behind __threadfence(), elects it. The counter only
//      elects; the electing block resets it to 0 for the next call.
//   2. bn_fwd_normalize: y from x, read a second time (from L2 at the
//      model's sizes: 25.7 MB < 50 MB); a 2-D grid of row ranges x column
//      blocks, float4 along D where aligned.
// Backward, three launches: partials, finalize, elementwise dx.
//
// Bound on this card: bytes. The forward must read x and write y
// (2 * M * D * 4 bytes), the backward read g and x and write dx (3 * M * D *
// 4); the second read of the elementwise pass is the price of the split.
// Per-element arithmetic uses the round-to-nearest intrinsics in the order
// of the plain version, so with equal statistics the outputs are equal bit
// for bit; the statistics themselves differ from a library reduction only
// by the order of summation.
#include <stdint.h>

#include "bn_stats.cuh"

namespace {

constexpr int BN_COLS = 32;     // column lanes per block (one warp wide)
constexpr int BN_LANES = 8;     // row lanes per block
constexpr int EW_ROWS = 32;     // rows per block of the elementwise passes
// bn_fwd_stats finalizes with reduce_parts on its own block
static_assert(BN_COLS == e2a::STAT_COLS && BN_LANES == e2a::STAT_LANES,
              "block shape of reduce_parts");

// Pass 1: per-chunk partials of sum(x) and sum(x^2), then, in the last block
// of each group of BN_COLS columns, mu and sqrt_d of those columns. One
// column per lane: float4 loads (four columns a lane, 128 a block) made a
// quarter as many blocks (392 for 132 SMs at 12544 x 512) and ran slower on
// the H100, 20.0 against 16.1 us (PERF.md, section 6).
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_stats(
    const float* __restrict__ x, float* part, unsigned* __restrict__ arrived,
    float* __restrict__ mu, float* __restrict__ sqrt_d, long long M, int D,
    long long rows, int n_chunks, float eps) {
  __shared__ float sh[2][BN_LANES][BN_COLS];
  __shared__ bool last;
  const int col = blockIdx.x * BN_COLS + threadIdx.x;
  const int lane = threadIdx.y;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = min(r0 + rows, M);
  float s = 0.0f, q = 0.0f;
  if (col < D) {
    for (long long r = r0 + lane; r < r1; r += BN_LANES) {
      const float v = x[r * D + col];
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
  }
  sh[0][lane][threadIdx.x] = s;
  sh[1][lane][threadIdx.x] = q;
  __syncthreads();
  if (lane < 2 && col < D) {
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < BN_LANES; ++l)
      acc = __fadd_rn(acc, sh[lane][l][threadIdx.x]);
    part[((long long)lane * n_chunks + blockIdx.y) * D + col] = acc;
  }
  // Elect the group's last block: every partial of this block is visible
  // device-wide before its arrival is counted.
  __threadfence();
  __syncthreads();
  if (lane == 0 && threadIdx.x == 0) {
    last = atomicAdd(arrived + blockIdx.x, 1u) == gridDim.y - 1;
    if (last) arrived[blockIdx.x] = 0;   // no other block of the group is left
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double sums[2];
  e2a::reduce_parts<2>(part, n_chunks, D, col, sums);
  if (lane == 0 && col < D) {
    float m, v, sd;
    e2a::column_stats(sums[0], sums[1], (double)M, eps, m, v, sd);
    mu[col] = m;
    sqrt_d[col] = sd;
  }
}

// Pass 2: y = gamma * (x - mu) / sqrt_d + beta (eq. 17-18). A block covers
// BN_COLS * V columns of EW_ROWS rows; a thread takes V neighbouring
// columns of every BN_LANES-th row of the range.
template <int V>
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_normalize(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* __restrict__ y, long long M,
    int D) {
  const int c0 = (blockIdx.x * BN_COLS + threadIdx.x) * V;
  if (c0 >= D) return;
  float ga[V], be[V], m[V], sd[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ga[j] = gamma[c0 + j];
    be[j] = beta[c0 + j];
    m[j] = mu[c0 + j];
    sd[j] = sqrt_d[c0 + j];
  }
  // grid.y is capped at MAX_ROW_BLOCKS: a block then takes every
  // gridDim.y-th row range
  for (long long r0 = (long long)blockIdx.y * EW_ROWS; r0 < M;
       r0 += (long long)gridDim.y * EW_ROWS) {
    const long long r1 = min(r0 + EW_ROWS, M);
    for (long long r = r0 + threadIdx.y; r < r1; r += BN_LANES) {
      float v[V];
      e2a::load_v<V>(x + r * D + c0, v);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = __fadd_rn(
            __fdiv_rn(__fmul_rn(ga[j], __fsub_rn(v[j], m[j])), sd[j]), be[j]);
      e2a::store_v<V>(y + r * D + c0, v);
    }
  }
}

template <int V>
void launch_normalize(const float* x, const float* gamma, const float* beta,
                      const float* mu, const float* sqrt_d, float* y,
                      long long M, int D, cudaStream_t st) {
  const dim3 grid((D + BN_COLS * V - 1) / (BN_COLS * V),
                  e2a::row_blocks(M, EW_ROWS));
  bn_fwd_normalize<V><<<grid, dim3(BN_COLS, BN_LANES), 0, st>>>(
      x, gamma, beta, mu, sqrt_d, y, M, D);
}

// Backward partials: s_n = sum(x - mu), s_m = sum(mi), s_mn = sum(mi * n),
// s_g = sum(g), with mi = gamma * g / sqrt_d (eq. 19-20, 22).
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_bwd_partials(
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* __restrict__ part, long long M,
    int D, long long rows, int n_chunks) {
  __shared__ float sh[4][BN_LANES][BN_COLS];
  const int col = blockIdx.x * BN_COLS + threadIdx.x;
  const int lane = threadIdx.y;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = min(r0 + rows, M);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < D) {
    const float ga = gamma[col], m = mu[col], sd = sqrt_d[col];
    for (long long r = r0 + lane; r < r1; r += BN_LANES) {
      const float gv = g[r * D + col];
      const float mi = __fdiv_rn(__fmul_rn(ga, gv), sd);
      const float nv = __fsub_rn(x[r * D + col], m);
      acc[0] = __fadd_rn(acc[0], nv);
      acc[1] = __fadd_rn(acc[1], mi);
      acc[2] = __fadd_rn(acc[2], __fmul_rn(mi, nv));
      acc[3] = __fadd_rn(acc[3], gv);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) sh[k][lane][threadIdx.x] = acc[k];
  __syncthreads();
  if (lane < 4 && col < D) {
    float a = 0.0f;
#pragma unroll
    for (int l = 0; l < BN_LANES; ++l) a = __fadd_rn(a, sh[lane][l][threadIdx.x]);
    part[((long long)lane * n_chunks + blockIdx.y) * D + col] = a;
  }
}

// sums (4, D): s_n, s_m, s_mn, s_g; dgamma = s_mn / gamma (eq. 21, as the
// reference has it: inf or nan where gamma is 0), dbeta = s_g (eq. 22).
__global__ void __launch_bounds__(e2a::STAT_COLS* e2a::STAT_LANES)
bn_bwd_finalize(const float* __restrict__ part,
                const float* __restrict__ gamma, float* __restrict__ sums,
                float* __restrict__ dgamma, float* __restrict__ dbeta, int D,
                int n_chunks) {
  const int col = blockIdx.x * e2a::STAT_COLS + threadIdx.x;
  double s[4];
  e2a::reduce_parts<4>(part, n_chunks, D, col, s);
  if (threadIdx.y != 0 || col >= D) return;
  for (int k = 0; k < 4; ++k) sums[k * D + col] = (float)s[k];
  dgamma[col] = __fdiv_rn(sums[2 * D + col], gamma[col]);
  dbeta[col] = sums[3 * D + col];
}

// dx = mi - n * s_mn / (M * sq2) + s_n * s_mn / (sq2 * M * M) - s_m / M
// (eq. 23), left to right as the reference writes it.
__global__ void __launch_bounds__(256) bn_bwd_dx(
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, const float* __restrict__ sums,
    float* __restrict__ dx, long long n, long long M, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % D);
  const float m = (float)M;
  const float sd = sqrt_d[c];
  const float s_n = sums[c], s_m = sums[D + c], s_mn = sums[2 * D + c];
  const float mi = __fdiv_rn(__fmul_rn(gamma[c], g[i]), sd);
  const float nv = __fsub_rn(x[i], mu[c]);
  const float sq2 = __fmul_rn(sd, sd);
  float r = __fsub_rn(mi, __fdiv_rn(__fmul_rn(nv, s_mn), __fmul_rn(m, sq2)));
  r = __fadd_rn(r, __fdiv_rn(__fmul_rn(s_n, s_mn),
                             __fmul_rn(__fmul_rn(sq2, m), m)));
  dx[i] = __fsub_rn(r, __fdiv_rn(s_m, m));
}

const dim3 STAT_BLOCK(e2a::STAT_COLS, e2a::STAT_LANES);

int stat_blocks(int D) { return (D + e2a::STAT_COLS - 1) / e2a::STAT_COLS; }

}  // namespace

// x (M, D) -> y (M, D), mu (D), sqrt_d (D). part: 2 * ceil(M / rows) * D
// floats of scratch, one partial per chunk of ``rows`` rows; arrived:
// ceil(D / 32) counters, 0 on entry and left at 0.
extern "C" int e2a_bn_fwd(const float* x, const float* gamma,
                          const float* beta, float* y, float* mu,
                          float* sqrt_d, float* part, unsigned* arrived,
                          long long M, int D, long long rows, float eps,
                          void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  bn_fwd_stats<<<dim3((D + BN_COLS - 1) / BN_COLS, n_chunks),
                 dim3(BN_COLS, BN_LANES), 0, st>>>(x, part, arrived, mu,
                                                   sqrt_d, M, D, rows,
                                                   n_chunks, eps);
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0)
    launch_normalize<4>(x, gamma, beta, mu, sqrt_d, y, M, D, st);
  else
    launch_normalize<1>(x, gamma, beta, mu, sqrt_d, y, M, D, st);
  return (int)cudaGetLastError();
}

// g, x (M, D), gamma, mu, sqrt_d (D) -> dx (M, D), dgamma, dbeta (D).
// part: 4 * ceil(M / rows) * D floats of scratch, sums: 4 * D.
extern "C" int e2a_bn_bwd(const float* g, const float* x, const float* gamma,
                          const float* mu, const float* sqrt_d, float* dx,
                          float* dgamma, float* dbeta, float* part,
                          float* sums, long long M, int D, long long rows,
                          void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  const dim3 grid((D + BN_COLS - 1) / BN_COLS, n_chunks);
  bn_bwd_partials<<<grid, dim3(BN_COLS, BN_LANES), 0, st>>>(
      g, x, gamma, mu, sqrt_d, part, M, D, rows, n_chunks);
  bn_bwd_finalize<<<stat_blocks(D), STAT_BLOCK, 0, st>>>(part, gamma, sums,
                                                         dgamma, dbeta, D,
                                                         n_chunks);
  const long long n = M * D;
  bn_bwd_dx<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      g, x, gamma, mu, sqrt_d, sums, dx, n, M, D);
  return (int)cudaGetLastError();
}
