// Training batch norm over (M, D), forward (eq. 13-18) and backward
// (eq. 19-23), each as three short launches behind one C entry point.
//
// The TPU kernel had one program own all M rows of a feature block. At
// D = 512 that gives a handful of blocks for 132 SMs, so here the column
// reduction is split over row chunks:
//
//   1. partials: a block of 32 columns x 8 row lanes walks one chunk of rows
//      (at least 128, and at most 256 chunks, so the next pass stays short);
//      each lane sums its rows in order, the 8 lanes are added in order in
//      shared memory, and one partial per (chunk, column) and quantity is
//      written to scratch (fp32);
//   2. finalize: the chunks of each column are added in a fixed order
//      (bn_stats.cuh);
//   3. elementwise: y (forward) or dx (backward), reading x (and g) a
//      second time, from L2 at the model's sizes (25.7 MB < 50 MB).
//
// Bound on this card: bytes. The forward must read x and write y
// (2 * M * D * 4 bytes), the backward read g and x and write dx (3 * M * D *
// 4); the second read of the elementwise pass is the price of the split.
// Per-element arithmetic uses the round-to-nearest intrinsics in the order
// of the plain version, so with equal statistics the outputs are equal bit
// for bit; the statistics themselves differ from a library reduction only
// by the order of summation.
#include "bn_stats.cuh"

namespace {

constexpr int BN_COLS = 32;     // columns per block (one warp wide)
constexpr int BN_LANES = 8;     // row lanes per block

__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_partials(
    const float* __restrict__ x, float* __restrict__ part, long long M, int D,
    long long rows, int n_chunks) {
  __shared__ float sh[2][BN_LANES][BN_COLS];
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
    for (int l = 0; l < BN_LANES; ++l) acc = __fadd_rn(acc, sh[lane][l][threadIdx.x]);
    part[((long long)lane * n_chunks + blockIdx.y) * D + col] = acc;
  }
}

__global__ void __launch_bounds__(e2a::STAT_COLS* e2a::STAT_LANES)
bn_fwd_finalize(const float* __restrict__ part, float* __restrict__ mu,
                float* __restrict__ sqrt_d, long long M, int D, int n_chunks,
                float eps) {
  const int col = blockIdx.x * e2a::STAT_COLS + threadIdx.x;
  double sums[2];
  e2a::reduce_parts<2>(part, n_chunks, D, col, sums);
  if (threadIdx.y != 0 || col >= D) return;
  float m, v, sd;
  e2a::column_stats(sums[0], sums[1], (double)M, eps, m, v, sd);
  mu[col] = m;
  sqrt_d[col] = sd;
}

__global__ void __launch_bounds__(256) bn_fwd_normalize(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* __restrict__ y, long long n,
    int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % D);
  // y = gamma * (x - mu) / sqrt_d + beta            (eq. 17-18)
  y[i] = __fadd_rn(__fdiv_rn(__fmul_rn(gamma[c], __fsub_rn(x[i], mu[c])),
                             sqrt_d[c]),
                   beta[c]);
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
// floats of scratch, one partial per chunk of ``rows`` rows.
extern "C" int e2a_bn_fwd(const float* x, const float* gamma,
                          const float* beta, float* y, float* mu,
                          float* sqrt_d, float* part, long long M, int D,
                          long long rows, float eps, void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  const dim3 grid((D + BN_COLS - 1) / BN_COLS, n_chunks);
  bn_fwd_partials<<<grid, dim3(BN_COLS, BN_LANES), 0, st>>>(x, part, M, D,
                                                            rows, n_chunks);
  bn_fwd_finalize<<<stat_blocks(D), STAT_BLOCK, 0, st>>>(part, mu, sqrt_d, M,
                                                         D, n_chunks, eps);
  const long long n = M * D;
  bn_fwd_normalize<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      x, gamma, beta, mu, sqrt_d, y, n, D);
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
