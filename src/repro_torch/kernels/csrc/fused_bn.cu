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
// Backward, two launches, the same design:
//   1. bn_bwd_partials: the four column sums of eq. 19-22 as partials, one
//      column per lane; the group's last block adds them and writes dgamma,
//      dbeta and the per-column terms of eq. 23, rounded as the plain
//      version rounds them, so that the dx pass does no per-column work.
//   2. bn_bwd_dx: dx from g and x, read a second time; the forward's 2-D
//      grid, float4 along D where aligned.
//
// Split path (data parallelism, the statistics of the global batch): the
// elected block of each first pass writes the group's column sums in double
// to a buffer instead of finishing the statistics (bn_stats.cuh), and a
// second entry point, called after the wrapper has all-reduced the buffer
// over the ranks, forms them from the global sums and row count and runs
// the elementwise pass: e2a_bn_fwd_sums + e2a_bn_fwd_apply, e2a_bn_bwd_sums +
// e2a_bn_bwd_apply. dgamma and dbeta come from the rank's own sums (the
// train step adds them over the ranks with the other gradients); dx from the
// global ones. The arithmetic is the fused path's, so at a world of 1 the
// outputs are its bits.
//
// Bound on this card: bytes. The forward must read x and write y
// (2 * M * D * 4 bytes), the backward read g and x and write dx (3 * M * D *
// 4); the second read of the elementwise pass is the price of the split (at
// 12544 x 512, g and x are 51.4 MB, just over the 50 MB L2).
// Per-element arithmetic uses the round-to-nearest intrinsics in the order
// of the plain version, so with equal statistics the outputs are equal bit
// for bit; the statistics themselves differ from a library reduction only
// by the order of summation.
#include <stdint.h>

#include "bn_stats.cuh"

namespace {

constexpr int BN_COLS = 32;     // column lanes per block (one warp wide)
constexpr int BN_LANES = 8;     // row lanes per block
constexpr int EW_ROWS = 32;     // rows per block of the normalize pass
// bn_fwd_stats and bn_bwd_partials finalize with reduce_parts on their own
// blocks
static_assert(BN_COLS == e2a::STAT_COLS && BN_LANES == e2a::STAT_LANES,
              "block shape of reduce_parts");

// Pass 1: per-chunk partials of sum(x) and sum(x^2), then, in the last block
// of each group of BN_COLS columns, mu and sqrt_d of those columns; where
// sums is given, the columns' sums and the row count go there instead. One
// column per lane: float4 loads (four columns a lane, 128 a block) made a
// quarter as many blocks (392 for 132 SMs at 12544 x 512) and ran slower on
// the H100, 20.0 against 16.1 us (PERF.md, section 6).
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_stats(
    const float* __restrict__ x, float* part, unsigned* __restrict__ arrived,
    float* __restrict__ mu, float* __restrict__ sqrt_d,
    double* __restrict__ sums, long long M, int D, long long rows,
    int n_chunks, float eps) {
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
  double sx[2];
  e2a::reduce_parts<2>(part, n_chunks, D, col, sx);
  if (lane != 0 || col >= D) return;
  if (sums != nullptr) {
    sums[col] = sx[0];
    sums[D + col] = sx[1];
    if (col == 0) sums[2 * D] = (double)M;
    return;
  }
  float m, v, sd;
  e2a::column_stats(sx[0], sx[1], (double)M, eps, m, v, sd);
  mu[col] = m;
  sqrt_d[col] = sd;
}

// Split path: mu and sqrt_d of each column from the all-reduced sums.
__global__ void bn_fwd_finalize(const double* __restrict__ sums, int D,
                                float eps, float* __restrict__ mu,
                                float* __restrict__ sqrt_d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  float m, v, sd;
  e2a::stats_from_sums(sums, D, col, eps, m, v, sd);
  mu[col] = m;
  sqrt_d[col] = sd;
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

// The normalize pass, float4 along D where D % 4 == 0 and x and y are
// 16-byte aligned. Returns a cudaError_t.
int launch_normalize_any(const float* x, const float* gamma,
                         const float* beta, const float* mu,
                         const float* sqrt_d, float* y, long long M, int D,
                         cudaStream_t st) {
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0)
    launch_normalize<4>(x, gamma, beta, mu, sqrt_d, y, M, D, st);
  else
    launch_normalize<1>(x, gamma, beta, mu, sqrt_d, y, M, D, st);
  return (int)cudaGetLastError();
}

// One row's terms of the four sums, added in the plain version's order.
__device__ __forceinline__ void bwd_terms(float gv, float xv, float ga,
                                          float m, float sd,
                                          float (&acc)[4]) {
  const float mi = __fdiv_rn(__fmul_rn(ga, gv), sd);
  const float nv = __fsub_rn(xv, m);
  acc[0] = __fadd_rn(acc[0], nv);
  acc[1] = __fadd_rn(acc[1], mi);
  acc[2] = __fadd_rn(acc[2], __fmul_rn(mi, nv));
  acc[3] = __fadd_rn(acc[3], gv);
}

constexpr int BWD_UNROLL = 4;   // rows of a batch of loads in pass 1

// Backward pass 1: per-chunk partials of s_n = sum(x - mu), s_m = sum(mi),
// s_mn = sum(mi * n) and s_g = sum(g), with mi = gamma * g / sqrt_d (eq.
// 19-20, 22), one column per lane; then, as in bn_fwd_stats, the last block
// of each group of BN_COLS columns to finish adds the group's chunks and
// writes dgamma = s_mn / gamma (eq. 21, as the reference has it: inf or nan
// where gamma is 0), dbeta = s_g (eq. 22), and eq. 23's per-column terms
// for the dx pass, each rounded as the plain version rounds it:
//   cols[0] = s_mn, cols[1] = M * sq2, cols[2] = s_n * s_mn / (sq2 * M * M),
//   cols[3] = s_m / M, with sq2 = sqrt_d * sqrt_d.
// Where sums is given (the split path) the block writes dgamma and dbeta
// and leaves the four sums, in double, and the row count to sums: eq. 23's
// terms wait for the global sums (bn_bwd_cols).
__device__ __forceinline__ void bwd_cols(double s_n_d, double s_m_d,
                                         double s_mn_d, double count,
                                         float sd, int D, int col,
                                         float* __restrict__ cols) {
  const float s_n = (float)s_n_d, s_m = (float)s_m_d, s_mn = (float)s_mn_d;
  const float m = (float)count;
  const float sq2 = __fmul_rn(sd, sd);
  cols[col] = s_mn;
  cols[D + col] = __fmul_rn(m, sq2);
  cols[2 * D + col] = __fdiv_rn(__fmul_rn(s_n, s_mn),
                                __fmul_rn(__fmul_rn(sq2, m), m));
  cols[3 * D + col] = __fdiv_rn(s_m, m);
}

__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_bwd_partials(
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* part,
    unsigned* __restrict__ arrived, float* __restrict__ cols,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    double* __restrict__ sums, long long M, int D, long long rows,
    int n_chunks) {
  __shared__ float sh[4][BN_LANES][BN_COLS];
  __shared__ bool last;
  const int col = blockIdx.x * BN_COLS + threadIdx.x;
  const int lane = threadIdx.y;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = min(r0 + rows, M);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (col < D) {
    const float ga = gamma[col], m = mu[col], sd = sqrt_d[col];
    // the lane's rows in order, in batches of BWD_UNROLL rows; the next
    // batch's loads are issued before this batch is added, so that two
    // batches' loads are in flight while the adds wait on one
    constexpr long long STEP = (long long)BWD_UNROLL * BN_LANES;
    const long long first = r0 + lane;
    const long long full = r1 - first >= STEP ? (r1 - first) / STEP : 0;
    float gv[BWD_UNROLL], xv[BWD_UNROLL];
    const auto load = [&](long long r, float (&gb)[BWD_UNROLL],
                          float (&xb)[BWD_UNROLL]) {
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        gb[u] = g[(r + u * BN_LANES) * D + col];
        xb[u] = x[(r + u * BN_LANES) * D + col];
      }
    };
    if (full > 0) load(first, gv, xv);
    for (long long b = 0; b < full; ++b) {
      float gn[BWD_UNROLL], xn[BWD_UNROLL];
      const bool more = b + 1 < full;
      if (more) load(first + (b + 1) * STEP, gn, xn);
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u)
        bwd_terms(gv[u], xv[u], ga, m, sd, acc);
      if (more)
#pragma unroll
        for (int u = 0; u < BWD_UNROLL; ++u) {
          gv[u] = gn[u];
          xv[u] = xn[u];
        }
    }
    for (long long r = first + full * STEP; r < r1; r += BN_LANES)
      bwd_terms(g[r * D + col], x[r * D + col], ga, m, sd, acc);
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
  // Elect the group's last block, as bn_fwd_stats does.
  __threadfence();
  __syncthreads();
  if (lane == 0 && threadIdx.x == 0) {
    last = atomicAdd(arrived + blockIdx.x, 1u) == gridDim.y - 1;
    if (last) arrived[blockIdx.x] = 0;   // no other block of the group is left
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s[4];
  e2a::reduce_parts<4>(part, n_chunks, D, col, s);
  if (lane != 0 || col >= D) return;
  dgamma[col] = __fdiv_rn((float)s[2], gamma[col]);
  dbeta[col] = (float)s[3];
  if (sums != nullptr) {
#pragma unroll
    for (int q = 0; q < 3; ++q) sums[q * D + col] = s[q];
    if (col == 0) sums[3 * D] = (double)M;
    return;
  }
  bwd_cols(s[0], s[1], s[2], (double)M, sqrt_d[col], D, col, cols);
}

// Split path: eq. 23's per-column terms from the all-reduced (s_n, s_m,
// s_mn) and row count.
__global__ void bn_bwd_cols(const double* __restrict__ sums,
                            const float* __restrict__ sqrt_d, int D,
                            float* __restrict__ cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= D) return;
  bwd_cols(sums[col], sums[D + col], sums[2 * D + col], sums[3 * D],
           sqrt_d[col], D, col, cols);
}

// Backward pass 2: dx = mi - n * s_mn / (M * sq2) + s_n * s_mn / (sq2 * M *
// M) - s_m / M (eq. 23), left to right as the reference writes it, the
// per-column terms from pass 1 held in registers: per element only mi, n
// and n * s_mn / (M * sq2), two divisions. A block of DX_THREADS threads is
// blockDim.x column lanes (V neighbouring columns each, one float4 where
// V = 4) by blockDim.y row lanes over DX_LANE_ROWS * blockDim.y rows; fewer
// than 32 column lanes where D is narrow, so that no lane idles.
constexpr int DX_THREADS = 256;
constexpr int DX_LANE_ROWS = 4;

template <int V>
__global__ void __launch_bounds__(DX_THREADS) bn_bwd_dx(
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, const float* __restrict__ cols,
    float* __restrict__ dx, long long M, int D) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c0 >= D) return;               // V = 4 only where D % 4 == 0
  float ga[V], m[V], sd[V], smn[V], msq2[V], c1[V], c2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ga[j] = gamma[c0 + j];
    m[j] = mu[c0 + j];
    sd[j] = sqrt_d[c0 + j];
    smn[j] = cols[c0 + j];
    msq2[j] = cols[D + c0 + j];
    c1[j] = cols[2 * D + c0 + j];
    c2[j] = cols[3 * D + c0 + j];
  }
  const auto dx_of = [&](float (&gv)[V], const float (&xv)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float mi = __fdiv_rn(__fmul_rn(ga[j], gv[j]), sd[j]);
      const float nv = __fsub_rn(xv[j], m[j]);
      const float v =
          __fsub_rn(mi, __fdiv_rn(__fmul_rn(nv, smn[j]), msq2[j]));
      gv[j] = __fsub_rn(__fadd_rn(v, c1[j]), c2[j]);
    }
  };
  const long long rows = (long long)DX_LANE_ROWS * blockDim.y;
  // grid.y is capped at MAX_ROW_BLOCKS: a block then takes every
  // gridDim.y-th row range
  for (long long r0 = (long long)blockIdx.y * rows; r0 < M;
       r0 += (long long)gridDim.y * rows) {
    const long long r = r0 + threadIdx.y;
    if (r0 + rows <= M) {   // a whole range: every load issued first
      float gv[DX_LANE_ROWS][V], xv[DX_LANE_ROWS][V];
#pragma unroll
      for (int i = 0; i < DX_LANE_ROWS; ++i) {
        e2a::load_v<V>(g + (r + i * blockDim.y) * D + c0, gv[i]);
        e2a::load_v<V>(x + (r + i * blockDim.y) * D + c0, xv[i]);
      }
#pragma unroll
      for (int i = 0; i < DX_LANE_ROWS; ++i) {
        dx_of(gv[i], xv[i]);
        e2a::store_v<V>(dx + (r + i * blockDim.y) * D + c0, gv[i]);
      }
      continue;
    }
    for (long long ri = r; ri < M; ri += blockDim.y) {
      float gv[V], xv[V];
      e2a::load_v<V>(g + ri * D + c0, gv);
      e2a::load_v<V>(x + ri * D + c0, xv);
      dx_of(gv, xv);
      e2a::store_v<V>(dx + ri * D + c0, gv);
    }
  }
}

template <int V>
void launch_dx(const float* g, const float* x, const float* gamma,
               const float* mu, const float* sqrt_d, const float* cols,
               float* dx, long long M, int D, cudaStream_t st) {
  int bx = 32;   // column lanes: 32, or the least power of two whose V
  while (bx > 1 && (bx / 2) * V >= D) bx /= 2;   // columns each cover D
  const int by = DX_THREADS / bx;
  const dim3 grid((D + bx * V - 1) / (bx * V),
                  e2a::row_blocks(M, DX_LANE_ROWS * by));
  bn_bwd_dx<V><<<grid, dim3(bx, by), 0, st>>>(g, x, gamma, mu, sqrt_d, cols,
                                              dx, M, D);
}

// The dx pass, float4 along D where D % 4 == 0 and g, x and dx are 16-byte
// aligned. Returns a cudaError_t.
int launch_dx_any(const float* g, const float* x, const float* gamma,
                  const float* mu, const float* sqrt_d, const float* cols,
                  float* dx, long long M, int D, cudaStream_t st) {
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dx) % 16 == 0)
    launch_dx<4>(g, x, gamma, mu, sqrt_d, cols, dx, M, D, st);
  else
    launch_dx<1>(g, x, gamma, mu, sqrt_d, cols, dx, M, D, st);
  return (int)cudaGetLastError();
}

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
                                                   sqrt_d, nullptr, M, D,
                                                   rows, n_chunks, eps);
  return launch_normalize_any(x, gamma, beta, mu, sqrt_d, y, M, D, st);
}

// Split path, forward, before the all-reduce: sums (2 * D + 1 doubles)
// receives the rank's sum(x) and sum(x^2) per column and its row count M.
extern "C" int e2a_bn_fwd_sums(const float* x, float* part, unsigned* arrived,
                               double* sums, long long M, int D,
                               long long rows, void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  bn_fwd_stats<<<dim3((D + BN_COLS - 1) / BN_COLS, n_chunks),
                 dim3(BN_COLS, BN_LANES), 0, st>>>(x, part, arrived, nullptr,
                                                   nullptr, sums, M, D, rows,
                                                   n_chunks, 0.0f);
  return (int)cudaGetLastError();
}

// Split path, forward, after the all-reduce: mu and sqrt_d from the global
// sums, then y.
extern "C" int e2a_bn_fwd_apply(const float* x, const float* gamma,
                                const float* beta, const double* sums,
                                float* y, float* mu, float* sqrt_d,
                                long long M, int D, float eps, void* stream) {
  if (D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_fwd_finalize<<<(D + 255) / 256, 256, 0, st>>>(sums, D, eps, mu, sqrt_d);
  if (M <= 0) return (int)cudaGetLastError();
  return launch_normalize_any(x, gamma, beta, mu, sqrt_d, y, M, D, st);
}

// g, x (M, D), gamma, mu, sqrt_d (D) -> dx (M, D), dgamma, dbeta (D).
// part: 4 * ceil(M / rows) * D floats of scratch, cols: 4 * D; arrived:
// ceil(D / 32) counters, 0 on entry and left at 0.
extern "C" int e2a_bn_bwd(const float* g, const float* x, const float* gamma,
                          const float* mu, const float* sqrt_d, float* dx,
                          float* dgamma, float* dbeta, float* part,
                          float* cols, unsigned* arrived, long long M, int D,
                          long long rows, void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  bn_bwd_partials<<<dim3((D + BN_COLS - 1) / BN_COLS, n_chunks),
                    dim3(BN_COLS, BN_LANES), 0, st>>>(
      g, x, gamma, mu, sqrt_d, part, arrived, cols, dgamma, dbeta, nullptr, M,
      D, rows, n_chunks);
  return launch_dx_any(g, x, gamma, mu, sqrt_d, cols, dx, M, D, st);
}

// Split path, backward, before the all-reduce: dgamma and dbeta from the
// rank's rows, and sums (3 * D + 1 doubles) receives its s_n, s_m, s_mn per
// column and its row count M.
extern "C" int e2a_bn_bwd_sums(const float* g, const float* x,
                               const float* gamma, const float* mu,
                               const float* sqrt_d, float* dgamma,
                               float* dbeta, float* part, double* sums,
                               unsigned* arrived, long long M, int D,
                               long long rows, void* stream) {
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (int)((M + rows - 1) / rows);
  bn_bwd_partials<<<dim3((D + BN_COLS - 1) / BN_COLS, n_chunks),
                    dim3(BN_COLS, BN_LANES), 0, st>>>(
      g, x, gamma, mu, sqrt_d, part, arrived, nullptr, dgamma, dbeta, sums,
      M, D, rows, n_chunks);
  return (int)cudaGetLastError();
}

// Split path, backward, after the all-reduce: eq. 23's terms from the
// global sums into cols (4 * D floats), then dx.
extern "C" int e2a_bn_bwd_apply(const float* g, const float* x,
                                const float* gamma, const float* mu,
                                const float* sqrt_d, const double* sums,
                                float* cols, float* dx, long long M, int D,
                                void* stream) {
  if (D <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_bwd_cols<<<(D + 255) / 256, 256, 0, st>>>(sums, sqrt_d, D, cols);
  if (M <= 0) return (int)cudaGetLastError();
  return launch_dx_any(g, x, gamma, mu, sqrt_d, cols, dx, M, D, st);
}
