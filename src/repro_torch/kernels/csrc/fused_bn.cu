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
//
// bf16 (the reference's kernels at a bf16 input): x, y (forward) and g, x,
// dx (backward) are bf16, named by the dtype code; each element is loaded
// as fp32 and everything after runs as for fp32: the partials, the
// statistics mu and sqrt_d, dgamma and dbeta stay fp32, and y and dx are
// rounded to bf16 once, at the store (the Pallas kernels load as fp32 and
// store in x.dtype and g.dtype). gamma and beta come as fp32 (the wrapper
// widens a bf16 parameter, exactly).
//
// The backward at bf16 has launch shapes of its own, since the fp32 ones
// moved half the bytes a lane at bf16 (one column a lane in pass 1: 64
// bytes of a row a warp): pass 1 takes two neighbouring columns a lane
// (bn_bwd_partials2: a bf16x2 word of g and of x a row) over chunks of at
// least 256 rows (the wrapper's), and the dx pass eight columns a lane
// (bn_bwd_dx8: 16 bytes of g, x and dx a row, one wave of blocks walking
// their rows with loads in flight) where D % 8 == 0 and the operands are
// 16-byte aligned; elsewhere the fp32 design's shapes. Each element's
// arithmetic (bwd_terms, dx_elem) and each column's order of summation
// within a chunk (the lane's rows, the lanes) are the fp32 arm's, so inputs
// whose every sum is exact give the plain version's bits. The fp32 arm
// keeps its launches.
#include <stdint.h>

#include <type_traits>

#include "bn_stats.cuh"
#include "launch_plan.cuh"

namespace {

constexpr int BN_COLS = 32;     // column lanes per block (one warp wide)
constexpr int BN_LANES = 8;     // row lanes per block
constexpr int EW_ROWS = 32;     // rows per block of the normalize pass
constexpr int PAIR = 2;         // columns a lane of the bf16 backward's pass 1
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
template <class E>
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_stats(
    const E* __restrict__ x, float* part, unsigned* __restrict__ arrived,
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
      const float v = e2a::to_f(x[r * D + col]);
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
template <int V, class E>
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_fwd_normalize(
    const E* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, E* __restrict__ y, long long M,
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

// Which kernel a Launch record of this file is for.
enum Kernel {
  STATS, NORM4, NORM1, FINALIZE, PARTIALS, DX4, DX1, COLS, PARTIALS2, DX8
};

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
bool aligned16(const void* p) { return aligned(p, 16); }

// A first pass (bn_fwd_stats, bn_bwd_partials): a block of 32 columns x 8
// row lanes for each chunk of `rows` rows.
e2a::Launch chunks_plan(long long M, int D, long long rows, Kernel k) {
  e2a::Launch l = e2a::launch_of(BN_COLS, BN_LANES, 0, k);
  e2a::axis(l, 0, e2a::cdiv(D, BN_COLS), BN_COLS, D);
  return e2a::axis(l, 1, e2a::cdiv(M, rows), rows, M);
}

// The backward's first pass: bn_bwd_partials, or at bf16 bn_bwd_partials2
// (D % 2 == 0, g and x 4-byte aligned: a bf16x2 word a lane) over blocks
// of BN_COLS * PAIR columns.
e2a::Launch partials_plan(const void* g, const void* x, long long M, int D,
                          long long rows, int dtype) {
  const int V = dtype == e2a::kBfloat16 && D % 2 == 0 && aligned(g, 4) &&
                        aligned(x, 4)
                    ? PAIR
                    : 1;
  e2a::Launch l =
      e2a::launch_of(BN_COLS, BN_LANES, 0, V == PAIR ? PARTIALS2 : PARTIALS);
  e2a::axis(l, 0, e2a::cdiv(D, BN_COLS * V), BN_COLS * V, D);
  return e2a::axis(l, 1, e2a::cdiv(M, rows), rows, M);
}

// A per-column pass (bn_fwd_finalize, bn_bwd_cols): 256 columns a block.
e2a::Launch columns_plan(int D, Kernel k) {
  e2a::Launch l = e2a::launch_of(256, 1, 0, k);
  return e2a::axis(l, 0, e2a::cdiv(D, 256), 256, D);
}

// Row ranges of `rows` rows on grid.y, at most MAX_ROW_BLOCKS of them.
e2a::Launch& row_axis(e2a::Launch& l, long long M, long long rows) {
  return e2a::axis(l, 1, e2a::row_blocks(M, (int)rows), rows, M,
                   e2a::cdiv(M, rows) > e2a::MAX_ROW_BLOCKS);
}

// The normalize pass, float4 along D where D % 4 == 0 and x and y are
// 16-byte aligned.
e2a::Launch normalize_plan(const void* x, const void* y, long long M,
                           int D) {
  const bool v4 = D % 4 == 0 && aligned16(x) && aligned16(y);
  const int V = v4 ? 4 : 1;
  e2a::Launch l = e2a::launch_of(BN_COLS, BN_LANES, 0, v4 ? NORM4 : NORM1);
  e2a::axis(l, 0, e2a::cdiv(D, BN_COLS * V), BN_COLS * V, D);
  return row_axis(l, M, EW_ROWS);
}

// Returns a cudaError_t.
template <class E>
int launch_normalize(const e2a::Launch& l, const E* x, const float* gamma,
                     const float* beta, const float* mu, const float* sqrt_d,
                     E* y, long long M, int D, cudaStream_t st) {
  if (l.kernel == NORM4)
    bn_fwd_normalize<4, E><<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
        x, gamma, beta, mu, sqrt_d, y, M, D);
  else
    bn_fwd_normalize<1, E><<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
        x, gamma, beta, mu, sqrt_d, y, M, D);
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

// One column's results from its four sums: dgamma, dbeta and eq. 23's
// terms (or, where sums is given, the sums and the row count).
__device__ __forceinline__ void bwd_write(
    const double (&s)[4], const float* __restrict__ gamma,
    const float* __restrict__ sqrt_d, float* __restrict__ cols,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    double* __restrict__ sums, long long M, int D, int col) {
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

// The elected block's work for one column, every thread of the block
// calling it (reduce_parts synchronises): the column's chunks added, then
// bwd_write.
__device__ __forceinline__ void bwd_finish(
    const float* part, const float* __restrict__ gamma,
    const float* __restrict__ sqrt_d, float* __restrict__ cols,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    double* __restrict__ sums, long long M, int D, int col, int n_chunks) {
  double s[4];
  e2a::reduce_parts<4>(part, n_chunks, D, col, s);
  if (threadIdx.y != 0 || col >= D) return;
  bwd_write(s, gamma, sqrt_d, cols, dgamma, dbeta, sums, M, D, col);
}

template <class E>
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_bwd_partials(
    const E* __restrict__ g, const E* __restrict__ x,
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
        gb[u] = e2a::to_f(g[(r + u * BN_LANES) * D + col]);
        xb[u] = e2a::to_f(x[(r + u * BN_LANES) * D + col]);
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
      bwd_terms(e2a::to_f(g[r * D + col]), e2a::to_f(x[r * D + col]), ga, m,
                sd, acc);
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
  bwd_finish(part, gamma, sqrt_d, cols, dgamma, dbeta, sums, M, D, col,
             n_chunks);
}

// The elected block's work: its 256 threads as BN_COLS * PAIR columns (a
// warp's 32 threads on 32 neighbouring columns) x BN_LANES / PAIR chunk
// lanes. Lane l of a column adds chunks l, l + BN_LANES / PAIR, ... of all
// four sums at once, in double, then the lanes' sums are added in lane
// order and the column finished as bwd_finish does: one pass over the
// chunks for all the block's columns, with many loads in flight.
__device__ __forceinline__ void finish_pairs(
    const float* part, const float* __restrict__ gamma,
    const float* __restrict__ sqrt_d, float* __restrict__ cols,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    double* __restrict__ sums, long long M, int D, int n_chunks) {
  constexpr int LANES = BN_LANES / PAIR, COLS = BN_COLS * PAIR;
  __shared__ double sh[4][LANES][COLS];
  const int t = threadIdx.y * BN_COLS + threadIdx.x;
  const int c = t % COLS, l = t / COLS;
  const int col = blockIdx.x * COLS + c;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (col < D)
#pragma unroll 8
    for (int k = l; k < n_chunks; k += LANES)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] += (double)__ldcg(part + ((long long)q * n_chunks + k) * D +
                                 col);
#pragma unroll
  for (int q = 0; q < 4; ++q) sh[q][l][c] = acc[q];
  __syncthreads();
  if (l != 0 || col >= D) return;
  double s[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s[q] = 0.0;
    for (int k = 0; k < LANES; ++k) s[q] += sh[q][k][c];
  }
  bwd_write(s, gamma, sqrt_d, cols, dgamma, dbeta, sums, M, D, col);
}

// Backward pass 1 at bf16: the design above with two neighbouring columns
// a lane (one bf16x2 word of g and of x a row: a warp reads a whole
// 128-byte line of a row, where one column a lane read half of one), so a
// block covers BN_COLS * PAIR columns. Each column's terms are added as in
// bn_bwd_partials: the lane's rows in order, then the BN_LANES lanes in
// order, then the chunks in order in the elected block (finish_pairs).
// The wrapper's chunks are shorter at bf16 (256 rows at least,
// BWD16_MIN_CHUNK_ROWS) so that as many blocks are at work. Four columns a
// lane (8-byte loads, 90 registers, two blocks an SM) was no faster at the
// blocks' two shapes and 4-6 % slower at (50176, 256) and (200704, 128)
// (PERF.md, section 6).
__global__ void __launch_bounds__(BN_COLS* BN_LANES) bn_bwd_partials2(
    const e2a::bf16* __restrict__ g, const e2a::bf16* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, float* part,
    unsigned* __restrict__ arrived, float* __restrict__ cols,
    float* __restrict__ dgamma, float* __restrict__ dbeta,
    double* __restrict__ sums, long long M, int D, long long rows,
    int n_chunks) {
  __shared__ float sh[4][BN_LANES][BN_COLS * PAIR];
  __shared__ bool last;
  const int c0 = (blockIdx.x * BN_COLS + threadIdx.x) * PAIR;
  const int lane = threadIdx.y;
  const long long r0 = (long long)blockIdx.y * rows;
  const long long r1 = min(r0 + rows, M);
  float acc[PAIR][4] = {};
  if (c0 < D) {   // D % 2 == 0: both of the lane's columns are in
    float ga[PAIR], m[PAIR], sd[PAIR];
#pragma unroll
    for (int j = 0; j < PAIR; ++j) {
      ga[j] = gamma[c0 + j];
      m[j] = mu[c0 + j];
      sd[j] = sqrt_d[c0 + j];
    }
    const uint32_t* const gw = reinterpret_cast<const uint32_t*>(g + c0);
    const uint32_t* const xw = reinterpret_cast<const uint32_t*>(x + c0);
    const long long pitch = D / PAIR;   // words a row
    // a bf16 is the top half of its fp32
    const auto add = [&](uint32_t gr, uint32_t xr) {
      bwd_terms(__uint_as_float(gr << 16), __uint_as_float(xr << 16), ga[0],
                m[0], sd[0], acc[0]);
      bwd_terms(__uint_as_float(gr & 0xFFFF0000u),
                __uint_as_float(xr & 0xFFFF0000u), ga[1], m[1], sd[1],
                acc[1]);
    };
    // batches of BWD_UNROLL rows, the next batch's loads in flight while
    // this batch is added, as in bn_bwd_partials
    constexpr long long STEP = (long long)BWD_UNROLL * BN_LANES;
    const long long first = r0 + lane;
    const long long full = r1 - first >= STEP ? (r1 - first) / STEP : 0;
    uint32_t gv[BWD_UNROLL], xv[BWD_UNROLL];
    const auto load = [&](long long r, uint32_t (&gb)[BWD_UNROLL],
                          uint32_t (&xb)[BWD_UNROLL]) {
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        gb[u] = gw[(r + u * BN_LANES) * pitch];
        xb[u] = xw[(r + u * BN_LANES) * pitch];
      }
    };
    if (full > 0) load(first, gv, xv);
    for (long long b = 0; b < full; ++b) {
      uint32_t gn[BWD_UNROLL], xn[BWD_UNROLL];
      const bool more = b + 1 < full;
      if (more) load(first + (b + 1) * STEP, gn, xn);
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) add(gv[u], xv[u]);
      if (more)
#pragma unroll
        for (int u = 0; u < BWD_UNROLL; ++u) {
          gv[u] = gn[u];
          xv[u] = xn[u];
        }
    }
    for (long long r = first + full * STEP; r < r1; r += BN_LANES)
      add(gw[r * pitch], xw[r * pitch]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < PAIR; ++j)
      sh[k][lane][threadIdx.x * PAIR + j] = acc[j][k];
  __syncthreads();
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < PAIR; ++j) {   // column c of the block: coalesced
      const int c = j * BN_COLS + threadIdx.x;
      const int col = blockIdx.x * BN_COLS * PAIR + c;
      if (col >= D) break;
      float a = 0.0f;
#pragma unroll
      for (int l = 0; l < BN_LANES; ++l) a = __fadd_rn(a, sh[lane][l][c]);
      part[((long long)lane * n_chunks + blockIdx.y) * D + col] = a;
    }
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
  finish_pairs(part, gamma, sqrt_d, cols, dgamma, dbeta, sums, M, D,
               n_chunks);
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

// eq. 23 for one element, left to right, from its column's terms.
__device__ __forceinline__ float dx_elem(float gv, float xv, float ga,
                                         float m, float sd, float smn,
                                         float msq2, float c1, float c2) {
  const float mi = __fdiv_rn(__fmul_rn(ga, gv), sd);
  const float nv = __fsub_rn(xv, m);
  const float v = __fsub_rn(mi, __fdiv_rn(__fmul_rn(nv, smn), msq2));
  return __fsub_rn(__fadd_rn(v, c1), c2);
}

template <int V, class E>
__global__ void __launch_bounds__(DX_THREADS) bn_bwd_dx(
    const E* __restrict__ g, const E* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, const float* __restrict__ cols,
    E* __restrict__ dx, long long M, int D) {
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
    for (int j = 0; j < V; ++j)
      gv[j] = dx_elem(gv[j], xv[j], ga[j], m[j], sd[j], smn[j], msq2[j],
                      c1[j], c2[j]);
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

// Backward pass 2 at bf16 where D % 8 == 0 and g, x and dx are 16-byte
// aligned: eight columns a lane, so that each row of g, of x and of dx
// moves 16 bytes a lane (V = 4 moved 8 at bf16). A lane's column terms
// take 56 registers, which leaves room for two blocks an SM, so the blocks
// stay: one wave of them (dx_plan), each thread walking its rows with the
// next DX8_RING rows' loads in flight while it works on one (a ring of
// registers, each row kept as loaded, 16 bytes). A block that took one
// range of rows and left waited for its loads with nothing to do. The rows
// are walked from the last to the first: pass 1 read the last chunks last,
// so at D = 2,048, where g and x (103 MB) outgrow the 50 MB L2, the rows
// still in L2 come first (3 % of the pass there, PERF.md section 6). A
// deeper ring ran no faster and spilled registers.
constexpr int DX8_RING = 2;

__global__ void __launch_bounds__(DX_THREADS, 2) bn_bwd_dx8(
    const e2a::bf16* __restrict__ g, const e2a::bf16* __restrict__ x,
    const float* __restrict__ gamma, const float* __restrict__ mu,
    const float* __restrict__ sqrt_d, const float* __restrict__ cols,
    e2a::bf16* __restrict__ dx, long long M, int D) {
  constexpr int V = 8;
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const long long first = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  if (c0 >= D || first >= M) return;
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
  const uint4* const gp = reinterpret_cast<const uint4*>(g + c0);
  const uint4* const xp = reinterpret_cast<const uint4*>(x + c0);
  const long long pitch = D / V;     // 16-byte words a row
  const long long step = (long long)gridDim.y * blockDim.y;
  const long long n = (M - 1 - first) / step + 1;   // the thread's rows
  const auto row_of = [&](long long k) { return M - 1 - (first + k * step); };
  uint4 gr[DX8_RING], xr[DX8_RING];
#pragma unroll
  for (int i = 0; i < DX8_RING; ++i)
    if (i < n) {
      gr[i] = gp[row_of(i) * pitch];
      xr[i] = xp[row_of(i) * pitch];
    }
  for (long long k = 0; k < n; k += DX8_RING) {
#pragma unroll
    for (int i = 0; i < DX8_RING; ++i) {
      if (k + i >= n) break;
      float gv[V], xv[V];
      const uint32_t gw[4] = {gr[i].x, gr[i].y, gr[i].z, gr[i].w};
      const uint32_t xw[4] = {xr[i].x, xr[i].y, xr[i].z, xr[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[2 * j] = __uint_as_float(gw[j] << 16);
        gv[2 * j + 1] = __uint_as_float(gw[j] & 0xFFFF0000u);
        xv[2 * j] = __uint_as_float(xw[j] << 16);
        xv[2 * j + 1] = __uint_as_float(xw[j] & 0xFFFF0000u);
      }
      if (k + i + DX8_RING < n) {   // the ring's next row into this slot
        gr[i] = gp[row_of(k + i + DX8_RING) * pitch];
        xr[i] = xp[row_of(k + i + DX8_RING) * pitch];
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        gv[j] = dx_elem(gv[j], xv[j], ga[j], m[j], sd[j], smn[j], msq2[j],
                        c1[j], c2[j]);
      e2a::store_v<V>(dx + row_of(k + i) * D + c0, gv);
    }
  }
}

// The dx pass, float4 along D where D % 4 == 0 and g, x and dx are 16-byte
// aligned: column lanes bx, 32 or the least power of two whose V columns
// each cover D, and DX_THREADS / bx row lanes. At bf16 with D % 8 == 0
// and the same alignment, bn_bwd_dx8: V = 8, its wave sized by the
// card's SM count. Writes l; returns a cudaError_t.
int dx_plan(const void* g, const void* x, const void* dx, long long M, int D,
            int dtype, e2a::Launch& l) {
  const bool al = aligned16(g) && aligned16(x) && aligned16(dx);
  const bool v8 = dtype == e2a::kBfloat16 && D % 8 == 0 && al;
  const bool v4 = D % 4 == 0 && al;
  const int V = v8 ? 8 : v4 ? 4 : 1;
  int bx = 32;
  while (bx > 1 && (bx / 2) * V >= D) bx /= 2;
  const int by = DX_THREADS / bx;
  l = e2a::launch_of(bx, by, 0, v8 ? DX8 : v4 ? DX4 : DX1);
  e2a::axis(l, 0, e2a::cdiv(D, bx * V), bx * V, D);
  if (!v8) {
    row_axis(l, M, (long long)DX_LANE_ROWS * by);
    return 0;
  }
  // bn_bwd_dx8: one wave of two blocks an SM (at least one row a lane)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long ranges = e2a::cdiv(M, by);
  const long long wave = e2a::cdiv(2LL * sms, l.grid[0]);
  const long long blocks = ranges < wave ? ranges : wave;
  e2a::axis(l, 1, blocks, by, M, blocks * by < M);
  return 0;
}

// Returns a cudaError_t.
template <class E>
int launch_dx(const e2a::Launch& l, const E* g, const E* x,
              const float* gamma, const float* mu, const float* sqrt_d,
              const float* cols, E* dx, long long M, int D,
              cudaStream_t st) {
  if constexpr (std::is_same_v<E, e2a::bf16>) {
    if (l.kernel == DX8) {
      bn_bwd_dx8<<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
          g, x, gamma, mu, sqrt_d, cols, dx, M, D);
      return (int)cudaGetLastError();
    }
  }
  if (l.kernel == DX4)
    bn_bwd_dx<4, E><<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
        g, x, gamma, mu, sqrt_d, cols, dx, M, D);
  else
    bn_bwd_dx<1, E><<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
        g, x, gamma, mu, sqrt_d, cols, dx, M, D);
  return (int)cudaGetLastError();
}

// The backward's first pass as partials_plan planned it. Returns a
// cudaError_t.
template <class E>
int launch_partials(const e2a::Launch& l, const E* g, const E* x,
                    const float* gamma, const float* mu, const float* sqrt_d,
                    float* part, unsigned* arrived, float* cols,
                    float* dgamma, float* dbeta, double* sums, long long M,
                    int D, long long rows, cudaStream_t st) {
  const int chunks = (int)l.grid[1];
  if constexpr (std::is_same_v<E, e2a::bf16>) {
    if (l.kernel == PARTIALS2) {
      bn_bwd_partials2<<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
          g, x, gamma, mu, sqrt_d, part, arrived, cols, dgamma, dbeta, sums,
          M, D, rows, chunks);
      return (int)cudaGetLastError();
    }
  }
  bn_bwd_partials<E><<<e2a::grid_of(l), e2a::block_of(l), 0, st>>>(
      g, x, gamma, mu, sqrt_d, part, arrived, cols, dgamma, dbeta, sums, M,
      D, rows, chunks);
  return (int)cudaGetLastError();
}

// The launches of each entry point, in order; n = 0 where it launches
// nothing. Each returns a cudaError_t.
// Any dtype code but fp32's and bf16's is refused.
bool bad_dtype(int dtype) { return e2a::elem_bytes(dtype) == 0; }
constexpr int BAD = (int)cudaErrorInvalidValue;

int fwd_plan(const void* x, const void* y, long long M, int D,
             long long rows, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  l[n++] = chunks_plan(M, D, rows, STATS);
  l[n++] = normalize_plan(x, y, M, D);
  return 0;
}

int fwd_sums_plan(long long M, int D, long long rows, int dtype,
                  e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  l[n++] = chunks_plan(M, D, rows, STATS);
  return 0;
}

int fwd_apply_plan(const void* x, const void* y, long long M, int D,
                   int dtype, e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (D <= 0) return 0;
  l[n++] = columns_plan(D, FINALIZE);
  if (M > 0) l[n++] = normalize_plan(x, y, M, D);
  return 0;
}

int bwd_plan(const void* g, const void* x, const void* dx, long long M,
             int D, long long rows, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  l[0] = partials_plan(g, x, M, D, rows, dtype);
  const int err = dx_plan(g, x, dx, M, D, dtype, l[1]);
  if (err == 0) n = 2;
  return err;
}

int bwd_sums_plan(const void* g, const void* x, long long M, int D,
                  long long rows, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (M <= 0 || D <= 0 || rows <= 0) return 0;
  l[n++] = partials_plan(g, x, M, D, rows, dtype);
  return 0;
}

int bwd_apply_plan(const void* g, const void* x, const void* dx,
                   long long M, int D, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  if (bad_dtype(dtype)) return BAD;
  if (D <= 0) return 0;
  l[0] = columns_plan(D, COLS);
  const int err = M > 0 ? dx_plan(g, x, dx, M, D, dtype, l[1]) : 0;
  if (err == 0) n = M > 0 ? 2 : 1;
  return err;
}

}  // namespace

// dtype (every entry point): 0 fp32, 1 bf16, the type of x and y (forward)
// or of g, x and dx (backward); every other operand is fp32.

// x (M, D) -> y (M, D), mu (D), sqrt_d (D). part: 2 * ceil(M / rows) * D
// floats of scratch, one partial per chunk of ``rows`` rows; arrived:
// ceil(D / 32) counters, 0 on entry and left at 0.
extern "C" int e2a_bn_fwd(const void* x, const float* gamma,
                          const float* beta, void* y, float* mu,
                          float* sqrt_d, float* part, unsigned* arrived,
                          long long M, int D, long long rows, float eps,
                          int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, y, M, D, rows, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    bn_fwd_stats<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        static_cast<const E*>(x), part, arrived, mu, sqrt_d, nullptr, M, D,
        rows, (int)l[0].grid[1], eps);
    return launch_normalize(l[1], static_cast<const E*>(x), gamma, beta, mu,
                            sqrt_d, static_cast<E*>(y), M, D, st);
  });
}

extern "C" int e2a_bn_fwd_plan(const void* x, const float* gamma,
                               const float* beta, void* y, float* mu,
                               float* sqrt_d, float* part, unsigned* arrived,
                               long long M, int D, long long rows, float eps,
                               int dtype, long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, y, M, D, rows, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

// Split path, forward, before the all-reduce: sums (2 * D + 1 doubles)
// receives the rank's sum(x) and sum(x^2) per column and its row count M.
extern "C" int e2a_bn_fwd_sums(const void* x, float* part, unsigned* arrived,
                               double* sums, long long M, int D,
                               long long rows, int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_sums_plan(M, D, rows, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    bn_fwd_stats<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        static_cast<const E*>(x), part, arrived, nullptr, nullptr, sums, M,
        D, rows, (int)l[0].grid[1], 0.0f);
    return (int)cudaGetLastError();
  });
}

extern "C" int e2a_bn_fwd_sums_plan(const void* x, float* part,
                                    unsigned* arrived, double* sums,
                                    long long M, int D, long long rows,
                                    int dtype, long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_sums_plan(M, D, rows, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

// Split path, forward, after the all-reduce: mu and sqrt_d from the global
// sums, then y.
extern "C" int e2a_bn_fwd_apply(const void* x, const float* gamma,
                                const float* beta, const double* sums,
                                void* y, float* mu, float* sqrt_d,
                                long long M, int D, float eps, int dtype,
                                void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_apply_plan(x, y, M, D, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_fwd_finalize<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
      sums, D, eps, mu, sqrt_d);
  if (n == 1) return (int)cudaGetLastError();
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return launch_normalize(l[1], static_cast<const E*>(x), gamma, beta, mu,
                            sqrt_d, static_cast<E*>(y), M, D, st);
  });
}

extern "C" int e2a_bn_fwd_apply_plan(const void* x, const float* gamma,
                                     const float* beta, const double* sums,
                                     void* y, float* mu, float* sqrt_d,
                                     long long M, int D, float eps,
                                     int dtype, long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_apply_plan(x, y, M, D, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

// g, x (M, D), gamma, mu, sqrt_d (D) -> dx (M, D), dgamma, dbeta (D).
// part: 4 * ceil(M / rows) * D floats of scratch, cols: 4 * D; arrived:
// ceil(D / 32) counters, 0 on entry and left at 0.
extern "C" int e2a_bn_bwd(const void* g, const void* x, const float* gamma,
                          const float* mu, const float* sqrt_d, void* dx,
                          float* dgamma, float* dbeta, float* part,
                          float* cols, unsigned* arrived, long long M, int D,
                          long long rows, int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, x, dx, M, D, rows, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const int err = launch_partials(l[0], static_cast<const E*>(g),
                                    static_cast<const E*>(x), gamma, mu,
                                    sqrt_d, part, arrived, cols, dgamma, dbeta,
                                    nullptr, M, D, rows, st);
    if (err != 0) return err;
    return launch_dx(l[1], static_cast<const E*>(g), static_cast<const E*>(x),
                     gamma, mu, sqrt_d, cols, static_cast<E*>(dx), M, D, st);
  });
}

extern "C" int e2a_bn_bwd_plan(const void* g, const void* x,
                               const float* gamma, const float* mu,
                               const float* sqrt_d, void* dx, float* dgamma,
                               float* dbeta, float* part, float* cols,
                               unsigned* arrived, long long M, int D,
                               long long rows, int dtype, long long* records,
                               int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, x, dx, M, D, rows, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

// Split path, backward, before the all-reduce: dgamma and dbeta from the
// rank's rows, and sums (3 * D + 1 doubles) receives its s_n, s_m, s_mn per
// column and its row count M.
extern "C" int e2a_bn_bwd_sums(const void* g, const void* x,
                               const float* gamma, const float* mu,
                               const float* sqrt_d, float* dgamma,
                               float* dbeta, float* part, double* sums,
                               unsigned* arrived, long long M, int D,
                               long long rows, int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_sums_plan(g, x, M, D, rows, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return launch_partials(l[0], static_cast<const E*>(g),
                           static_cast<const E*>(x), gamma, mu, sqrt_d, part,
                           arrived, nullptr, dgamma, dbeta, sums, M, D, rows,
                           st);
  });
}

extern "C" int e2a_bn_bwd_sums_plan(const void* g, const void* x,
                                    const float* gamma, const float* mu,
                                    const float* sqrt_d, float* dgamma,
                                    float* dbeta, float* part, double* sums,
                                    unsigned* arrived, long long M, int D,
                                    long long rows, int dtype,
                                    long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_sums_plan(g, x, M, D, rows, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

// Split path, backward, after the all-reduce: eq. 23's terms from the
// global sums into cols (4 * D floats), then dx.
extern "C" int e2a_bn_bwd_apply(const void* g, const void* x,
                                const float* gamma, const float* mu,
                                const float* sqrt_d, const double* sums,
                                float* cols, void* dx, long long M, int D,
                                int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_apply_plan(g, x, dx, M, D, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bn_bwd_cols<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
      sums, sqrt_d, D, cols);
  if (n == 1) return (int)cudaGetLastError();
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return launch_dx(l[1], static_cast<const E*>(g), static_cast<const E*>(x),
                     gamma, mu, sqrt_d, cols, static_cast<E*>(dx), M, D, st);
  });
}

extern "C" int e2a_bn_bwd_apply_plan(const void* g, const void* x,
                                     const float* gamma, const float* mu,
                                     const float* sqrt_d, const double* sums,
                                     float* cols, void* dx, long long M,
                                     int D, int dtype, long long* records,
                                     int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_apply_plan(g, x, dx, M, D, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
