// The neuron layer: matmul, batch norm and LIF SOMA behind one entry point,
// eval mode and train mode.
//
// x is (T, M, C) fp32, or its bit-packed form (T, M, C/8) uint8 (least
// significant bit first along C) when the input is a spike train; w is
// (C, K) fp32. Offsets are 64-bit: the first tokenizer stage writes more
// than 2^25 elements per time step.
//
// Eval mode (replaces _nl_eval_kernel, src/repro/kernels/neuron_layer.py,
// neuron_layer_eval): batch norm is folded into (w, bias) by the caller, so
//
//   y[t][m][k] = sum_c x[t][m][c] * w[c][k] + bias[k]
//   u = alpha * u * (1 - s) + y[t];  s = u >= th_fire
//
// and only the spikes (T, M, K) are written: the pre-activation never
// reaches device memory.
//   - Packed arm (every site but the first tokenizer stage):
//     neuron_layer_eval_mma. A block owns a BM x BN tile of the M rows of
//     one time step and loops t = 0..T-1: the tensor-core mainloop of
//     spike_mma_mainloop.cuh (the one e2a_spike_matmul and the train arm's
//     z pass run) over time step t's packed rows, then an epilogue that adds
//     the bias to each of the thread's fragment outputs and advances its
//     membrane. (U, S) stay with the thread across the T mainloops: S as one
//     bit per output in a register, U in shared memory at the thread's own
//     slots (no other thread reads them, so no barrier guards them), beside
//     the mainloop's space. Each output's MMAs run in the same order
//     whatever the tile, so y equals the spike matmul's product on the same
//     operands plus the bias, bit for bit, and the spikes equal those of
//     spike matmul + bias + the plain SOMA. T is sequential inside a block,
//     so the grid covers M only and a block does T times the z pass's work;
//     the entry point picks the tile (eval_tile). Bound: three dense bf16
//     passes on the tensor cores (3 * 2 * T*M*C*K operations) or the
//     spikes' bytes.
//   - Dense arm (the first tokenizer stage: C = 27, a dense fp32 image):
//     neuron_layer_eval_dense, fp32 FMAs on x and w staged in shared memory
//     (the dense arms' section below), T time steps in turn with (U, S)
//     in registers; bound by the bytes of its input and output.
//
// Train mode (replaces _nl_train_kernel, neuron_layer_train): batch
// statistics over all T * M rows of a column cannot finish in a tile's
// epilogue, since they need every row tile first. The TPU kernel had one
// program own all rows of a feature block; here that would be one block per
// 64 columns. The train arm is therefore three launches behind one entry
// point:
//   (a) z = x @ w, written once as (T * M, K) fp32, and per row tile the
//       column sums of z and z^2 (a fixed order: no atomics, the same
//       statistics on every run). In train mode T is only a row index, so
//       the packed arm's pass is the spike matmul over T * M rows: the
//       tensor-core mainloop, Large tile (256 x 64 outputs, 16 warps,
//       BK = 128), with an epilogue that also forms the tile's column
//       partials. The dense arm's pass, neuron_layer_train_z_dense, runs
//       the eval arm's fp32 product over T * M rows, 1024-row tiles (a
//       quarter as many partials as 256-row tiles would give (b) to add),
//       with coalesced float4 stores of z. The autograd op's
//       backward replays z through this pass alone (e2a_neuron_layer_train_z),
//       so its z is the forward's bit for bit;
//   (b) per column, the tiles' partials are added in order and mu, var,
//       sqrt(var + eps) formed (bn_stats.cuh);
//   (c) one pass reads z once, normalises (eq. 17-18) and runs SOMA over T
//       with (U, S) in registers, writing the spikes; a 2-D grid (row range
//       x column block), float4 along K where K % 4 == 0.
// Split path (data parallelism, the statistics of the global batch): (b)
// writes the rank's column sums, in double, and its row count T * M to a
// buffer instead of the statistics (e2a_neuron_layer_train_sums: (a) and
// (b)); the wrapper all-reduces the buffer over the ranks; then
// e2a_neuron_layer_train_apply forms mu, var and sqrt_d from the global sums
// (bn_stats.cuh) and runs (c). The arithmetic is the fused path's, so at a
// world of 1 the statistics and spikes are its bits.
// Bound: the packed arm by three dense bf16 passes on the tensor cores plus
// the z round trip (2 * T * M * K * 4 bytes); recomputing the product in (c)
// instead of storing z would double the dominant work.
#include "bn_stats.cuh"
#include "spike_mma_mainloop.cuh"

namespace {

using namespace e2a;

// eq. 11's membrane update, every operation rounded once in the plain
// version's order (lif_soma.cu's lif_step), so equal inputs give equal
// spikes bit for bit.
__device__ __forceinline__ float membrane(float u, float s, float y,
                                          float alpha) {
  return __fadd_rn(__fmul_rn(__fmul_rn(alpha, u), __fsub_rn(1.0f, s)), y);
}

// ---- the dense arms (the first tokenizer stage) ----
// x is a dense fp32 matrix of rows x C (eval: time step t's rows are rows
// t * M .. t * M + M - 1 of the (T * M, C) view; train: all T * M rows), C
// small (27 at the first stage: 2 * T*M*C*K operations take 0.041 ms at
// 67 TFLOP/s, under the 0.087 ms its bytes take). fp32 FMAs outside the
// tensor cores. A block of DENSE_THREADS threads computes DENSE_ROWS x
// DENSE_COLS outputs at a time: a thread holds 4 rows x 4 neighbouring
// columns, the two halves of a warp two neighbouring rows, so that each
// store of a warp is two runs of 64 contiguous floats (one 512-byte run
// where K = 64). The weight (C x DENSE_COLS) is staged in shared memory
// once per block while C <= DENSE_CHUNK; the block's x rows, one contiguous
// span of rows * C floats, are staged with float4 loads into rows padded to
// a multiple of 4 floats, from which a thread reads 4 c at a time. Each
// output is fmaf over c ascending from 0 (the pad adds 0 * 0), so the
// eval arm's product and the train arm's first pass give the same bits,
// and the order is fixed: no atomics.
constexpr int DENSE_THREADS = 256;
constexpr int DENSE_ROWS = 64;       // 8 warps x 2 halves x 4 rows
constexpr int DENSE_COLS = 64;       // 16 lanes x 4 columns
constexpr int DENSE_CHUNK = 32;      // contraction staged at once
// Rows of one tile of the train arm's first pass: DENSE_ROWS at a time,
// one partial sum per tile and column (kernels/neuron_layer.py
// DENSE_TILE_ROWS).
constexpr int DENSE_TILE_ROWS = 1024;

struct DenseSmem {
  float w[DENSE_CHUNK * DENSE_COLS];               // w[c][k], k fastest
  float x[DENSE_ROWS * (DENSE_CHUNK + 4)];          // x[row][c], padded rows
  // eval: U of the thread's 16 outputs, slot i of thread j at i *
  // DENSE_THREADS + j (only that thread reads it: no barrier guards it)
  float u[16 * DENSE_THREADS];
};

// Row stride of the staged x for a chunk padded to cp floats: cp, or cp + 4
// where cp is a multiple of 8, so that the two rows a warp reads at once
// never share a bank.
__device__ __forceinline__ int dense_ld(int cp) {
  return cp % 8 == 0 ? cp + 4 : cp;
}

// w[c0 .. c0 + cw) x [n0 .. n0 + DENSE_COLS) into sm.w, zero past cw (up to
// cp) and past K.
__device__ __forceinline__ void dense_stage_w(DenseSmem& sm,
                                              const float* __restrict__ w,
                                              int c0, int cw, int cp, int K,
                                              int n0) {
  for (int i = threadIdx.x; i < cp * DENSE_COLS; i += DENSE_THREADS) {
    const int c = i / DENSE_COLS, k = i % DENSE_COLS;
    sm.w[i] = c < cw && n0 + k < K ? w[(long long)(c0 + c) * K + n0 + k]
                                   : 0.0f;
  }
}

// acc[j][e] += x[rl + 2 j][c] * w[c][4 q + e] over the cp staged c in
// ascending order, fmaf: the thread's 4 rows x 4 columns, 4 c at a time
// (one float4 of each row and of each of 4 weight rows).
__device__ __forceinline__ void dense_fma(const DenseSmem& sm, int ld, int cp,
                                          int rl, int q, float (&acc)[4][4]) {
  const float* xr = sm.x + rl * ld;
  const float* wr = sm.w + 4 * q;
  for (int c = 0; c < cp; c += 4) {
    float4 wv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wv[k] = *reinterpret_cast<const float4*>(wr + (c + k) * DENSE_COLS);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + 2 * j * ld + c);
      const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[j][0] = fmaf(xe[k], wv[k].x, acc[j][0]);
        acc[j][1] = fmaf(xe[k], wv[k].y, acc[j][1]);
        acc[j][2] = fmaf(xe[k], wv[k].z, acc[j][2]);
        acc[j][3] = fmaf(xe[k], wv[k].w, acc[j][3]);
      }
    }
  }
}

// One sub-tile's x rows [r0, r0 + n) (n <= DENSE_ROWS, C <= DENSE_CHUNK):
// one contiguous span of n * C floats, read as the floats before its first
// 16-byte boundary (head), float4s (body), and the rest (tail). A thread
// loads its share into registers (load) while the block computes the last
// sub-tile, and writes it to the staged rows (put) after the next barrier,
// so that the loads' latency hides behind the FMAs.
struct DenseSpan {
  static constexpr int PER_THREAD =
      DENSE_ROWS * DENSE_CHUNK / 4 / DENSE_THREADS;   // float4s at most
  float4 v[PER_THREAD];
  float h, t;                                          // head, tail floats
  int head, body, total;

  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       long long r0, int n, int C) {
    const float* src = x + r0 * C;
    h = t = 0.0f;
    total = n * C;
    head = min(total,
               (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
    body = (total - head) / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int f = threadIdx.x + k * DENSE_THREADS;
      if (f < body) v[k] = src4[f];
    }
    const int tail = total - head - 4 * body;
    if ((int)threadIdx.x < head) h = src[threadIdx.x];
    if ((int)threadIdx.x < tail) t = src[head + 4 * body + threadIdx.x];
  }

  __device__ __forceinline__ void put(DenseSmem& sm, int C, int ld) const {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int f = threadIdx.x + k * DENSE_THREADS;
      if (f >= body) break;
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      const int i = head + 4 * f;
      int row = i / C, c = i - row * C;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sm.x[row * ld + c] = e[u];
        if (++c == C) {
          c = 0;
          ++row;
        }
      }
    }
    const int i = threadIdx.x, tail = total - head - 4 * body;
    if (i < head) sm.x[(i / C) * ld + i % C] = h;
    if (i < tail) {
      const int j = head + 4 * body + i;
      sm.x[(j / C) * ld + j % C] = t;
    }
  }
};

// The block's S sub-tiles in turn: rows(s) gives sub-tile s's first x row
// and its number of rows (<= DENSE_ROWS), and epi(s, acc) receives the
// thread's 4 x 4 products of it, each fmaf over c ascending from 0.
// Every thread of the block calls it.
template <class Rows, class Epilogue>
__device__ __forceinline__ void dense_tiles(DenseSmem& sm,
                                            const float* __restrict__ x,
                                            const float* __restrict__ w, int S,
                                            Rows rows, int C, int K, int n0,
                                            int rl, int q, Epilogue epi) {
  if (C <= DENSE_CHUNK) {   // the whole weight and whole rows at once
    const int cp = (C + 3) & ~3, ld = dense_ld(cp);
    dense_stage_w(sm, w, 0, C, cp, K, n0);
    for (int i = threadIdx.x; i < DENSE_ROWS * (cp - C); i += DENSE_THREADS)
      sm.x[(i / (cp - C)) * ld + C + i % (cp - C)] = 0.0f;   // the pad
    DenseSpan span;
    long long r0;
    int n;
    rows(0, r0, n);
    span.load(x, r0, n, C);
    for (int s = 0; s < S; ++s) {
      __syncthreads();           // every thread is done with sub-tile s - 1
      span.put(sm, C, ld);
      __syncthreads();
      if (s + 1 < S) {
        rows(s + 1, r0, n);
        span.load(x, r0, n, C);
      }
      float acc[4][4] = {};
      dense_fma(sm, ld, cp, rl, q, acc);
      epi(s, acc);
    }
    return;
  }
  // C > DENSE_CHUNK: chunks of the contraction staged element by element
  for (int s = 0; s < S; ++s) {
    long long r0;
    int n;
    rows(s, r0, n);
    float acc[4][4] = {};
    for (int c0 = 0; c0 < C; c0 += DENSE_CHUNK) {
      const int cw = min(DENSE_CHUNK, C - c0), cp = (cw + 3) & ~3;
      const int ld = dense_ld(cp);
      __syncthreads();
      dense_stage_w(sm, w, c0, cw, cp, K, n0);
      for (int i = threadIdx.x; i < DENSE_ROWS * cp; i += DENSE_THREADS) {
        const int row = i / cp, c = i % cp;
        sm.x[row * ld + c] =
            row < n && c < cw ? x[(r0 + row) * C + c0 + c] : 0.0f;
      }
      __syncthreads();
      dense_fma(sm, ld, cp, rl, q, acc);
    }
    epi(s, acc);
  }
}

// The 4 values of a thread's row at column col of out (rows of K floats):
// one float4 where vec4 (K % 4 == 0, out 16-byte aligned), else those
// below K.
__device__ __forceinline__ void dense_store(float* out, int col, int K,
                                            bool vec4, const float (&v)[4]) {
  if (vec4) {
    if (col < K)
      *reinterpret_cast<float4*>(out + col) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < K) out[col + e] = v[e];
  }
}

// Eval: the block owns DENSE_ROWS rows of M and DENSE_COLS columns and loops
// t = 0..T-1 over time step t's rows; (U, S) of its 16 outputs stay with
// the thread (S as one bit each in a register, U in shared memory, which
// leaves the registers to the product), and only the spikes are written.
__global__ void __launch_bounds__(DENSE_THREADS, 3) neuron_layer_eval_dense(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ s, int T,
    long long M, int C, int K, bool vec4, float alpha, float th_fire) {
  __shared__ __align__(16) DenseSmem sm;
  const int lane = threadIdx.x % 32, q = lane % 16;
  const int rl = (threadIdx.x / 32) * 8 + lane / 16;   // the thread's row 0
  const long long m0 = (long long)blockIdx.x * DENSE_ROWS;
  const int n0 = blockIdx.y * DENSE_COLS, col = n0 + 4 * q;
  const int n = (int)min((long long)DENSE_ROWS, M - m0);
  float b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) b[e] = col + e < K ? bias[col + e] : 0.0f;
  float* const u = sm.u + threadIdx.x;   // U in shared memory, S as bits
  uint32_t fired = 0;             // bit 4 j + e: that output's last spike
  const auto rows = [&](int t, long long& r0, int& nr) {
    r0 = (long long)t * M + m0;   // time step t's rows
    nr = n;
  };
  const auto soma = [&](int t, const float (&acc)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float ui =
            membrane(t > 0 ? u[i * DENSE_THREADS] : 0.0f,
                     (fired >> i) & 1u ? 1.0f : 0.0f,
                     __fadd_rn(acc[j][e], b[e]), alpha);
        u[i * DENSE_THREADS] = ui;
        const bool f = ui >= th_fire;
        fired = f ? fired | (1u << i) : fired & ~(1u << i);
        v[e] = f ? 1.0f : 0.0f;
      }
      const long long row = m0 + rl + 2 * j;
      if (row < M)
        dense_store(s + ((long long)t * M + row) * K, col, K, vec4, v);
    }
  };
  dense_tiles(sm, x, w, T, rows, C, K, n0, rl, q, soma);
}

// Train, pass (a): z for the rows of one DENSE_TILE_ROWS tile of the
// (rows, C) view (T is only a row index here), and the tile's column
// partials of sum(z) and sum(z^2) in a fixed order: each thread over its
// rows in order, then the 16 row lanes in shared memory in order (not
// written where part is null).
__global__ void __launch_bounds__(DENSE_THREADS) neuron_layer_train_z_dense(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ z, float* __restrict__ part, long long rows, int C,
    int K, bool vec4, int n_tiles) {
  __shared__ __align__(16) DenseSmem sm;
  const int lane = threadIdx.x % 32, q = lane % 16;
  const int rl = (threadIdx.x / 32) * 8 + lane / 16;
  const int n0 = blockIdx.y * DENSE_COLS, col = n0 + 4 * q;
  const long long tile0 = (long long)blockIdx.x * DENSE_TILE_ROWS;
  const int S = (int)min((long long)DENSE_TILE_ROWS / DENSE_ROWS,
                         (rows - tile0 + DENSE_ROWS - 1) / DENSE_ROWS);
  const auto sub_rows = [&](int sub, long long& r0, int& n) {
    r0 = tile0 + sub * DENSE_ROWS;
    n = (int)min((long long)DENSE_ROWS, rows - r0);
  };
  float cs[4] = {}, cq[4] = {};
  const auto store = [&](int sub, const float (&acc)[4][4]) {
    long long r0;
    int n;
    sub_rows(sub, r0, n);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (rl + 2 * j >= n) continue;
      dense_store(z + (r0 + rl + 2 * j) * K, col, K, vec4, acc[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cs[e] = __fadd_rn(cs[e], acc[j][e]);
        cq[e] = __fadd_rn(cq[e], __fmul_rn(acc[j][e], acc[j][e]));
      }
    }
  };
  dense_tiles(sm, x, w, S, sub_rows, C, K, n0, rl, q, store);
  // the U space (unused in train) holds [2][16 row lanes][DENSE_COLS] sums
  static_assert(2 * 16 * DENSE_COLS <= 16 * DENSE_THREADS, "reduction space");
  float* const red = sm.u;
  const int lr = (threadIdx.x / 32) * 2 + lane / 16;   // row lane 0..15
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    red[lr * DENSE_COLS + 4 * q + e] = cs[e];
    red[(16 + lr) * DENSE_COLS + 4 * q + e] = cq[e];
  }
  __syncthreads();
  if (part != nullptr && threadIdx.x < 2 * DENSE_COLS) {
    const int qn = threadIdx.x / DENSE_COLS, c = threadIdx.x % DENSE_COLS;
    if (n0 + c < K) {
      float v = 0.0f;
      for (int r = 0; r < 16; ++r)
        v = __fadd_rn(v, red[(qn * 16 + r) * DENSE_COLS + c]);
      part[((long long)qn * n_tiles + blockIdx.x) * K + n0 + c] = v;
    }
  }
}

int launch_eval_dense(const float* x, const float* w, const float* bias,
                      float* s, int T, long long M, int C, int K, float alpha,
                      float th_fire, cudaStream_t st) {
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const dim3 grid((unsigned)((M + DENSE_ROWS - 1) / DENSE_ROWS),
                  (K + DENSE_COLS - 1) / DENSE_COLS, 1);
  neuron_layer_eval_dense<<<grid, DENSE_THREADS, 0, st>>>(
      x, w, bias, s, T, M, C, K, vec4, alpha, th_fire);
  return (int)cudaGetLastError();
}

int launch_train_z_dense(const float* x, const float* w, float* z,
                         float* part, long long rows, int C, int K,
                         int n_tiles, cudaStream_t st) {
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const dim3 grid((unsigned)n_tiles, (K + DENSE_COLS - 1) / DENSE_COLS, 1);
  neuron_layer_train_z_dense<<<grid, DENSE_THREADS, 0, st>>>(
      x, w, z, part, rows, C, K, vec4, n_tiles);
  return (int)cudaGetLastError();
}

// ---- eval, packed arm ----
// Outputs a thread owns in the tile (Lane<Tile>: WM x WN fragments of 4),
// and the dynamic shared memory of a block: the mainloop's, then U, slot i
// of thread j at float (i * THREADS + j), so a warp's accesses are
// contiguous.
template <class Tile>
struct EvalTile {
  static constexpr int OUTS = Tile::WM * Tile::WN * 4;
  static constexpr int SMEM = Tile::SMEM + OUTS * Tile::THREADS * 4;
  static_assert(OUTS <= 32, "one spike bit per output in a 32-bit mask");
};

template <class Tile>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
    neuron_layer_eval_mma(const e2a::mma::Operands a, int T,
                          const float* __restrict__ bias,
                          float* __restrict__ s, float alpha, float th_fire) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const u_mem =
      reinterpret_cast<float*>(smem + Tile::SMEM) + threadIdx.x;
  const long long m0 = (long long)blockIdx.x * Tile::BM;
  const int n0 = blockIdx.y * Tile::BN;
  const e2a::mma::Lane<Tile> L;
  const int K = a.K;
  const bool vec2 = K % 2 == 0;   // s is 256-byte aligned, rows K floats
  uint32_t fired = 0;             // bit i: output i's spike at step t - 1
  e2a::mma::Operands at = a;
  for (int t = 0; t < T; ++t) {
    at.x = a.x + (long long)t * a.M * a.x_m;   // time step t's packed rows
    if (t > 0) __syncthreads();   // every warp is past step t - 1's mainloop
    e2a::mma::Acc<Tile> acc;
    e2a::mma::mainloop<Tile>(at, m0, n0, smem, acc);
    float* const out = s + (long long)t * a.M * K;
#pragma unroll
    for (int mt = 0; mt < Tile::WM; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + L.wm0 + mt * 16 + L.g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < Tile::WN; ++nt) {
          const int col = n0 + L.wn0 + nt * 8 + 2 * L.t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = (mt * Tile::WN + nt) * 4 + 2 * h + e;
            // the bias is read here, not kept across the mainloop, which
            // needs every register it can get
            const float y = __fadd_rn(
                e2a::mma::result(acc[0][mt][nt][2 * h + e],
                                 acc[1][mt][nt][2 * h + e]),
                col + e < K ? __ldg(bias + col + e) : 0.0f);
            const float u =
                membrane(t > 0 ? u_mem[i * Tile::THREADS] : 0.0f,
                         (fired >> i) & 1u ? 1.0f : 0.0f, y, alpha);
            u_mem[i * Tile::THREADS] = u;
            const bool f = u >= th_fire;
            fired = f ? fired | (1u << i) : fired & ~(1u << i);
            v[e] = f ? 1.0f : 0.0f;
          }
          if (row >= a.M) continue;
          float* const o = out + row * K + col;
          if (vec2 && col + 1 < K) {
            *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          } else {
            if (col < K) o[0] = v[0];
            if (col + 1 < K) o[1] = v[1];
          }
        }
      }
  }
}

template <class Tile>
int launch_eval_mma(const e2a::mma::Operands& a, int T, const float* bias,
                    float* s, float alpha, float th_fire, cudaStream_t st) {
  static bool raised[e2a::mma::kMaxDevices] = {};
  const int err = e2a::mma::allow_smem(
      reinterpret_cast<const void*>(neuron_layer_eval_mma<Tile>),
      EvalTile<Tile>::SMEM, raised);
  if (err != 0) return err;
  const dim3 grid((unsigned)((a.M + Tile::BM - 1) / Tile::BM),
                  (a.K + Tile::BN - 1) / Tile::BN, 1);
  neuron_layer_eval_mma<Tile><<<grid, Tile::THREADS, EvalTile<Tile>::SMEM,
                                st>>>(a, T, bias, s, alpha, th_fire);
  return (int)cudaGetLastError();
}

// The packed eval arm's tile. A block runs T mainloops, so its blocks are
// few and long and the last wave's share of idle SMs decides the time.
// Large (256 x 64 outputs, one block an SM) where its grid fits in one wave
// (the block sites, M = 3,136 rows: 104 blocks); Small (128 x 64, two blocks
// an SM) beyond, whose half-size blocks even out the last wave. Measured at
// the preset's five packed sites, this picks the faster tile at each
// (benchmarks/torch/bench_eval_kernels.py; PERF.md, section 6).
int eval_tile(long long M, int K) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  using e2a::mma::Large;
  const long long blocks =
      ((M + Large::BM - 1) / Large::BM) * ((K + Large::BN - 1) / Large::BN);
  return blocks <= sms ? 1 : 2;
}

// ---- train, pass (a), packed arm ----
// Packed arm: z (T * M, K) = x (T * M, C / 8) @ w on the tensor cores, and
// per 256-row tile the column partials of sum(z) and sum(z^2) of the
// rounded z, in a fixed order: each thread over its own four rows, then the
// eight g lanes of a warp by __shfl_xor in a fixed order, then the WARPS_M
// warps in shared memory in warp order (not written where part is null).
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
  if (part != nullptr && threadIdx.x < 2 * T::BN) {
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

// Pass (a) of either arm: z (T, M, K), and the column partials into part
// unless it is null; n_tiles receives the partials' tile count:
// ceil(T * M / 256) for the packed arm (ZTile::BM; kernels/neuron_layer.py
// TILE_ROWS), ceil(T * M / DENSE_TILE_ROWS) for the dense arm
// (DENSE_TILE_ROWS there too). Returns a cudaError_t.
int launch_z(const void* x, const float* w, float* z, float* part, int T,
             long long M, int C, int K, int packed, int& n_tiles,
             cudaStream_t st) {
  if (packed && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (T < 1 || T > 8) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)T * M;
  if (packed) {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // T is a row index here: x (T * M, C / 8) and z (T * M, K), contiguous
    const e2a::mma::Operands a = {static_cast<const uint8_t*>(x), C / 8, 1,
                                  w, K, 1, (int)rows, C, K};
    n_tiles = (int)((rows + ZTile::BM - 1) / ZTile::BM);
    return launch_train_z_packed(a, z, part, n_tiles, st);
  }
  n_tiles = (int)((rows + DENSE_TILE_ROWS - 1) / DENSE_TILE_ROWS);
  return launch_train_z_dense(static_cast<const float*>(x), w, z, part, rows,
                              C, K, n_tiles, st);
}

// (b): the statistics of each column; where sums is given (the split
// path), the column sums and the row count go there instead.
__global__ void __launch_bounds__(STAT_COLS* STAT_LANES)
neuron_layer_train_stats(const float* __restrict__ part,
                         float* __restrict__ mu, float* __restrict__ var,
                         float* __restrict__ sqrt_d,
                         double* __restrict__ sums, int n_tiles, int K,
                         double count, float eps) {
  const int col = blockIdx.x * STAT_COLS + threadIdx.x;
  double sz[2];
  reduce_parts<2>(part, n_tiles, K, col, sz);
  if (threadIdx.y != 0 || col >= K) return;
  if (sums != nullptr) {
    sums[col] = sz[0];
    sums[K + col] = sz[1];
    if (col == 0) sums[2 * K] = count;
    return;
  }
  float m, v, sd;
  column_stats(sz[0], sz[1], count, eps, m, v, sd);
  mu[col] = m;
  var[col] = v;
  sqrt_d[col] = sd;
}

// Split path: mu, var and sqrt_d of each column from the all-reduced sums.
__global__ void neuron_layer_train_finalize(const double* __restrict__ sums,
                                            int K, float eps,
                                            float* __restrict__ mu,
                                            float* __restrict__ var,
                                            float* __restrict__ sqrt_d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= K) return;
  float m, v, sd;
  stats_from_sums(sums, K, col, eps, m, v, sd);
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
          u[j] = membrane(u[j], sp[j], y, alpha);
          sp[j] = (u[j] >= th_fire) ? 1.0f : 0.0f;
        }
        e2a::store_v<V>(s + at, sp);
      }
    }
  }
}

// (c) over z with the statistics in mu and sqrt_d. Returns a cudaError_t.
int launch_soma(const float* z, const float* gamma, const float* beta,
                const float* mu, const float* sqrt_d, float* s, int T,
                long long M, int K, float alpha, float th_fire,
                cudaStream_t st) {
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

}  // namespace

// Eval mode: x (T, M, C) [packed: (T, M, C/8) uint8] @ w (C, K) + bias ->
// SOMA; writes s (T, M, K). tile picks the packed arm's tile: 0 by the rule
// of eval_tile, 1 Large, 2 Small (the benchmark times both).
extern "C" int e2a_neuron_layer_eval(const void* x, const float* w,
                                     const float* bias, float* s, int T,
                                     long long M, int C, int K, int packed,
                                     int tile, float alpha, float th_fire,
                                     void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (T < 1 || T > 8 || tile < 0 || tile > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) {
    if (C % 8 != 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    // x (T, M, C / 8): time step t's rows start at t * M * (C / 8)
    const e2a::mma::Operands a = {static_cast<const uint8_t*>(x), C / 8, 1,
                                  w, K, 1, (int)M, C, K};
    if (tile == 0) tile = eval_tile(M, K);
    return tile == 1
               ? launch_eval_mma<e2a::mma::Large>(a, T, bias, s, alpha,
                                                  th_fire, st)
               : launch_eval_mma<e2a::mma::Small>(a, T, bias, s, alpha,
                                                  th_fire, st);
  }
  return launch_eval_dense(static_cast<const float*>(x), w, bias, s, T, M, C,
                           K, alpha, th_fire, st);
}

// Train mode: x (T, M, C) [packed: (T, M, C/8) uint8] @ w (C, K) -> batch
// statistics over T * M rows -> BN -> SOMA. Writes s (T, M, K) and mu, var,
// sqrt_d (K); z (T, M, K) and part are scratch. part holds (2, n_tiles, K)
// floats, n_tiles as launch_z gives it.
extern "C" int e2a_neuron_layer_train(const void* x, const float* w,
                                      const float* gamma, const float* beta,
                                      float* z, float* part, float* mu,
                                      float* var, float* sqrt_d, float* s,
                                      int T, long long M, int C, int K,
                                      int packed, float alpha, float th_fire,
                                      float eps, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const int code = launch_z(x, w, z, part, T, M, C, K, packed, n_tiles, st);
  if (code != 0) return code;
  neuron_layer_train_stats<<<(K + STAT_COLS - 1) / STAT_COLS,
                             dim3(STAT_COLS, STAT_LANES), 0, st>>>(
      part, mu, var, sqrt_d, nullptr, n_tiles, K, (double)T * M, eps);
  return launch_soma(z, gamma, beta, mu, sqrt_d, s, T, M, K, alpha, th_fire,
                     st);
}

// Split path, before the all-reduce: pass (a), then sums (2 * K + 1
// doubles) receives the rank's sum(z) and sum(z^2) per column and its row
// count T * M. z (T, M, K) and part are kept for the apply call.
extern "C" int e2a_neuron_layer_train_sums(const void* x, const float* w,
                                           float* z, float* part,
                                           double* sums, int T, long long M,
                                           int C, int K, int packed,
                                           void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_tiles = 0;
  const int code = launch_z(x, w, z, part, T, M, C, K, packed, n_tiles, st);
  if (code != 0) return code;
  neuron_layer_train_stats<<<(K + STAT_COLS - 1) / STAT_COLS,
                             dim3(STAT_COLS, STAT_LANES), 0, st>>>(
      part, nullptr, nullptr, nullptr, sums, n_tiles, K, (double)T * M,
      0.0f);
  return (int)cudaGetLastError();
}

// Split path, after the all-reduce: mu, var and sqrt_d (K) from the global
// sums, then BN and SOMA over z, writing s (T, M, K).
extern "C" int e2a_neuron_layer_train_apply(const float* z,
                                            const float* gamma,
                                            const float* beta,
                                            const double* sums, float* mu,
                                            float* var, float* sqrt_d,
                                            float* s, int T, long long M,
                                            int K, float alpha, float th_fire,
                                            float eps, void* stream) {
  if (K <= 0) return 0;
  if (T < 1 || T > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  neuron_layer_train_finalize<<<(K + 255) / 256, 256, 0, st>>>(
      sums, K, eps, mu, var, sqrt_d);
  if (M <= 0) return (int)cudaGetLastError();
  return launch_soma(z, gamma, beta, mu, sqrt_d, s, T, M, K, alpha, th_fire,
                     st);
}

// Pass (a) of the train mode alone: z (T, M, K) = x @ w, the same kernel,
// tile and bits as e2a_neuron_layer_train's z, without the column partials.
// The autograd op's backward replays the forward's pre-activation with it.
extern "C" int e2a_neuron_layer_train_z(const void* x, const float* w,
                                        float* z, int T, long long M, int C,
                                        int K, int packed, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  int n_tiles = 0;
  return launch_z(x, w, z, nullptr, T, M, C, K, packed, n_tiles,
                  static_cast<cudaStream_t>(stream));
}
