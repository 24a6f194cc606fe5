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
//
// bf16 (the reference's kernels at a bf16 input: bf16 x bf16 products into
// an fp32 accumulator, BN or the bias and the SOMA on that fp32
// accumulator, the spikes stored in x.dtype): x (dense) and w are bf16, named
// by the dtype code, and so are the spikes s; z, the statistics, gamma,
// beta and the bias stay fp32 (the wrapper widens a bf16 vector, exactly).
// The packed arms run the mainloop on one weight plane (a bf16 weight is
// its own, Planes<bf16>); the dense arms convert each staged element to
// fp32, where a bf16 x bf16 product is exact, so each fmaf adds the exact
// product as the fp32 accumulator of the reference's dot does. Everything
// after the product is the fp32 arm's arithmetic, so train_z replays the
// forward's z bit for bit at bf16 too. Where the spike matmul's rule sends
// the same product to its wgmma kernel (a bf16 weight TMA can read, more
// than 512 rows), pass (a) runs on that kernel's mainloop instead
// (neuron_layer_train_z_wgmma, wgmma_mainloop.cuh) with an epilogue of its
// own: z and the column partials of 192-row tiles. The forward, the split
// path's sums and the replay plan the same pass for the same operands.
#include <type_traits>

#include "bn_stats.cuh"
#include "elem.cuh"
#include "launch_plan.cuh"
#include "spike_mma_mainloop.cuh"
#include "wgmma_mainloop.cuh"

namespace {

using namespace e2a;
using e2a::mma::Planes;
using e2a::mma::planes_of;

// Which kernel a Launch record of this file is for.
enum Kernel {
  EVAL_DENSE, EVAL_LARGE, EVAL_SMALL, Z_DENSE, Z_MMA, STATS, FINALIZE,
  SOMA4, SOMA1, Z_WGMMA, EVAL_WGMMA
};

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

// w[c0 .. c0 + cw) x [n0 .. n0 + DENSE_COLS) into sm.w as fp32, zero past
// cw (up to cp) and past K.
template <class E>
__device__ __forceinline__ void dense_stage_w(DenseSmem& sm,
                                              const E* __restrict__ w,
                                              int c0, int cw, int cp, int K,
                                              int n0) {
  for (int i = threadIdx.x; i < cp * DENSE_COLS; i += DENSE_THREADS) {
    const int c = i / DENSE_COLS, k = i % DENSE_COLS;
    sm.w[i] = c < cw && n0 + k < K
                  ? to_f(w[(long long)(c0 + c) * K + n0 + k])
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
// one contiguous span of n * C elements, read as the elements before its
// first 16-byte boundary (head), 16-byte vectors of VE elements (body: 4
// fp32 or 8 bf16), and the rest (tail). A thread loads its share into
// registers (load) while the block computes the last sub-tile, and writes
// it to the staged rows as fp32 (put) after the next barrier, so that the
// loads' latency hides behind the FMAs.
template <class E>
struct DenseSpan {
  static constexpr int VE = kVec<E>;
  static constexpr int PER_THREAD =
      DENSE_ROWS * DENSE_CHUNK / VE / DENSE_THREADS;  // vectors at most
  struct alignas(16) Vec {
    E e[VE];
  };
  Vec v[PER_THREAD];
  float h, t;                                          // head, tail elements
  int head, body, total;

  __device__ __forceinline__ void load(const E* __restrict__ x,
                                       long long r0, int n, int C) {
    const E* src = x + r0 * C;
    h = t = 0.0f;
    total = n * C;
    head = min(total,
               (int)(((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) /
                     sizeof(E)));
    body = (total - head) / VE;
    const Vec* srcv = reinterpret_cast<const Vec*>(src + head);
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int f = threadIdx.x + k * DENSE_THREADS;
      if (f < body) v[k] = srcv[f];
    }
    const int tail = total - head - VE * body;
    if ((int)threadIdx.x < head) h = to_f(src[threadIdx.x]);
    if ((int)threadIdx.x < tail) t = to_f(src[head + VE * body + threadIdx.x]);
  }

  __device__ __forceinline__ void put(DenseSmem& sm, int C, int ld) const {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int f = threadIdx.x + k * DENSE_THREADS;
      if (f >= body) break;
      const int i = head + VE * f;
      int row = i / C, c = i - row * C;
#pragma unroll
      for (int u = 0; u < VE; ++u) {
        sm.x[row * ld + c] = to_f(v[k].e[u]);
        if (++c == C) {
          c = 0;
          ++row;
        }
      }
    }
    const int i = threadIdx.x, tail = total - head - VE * body;
    if (i < head) sm.x[(i / C) * ld + i % C] = h;
    if (i < tail) {
      const int j = head + VE * body + i;
      sm.x[(j / C) * ld + j % C] = t;
    }
  }
};

// The block's S sub-tiles in turn: rows(s) gives sub-tile s's first x row
// and its number of rows (<= DENSE_ROWS), and epi(s, acc) receives the
// thread's 4 x 4 products of it, each fmaf over c ascending from 0.
// Every thread of the block calls it.
template <class E, class Rows, class Epilogue>
__device__ __forceinline__ void dense_tiles(DenseSmem& sm,
                                            const E* __restrict__ x,
                                            const E* __restrict__ w, int S,
                                            Rows rows, int C, int K, int n0,
                                            int rl, int q, Epilogue epi) {
  if (C <= DENSE_CHUNK) {   // the whole weight and whole rows at once
    const int cp = (C + 3) & ~3, ld = dense_ld(cp);
    dense_stage_w(sm, w, 0, C, cp, K, n0);
    for (int i = threadIdx.x; i < DENSE_ROWS * (cp - C); i += DENSE_THREADS)
      sm.x[(i / (cp - C)) * ld + C + i % (cp - C)] = 0.0f;   // the pad
    DenseSpan<E> span;
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
            row < n && c < cw ? to_f(x[(r0 + row) * C + c0 + c]) : 0.0f;
      }
      __syncthreads();
      dense_fma(sm, ld, cp, rl, q, acc);
    }
    epi(s, acc);
  }
}

// The 4 values of a thread's row at column col of out (rows of K
// elements): one vector store where vec4 (K % 4 == 0, out 16-byte aligned),
// else those below K, each rounded to out's type once.
template <class O>
__device__ __forceinline__ void dense_store(O* out, int col, int K,
                                            bool vec4, const float (&v)[4]) {
  if (vec4) {
    if (col < K) store_v<4>(out + col, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < K) out[col + e] = from_f<O>(v[e]);
  }
}

// Eval: the block owns DENSE_ROWS rows of M and DENSE_COLS columns and loops
// t = 0..T-1 over time step t's rows; (U, S) of its 16 outputs stay with
// the thread (S as one bit each in a register, U in shared memory, which
// leaves the registers to the product), and only the spikes are written.
template <class E>
__global__ void __launch_bounds__(DENSE_THREADS, 3) neuron_layer_eval_dense(
    const E* __restrict__ x, const E* __restrict__ w,
    const float* __restrict__ bias, E* __restrict__ s, int T,
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
template <class E>
__global__ void __launch_bounds__(DENSE_THREADS) neuron_layer_train_z_dense(
    const E* __restrict__ x, const E* __restrict__ w,
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

// The dense arms: blocks of DENSE_ROWS rows (eval: a time step's M rows,
// each block walking the T steps) or DENSE_TILE_ROWS rows (train: all T * M
// rows) x DENSE_COLS columns.
Launch dense_plan(long long rows, long long rows_per_block, int K,
                  Kernel k) {
  Launch l = launch_of(DENSE_THREADS, 1, 0, k);
  axis(l, 0, cdiv(rows, rows_per_block), rows_per_block, rows);
  return axis(l, 1, cdiv(K, DENSE_COLS), DENSE_COLS, K);
}

template <class E>
int launch_eval_dense(const Launch& l, const E* x, const E* w,
                      const float* bias, E* s, int T, long long M, int C,
                      int K, float alpha, float th_fire, cudaStream_t st) {
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  neuron_layer_eval_dense<E><<<grid_of(l), block_of(l), 0, st>>>(
      x, w, bias, s, T, M, C, K, vec4, alpha, th_fire);
  return (int)cudaGetLastError();
}

template <class E>
int launch_train_z_dense(const Launch& l, const E* x, const E* w,
                         float* z, float* part, long long rows, int C, int K,
                         cudaStream_t st) {
  const bool vec4 = K % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  neuron_layer_train_z_dense<E><<<grid_of(l), block_of(l), 0, st>>>(
      x, w, z, part, rows, C, K, vec4, (int)l.grid[0]);
  return (int)cudaGetLastError();
}

// ---- eval, packed arm ----
// Outputs a thread owns in the tile (Lane<Tile>: WM x WN fragments of 4),
// and the dynamic shared memory of a block: the mainloop's (its P weight
// planes and rows), then U, slot i of thread j at float (i * THREADS + j),
// so a warp's accesses are contiguous.
template <class Tile>
struct EvalTile {
  static constexpr int OUTS = Tile::WM * Tile::WN * 4;
  static constexpr int smem(int planes) {
    return Tile::smem(planes) + OUTS * Tile::THREADS * 4;
  }
  static_assert(OUTS <= 32, "one spike bit per output in a 32-bit mask");
};

// Two neighbouring spikes of E in one store (8 bytes of fp32, 4 of bf16).
__device__ __forceinline__ void store2(float* o, const float (&v)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store2(bf16* o, const float (&v)[2]) {
  *reinterpret_cast<uint32_t*>(o) = e2a::mma::bf16x2_rn(v[0], v[1]);
}

template <class Tile, class E>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
    neuron_layer_eval_mma(const e2a::mma::Operands<E> a, int T,
                          const float* __restrict__ bias,
                          E* __restrict__ s, float alpha, float th_fire) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const u_mem =
      reinterpret_cast<float*>(smem + Tile::smem(Planes<E>)) + threadIdx.x;
  const long long m0 = (long long)blockIdx.x * Tile::BM;
  const int n0 = blockIdx.y * Tile::BN;
  const e2a::mma::Lane<Tile> L;
  const int K = a.K;
  const bool vec2 = K % 2 == 0;   // s is 256-byte aligned, rows K elements
  uint32_t fired = 0;             // bit i: output i's spike at step t - 1
  e2a::mma::Operands<E> at = a;
  for (int t = 0; t < T; ++t) {
    at.x = a.x + (long long)t * a.M * a.x_m;   // time step t's packed rows
    if (t > 0) __syncthreads();   // every warp is past step t - 1's mainloop
    e2a::mma::Acc<Tile> acc;
    e2a::mma::mainloop<Tile>(at, m0, n0, smem, acc);
    E* const out = s + (long long)t * a.M * K;
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
          E* const o = out + row * K + col;
          if (vec2 && col + 1 < K) {
            store2(o, v);
          } else {
            if (col < K) o[0] = from_f<E>(v[0]);
            if (col + 1 < K) o[1] = from_f<E>(v[1]);
          }
        }
      }
  }
}

// The packed eval arm's launch: blocks of Tile::BM rows of a time step x
// Tile::BN columns, each walking the T steps.
template <class Tile>
Launch eval_mma_plan(long long M, int K, Kernel k, int planes) {
  Launch l = launch_of(Tile::THREADS, 1, EvalTile<Tile>::smem(planes), k);
  axis(l, 0, cdiv(M, Tile::BM), Tile::BM, M);
  return axis(l, 1, cdiv(K, Tile::BN), Tile::BN, K);
}

template <class Tile, class E>
int launch_eval_mma(const Launch& l, const e2a::mma::Operands<E>& a, int T,
                    const float* bias, E* s, float alpha, float th_fire,
                    cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(
      l, reinterpret_cast<const void*>(neuron_layer_eval_mma<Tile, E>),
      raised);
  if (err != 0) return err;
  neuron_layer_eval_mma<Tile, E><<<grid_of(l), block_of(l), l.smem, st>>>(
      a, T, bias, s, alpha, th_fire);
  return (int)cudaGetLastError();
}

// The packed eval arm's tile on the mma.sync mainloop: every fp32 call, and
// the bf16 calls the wrappers do not send to the wgmma kernel below
// (neuron_layer.eval_kernel: at most 512 rows a time step, or a weight TMA
// cannot read); bf16 calls above 512 rows a step with a weight TMA can read
// take the wgmma kernel (tile code 3, EVAL_WGMMA). A block runs T mainloops,
// so its blocks are few and long and the last wave's share of idle SMs
// decides the time. Large (256 x 64 outputs, one block an SM) where its grid
// fits in one wave (the block sites, M = 3,136 rows: 104 blocks); Small (128
// x 64, two blocks an SM) beyond, whose half-size blocks even out the last
// wave. Measured at the preset's five packed sites in fp32, this picks the
// faster tile at each (benchmarks/torch/bench_eval_kernels.py; PERF.md,
// section 6).
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

template <class E>
__global__ void __launch_bounds__(ZTile::THREADS, ZTile::MIN_BLOCKS)
    neuron_layer_train_z_mma(const e2a::mma::Operands<E> a,
                             float* __restrict__ z, float* __restrict__ part,
                             int n_tiles) {
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
  static_assert(2 * T::WARPS_M * T::BN * 4 <= T::smem(1), "reduction space");
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

template <class E>
int launch_train_z_packed(const Launch& l, const e2a::mma::Operands<E>& a,
                          float* z, float* part, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  const int err = raise_smem(
      l, reinterpret_cast<const void*>(neuron_layer_train_z_mma<E>), raised);
  if (err != 0) return err;
  neuron_layer_train_z_mma<E><<<grid_of(l), block_of(l), l.smem, st>>>(
      a, z, part, (int)l.grid[0]);
  return (int)cudaGetLastError();
}

// ---- train, pass (a), packed arm at bf16: the wgmma mainloop ----
// z (T * M, K) fp32 = x (T * M, C / 8) packed @ w (C, K) bf16 on the
// mainloop of the bf16 spike matmul (wgmma_mainloop.cuh), wherever the
// spike matmul's rule sends the same product there (z_kernel in
// kernels/neuron_layer.py: more than 512 rows and a weight TMA can read).
// Bound: one bf16 tensor-core pass, 2 * T*M*C*K operations, or z's
// bytes, T*M*K * 4, whichever is longer
// (at smlp.a z's 103 MB, 0.031 ms, against the product's 0.027). The
// one-plane mma.sync pass above ran 4-6x slower than this mainloop on the
// same product: its weight went through registers into shared memory
// behind two barriers a chunk, with nothing in flight while the tensor
// cores waited; here a producer warp keeps the TMA ring full.
// The epilogue of a consumer's 64 rows x 128 columns:
// - z goes out as the spike matmul's outputs do: staged in shared memory
//   in the 128-byte swizzle (four boxes of 32 columns x 64 rows) and
//   stored by TMA, which clips rows past T * M and columns past K and runs
//   on while the consumer starts its next tile. Stored from registers, z
//   took the consumers off the tensor cores for as long as its bytes took
//   to leave (0.080 against the spike matmul's 0.040 ms at smlp.a).
// - The column partials of sum(z) and sum(z^2) of each BM-row tile, of
//   the rounded z, in a fixed order: each consumer's thread c adds column
//   c of its 64 staged rows in row order, then the ZW_CWG consumers'
//   sums are added in consumer order through shared memory (the buffer
//   alternates with the tile's parity, so one barrier a tile keeps a
//   tile's reads ahead of the next tile's writes). No atomics.
// The staging takes 32 KB a consumer, so the ring holds three stages
// (3 x 35 KB + 96 KB + 6 KB of sums fit in the 227 KB a block may use).
constexpr int ZW_CWG = 3;                          // consumer warpgroups
constexpr int ZW_STAGES = 3;
constexpr int ZW_E_WG = 64 * 128 * 4;              // a consumer's z tile
constexpr int ZW_RED = 2 * 2 * ZW_CWG * 128 * 4;   // [parity][q][wg][n]
using ZWide = e2a::wg::WTile<ZW_CWG, ZW_STAGES, ZW_CWG * ZW_E_WG + ZW_RED>;
constexpr int ZW_BARRIER = 4;   // the consumers' named barrier (1-3, 15 taken)

// Byte offset of 16-byte piece p (columns 4p .. 4p + 3) of row r in a
// consumer's staged z: 32-column boxes of 64 rows x 128 bytes, the pieces
// of a row in the 128-byte swizzle (piece ^ row % 8), as TMA reads a box
// of z's tensor map. A warp's 8-byte writes of two pieces over its eight
// rows, and 32 lanes' reads of one row, fall in 32 distinct banks. The
// eval kernel's bf16 spikes are staged the same way, a piece 8 columns
// (64-column boxes).
__device__ __forceinline__ uint32_t z_offset(int r, int p) {
  return (p / 8) * 64 * 128 + r * 128 + (((p % 8) ^ (r % 8)) * 16);
}

struct ZEpilogue {
  using T = ZWide;
  const CUtensorMap& zmap;
  float* z;
  float* part;
  int n_tiles;
  long long rows;
  int K;
  int parity;

  __device__ __forceinline__ void tile(float (&acc)[T::BN / 2],
                                       const e2a::wg::TileAt& at) {
    using namespace e2a::wg;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
    const uint32_t base = smem_addr(smem_base()) + T::E_OFF;
    const uint32_t ebuf = base + (wg - 1) * ZW_E_WG;
    const int row0 = (int)at.m0 + (wg - 1) * 64;
    // the last TMA store of this consumer has read its staging
    if (tid == 0) bulk_wait_read();
    named_sync(wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {   // columns 8j + 2 t4, + 1
        const uint32_t at_r = ebuf + z_offset(r, 2 * j + t4 / 2) +
                              8 * (t4 % 2);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at_r),
                     "f"(acc[4 * j + 2 * h]), "f"(acc[4 * j + 2 * h + 1])
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < T::BN / 32; ++q)
        tma_store(ebuf + q * 64 * 128, &zmap, at.n0 + 32 * q, row0, 0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (part == nullptr) return;   // the replay: z alone (every consumer)
    // column tid of the consumer's rows in row order, from the staging
    float s = 0.0f, q = 0.0f;
    const int n = (int)min(64LL, rows - row0);
    for (int r = 0; r < n; ++r) {
      float v;
      asm volatile("ld.shared.f32 %0, [%1];\n"
                   : "=f"(v)
                   : "r"(ebuf + z_offset(r, tid / 4) + 4 * (tid % 4)));
      s = __fadd_rn(s, v);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
    float* const red =
        reinterpret_cast<float*>(smem_base() + T::E_OFF + ZW_CWG * ZW_E_WG) +
        parity * (2 * ZW_CWG * T::BN);
    red[(wg - 1) * T::BN + tid] = s;
    red[(ZW_CWG + wg - 1) * T::BN + tid] = q;
    named_sync(ZW_BARRIER, 128 * T::CWG);
    // the consumers in order: threads 0 .. 2 BN - 1 of the consumers
    const int i = threadIdx.x - 128;
    if (i < 2 * T::BN) {
      const int qi = i / T::BN, c = i % T::BN, col = at.n0 + c;
      if (col < K) {
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < ZW_CWG; ++k)
          v = __fadd_rn(v, red[(qi * ZW_CWG + k) * T::BN + c]);
        part[((long long)qi * n_tiles + at.tm) * K + col] = v;
      }
    }
    parity ^= 1;
  }

  __device__ __forceinline__ void done(uint32_t sink) {
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (rows < 0) z[threadIdx.x] = __uint_as_float(sink);
  }
};

__global__ void __launch_bounds__(ZWide::THREADS, 1)
    neuron_layer_train_z_wgmma(const __grid_constant__ CUtensorMap wmap,
                               const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap zmap,
                               const e2a::wg::Args a, float* __restrict__ z,
                               float* __restrict__ part, int n_tiles) {
  ZEpilogue epi{zmap, z, part, n_tiles, a.M, a.K, 0};
  e2a::wg::mainloop<ZWide, true>(wmap, xmap, a, epi);
}

// The partials' row tiles of pass (a) as planned (kernels/neuron_layer.py
// part_tiles): grid.x where a block is a row tile, the BM-row tiles of
// all T * M rows on the persistent wgmma kernel.
long long z_parts(const Launch& l, long long rows) {
  return l.kernel == Z_WGMMA ? cdiv(rows, ZWide::BM) : l.grid[0];
}

// Pass (a) at bf16 on the wgmma mainloop: the tensor maps, the launch.
// Returns a cudaError_t.
int launch_z_wgmma(const Launch& l, const void* x, const bf16* w, float* z,
                   float* part, long long rows, int C, int K,
                   cudaStream_t st) {
  e2a::wg::Args a = {static_cast<const uint8_t*>(x), nullptr, 1, 1, (int)rows,
                     C, K, 0, 0, C / 8, 1, 0, 0, 0, 0,
                     0, 0, 0, 0, 0, 0, 0};
  CUtensorMap wmap, xmap = {}, zmap;
  int err = e2a::wg::encode_weight<ZWide>(&wmap, a, w, 1, 1, 0, 0, K, 1);
  if (err == 0) err = e2a::wg::encode_rows<ZWide>(&xmap, a, 1);
  if (err != 0) return err;
  if (!a.n_major || reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // z (rows, K) fp32: K, the rows and one batch; boxes of 32 columns x 64
  // rows in the 128-byte swizzle (K % 8 == 0: rows of 16-byte multiples)
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)K * 4 * rows};
  const cuuint32_t box[3] = {32, 64, 1};
  if (e2a::wg::encode_cached(&zmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, z,
                             dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  err = raise_smem(
      l, reinterpret_cast<const void*>(neuron_layer_train_z_wgmma), raised);
  if (err != 0) return err;
  neuron_layer_train_z_wgmma<<<grid_of(l), block_of(l), l.smem, st>>>(
      wmap, xmap, zmap, a, z, part, (int)z_parts(l, rows));
  return (int)cudaGetLastError();
}

// ---- eval, packed arm at bf16: the wgmma mainloop ----
// s (T, M, K) bf16 = SOMA over t of x_t (M, C / 8) packed @ w (C, K) bf16
// + bias, on the mainloop of the bf16 spike matmul (wgmma_mainloop.cuh),
// wherever the wrappers send a bf16 call there (eval_kernel in
// kernels/neuron_layer.py, the spike matmul's rule on the rows of one time
// step: more than 512, and a weight TMA can read). Replaces, at a bf16
// weight, the reference's _nl_eval_kernel as neuron_layer_eval_mma does.
// Bound: one bf16 tensor-core pass, 2 * T*M*C*K operations, or the bytes of
// the packed rows, the weight and the spikes, whichever is longer. The
// one-plane mma.sync arm ran 13-16x off that bound: its weight went through
// registers into shared memory behind two barriers a chunk, with nothing in
// flight while the tensor cores waited; here a producer warp keeps a TMA
// ring full.
// - A block owns a unit of BM = 128 rows x BN = 128 columns and walks its T
//   time steps in order (walk<true>: the batch of the rows' tensor map is
//   the time step), so the producer stages step t + 1's chunks while the
//   consumers run step t's epilogue.
// - Each consumer thread keeps its 64 membranes (fp32) and its 64 last
//   spikes (bits of two words) in registers across the steps, beside its
//   64 accumulators: two consumer warpgroups may hold 224 registers a
//   thread (three only 152). The pre-activation and the membrane never
//   reach device memory.
// - The epilogue of a step adds the bias (the unit's 128 columns, copied
//   into shared memory by each consumer at the unit's first step), runs the
//   membrane update on the fp32 sum (the one-plane arm's arithmetic:
//   __fadd_rn of the accumulator and the bias, then membrane()), and stages
//   the bf16 spikes in the 128-byte swizzle; TMA stores them into step t's
//   rows, clipping rows past M and columns past K, and runs on while the
//   consumer starts the next step. Stores from registers kept the consumers
//   off the tensor cores (the z pass, above).
// On exact operands every sum is exact, so the spikes are those of the
// plain version bit for bit.
constexpr int EW_CWG = 2;                          // consumer warpgroups
constexpr int EW_STAGES = 4;
constexpr int EW_E_WG = 64 * 128 * 2;              // a consumer's spike tile
constexpr int EW_BIAS = 128 * 4;                   // a consumer's bias copy
using EWide =
    e2a::wg::WTile<EW_CWG, EW_STAGES, EW_CWG * (EW_E_WG + EW_BIAS)>;
static_assert(EWide::CONSUMER_REGS == 224, "a consumer's registers");

struct EvalEpilogue {
  using T = EWide;
  const CUtensorMap& smap;
  bf16* s;
  const float* bias;
  int K;
  float alpha, th_fire;
  float u[T::BN / 2];          // the thread's membranes
  uint32_t fired[2] = {0, 0};  // bit i % 32 of word i / 32: output i's spike

  __device__ __forceinline__ void tile(float (&acc)[T::BN / 2],
                                       const e2a::wg::TileAt& at) {
    using namespace e2a::wg;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
    unsigned char* const base = smem_base() + T::E_OFF;
    const uint32_t ebuf = smem_addr(base) + (wg - 1) * EW_E_WG;
    float* const bs =
        reinterpret_cast<float*>(base + EW_CWG * EW_E_WG) + (wg - 1) * T::BN;
    const bool first = at.g == 0;   // the unit's first time step
    // the unit's bias: every thread of this consumer is past the last
    // step's reads of it (the second barrier below)
    if (first) bs[tid] = at.n0 + tid < K ? bias[at.n0 + tid] : 0.0f;
    // the last TMA store of this consumer has read its staging
    if (tid == 0) bulk_wait_read();
    named_sync(wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gq + 8 * h;
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {   // columns 8j + 2 t4, + 1
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const uint32_t bit = 1u << (i % 32);
          const float y = __fadd_rn(acc[i], bs[8 * j + 2 * t4 + e]);
          const float un =
              membrane(first ? 0.0f : u[i],
                       !first && (fired[i / 32] & bit) ? 1.0f : 0.0f, y,
                       alpha);
          u[i] = un;
          const bool f = un >= th_fire;
          fired[i / 32] = f ? fired[i / 32] | bit : fired[i / 32] & ~bit;
          v[e] = f ? 1.0f : 0.0f;
        }
        sts32(ebuf + z_offset(r, j) + 4 * t4, e2a::mma::bf16x2_rn(v[0], v[1]));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < T::BN / 64; ++q)
        tma_store(ebuf + q * 64 * 128, &smap, at.n0 + 64 * q,
                  (int)at.m0 + (wg - 1) * 64, at.g);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }

  __device__ __forceinline__ void done(uint32_t sink) {
    if (threadIdx.x % 128 == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    if (K < 0) s[threadIdx.x] = __ushort_as_bfloat16((unsigned short)sink);
  }
};

__global__ void __launch_bounds__(EWide::THREADS, 1)
    neuron_layer_eval_wgmma(const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap smap,
                            const e2a::wg::Args a,
                            const float* __restrict__ bias, float alpha,
                            float th_fire) {
  EvalEpilogue epi{smap, a.out, bias, a.K, alpha, th_fire};
  e2a::wg::mainloop<EWide, true, true>(wmap, xmap, a, epi);
}

// The eval arm at bf16 on the wgmma mainloop: the tensor maps (the packed
// rows' with the time step as a batch level; the spikes' (T, M, K) bf16 in
// the 128-byte swizzle), the launch. Returns a cudaError_t.
int launch_eval_wgmma(const Launch& l, const void* x, const bf16* w,
                      const float* bias, bf16* s, int T, long long M, int C,
                      int K, float alpha, float th_fire, cudaStream_t st) {
  e2a::wg::Args a = {static_cast<const uint8_t*>(x), s, T, T, (int)M, C, K,
                     0, M * (C / 8), C / 8, 1, 0, 0, 0, 0,
                     0, 0, 0, 0, 0, 0, 0};
  CUtensorMap wmap, xmap = {}, smap;
  int err = e2a::wg::encode_weight<EWide>(&wmap, a, w, 1, T, 0, 0, K, 1);
  if (err == 0) err = e2a::wg::encode_rows<EWide>(&xmap, a, 1);
  if (err != 0) return err;
  if (!a.n_major || reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // s (T, M, K) bf16: K, the rows, the steps; boxes of 64 columns x 64 rows
  // in the 128-byte swizzle (K % 8 == 0: rows of 16-byte multiples)
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)K * 2 * M};
  const cuuint32_t box[3] = {64, 64, 1};
  if (e2a::wg::encode_cached(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, s,
                             dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool raised[kMaxDevices] = {};
  err = raise_smem(
      l, reinterpret_cast<const void*>(neuron_layer_eval_wgmma), raised);
  if (err != 0) return err;
  neuron_layer_eval_wgmma<<<grid_of(l), block_of(l), l.smem, st>>>(
      wmap, xmap, smap, a, bias, alpha, th_fire);
  return (int)cudaGetLastError();
}

// Pass (a) of either arm over all T * M rows on the kernel the caller
// names (kernels/neuron_layer.py z_kernel, the spike matmul's rule):
// Z_DENSE for the dense arm, DENSE_TILE_ROWS-row tiles (DENSE_TILE_ROWS
// there too); Z_MMA for the packed arm, ZTile::BM-row tiles (TILE_ROWS
// there), its shared memory the weight planes of dtype; Z_WGMMA for the
// packed arm at bf16 with a (C, K) weight TMA can read (contiguous,
// 16-byte aligned, K % 8 == 0), the persistent wgmma kernel over
// ZWide::BM-row tiles (WGMMA_TILE_ROWS there). grid.x, or those tiles,
// is the partials' tile count (z_parts). A kernel the call cannot take is
// refused, with no other in its place. Returns a cudaError_t.
int z_plan(int T, long long M, int C, int K, int packed, int kernel,
           int dtype, const void* w, Launch& l) {
  if (packed && C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (T < 1 || T > 8) return (int)cudaErrorInvalidValue;
  if (kernel != (packed ? Z_MMA : Z_DENSE) &&
      !(packed && kernel == Z_WGMMA))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)T * M;
  if (!packed) {
    l = dense_plan(rows, DENSE_TILE_ROWS, K, Z_DENSE);
    return 0;
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (kernel == Z_WGMMA) {
    if (dtype != kBfloat16 || !e2a::wg::tma_suits(w, 1, 1, C, K, 0, 0, K, 1))
      return (int)cudaErrorInvalidValue;
    return e2a::wg::wgmma_plan<ZWide>((int)rows, K, 1, Z_WGMMA, l);
  }
  l = launch_of(ZTile::THREADS, 1, ZTile::smem(planes_of(dtype)), Z_MMA);
  axis(l, 0, cdiv(rows, ZTile::BM), ZTile::BM, rows);
  axis(l, 1, cdiv(K, ZTile::BN), ZTile::BN, K);
  return 0;
}

// Pass (a) as z_plan planned it: z (T, M, K), and the column partials into
// part unless it is null. Returns a cudaError_t.
template <class E>
int launch_z(const Launch& l, const void* x, const E* w, float* z,
             float* part, int T, long long M, int C, int K, cudaStream_t st) {
  const long long rows = (long long)T * M;
  if constexpr (std::is_same_v<E, bf16>) {
    if (l.kernel == Z_WGMMA)
      return launch_z_wgmma(l, x, w, z, part, rows, C, K, st);
  }
  if (l.kernel == Z_MMA) {
    // T is a row index here: x (T * M, C / 8) and z (T * M, K), contiguous
    const e2a::mma::Operands<E> a = {static_cast<const uint8_t*>(x), C / 8, 1,
                                     w, K, 1, (int)rows, C, K};
    return launch_train_z_packed(l, a, z, part, st);
  }
  return launch_train_z_dense(l, static_cast<const E*>(x), w, z, part,
                              rows, C, K, st);
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

template <int V, class E>
__global__ void __launch_bounds__(SOMA_COLS* SOMA_LANES)
    neuron_layer_train_soma(const float* __restrict__ z,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const float* __restrict__ mu,
                            const float* __restrict__ sqrt_d,
                            E* __restrict__ s, long long M, int K, int T,
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

// (c): SOMA_COLS column lanes (V = 4 columns each where K % 4 == 0) x
// SOMA_LANES row lanes a block, ranges of SOMA_ROWS rows on grid.y (at most
// MAX_ROW_BLOCKS of them).
Launch soma_plan(long long M, int K) {
  const bool v4 = K % 4 == 0;
  const int V = v4 ? 4 : 1;
  Launch l = launch_of(SOMA_COLS, SOMA_LANES, 0, v4 ? SOMA4 : SOMA1);
  axis(l, 0, cdiv(K, SOMA_COLS * V), SOMA_COLS * V, K);
  return axis(l, 1, row_blocks(M, SOMA_ROWS), SOMA_ROWS, M,
              cdiv(M, SOMA_ROWS) > MAX_ROW_BLOCKS);
}

// (c) over z with the statistics in mu and sqrt_d, the spikes in E.
// Returns a cudaError_t.
template <class E>
int launch_soma(const Launch& l, const float* z, const float* gamma,
                const float* beta, const float* mu, const float* sqrt_d,
                E* s, int T, long long M, int K, float alpha,
                float th_fire, cudaStream_t st) {
  if (l.kernel == SOMA4)
    neuron_layer_train_soma<4, E><<<grid_of(l), block_of(l), 0, st>>>(
        z, gamma, beta, mu, sqrt_d, s, M, K, T, alpha, th_fire);
  else
    neuron_layer_train_soma<1, E><<<grid_of(l), block_of(l), 0, st>>>(
        z, gamma, beta, mu, sqrt_d, s, M, K, T, alpha, th_fire);
  return (int)cudaGetLastError();
}

// (b), and the split path's finalize: a column a lane.
Launch stats_plan(int K) {
  Launch l = launch_of(STAT_COLS, STAT_LANES, 0, STATS);
  return axis(l, 0, cdiv(K, STAT_COLS), STAT_COLS, K);
}

Launch finalize_plan(int K) {
  Launch l = launch_of(256, 1, 0, FINALIZE);
  return axis(l, 0, cdiv(K, 256), 256, K);
}

// The launches of each entry point, in order; n = 0 where it launches
// nothing. Each returns a cudaError_t.
// eval: tile 3 (kernels/neuron_layer.py eval_kernel) plans the wgmma
// kernel, for a bf16 (C, K) weight TMA can read (contiguous, 16-byte
// aligned, K % 8 == 0) and packed rows, one persistent block an SM at most
// over the 128 x 128 units; any other call with it is refused, with no
// other kernel in its place.
int eval_plan(int T, long long M, int C, int K, int packed, int tile,
              int dtype, const void* w, Launch* l, int& n) {
  n = 0;
  const int planes = planes_of(dtype);
  if (planes == 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0) return 0;
  if (T < 1 || T > 8 || tile < 0 || tile > 3)
    return (int)cudaErrorInvalidValue;
  if (!packed) {
    if (tile == 3) return (int)cudaErrorInvalidValue;
    l[n++] = dense_plan(M, DENSE_ROWS, K, EVAL_DENSE);
    return 0;
  }
  if (C % 8 != 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tile == 3) {
    if (dtype != kBfloat16 || !e2a::wg::tma_suits(w, 1, 1, C, K, 0, 0, K, 1))
      return (int)cudaErrorInvalidValue;
    const int code = e2a::wg::wgmma_plan<EWide>((int)M, K, 1, EVAL_WGMMA, l[0]);
    if (code == 0) n = 1;
    return code;
  }
  if (tile == 0) tile = eval_tile(M, K);
  l[n++] = tile == 1
               ? eval_mma_plan<e2a::mma::Large>(M, K, EVAL_LARGE, planes)
               : eval_mma_plan<e2a::mma::Small>(M, K, EVAL_SMALL, planes);
  return 0;
}

int train_plan(int T, long long M, int C, int K, int packed, int kernel,
               bool soma, int dtype, const void* w, Launch* l, int& n) {
  n = 0;
  if (planes_of(dtype) == 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0) return 0;
  const int code = z_plan(T, M, C, K, packed, kernel, dtype, w, l[0]);
  if (code != 0) return code;
  l[1] = stats_plan(K);
  n = 2;
  if (soma) l[n++] = soma_plan(M, K);
  return 0;
}

int train_apply_plan(int T, long long M, int K, int dtype, Launch* l,
                     int& n) {
  n = 0;
  if (planes_of(dtype) == 0) return (int)cudaErrorInvalidValue;
  if (K <= 0) return 0;
  if (T < 1 || T > 8) return (int)cudaErrorInvalidValue;
  l[n++] = finalize_plan(K);
  if (M > 0) l[n++] = soma_plan(M, K);
  return 0;
}

int train_z_plan(int T, long long M, int C, int K, int packed, int kernel,
                 int dtype, const void* w, Launch* l, int& n) {
  n = 0;
  if (planes_of(dtype) == 0) return (int)cudaErrorInvalidValue;
  if (M <= 0 || K <= 0) return 0;
  const int code = z_plan(T, M, C, K, packed, kernel, dtype, w, l[0]);
  if (code == 0) n = 1;
  return code;
}

}  // namespace

// dtype (every entry point): 0 fp32, 1 bf16, the type of x (dense), w and
// the spikes s; z, part, the statistics, gamma, beta, bias and sums are
// fp32 (sums float64) at either.

// Eval mode: x (T, M, C) [packed: (T, M, C/8) uint8] @ w (C, K) + bias ->
// SOMA; writes s (T, M, K). tile picks the packed arm's kernel: 0 the
// mma.sync tile by the rule of eval_tile, 1 Large, 2 Small (the benchmark
// times both), 3 the bf16 wgmma kernel (EVAL_WGMMA; refused where eval_plan
// cannot plan it).
extern "C" int e2a_neuron_layer_eval(const void* x, const void* w,
                                     const float* bias, void* s, int T,
                                     long long M, int C, int K, int packed,
                                     int tile, float alpha, float th_fire,
                                     int dtype, void* stream) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code = eval_plan(T, M, C, K, packed, tile, dtype, w, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const E* const we = static_cast<const E*>(w);
    E* const se = static_cast<E*>(s);
    if constexpr (std::is_same_v<E, bf16>) {
      if (l[0].kernel == EVAL_WGMMA)
        return launch_eval_wgmma(l[0], x, we, bias, se, T, M, C, K, alpha,
                                 th_fire, st);
    }
    if (l[0].kernel == EVAL_DENSE)
      return launch_eval_dense(l[0], static_cast<const E*>(x), we, bias, se,
                               T, M, C, K, alpha, th_fire, st);
    // x (T, M, C / 8): time step t's rows start at t * M * (C / 8)
    const e2a::mma::Operands<E> a = {static_cast<const uint8_t*>(x), C / 8,
                                     1, we, K, 1, (int)M, C, K};
    return l[0].kernel == EVAL_LARGE
               ? launch_eval_mma<e2a::mma::Large>(l[0], a, T, bias, se, alpha,
                                                  th_fire, st)
               : launch_eval_mma<e2a::mma::Small>(l[0], a, T, bias, se, alpha,
                                                  th_fire, st);
  });
}

extern "C" int e2a_neuron_layer_eval_plan(
    const void* x, const void* w, const float* bias, void* s, int T,
    long long M, int C, int K, int packed, int tile, float alpha,
    float th_fire, int dtype, long long* records, int cap) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code = eval_plan(T, M, C, K, packed, tile, dtype, w, l, n);
  return write_plan(code, l, n, records, cap);
}

// Train mode: x (T, M, C) [packed: (T, M, C/8) uint8] @ w (C, K) -> batch
// statistics over T * M rows -> BN -> SOMA. Writes s (T, M, K) and mu, var,
// sqrt_d (K); z (T, M, K) and part are scratch. kernel names pass (a)'s
// kernel (z_plan: Z_DENSE, Z_MMA or Z_WGMMA). part holds (2, n_tiles, K)
// floats, n_tiles the row tiles of that kernel (z_parts).
extern "C" int e2a_neuron_layer_train(const void* x, const void* w,
                                      const float* gamma, const float* beta,
                                      float* z, float* part, float* mu,
                                      float* var, float* sqrt_d, void* s,
                                      int T, long long M, int C, int K,
                                      int packed, int kernel, float alpha,
                                      float th_fire, float eps, int dtype,
                                      void* stream) {
  Launch l[kMaxLaunches];
  int n = 0;
  int code = train_plan(T, M, C, K, packed, kernel, true, dtype, w, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const int err =
        launch_z(l[0], x, static_cast<const E*>(w), z, part, T, M, C, K, st);
    if (err != 0) return err;
    neuron_layer_train_stats<<<grid_of(l[1]), block_of(l[1]), 0, st>>>(
        part, mu, var, sqrt_d, nullptr, (int)z_parts(l[0], (long long)T * M),
        K, (double)T * M, eps);
    return launch_soma(l[2], z, gamma, beta, mu, sqrt_d, static_cast<E*>(s),
                       T, M, K, alpha, th_fire, st);
  });
}

extern "C" int e2a_neuron_layer_train_plan(
    const void* x, const void* w, const float* gamma, const float* beta,
    float* z, float* part, float* mu, float* var, float* sqrt_d, void* s,
    int T, long long M, int C, int K, int packed, int kernel, float alpha,
    float th_fire, float eps, int dtype, long long* records, int cap) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code =
      train_plan(T, M, C, K, packed, kernel, true, dtype, w, l, n);
  return write_plan(code, l, n, records, cap);
}

// Split path, before the all-reduce: pass (a), then sums (2 * K + 1
// doubles) receives the rank's sum(z) and sum(z^2) per column and its row
// count T * M. z (T, M, K) and part are kept for the apply call.
extern "C" int e2a_neuron_layer_train_sums(const void* x, const void* w,
                                           float* z, float* part,
                                           double* sums, int T, long long M,
                                           int C, int K, int packed,
                                           int kernel, int dtype,
                                           void* stream) {
  Launch l[kMaxLaunches];
  int n = 0;
  int code = train_plan(T, M, C, K, packed, kernel, false, dtype, w, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const int err =
        launch_z(l[0], x, static_cast<const E*>(w), z, part, T, M, C, K, st);
    if (err != 0) return err;
    neuron_layer_train_stats<<<grid_of(l[1]), block_of(l[1]), 0, st>>>(
        part, nullptr, nullptr, nullptr, sums,
        (int)z_parts(l[0], (long long)T * M), K, (double)T * M, 0.0f);
    return (int)cudaGetLastError();
  });
}

extern "C" int e2a_neuron_layer_train_sums_plan(
    const void* x, const void* w, float* z, float* part, double* sums, int T,
    long long M, int C, int K, int packed, int kernel, int dtype,
    long long* records, int cap) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code =
      train_plan(T, M, C, K, packed, kernel, false, dtype, w, l, n);
  return write_plan(code, l, n, records, cap);
}

// Split path, after the all-reduce: mu, var and sqrt_d (K) from the global
// sums, then BN and SOMA over z, writing s (T, M, K).
extern "C" int e2a_neuron_layer_train_apply(const float* z,
                                            const float* gamma,
                                            const float* beta,
                                            const double* sums, float* mu,
                                            float* var, float* sqrt_d,
                                            void* s, int T, long long M,
                                            int K, float alpha, float th_fire,
                                            float eps, int dtype,
                                            void* stream) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code = train_apply_plan(T, M, K, dtype, l, n);
  if (code != 0 || n == 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  neuron_layer_train_finalize<<<grid_of(l[0]), block_of(l[0]), 0, st>>>(
      sums, K, eps, mu, var, sqrt_d);
  if (n == 1) return (int)cudaGetLastError();
  return by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return launch_soma(l[1], z, gamma, beta, mu, sqrt_d, static_cast<E*>(s),
                       T, M, K, alpha, th_fire, st);
  });
}

extern "C" int e2a_neuron_layer_train_apply_plan(
    const float* z, const float* gamma, const float* beta, const double* sums,
    float* mu, float* var, float* sqrt_d, void* s, int T, long long M, int K,
    float alpha, float th_fire, float eps, int dtype, long long* records,
    int cap) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code = train_apply_plan(T, M, K, dtype, l, n);
  return write_plan(code, l, n, records, cap);
}

// Pass (a) of the train mode alone: z (T, M, K) = x @ w, the same kernel,
// tile and bits as e2a_neuron_layer_train's z for the same kernel, without
// the column partials. The autograd op's backward replays the forward's
// pre-activation with it.
extern "C" int e2a_neuron_layer_train_z(const void* x, const void* w,
                                        float* z, int T, long long M, int C,
                                        int K, int packed, int kernel,
                                        int dtype, void* stream) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code =
      train_z_plan(T, M, C, K, packed, kernel, dtype, w, l, n);
  if (code != 0 || n == 0) return code;
  return by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    return launch_z(l[0], x, static_cast<const E*>(w), z, nullptr, T, M, C,
                    K, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int e2a_neuron_layer_train_z_plan(
    const void* x, const void* w, float* z, int T, long long M, int C, int K,
    int packed, int kernel, int dtype, long long* records, int cap) {
  Launch l[kMaxLaunches];
  int n = 0;
  const int code =
      train_z_plan(T, M, C, K, packed, kernel, dtype, w, l, n);
  return write_plan(code, l, n, records, cap);
}
