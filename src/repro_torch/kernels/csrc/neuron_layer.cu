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
