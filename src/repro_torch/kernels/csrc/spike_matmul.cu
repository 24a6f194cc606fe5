// Bit-packed spike matmul on the tensor cores, 2-D and batched, one kernel.
//
//   out[g][m][n] = sum_c bit(packed[g][m], c) * w[g][c][n]
//
// Replaces the reference's two TPU kernels, _spike_mm_kernel
// (src/repro/kernels/spike_matmul.py:80, spike_matmul_packed) and
// _spike_bmm_kernel (:139, spike_matmul_packed_batched). packed is uint8
// with 8 contraction indices per byte, least significant bit first; w and
// out are fp32. The batch index g = g1 * G2 + g2 has two levels
// (blockIdx.z = g), and every operand comes with element strides for g1,
// g2 and its two matrix dims, so a transposed K^T or attn^T, a per-head
// slice of a (T*B, N, h*dh) tensor or a weight shared by all batches
// (stride 0) is read where it lies and never copied.
//
// Why the result is fp32: a spike is exactly 0 or 1 in bf16, and each
// fp32 weight is split once, when its chunk is staged, into three bf16
// planes with w == hi + mid + lo exactly (split_bf16x3 in
// spike_tile_mma.cuh). Every product on the tensor cores is then exact,
// but the sums are not rounded as fp32 FMAs round them: an MMA truncates
// the sum it adds to where an FMA rounds to nearest. The hi plane's MMAs
// add into one fp32 accumulator, the mid and lo planes' into a second,
// small one, because most of the bits an MMA would cut from the large sum
// are the small planes'; the two are added, rounded to nearest, at the
// end. So the result differs from an fp32 product in the order of the sums
// and in the truncation of each; where every partial sum is exact in fp32
// (integer and dyadic weights) it gives the same bits.
//
// bf16 (the reference's kernels at a bf16 weight: the spikes unpacked to
// bf16, the dot accumulated in fp32, the output in the weight's dtype): w
// and out are then bf16; the dtype code names the type of both. Three
// kernels take it. Tile 3 is spike_wgmma.cuh's, designed for Hopper (a TMA
// ring of weight tiles, wgmma with the spikes expanded in registers); the
// wrapper's rule names it for more than 512 rows and a weight TMA can read.
// Tile 4 is spike_heads.cuh's, designed for the bytes of small per-batch
// products (whole output rows of a batch a unit, stored by one bulk copy);
// the rule names it for such a weight at 512 rows or fewer, C <= 128 and
// K <= 256 (attn_qk's per-head Q K^T). Every other bf16 call runs the
// mainloop below with the weight as its own single plane
// (spike_mma_mainloop.cuh, Planes): one MMA per fragment and k16 step. All
// three add exact bf16 products into fp32 accumulators and round each
// result to bf16 once, in the epilogue.
//
// Design: the contraction loop is mainloop() of spike_mma_mainloop.cuh,
// shared with the train-mode neuron layer (spike_tile_mma.cuh has the
// fragment mapping and the layouts); this file adds the batch offsets and
// the epilogue, float2 stores along out's unit-stride axis. Two tiles, the
// caller names one (spike_matmul.py chooses from M unless a tuned table
// says otherwise): Large (256 x 64 outputs, 16 warps, BK = 128) for the
// projection sites (M = T*B*N rows): a block's split of a weight chunk
// serves 256 rows; Small (128 x 64, 8 warps, BK = 64) for per-head
// matrices (M <= 512, e.g. 196 x 196 at attn_qk: 60 of 256 rows masked).
// Both walk the contraction in the same k16 steps in the same order, so a
// product's bits do not depend on the tile.
// Half as many rows per block ran 10-15 % slower at the model's shapes
// (benchmarks/torch/bench_spike_matmul.py; PERF.md, section 6).
// What bounds it: at pssa.proj and smlp.b three dense bf16 passes, 3 * 2MCK
// operations at the tensor cores' rate; at attn_qk (C = 64) the bytes of
// the K^T operand and of out.
#include "launch_plan.cuh"
#include "spike_mma_mainloop.cuh"
#include "spike_heads.cuh"
#include "spike_wgmma.cuh"

namespace {

using namespace e2a::mma;

struct BatchStrides {
  long long g1, g2, row, col;   // two batch levels, then the two matrix dims
};

template <class E>
struct Args {
  const uint8_t* x;
  const E* w;
  E* out;
  int G2, M, C, K;
  BatchStrides xs, ws, os;      // x: (row, byte); w: (c, n); out: (m, n)
};

// Two neighbouring outputs of E in one store (8 bytes of fp32, 4 of bf16).
__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(e2a::bf16* o, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(o) = bf16x2_rn(v0, v1);
}

template <class T, class E>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    spike_mma_kernel(const Args<E> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g1 = blockIdx.z / a.G2, g2 = blockIdx.z % a.G2;
  E* const out = a.out + g1 * a.os.g1 + g2 * a.os.g2;
  const long long m0 = (long long)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const Operands<E> ops = {a.x + g1 * a.xs.g1 + g2 * a.xs.g2, a.xs.row,
                           a.xs.col, a.w + g1 * a.ws.g1 + g2 * a.ws.g2,
                           a.ws.row, a.ws.col, a.M, a.C, a.K};
  Acc<T> acc;
  mainloop<T>(ops, m0, n0, smem, acc);

  // ---- epilogue ----
  const Lane<T> L;
  const int K = a.K;
  const long long o_m = a.os.row, o_n = a.os.col;
  const bool vec2 = o_n == 1 && o_m % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (2 * sizeof(E)) == 0;
#pragma unroll
  for (int mt = 0; mt < T::WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + L.wm0 + mt * 16 + L.g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < T::WN; ++nt) {
        const int col = n0 + L.wn0 + nt * 8 + 2 * L.t;
        const float v0 = result(acc[0][mt][nt][2 * h], acc[1][mt][nt][2 * h]);
        const float v1 = result(acc[0][mt][nt][2 * h + 1],
                                acc[1][mt][nt][2 * h + 1]);
        E* const o = out + row * o_m + col * o_n;
        if (vec2 && col + 1 < K) {
          store2(o, v0, v1);
        } else {
          if (col < K) o[0] = e2a::from_f<E>(v0);
          if (col + 1 < K) o[o_n] = e2a::from_f<E>(v1);
        }
      }
    }
}

// The one launch of tile T: blocks of BM rows x BN columns, one batch a
// grid.z index, the shared memory of `planes` weight planes.
template <class T>
e2a::Launch tile_plan(int M, int K, long long G, int kernel, int planes) {
  e2a::Launch l = e2a::launch_of(T::THREADS, 1, T::smem(planes), kernel);
  e2a::axis(l, 0, e2a::cdiv(M, T::BM), T::BM, M);
  e2a::axis(l, 1, e2a::cdiv(K, T::BN), T::BN, K);
  return e2a::axis(l, 2, G, 1, G);
}

template <class T, class E>
int launch(const Args<E>& a, const e2a::Launch& l, cudaStream_t stream) {
  static bool raised[e2a::kMaxDevices] = {};
  const int err = e2a::raise_smem(
      l, reinterpret_cast<const void*>(spike_mma_kernel<T, E>), raised);
  if (err != 0) return err;
  spike_mma_kernel<T, E><<<e2a::grid_of(l), e2a::block_of(l), l.smem,
                           stream>>>(a);
  return (int)cudaGetLastError();
}

// One call's shape and element strides, as the entry points take them.
struct Call {
  int G1, G2, M, C, K;
  long long p_g1, p_g2, p_m, p_b, w_g1, w_g2, w_c, w_k, o_g1, o_g2, o_m, o_k;
};

// The launches of e2a_spike_matmul (none for an empty output). tma_ok:
// e2a::wg::tma_suits of the weight; tiles 3 and 4 are refused without it
// and at any dtype but bf16, tile 4 also outside spike_heads.cuh's limits
// (e2a::hd::suits). Returns a cudaError_t.
int plan(const Call& c, int tile, int dtype, bool tma_ok, e2a::Launch* l,
         int& n) {
  n = 0;
  const int planes = planes_of(dtype);
  if (planes == 0) return (int)cudaErrorInvalidValue;
  if (c.G1 <= 0 || c.G2 <= 0 || c.M <= 0 || c.K <= 0) return 0;
  const long long G = (long long)c.G1 * c.G2;
  if (G > 65535 || c.C < 0 || c.C % 8 != 0 || tile < 1 || tile > 4)
    return (int)cudaErrorInvalidValue;
  if (tile >= 3) {
    if (dtype != e2a::kBfloat16 || !tma_ok) return (int)cudaErrorInvalidValue;
    if (tile == 4 && !e2a::hd::suits(c.C, c.K, tma_ok, c.o_m, c.o_k))
      return (int)cudaErrorInvalidValue;
    const int err =
        tile == 3 ? e2a::wg::wgmma_plan<e2a::wg::Wide>(c.M, c.K, G, 3, l[0])
                  : e2a::hd::heads_plan(c.M, c.C, c.K, G,
                                        c.w_k == 1 && c.w_c * 2 % 16 == 0, 4,
                                        l[0]);
    if (err == 0) n = 1;
    return err;
  }
  l[n++] = tile == 2 ? tile_plan<Small>(c.M, c.K, G, 2, planes)
                     : tile_plan<Large>(c.M, c.K, G, 1, planes);
  return 0;
}

// For the wgmma kernel: a weight shared by every batch (zero batch
// strides) whose packed rows and outputs run on from one batch into the
// next is one product of G1 * G2 * M rows (the tokenizer's im2col
// patches, 4 x 3,136 rows: 392 tiles of 128 rows, not 4 x 25 of which
// the last are half empty).
void fold_shared_weight(Call& c) {
  const long long rows = (long long)c.G1 * c.G2 * c.M;
  const bool level2 = c.G2 == 1 || (c.w_g2 == 0 && c.p_g2 == c.M * c.p_m &&
                                    c.o_g2 == c.M * c.o_m);
  const bool level1 =
      c.G1 == 1 || (c.w_g1 == 0 && c.p_g1 == (long long)c.G2 * c.M * c.p_m &&
                    c.o_g1 == (long long)c.G2 * c.M * c.o_m);
  if (rows == c.M || rows > 0x7FFFFFFF || !level1 || !level2) return;
  c.M = (int)rows;
  c.G1 = c.G2 = 1;
}

// The plan of a call (the wgmma kernel's on the folded shape).
int plan_call(Call& c, const void* w, int tile, int dtype, e2a::Launch* l,
              int& n) {
  if (tile == 3) fold_shared_weight(c);
  return plan(c, tile, dtype,
              e2a::wg::tma_suits(w, c.G1, c.G2, c.C, c.K, c.w_g1, c.w_g2,
                                 c.w_c, c.w_k),
              l, n);
}

}  // namespace

// tile picks the kernel: 1 Large, 2 Small (the autotuner times both; a
// tuned table passes its winner), 3 the bf16 wgmma kernel of
// spike_wgmma.cuh (spike_matmul.py's rule names it for a bf16 weight TMA
// can read, at more than 512 rows), 4 the bf16 kernel of spike_heads.cuh
// (the rule's choice for such a weight at 512 rows or fewer, C <= 128,
// K <= 256). dtype: 0 fp32, 1 bf16, the type of w and out.
extern "C" int e2a_spike_matmul(
    const uint8_t* packed, const void* w, void* out, int G1, int G2, int M,
    int C, int K, long long p_g1, long long p_g2, long long p_m,
    long long p_b, long long w_g1, long long w_g2, long long w_c,
    long long w_k, long long o_g1, long long o_g2, long long o_m,
    long long o_k, int tile, int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  Call c = {G1,   G2,   M,    C,    K,    p_g1, p_g2, p_m, p_b,
            w_g1, w_g2, w_c,  w_k,  o_g1, o_g2, o_m,  o_k};
  const int code = plan_call(c, w, tile, dtype, l, n);
  if (code != 0 || n == 0) return code;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l[0].kernel == 3) {
    const e2a::wg::Args a = {packed, static_cast<e2a::bf16*>(out),
                             c.G1 * c.G2, c.G2, c.M, c.C, c.K,
                             c.p_g1, c.p_g2, c.p_m, c.p_b,
                             c.o_g1, c.o_g2, c.o_m, c.o_k,
                             0, 0, 0, 0, 0, 0, 0};
    return e2a::wg::launch<e2a::wg::Wide>(
        a, static_cast<const e2a::bf16*>(w), c.G1, c.w_g1, c.w_g2, c.w_c,
        c.w_k, l[0], s);
  }
  if (l[0].kernel == 4) {
    const e2a::hd::Args a = {packed, static_cast<e2a::bf16*>(out),
                             c.G1 * c.G2, c.G2, c.M, c.C, c.K,
                             c.p_g1, c.p_g2, c.p_m, c.p_b, c.o_g1, c.o_g2,
                             0, 0, 0, 0, 0, 0, 0};
    return e2a::hd::launch(a, static_cast<const e2a::bf16*>(w), c.G1, c.w_g1,
                           c.w_g2, c.w_c, c.w_k, l[0], s);
  }
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    const Args<E> a = {packed, static_cast<const E*>(w), static_cast<E*>(out),
                       G2, M, C, K,
                       {p_g1, p_g2, p_m, p_b}, {w_g1, w_g2, w_c, w_k},
                       {o_g1, o_g2, o_m, o_k}};
    return l[0].kernel == 2 ? launch<Small>(a, l[0], s)
                            : launch<Large>(a, l[0], s);
  });
}

extern "C" int e2a_spike_matmul_plan(const uint8_t* packed, const void* w,
                                     void* out, int G1, int G2, int M, int C,
                                     int K, long long p_g1, long long p_g2,
                                     long long p_m, long long p_b,
                                     long long w_g1, long long w_g2,
                                     long long w_c, long long w_k,
                                     long long o_g1, long long o_g2,
                                     long long o_m, long long o_k, int tile,
                                     int dtype, long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  Call c = {G1,   G2,   M,    C,    K,    p_g1, p_g2, p_m, p_b,
            w_g1, w_g2, w_c,  w_k,  o_g1, o_g2, o_m,  o_k};
  const int code = plan_call(c, w, tile, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
