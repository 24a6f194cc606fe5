// LIF SOMA forward (E2ATST eq. 11) and GRAD backward (eq. 12): one pass
// over time per element.
//
// x, s, u, mask are (T, M, D), all fp32 or all bf16 (the dtype code);
// element (t, m, d) of an operand lies at t * stride_t + m * stride_m + d
// (unit stride on d, any stride on t and m),
// so the spiking LM's (S, B, D) view of its (B, S, D) branch output is read
// and written in place. Inputs share one layout, outputs another.
//
// Replaces src/repro/kernels/lif_soma.py (_lif_fwd_kernel, _lif_bwd_kernel,
// _lif_bwd_carry_kernel). Two arms; the Python wrapper chooses one
// (lif_soma.choose_arm) and passes it, and no arm stands in for another.
//
// The ring arm: every call of more than 4 steps over fewer than 262,144
// elements (n = M * D), and every call with a carried state or a layout
// that is not contiguous; the spiking LM's (S, B, 1024) calls. One thread
// per element, so a (128, 8, 1024) call spreads over 256 blocks of 32
// threads (64 above 16,896 elements) where a thread of four elements left
// 8 blocks on 8 SMs. Each thread walks t with
// the membrane potential and the last spike (or dL/dU) in registers. Its
// input stream(s) arrive through a ring of STAGES time chunks of CHUNK steps
// in shared memory, filled by cp.async: the copies of chunk k+1 are in
// flight while chunk k is walked, so the serial recursion reads shared
// memory only and no step waits out a device-memory latency. Where a warp's
// 32 columns are one 16-byte aligned run (D % 32 == 0, strides multiples of
// 4: the LM and the Spikingformer), its lanes share the copies, 16 bytes
// each (a quarter of a cp.async per lane and step), and two __syncwarp()s a
// chunk order them; elsewhere a thread copies its own column, 4 bytes a
// step, and needs no barrier (cp.async.wait_group orders a thread's own
// copies). Outputs are written straight to device memory, one coalesced
// 4-byte store per lane and step that nothing on the recursion waits for.
// T is walked in chunks with a ragged last one. CHUNK, STAGES, the block
// sizes and the direct stores were chosen by a sweep on the H100 at the
// LM's shapes (chunks of 32-128 steps, 2-3 stages, 32 or 64 threads, and
// outputs staged through shared memory and written 16 bytes a lane, which
// was no faster). The walk is bound by the recursion, 4 (forward) or 5
// (backward) dependent fp32 operations a step, and at the LM's shapes by
// the instructions a step issues beside them (chip_smoke.py's bound_ms
// counts the chain from this kernel's SASS).
//
// The flat arm: contiguous (T, n) operands, T <= 4 or n >= 262,144, no
// carried state (the Spikingformer's (4, 196 * B, 512)): one thread per
// four neighbouring elements with 16-byte accesses (n % 4 == 0 and 16-byte
// aligned pointers), else one element a thread; each step's loads are
// issued straight from device memory. There the bytes bound the call and many
// threads hide the latency. The crossover was measured on the H100
// (benchmarks/torch/bench_lif_kernels.py; PERF.md): the flat arm is as fast
// or faster at T = 1 (the ring adds a trip through shared memory to the one
// step's load), at T = 4 with the L2 warm, and from 262,144 elements up at
// T = 1 .. 128; the ring arm faster at 65,536 elements from T = 16, and
// from T = 4 with the L2 cold.
//
// The arithmetic uses the round-to-nearest intrinsics, which the compiler
// never contracts into fused multiply-adds, so the result equals the plain
// tensor version (alpha * u * (1 - s) + x, evaluated left to right) bit for
// bit. A carried state (u0, s0), each (M, D) contiguous, enters step 0 as
// alpha * u0 * (1 - s0) + x_0, the order of core/lif.py's lif_step; the
// final (U, S) go to u_last and s_last, each (M, D), where those pointers
// are not null.
//
// The backward reads g = dL/dS, U, S and the mask (T, M, D), one layout, and
// writes dx = dL/dX in its own, walking t from T-1 down to 0 with
// dL/dU_{t+1} in registers (the ring arm stages all four input streams):
//   grad_s = g - alpha * U * gu_next
//   gu     = gu_next * alpha * (1 - S) + grad_s * mask * grad_scale
//   (+ gu_last at t = T-1, when the pointer is not null; (M, D) contiguous)
// in that order of operations, again bit for bit the plain version.
//
// bf16 (the reference's kernels at a bf16 input): U, S, the mask, the state
// and dx stay in bf16, as the Pallas kernels keep them in x.dtype, and each
// operation of the two recursions above is formed in fp32 and rounded to
// bf16 (elem.cuh rnd) in the same order, which is what the plain version's
// bf16 tensor ops do, so the bf16 arms equal it bit for bit too. The flat
// arm's 16-byte accesses carry 8 elements; the ring arm's shared lane
// copies take 8 elements a lane (D % 32 == 0, strides multiples of 8), and
// where a thread copies its own column, a 2-byte element is below
// cp.async's 4 bytes: that column is staged with plain loads instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "elem.cuh"
#include "launch_plan.cuh"
#include "spike_tile_mma.cuh"   // cp_async, cp_async_commit, cp_async_wait

namespace {

using e2a::from_f;
using e2a::kVec;
using e2a::rnd;
using e2a::to_f;
using e2a::mma::cp_async;
using e2a::mma::cp_async_commit;
using e2a::mma::cp_async_wait;

struct LifParams {
  float alpha, th_fire, th_lo, th_hi;
};

// Element (t, m, d) of an operand lies at t * Strides::t + m * Strides::m
// + d, in elements.
struct Strides {
  long long t, m;
};

// The ring: CHUNK time steps a stage, STAGES stages (STAGES - 1 chunks in
// flight while one is walked); blocks of 32 threads, or 64 where n is large.
constexpr int CHUNK = 64;
constexpr int STAGES = 2;

// u, s and mask hold values of E (rnd<E> after every operation).
template <class E>
__device__ __forceinline__ void lif_step(float x, float& u, float& s,
                                         float& mask, const LifParams& p) {
  u = rnd<E>(__fadd_rn(rnd<E>(__fmul_rn(rnd<E>(__fmul_rn(p.alpha, u)),
                                        rnd<E>(__fsub_rn(1.0f, s)))),
                       x));
  s = (u >= p.th_fire) ? 1.0f : 0.0f;
  mask = (u > p.th_lo && u < p.th_hi) ? 1.0f : 0.0f;
}

struct GradParams {
  float alpha, grad_scale;
};

template <class E>
__device__ __forceinline__ float grad_step(float g, float u, float s, float m,
                                           float gu_next,
                                           const GradParams& p) {
  const float grad_s = rnd<E>(
      __fsub_rn(g, rnd<E>(__fmul_rn(rnd<E>(__fmul_rn(p.alpha, u)), gu_next))));
  return rnd<E>(__fadd_rn(
      rnd<E>(__fmul_rn(rnd<E>(__fmul_rn(gu_next, p.alpha)),
                       rnd<E>(__fsub_rn(1.0f, s)))),
      rnd<E>(__fmul_rn(rnd<E>(__fmul_rn(grad_s, m)), p.grad_scale))));
}

// ---- the ring arm ----

// Copies `steps` time steps of one input stream into ring rows 0 .. steps-1
// (NT elements apart), step c from src + c * step. WIDE: the warp's 32
// columns are one 16-byte aligned run at every step, so `dst` and `src` are
// the warp's first column and lane l copies the 16 bytes (V = 4 fp32 or
// 8 bf16 elements) l % (32 / V) of rows l / (32 / V), + V, ... (V / 32 of a
// copy per lane and step). Else a thread copies its own column: 4 bytes a
// step by cp.async for fp32, a plain load and store for a 2-byte element.
template <int NT, int C, bool WIDE, class E>
__device__ __forceinline__ void fill(E* dst, const E* src, long long step,
                                     int steps, int lane) {
  if constexpr (WIDE) {
    constexpr int V = kVec<E>, LANES_A_ROW = 32 / V;
    const int q = (lane % LANES_A_ROW) * V, r = lane / LANES_A_ROW;
    if (steps == C) {
#pragma unroll
      for (int j = 0; j < C; j += V)
        cp_async<16>(dst + (j + r) * NT + q, src + (j + r) * step + q);
    } else {
      for (int c = r; c < steps; c += V)
        cp_async<16>(dst + c * NT + q, src + c * step + q);
    }
  } else if constexpr (sizeof(E) == 4) {
    if (steps == C) {
#pragma unroll
      for (int c = 0; c < C; ++c) cp_async<4>(dst + c * NT, src + c * step);
    } else {
      for (int c = 0; c < steps; ++c) cp_async<4>(dst + c * NT, src + c * step);
    }
  } else {
    for (int c = 0; c < steps; ++c) dst[c * NT] = src[c * step];
  }
}

// Rows a stage holds, and the stages that a walk over T steps fills.
__host__ __device__ inline int ring_rows(int T, int C) { return T < C ? T : C; }
__host__ __device__ inline int ring_stages(int T, int C, int S) {
  const int chunks = (T + C - 1) / C;
  return chunks < S ? chunks : S;
}

// Chunk k of the forward holds steps k*C .. k*C + rows - 1 in ring rows
// 0 .. rows - 1 of stage k % S; every thread commits one group per chunk
// index, empty past the last chunk, so wait<S - 1> means "chunk k landed".
// WIDE needs d % 32 == 0 (a warp's columns lie in one row), strides that are
// multiples of 16 bytes and 16-byte aligned operands; then whole warps are
// in or out of range and the __syncwarp()s order the lanes' copies and
// reads.
template <int NT, int C, int S, bool WIDE, class E>
__global__ void __launch_bounds__(NT) lif_fwd_ring(
    const E* __restrict__ x, E* __restrict__ s, E* __restrict__ u,
    E* __restrict__ mask, const E* __restrict__ u0,
    const E* __restrict__ s0, E* __restrict__ u_last,
    E* __restrict__ s_last, long long n, int d, int T, Strides in,
    Strides out, LifParams p) {
  extern __shared__ float4 smem[];
  E* const ring = reinterpret_cast<E*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long i = (long long)blockIdx.x * NT + tid;
  if (i >= n) return;
  const long long row = i / d, col = i - row * d;
  const int own = WIDE ? lane : 0;    // lanes before this one in its copies
  const E* xi = x + row * in.m + col - own;
  const int rows = ring_rows(T, C), chunks = (T + C - 1) / C;
  const int stage = rows * NT;
  auto issue = [&](int k) {
    if (k < chunks)
      fill<NT, C, WIDE>(ring + (k % S) * stage + tid - own,
                        xi + (long long)k * C * in.t, in.t,
                        min(C, T - k * C), lane);
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);

  float uu = u0 != nullptr ? to_f(u0[i]) : 0.0f;
  float ss = s0 != nullptr ? to_f(s0[i]) : 0.0f;
  float mm;
  long long at = row * out.m + col;
  for (int k = 0; k < chunks; ++k) {
    if (WIDE) __syncwarp();    // the warp is done with the stage refilled
    issue(k + S - 1);
    cp_async_wait<S - 1>();
    if (WIDE) __syncwarp();    // the warp's copies of chunk k have landed
    const E* src = ring + (k % S) * stage + tid;
    const int steps = min(C, T - k * C);
    auto walk = [&](int c) {
      lif_step<E>(to_f(src[c * NT]), uu, ss, mm, p);
      s[at] = from_f<E>(ss);
      u[at] = from_f<E>(uu);
      mask[at] = from_f<E>(mm);
      at += out.t;
    };
    if (steps == C) {
#pragma unroll
      for (int c = 0; c < C; ++c) walk(c);
    } else {
      for (int c = 0; c < steps; ++c) walk(c);
    }
  }
  if (u_last != nullptr) {
    u_last[i] = from_f<E>(uu);
    s_last[i] = from_f<E>(ss);
  }
}

// The backward's chunk k holds steps T-1-k*C down to T-k*C-rows in rows
// 0 .. rows-1 of each of the four streams (g, U, S, mask) of stage k % S.
template <int NT, int C, int S, bool WIDE, class E>
__global__ void __launch_bounds__(NT) lif_bwd_ring(
    const E* __restrict__ g, const E* __restrict__ u,
    const E* __restrict__ s, const E* __restrict__ mask,
    const E* __restrict__ gu_last, E* __restrict__ dx, long long n,
    int d, int T, Strides in, Strides out, GradParams p) {
  extern __shared__ float4 smem[];
  E* const ring = reinterpret_cast<E*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long i = (long long)blockIdx.x * NT + tid;
  if (i >= n) return;
  const long long row = i / d, col = i - row * d;
  const int own = WIDE ? lane : 0;
  const long long base = row * in.m + col - own + (long long)(T - 1) * in.t;
  const E* const streams[4] = {g + base, u + base, s + base, mask + base};
  const int rows = ring_rows(T, C), chunks = (T + C - 1) / C;
  const int plane = rows * NT, stage = 4 * plane;
  auto issue = [&](int k) {
    if (k < chunks) {
      const int steps = min(C, T - k * C);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fill<NT, C, WIDE>(ring + (k % S) * stage + q * plane + tid - own,
                          streams[q] - (long long)k * C * in.t, -in.t, steps,
                          lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) issue(k);

  float gu = 0.0f;
  long long at = row * out.m + col + (long long)(T - 1) * out.t;
  for (int k = 0; k < chunks; ++k) {
    if (WIDE) __syncwarp();
    issue(k + S - 1);
    cp_async_wait<S - 1>();
    if (WIDE) __syncwarp();
    const E* src = ring + (k % S) * stage + tid;
    const int steps = min(C, T - k * C);
    auto walk = [&](int c) {
      gu = grad_step<E>(to_f(src[c * NT]), to_f(src[plane + c * NT]),
                        to_f(src[2 * plane + c * NT]),
                        to_f(src[3 * plane + c * NT]), gu, p);
      if (c == 0 && k == 0 && gu_last != nullptr)
        gu = rnd<E>(__fadd_rn(gu, to_f(gu_last[i])));
      dx[at] = from_f<E>(gu);
      at -= out.t;
    };
    if (steps == C) {
#pragma unroll
      for (int c = 0; c < C; ++c) walk(c);
    } else {
      for (int c = 0; c < steps; ++c) walk(c);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Whether the ring arm may copy 16 bytes a lane: a warp's 32 columns in one
// row, strides that keep rows 16-byte aligned (multiples of `vec`
// elements), and aligned operands.
bool wide_layout(int d, Strides in, Strides out, int vec,
                 std::initializer_list<const void*> ptrs) {
  if (d % 32 != 0 || in.t % vec != 0 || in.m % vec != 0 ||
      out.t % vec != 0 || out.m % vec != 0)
    return false;
  for (const void* q : ptrs)
    if (q != nullptr && !aligned16(q)) return false;
  return true;
}

// Which kernel a Launch record of this file is for: the ring arm's block
// size and copy width (RING32 + 1 is RING32_WIDE, RING64 + 1 RING64_WIDE),
// or the flat arm's access width (FLAT_VEC: 16 bytes a thread).
enum Kernel { RING32, RING32_WIDE, RING64, RING64_WIDE, FLAT_VEC, FLAT1 };

// One launch of the ring arm: 32 threads a block while that leaves at most
// four warps to each of the 132 SMs (n <= 16,896), so the grid spreads over
// as many SMs as n allows; 64 above. Its shared memory holds the ring of
// each of `streams` input streams, of `esize`-byte elements.
e2a::Launch ring_plan(long long n, int T, int streams, bool wide, int esize) {
  const int nt = n <= 32LL * 4 * 132 ? 32 : 64;
  const long long smem = (long long)ring_rows(T, CHUNK) * nt * esize *
                         ring_stages(T, CHUNK, STAGES) * streams;
  e2a::Launch l = e2a::launch_of(nt, 1, smem,
                                 (nt == 64 ? RING64 : RING32) + (wide ? 1 : 0));
  return e2a::axis(l, 0, e2a::cdiv(n, nt), nt, n);
}

// The shared memory depends on T, so the limit is raised at every launch
// that needs it.
template <template <int, int, int, bool, class> class K, int NT, bool WIDE,
          class E, typename... Args>
int launch_ring_as(const e2a::Launch& l, cudaStream_t st, Args... args) {
  auto kernel = K<NT, CHUNK, STAGES, WIDE, E>::kernel;
  const int err =
      e2a::raise_smem(l, reinterpret_cast<const void*>(kernel));
  if (err != 0) return err;
  kernel<<<e2a::grid_of(l), e2a::block_of(l), l.smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int NT, int C, int S, bool WIDE, class E>
struct FwdRing {
  static constexpr auto kernel = lif_fwd_ring<NT, C, S, WIDE, E>;
};
template <int NT, int C, int S, bool WIDE, class E>
struct BwdRing {
  static constexpr auto kernel = lif_bwd_ring<NT, C, S, WIDE, E>;
};

template <template <int, int, int, bool, class> class K, class E,
          typename... Args>
int launch_ring(const e2a::Launch& l, cudaStream_t st, Args... args) {
  switch (l.kernel) {
    case RING32: return launch_ring_as<K, 32, false, E>(l, st, args...);
    case RING32_WIDE: return launch_ring_as<K, 32, true, E>(l, st, args...);
    case RING64: return launch_ring_as<K, 64, false, E>(l, st, args...);
    default: return launch_ring_as<K, 64, true, E>(l, st, args...);
  }
}

// ---- the flat arms ----

// 16 bytes of elements: one vector access of the flat arm.
template <class E>
struct alignas(16) Vec16 {
  E v[kVec<E>];
};

template <class E>
__global__ void __launch_bounds__(256) lif_fwd_vec(
    const Vec16<E>* __restrict__ x, Vec16<E>* __restrict__ s,
    Vec16<E>* __restrict__ u, Vec16<E>* __restrict__ mask, long long nv,
    int T, LifParams p) {
  constexpr int V = kVec<E>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  float uu[V] = {}, ss[V] = {}, mm[V];
  for (int t = 0; t < T; ++t) {
    const long long at = (long long)t * nv + i;
    const Vec16<E> xv = x[at];
    Vec16<E> so, uo, mo;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      lif_step<E>(to_f(xv.v[j]), uu[j], ss[j], mm[j], p);
      so.v[j] = from_f<E>(ss[j]);
      uo.v[j] = from_f<E>(uu[j]);
      mo.v[j] = from_f<E>(mm[j]);
    }
    s[at] = so;
    u[at] = uo;
    mask[at] = mo;
  }
}

template <class E>
__global__ void __launch_bounds__(256) lif_fwd_scalar(
    const E* __restrict__ x, E* __restrict__ s, E* __restrict__ u,
    E* __restrict__ mask, long long n, int T, LifParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float uu = 0.0f, ss = 0.0f, mm;
  for (int t = 0; t < T; ++t) {
    const long long at = (long long)t * n + i;
    lif_step<E>(to_f(x[at]), uu, ss, mm, p);
    s[at] = from_f<E>(ss);
    u[at] = from_f<E>(uu);
    mask[at] = from_f<E>(mm);
  }
}

template <class E>
__global__ void __launch_bounds__(256) lif_bwd_vec(
    const Vec16<E>* __restrict__ g, const Vec16<E>* __restrict__ u,
    const Vec16<E>* __restrict__ s, const Vec16<E>* __restrict__ mask,
    const Vec16<E>* __restrict__ gu_last, Vec16<E>* __restrict__ dx,
    long long nv, int T, GradParams p) {
  constexpr int V = kVec<E>;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nv) return;
  float gu[V] = {};
  for (int t = T - 1; t >= 0; --t) {
    const long long at = (long long)t * nv + i;
    const Vec16<E> gv = g[at], uv = u[at], sv = s[at], mv = mask[at];
    Vec16<E> out;
#pragma unroll
    for (int j = 0; j < V; ++j)
      gu[j] = grad_step<E>(to_f(gv.v[j]), to_f(uv.v[j]), to_f(sv.v[j]),
                           to_f(mv.v[j]), gu[j], p);
    if (t == T - 1 && gu_last != nullptr) {
      const Vec16<E> c = gu_last[i];
#pragma unroll
      for (int j = 0; j < V; ++j)
        gu[j] = rnd<E>(__fadd_rn(gu[j], to_f(c.v[j])));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) out.v[j] = from_f<E>(gu[j]);
    dx[at] = out;
  }
}

template <class E>
__global__ void __launch_bounds__(256) lif_bwd_scalar(
    const E* __restrict__ g, const E* __restrict__ u,
    const E* __restrict__ s, const E* __restrict__ mask,
    const E* __restrict__ gu_last, E* __restrict__ dx, long long n,
    int T, GradParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float gu = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const long long at = (long long)t * n + i;
    gu = grad_step<E>(to_f(g[at]), to_f(u[at]), to_f(s[at]), to_f(mask[at]),
                      gu, p);
    if (t == T - 1 && gu_last != nullptr)
      gu = rnd<E>(__fadd_rn(gu, to_f(gu_last[i])));
    dx[at] = from_f<E>(gu);
  }
}

// The flat arms take (T, n) operands with n = M * D contiguous and the
// steps n apart, in and out, and no carried state.
bool flat_layout(long long m, int d, int T, Strides in, Strides out) {
  const long long n = m * d;
  return (m == 1 || (in.m == d && out.m == d)) &&
         (T == 1 || (in.t == n && out.t == n));
}

constexpr int ARM_FLAT = 1, ARM_RING = 2;
constexpr int BAD_ARM = (int)cudaErrorInvalidValue;

// The flat arms: 256 threads a block, 16 bytes of elements a thread
// (FLAT_VEC: `vec` elements) or one.
e2a::Launch flat_plan(long long n, bool v, int vec) {
  const int threads = 256;
  const long long per_block = v ? (long long)vec * threads : threads;
  e2a::Launch l = e2a::launch_of(threads, 1, 0, v ? FLAT_VEC : FLAT1);
  return e2a::axis(l, 0, e2a::cdiv(n, per_block), per_block, n);
}

// The one launch of each entry point on its arm (none for an empty call).
// Each returns a cudaError_t.
int fwd_plan(const void* x, const void* s, const void* u, const void* mask,
             const void* u0, const void* s0, const void* u_last,
             const void* s_last, long long m, int d, int T, Strides in,
             Strides out, int arm, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  const int esize = e2a::elem_bytes(dtype);
  if (esize == 0) return BAD_ARM;
  const int vec = 16 / esize;
  const long long nn = m * d;
  if (nn <= 0 || T <= 0) return 0;
  if (arm == ARM_RING) {
    l[n++] = ring_plan(nn, T, 1,
                       wide_layout(d, in, out, vec, {x, s, u, mask}), esize);
    return 0;
  }
  if (arm != ARM_FLAT || u0 != nullptr || s0 != nullptr ||
      u_last != nullptr || s_last != nullptr ||
      !flat_layout(m, d, T, in, out))
    return BAD_ARM;
  l[n++] = flat_plan(nn, nn % vec == 0 && aligned16(x) && aligned16(s) &&
                             aligned16(u) && aligned16(mask), vec);
  return 0;
}

int bwd_plan(const void* g, const void* u, const void* s, const void* mask,
             const void* gu_last, const void* dx, long long m, int d, int T,
             Strides in, Strides out, int arm, int dtype, e2a::Launch* l,
             int& n) {
  n = 0;
  const int esize = e2a::elem_bytes(dtype);
  if (esize == 0) return BAD_ARM;
  const int vec = 16 / esize;
  const long long nn = m * d;
  if (nn <= 0 || T <= 0) return 0;
  if (arm == ARM_RING) {
    l[n++] = ring_plan(nn, T, 4,
                       wide_layout(d, in, out, vec, {g, u, s, mask, dx}),
                       esize);
    return 0;
  }
  if (arm != ARM_FLAT || !flat_layout(m, d, T, in, out)) return BAD_ARM;
  l[n++] = flat_plan(nn, nn % vec == 0 && aligned16(g) && aligned16(u) &&
                             aligned16(s) && aligned16(mask) &&
                             aligned16(dx) &&
                             (gu_last == nullptr || aligned16(gu_last)),
                     vec);
  return 0;
}

}  // namespace

// arm: 1 flat, 2 ring (the wrapper's rule, kernels/lif_soma.py choose_arm());
// dtype: 0 fp32, 1 bf16, the type of every operand.
extern "C" int e2a_lif_soma_fwd(const void* x, void* s, void* u, void* mask,
                                const void* u0, const void* s0, void* u_last,
                                void* s_last, long long m, int d, int T,
                                long long in_t, long long in_m,
                                long long out_t, long long out_m, float alpha,
                                float th_fire, float th_lo, float th_hi,
                                int arm, int dtype, void* stream) {
  const Strides in = {in_t, in_m}, out = {out_t, out_m};
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, s, u, mask, u0, s0, u_last, s_last, m, d, T,
                            in, out, arm, dtype, l, n);
  if (code != 0 || n == 0) return code;
  const long long nn = m * d;
  const LifParams p = {alpha, th_fire, th_lo, th_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if (arm == ARM_RING)
      return launch_ring<FwdRing, E>(
          l[0], st, static_cast<const E*>(x), static_cast<E*>(s),
          static_cast<E*>(u), static_cast<E*>(mask),
          static_cast<const E*>(u0), static_cast<const E*>(s0),
          static_cast<E*>(u_last), static_cast<E*>(s_last), nn, d, T, in,
          out, p);
    if (l[0].kernel == FLAT_VEC)
      lif_fwd_vec<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
          static_cast<const Vec16<E>*>(x), static_cast<Vec16<E>*>(s),
          static_cast<Vec16<E>*>(u), static_cast<Vec16<E>*>(mask),
          nn / kVec<E>, T, p);
    else
      lif_fwd_scalar<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
          static_cast<const E*>(x), static_cast<E*>(s), static_cast<E*>(u),
          static_cast<E*>(mask), nn, T, p);
    return (int)cudaGetLastError();
  });
}

extern "C" int e2a_lif_soma_fwd_plan(const void* x, void* s, void* u,
                                     void* mask, const void* u0,
                                     const void* s0, void* u_last,
                                     void* s_last, long long m, int d, int T,
                                     long long in_t, long long in_m,
                                     long long out_t, long long out_m,
                                     float alpha, float th_fire, float th_lo,
                                     float th_hi, int arm, int dtype,
                                     long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, s, u, mask, u0, s0, u_last, s_last, m, d, T,
                            {in_t, in_m}, {out_t, out_m}, arm, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

extern "C" int e2a_lif_soma_bwd(const void* g, const void* u, const void* s,
                                const void* mask, const void* gu_last,
                                void* dx, long long m, int d, int T,
                                long long in_t, long long in_m,
                                long long out_t, long long out_m, float alpha,
                                float grad_scale, int arm, int dtype,
                                void* stream) {
  const Strides in = {in_t, in_m}, out = {out_t, out_m};
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, u, s, mask, gu_last, dx, m, d, T, in, out,
                            arm, dtype, l, n);
  if (code != 0 || n == 0) return code;
  const long long nn = m * d;
  const GradParams p = {alpha, grad_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    using E = typename decltype(tag)::type;
    if (arm == ARM_RING)
      return launch_ring<BwdRing, E>(
          l[0], st, static_cast<const E*>(g), static_cast<const E*>(u),
          static_cast<const E*>(s), static_cast<const E*>(mask),
          static_cast<const E*>(gu_last), static_cast<E*>(dx), nn, d, T, in,
          out, p);
    if (l[0].kernel == FLAT_VEC)
      lif_bwd_vec<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
          static_cast<const Vec16<E>*>(g), static_cast<const Vec16<E>*>(u),
          static_cast<const Vec16<E>*>(s),
          static_cast<const Vec16<E>*>(mask),
          static_cast<const Vec16<E>*>(gu_last),
          static_cast<Vec16<E>*>(dx), nn / kVec<E>, T, p);
    else
      lif_bwd_scalar<E><<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
          static_cast<const E*>(g), static_cast<const E*>(u),
          static_cast<const E*>(s), static_cast<const E*>(mask),
          static_cast<const E*>(gu_last), static_cast<E*>(dx), nn, T, p);
    return (int)cudaGetLastError();
  });
}

extern "C" int e2a_lif_soma_bwd_plan(const void* g, const void* u,
                                     const void* s, const void* mask,
                                     const void* gu_last, void* dx,
                                     long long m, int d, int T, long long in_t,
                                     long long in_m, long long out_t,
                                     long long out_m, float alpha,
                                     float grad_scale, int arm, int dtype,
                                     long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, u, s, mask, gu_last, dx, m, d, T,
                            {in_t, in_m}, {out_t, out_m}, arm, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
