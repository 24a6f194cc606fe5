// LIF SOMA forward (E2ATST eq. 11) and GRAD backward (eq. 12): one pass
// over time per element.
//
// x, s, u, mask are (T, M, D) fp32; element (t, m, d) of an operand lies at
// t * stride_t + m * stride_m + d (unit stride on d, any stride on t and m),
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
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "launch_plan.cuh"
#include "spike_tile_mma.cuh"   // cp_async, cp_async_commit, cp_async_wait

namespace {

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

__device__ __forceinline__ void lif_step(float x, float& u, float& s,
                                         float& mask, const LifParams& p) {
  u = __fadd_rn(__fmul_rn(__fmul_rn(p.alpha, u), __fsub_rn(1.0f, s)), x);
  s = (u >= p.th_fire) ? 1.0f : 0.0f;
  mask = (u > p.th_lo && u < p.th_hi) ? 1.0f : 0.0f;
}

struct GradParams {
  float alpha, grad_scale;
};

__device__ __forceinline__ float grad_step(float g, float u, float s, float m,
                                           float gu_next,
                                           const GradParams& p) {
  const float grad_s = __fsub_rn(g, __fmul_rn(__fmul_rn(p.alpha, u), gu_next));
  return __fadd_rn(__fmul_rn(__fmul_rn(gu_next, p.alpha), __fsub_rn(1.0f, s)),
                   __fmul_rn(__fmul_rn(grad_s, m), p.grad_scale));
}

// ---- the ring arm ----

// Copies `steps` time steps of one input stream into ring rows 0 .. steps-1
// (NT floats apart), step c from src + c * step. WIDE: the warp's 32 columns
// are one 16-byte aligned run at every step, so `dst` and `src` are the
// warp's first column and lane l copies the 16 bytes l % 8 of rows l / 8,
// l / 8 + 4, ... (a quarter of a copy per lane and step). Else a thread
// copies its own column, 4 bytes a step.
template <int NT, int C, bool WIDE>
__device__ __forceinline__ void fill(float* dst, const float* src,
                                     long long step, int steps, int lane) {
  if (WIDE) {
    const int q = (lane & 7) * 4, r = lane >> 3;
    if (steps == C) {
#pragma unroll
      for (int j = 0; j < C; j += 4)
        cp_async<16>(dst + (j + r) * NT + q, src + (j + r) * step + q);
    } else {
      for (int c = r; c < steps; c += 4)
        cp_async<16>(dst + c * NT + q, src + c * step + q);
    }
  } else if (steps == C) {
#pragma unroll
    for (int c = 0; c < C; ++c) cp_async<4>(dst + c * NT, src + c * step);
  } else {
    for (int c = 0; c < steps; ++c) cp_async<4>(dst + c * NT, src + c * step);
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
// multiples of 4 and 16-byte aligned operands; then whole warps are in or
// out of range and the __syncwarp()s order the lanes' copies and reads.
template <int NT, int C, int S, bool WIDE>
__global__ void __launch_bounds__(NT) lif_fwd_ring(
    const float* __restrict__ x, float* __restrict__ s, float* __restrict__ u,
    float* __restrict__ mask, const float* __restrict__ u0,
    const float* __restrict__ s0, float* __restrict__ u_last,
    float* __restrict__ s_last, long long n, int d, int T, Strides in,
    Strides out, LifParams p) {
  extern __shared__ float4 smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long i = (long long)blockIdx.x * NT + tid;
  if (i >= n) return;
  const long long row = i / d, col = i - row * d;
  const int own = WIDE ? lane : 0;    // lanes before this one in its copies
  const float* xi = x + row * in.m + col - own;
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

  float uu = u0 != nullptr ? u0[i] : 0.0f;
  float ss = s0 != nullptr ? s0[i] : 0.0f;
  float mm;
  long long at = row * out.m + col;
  for (int k = 0; k < chunks; ++k) {
    if (WIDE) __syncwarp();    // the warp is done with the stage refilled
    issue(k + S - 1);
    cp_async_wait<S - 1>();
    if (WIDE) __syncwarp();    // the warp's copies of chunk k have landed
    const float* src = ring + (k % S) * stage + tid;
    const int steps = min(C, T - k * C);
    auto walk = [&](int c) {
      lif_step(src[c * NT], uu, ss, mm, p);
      s[at] = ss;
      u[at] = uu;
      mask[at] = mm;
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
    u_last[i] = uu;
    s_last[i] = ss;
  }
}

// The backward's chunk k holds steps T-1-k*C down to T-k*C-rows in rows
// 0 .. rows-1 of each of the four streams (g, U, S, mask) of stage k % S.
template <int NT, int C, int S, bool WIDE>
__global__ void __launch_bounds__(NT) lif_bwd_ring(
    const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ s, const float* __restrict__ mask,
    const float* __restrict__ gu_last, float* __restrict__ dx, long long n,
    int d, int T, Strides in, Strides out, GradParams p) {
  extern __shared__ float4 smem[];
  float* const ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const long long i = (long long)blockIdx.x * NT + tid;
  if (i >= n) return;
  const long long row = i / d, col = i - row * d;
  const int own = WIDE ? lane : 0;
  const long long base = row * in.m + col - own + (long long)(T - 1) * in.t;
  const float* const streams[4] = {g + base, u + base, s + base, mask + base};
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
    const float* src = ring + (k % S) * stage + tid;
    const int steps = min(C, T - k * C);
    auto walk = [&](int c) {
      gu = grad_step(src[c * NT], src[plane + c * NT], src[2 * plane + c * NT],
                     src[3 * plane + c * NT], gu, p);
      if (c == 0 && k == 0 && gu_last != nullptr)
        gu = __fadd_rn(gu, gu_last[i]);
      dx[at] = gu;
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
// row, strides that keep rows 16-byte aligned, and aligned operands.
bool wide_layout(int d, Strides in, Strides out,
                 std::initializer_list<const void*> ptrs) {
  if (d % 32 != 0 || in.t % 4 != 0 || in.m % 4 != 0 || out.t % 4 != 0 ||
      out.m % 4 != 0)
    return false;
  for (const void* q : ptrs)
    if (q != nullptr && !aligned16(q)) return false;
  return true;
}

// Which kernel a Launch record of this file is for: the ring arm's block
// size and copy width (RING32 + 1 is RING32_WIDE, RING64 + 1 RING64_WIDE),
// or the flat arm's access width.
enum Kernel { RING32, RING32_WIDE, RING64, RING64_WIDE, FLAT4, FLAT1 };

// One launch of the ring arm: 32 threads a block while that leaves at most
// four warps to each of the 132 SMs (n <= 16,896), so the grid spreads over
// as many SMs as n allows; 64 above. Its shared memory holds the ring of
// each of `streams` input streams.
e2a::Launch ring_plan(long long n, int T, int streams, bool wide) {
  const int nt = n <= 32LL * 4 * 132 ? 32 : 64;
  const long long smem = (long long)ring_rows(T, CHUNK) * nt * sizeof(float) *
                         ring_stages(T, CHUNK, STAGES) * streams;
  e2a::Launch l = e2a::launch_of(nt, 1, smem,
                                 (nt == 64 ? RING64 : RING32) + (wide ? 1 : 0));
  return e2a::axis(l, 0, e2a::cdiv(n, nt), nt, n);
}

// The shared memory depends on T, so the limit is raised at every launch
// that needs it.
template <template <int, int, int, bool> class K, int NT, bool WIDE,
          typename... Args>
int launch_ring_as(const e2a::Launch& l, cudaStream_t st, Args... args) {
  auto kernel = K<NT, CHUNK, STAGES, WIDE>::kernel;
  const int err =
      e2a::raise_smem(l, reinterpret_cast<const void*>(kernel));
  if (err != 0) return err;
  kernel<<<e2a::grid_of(l), e2a::block_of(l), l.smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int NT, int C, int S, bool WIDE>
struct FwdRing {
  static constexpr auto kernel = lif_fwd_ring<NT, C, S, WIDE>;
};
template <int NT, int C, int S, bool WIDE>
struct BwdRing {
  static constexpr auto kernel = lif_bwd_ring<NT, C, S, WIDE>;
};

template <template <int, int, int, bool> class K, typename... Args>
int launch_ring(const e2a::Launch& l, cudaStream_t st, Args... args) {
  switch (l.kernel) {
    case RING32: return launch_ring_as<K, 32, false>(l, st, args...);
    case RING32_WIDE: return launch_ring_as<K, 32, true>(l, st, args...);
    case RING64: return launch_ring_as<K, 64, false>(l, st, args...);
    default: return launch_ring_as<K, 64, true>(l, st, args...);
  }
}

// ---- the flat arms ----

__global__ void __launch_bounds__(256) lif_fwd_vec4(
    const float4* __restrict__ x, float4* __restrict__ s,
    float4* __restrict__ u, float4* __restrict__ mask, long long n4, int T,
    LifParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float uu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ss[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float mm[4];
  for (int t = 0; t < T; ++t) {
    const long long at = (long long)t * n4 + i;
    const float4 xv = x[at];
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) lif_step(xr[j], uu[j], ss[j], mm[j], p);
    s[at] = make_float4(ss[0], ss[1], ss[2], ss[3]);
    u[at] = make_float4(uu[0], uu[1], uu[2], uu[3]);
    mask[at] = make_float4(mm[0], mm[1], mm[2], mm[3]);
  }
}

__global__ void __launch_bounds__(256) lif_fwd_scalar(
    const float* __restrict__ x, float* __restrict__ s, float* __restrict__ u,
    float* __restrict__ mask, long long n, int T, LifParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float uu = 0.0f, ss = 0.0f, mm;
  for (int t = 0; t < T; ++t) {
    const long long at = (long long)t * n + i;
    lif_step(x[at], uu, ss, mm, p);
    s[at] = ss;
    u[at] = uu;
    mask[at] = mm;
  }
}

__global__ void __launch_bounds__(256) lif_bwd_vec4(
    const float4* __restrict__ g, const float4* __restrict__ u,
    const float4* __restrict__ s, const float4* __restrict__ mask,
    const float4* __restrict__ gu_last, float4* __restrict__ dx, long long n4,
    int T, GradParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float gu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = T - 1; t >= 0; --t) {
    const long long at = (long long)t * n4 + i;
    const float4 gv = g[at], uv = u[at], sv = s[at], mv = mask[at];
    const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
    const float ur[4] = {uv.x, uv.y, uv.z, uv.w};
    const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
    const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) gu[j] = grad_step(gr[j], ur[j], sr[j], mr[j], gu[j], p);
    if (t == T - 1 && gu_last != nullptr) {
      const float4 c = gu_last[i];
      gu[0] = __fadd_rn(gu[0], c.x);
      gu[1] = __fadd_rn(gu[1], c.y);
      gu[2] = __fadd_rn(gu[2], c.z);
      gu[3] = __fadd_rn(gu[3], c.w);
    }
    dx[at] = make_float4(gu[0], gu[1], gu[2], gu[3]);
  }
}

__global__ void __launch_bounds__(256) lif_bwd_scalar(
    const float* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ s, const float* __restrict__ mask,
    const float* __restrict__ gu_last, float* __restrict__ dx, long long n,
    int T, GradParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float gu = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const long long at = (long long)t * n + i;
    gu = grad_step(g[at], u[at], s[at], mask[at], gu, p);
    if (t == T - 1 && gu_last != nullptr) gu = __fadd_rn(gu, gu_last[i]);
    dx[at] = gu;
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

// The flat arms: 256 threads a block, four elements a thread (FLAT4) or
// one.
e2a::Launch flat_plan(long long n, bool v4) {
  const int threads = 256;
  const long long per_block = v4 ? 4LL * threads : threads;
  e2a::Launch l = e2a::launch_of(threads, 1, 0, v4 ? FLAT4 : FLAT1);
  return e2a::axis(l, 0, e2a::cdiv(n, per_block), per_block, n);
}

// The one launch of each entry point on its arm (none for an empty call).
// Each returns a cudaError_t.
int fwd_plan(const float* x, const float* s, const float* u,
             const float* mask, const float* u0, const float* s0,
             const float* u_last, const float* s_last, long long m, int d,
             int T, Strides in, Strides out, int arm, e2a::Launch* l,
             int& n) {
  n = 0;
  const long long nn = m * d;
  if (nn <= 0 || T <= 0) return 0;
  if (arm == ARM_RING) {
    l[n++] = ring_plan(nn, T, 1, wide_layout(d, in, out, {x, s, u, mask}));
    return 0;
  }
  if (arm != ARM_FLAT || u0 != nullptr || s0 != nullptr ||
      u_last != nullptr || s_last != nullptr ||
      !flat_layout(m, d, T, in, out))
    return BAD_ARM;
  l[n++] = flat_plan(nn, nn % 4 == 0 && aligned16(x) && aligned16(s) &&
                             aligned16(u) && aligned16(mask));
  return 0;
}

int bwd_plan(const float* g, const float* u, const float* s,
             const float* mask, const float* gu_last, const float* dx,
             long long m, int d, int T, Strides in, Strides out, int arm,
             e2a::Launch* l, int& n) {
  n = 0;
  const long long nn = m * d;
  if (nn <= 0 || T <= 0) return 0;
  if (arm == ARM_RING) {
    l[n++] = ring_plan(nn, T, 4,
                       wide_layout(d, in, out, {g, u, s, mask, dx}));
    return 0;
  }
  if (arm != ARM_FLAT || !flat_layout(m, d, T, in, out)) return BAD_ARM;
  l[n++] = flat_plan(nn, nn % 4 == 0 && aligned16(g) && aligned16(u) &&
                             aligned16(s) && aligned16(mask) &&
                             aligned16(dx) &&
                             (gu_last == nullptr || aligned16(gu_last)));
  return 0;
}

}  // namespace

// arm: 1 flat, 2 ring (the wrapper's rule, kernels/lif_soma.py choose_arm()).
extern "C" int e2a_lif_soma_fwd(const float* x, float* s, float* u,
                                float* mask, const float* u0, const float* s0,
                                float* u_last, float* s_last, long long m,
                                int d, int T, long long in_t, long long in_m,
                                long long out_t, long long out_m, float alpha,
                                float th_fire, float th_lo, float th_hi,
                                int arm, void* stream) {
  const Strides in = {in_t, in_m}, out = {out_t, out_m};
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, s, u, mask, u0, s0, u_last, s_last, m, d, T,
                            in, out, arm, l, n);
  if (code != 0 || n == 0) return code;
  const long long nn = m * d;
  const LifParams p = {alpha, th_fire, th_lo, th_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arm == ARM_RING)
    return launch_ring<FwdRing>(l[0], st, x, s, u, mask, u0, s0, u_last,
                                s_last, nn, d, T, in, out, p);
  if (l[0].kernel == FLAT4)
    lif_fwd_vec4<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(s),
        reinterpret_cast<float4*>(u), reinterpret_cast<float4*>(mask),
        nn / 4, T, p);
  else
    lif_fwd_scalar<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        x, s, u, mask, nn, T, p);
  return (int)cudaGetLastError();
}

extern "C" int e2a_lif_soma_fwd_plan(const float* x, float* s, float* u,
                                     float* mask, const float* u0,
                                     const float* s0, float* u_last,
                                     float* s_last, long long m, int d, int T,
                                     long long in_t, long long in_m,
                                     long long out_t, long long out_m,
                                     float alpha, float th_fire, float th_lo,
                                     float th_hi, int arm,
                                     long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = fwd_plan(x, s, u, mask, u0, s0, u_last, s_last, m, d, T,
                            {in_t, in_m}, {out_t, out_m}, arm, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}

extern "C" int e2a_lif_soma_bwd(const float* g, const float* u, const float* s,
                                const float* mask, const float* gu_last,
                                float* dx, long long m, int d, int T,
                                long long in_t, long long in_m,
                                long long out_t, long long out_m, float alpha,
                                float grad_scale, int arm, void* stream) {
  const Strides in = {in_t, in_m}, out = {out_t, out_m};
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, u, s, mask, gu_last, dx, m, d, T, in, out,
                            arm, l, n);
  if (code != 0 || n == 0) return code;
  const long long nn = m * d;
  const GradParams p = {alpha, grad_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arm == ARM_RING)
    return launch_ring<BwdRing>(l[0], st, g, u, s, mask, gu_last, dx, nn, d,
                                T, in, out, p);
  if (l[0].kernel == FLAT4)
    lif_bwd_vec4<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(u),
        reinterpret_cast<const float4*>(s),
        reinterpret_cast<const float4*>(mask),
        reinterpret_cast<const float4*>(gu_last),
        reinterpret_cast<float4*>(dx), nn / 4, T, p);
  else
    lif_bwd_scalar<<<e2a::grid_of(l[0]), e2a::block_of(l[0]), 0, st>>>(
        g, u, s, mask, gu_last, dx, nn, T, p);
  return (int)cudaGetLastError();
}

extern "C" int e2a_lif_soma_bwd_plan(const float* g, const float* u,
                                     const float* s, const float* mask,
                                     const float* gu_last, float* dx,
                                     long long m, int d, int T, long long in_t,
                                     long long in_m, long long out_t,
                                     long long out_m, float alpha,
                                     float grad_scale, int arm,
                                     long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code = bwd_plan(g, u, s, mask, gu_last, dx, m, d, T,
                            {in_t, in_m}, {out_t, out_m}, arm, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
