// LIF SOMA forward (E2ATST eq. 11) and GRAD backward (eq. 12): one pass
// over time per element.
//
// x, s, u, mask are (T, n) fp32 with n = M * D contiguous. A thread owns
// VEC neighbouring elements and walks t with the membrane potential and the
// last spike in registers, so x is read once and S, U and the surrogate mask
// are written once: the kernel is bound by those 4 * T * n * 4 bytes. VEC = 4
// moves 16 bytes per access and needs n % 4 == 0 and 16-byte aligned
// pointers; VEC = 1 serves every other shape.
//
// The arithmetic uses the round-to-nearest intrinsics, which the compiler
// never contracts into fused multiply-adds, so the result equals the plain
// tensor version (alpha * u * (1 - s) + x, evaluated left to right) bit for
// bit.
//
// The backward reads g = dL/dS, U, S and the mask (T, n) and writes
// dx = dL/dX (T, n), walking t from T-1 down to 0 with dL/dU_{t+1} in
// registers (5 * T * n * 4 bytes; gu_last adds n * 4):
//   grad_s = g - alpha * U * gu_next
//   gu     = gu_next * alpha * (1 - S) + grad_s * mask * grad_scale
//   (+ gu_last at t = T-1, when the pointer is not null)
// in that order of operations, again bit for bit the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct LifParams {
  float alpha, th_fire, th_lo, th_hi;
};

__device__ __forceinline__ void lif_step(float x, float& u, float& s,
                                         float& mask, const LifParams& p) {
  u = __fadd_rn(__fmul_rn(__fmul_rn(p.alpha, u), __fsub_rn(1.0f, s)), x);
  s = (u >= p.th_fire) ? 1.0f : 0.0f;
  mask = (u > p.th_lo && u < p.th_hi) ? 1.0f : 0.0f;
}

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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int e2a_lif_soma_fwd(const float* x, float* s, float* u,
                                float* mask, long long n, int T, float alpha,
                                float th_fire, float th_lo, float th_hi,
                                void* stream) {
  if (n <= 0 || T <= 0) return 0;
  const LifParams p = {alpha, th_fire, th_lo, th_hi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n % 4 == 0 && aligned16(x) && aligned16(s) && aligned16(u) &&
      aligned16(mask)) {
    const long long n4 = n / 4;
    const unsigned blocks = (unsigned)((n4 + threads - 1) / threads);
    lif_fwd_vec4<<<blocks, threads, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(s),
        reinterpret_cast<float4*>(u), reinterpret_cast<float4*>(mask), n4, T, p);
  } else {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    lif_fwd_scalar<<<blocks, threads, 0, st>>>(x, s, u, mask, n, T, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int e2a_lif_soma_bwd(const float* g, const float* u, const float* s,
                                const float* mask, const float* gu_last,
                                float* dx, long long n, int T, float alpha,
                                float grad_scale, void* stream) {
  if (n <= 0 || T <= 0) return 0;
  const GradParams p = {alpha, grad_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n % 4 == 0 && aligned16(g) && aligned16(u) && aligned16(s) &&
      aligned16(mask) && aligned16(dx) &&
      (gu_last == nullptr || aligned16(gu_last))) {
    const long long n4 = n / 4;
    const unsigned blocks = (unsigned)((n4 + threads - 1) / threads);
    lif_bwd_vec4<<<blocks, threads, 0, st>>>(
        reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(u),
        reinterpret_cast<const float4*>(s),
        reinterpret_cast<const float4*>(mask),
        reinterpret_cast<const float4*>(gu_last),
        reinterpret_cast<float4*>(dx), n4, T, p);
  } else {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    lif_bwd_scalar<<<blocks, threads, 0, st>>>(g, u, s, mask, gu_last, dx, n,
                                               T, p);
  }
  return (int)cudaGetLastError();
}
