// LIF SOMA forward (E2ATST eq. 11): one pass over time per element.
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
