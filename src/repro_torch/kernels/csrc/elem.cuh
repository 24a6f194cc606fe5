// The element types of the kernels' operands: fp32 or bf16, named by the
// dtype code every entry point takes (kernels/__init__.py dtype_code).
//
// A kernel is a template on its element type E. It loads E, converts to
// fp32 (exact) and computes in fp32; rnd<E>() rounds a result to E and back
// where the reference's Pallas kernel computes in E itself (each operation
// of the LIF recursion rounds to the input's dtype), and is the identity
// for fp32, so the fp32 instance is the fp32 kernel it always was. Outputs
// are stored in E, rounded to nearest once (from_f<E>).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace e2a {

using bf16 = __nv_bfloat16;

constexpr int kFloat32 = 0;    // dtype codes of the entry points
constexpr int kBfloat16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <class E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to nearest in E, as fp32 (exact): the value an operation of the
// reference's kernel leaves in E.
template <class E>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<E>(v));
}

// Elements of E in 16 bytes: the width of one vector access.
template <class E>
constexpr int kVec = 16 / (int)sizeof(E);

// A type tag for by_dtype's callback.
template <class E>
struct Elem {
  using type = E;
};

// f(Elem<float>{}) or f(Elem<bf16>{}) by the dtype code; any other code is
// refused (cudaErrorInvalidValue), as the wrappers refuse its dtype.
template <class F>
int by_dtype(int dtype, F&& f) {
  if (dtype == kFloat32) return f(Elem<float>{});
  if (dtype == kBfloat16) return f(Elem<bf16>{});
  return (int)cudaErrorInvalidValue;
}

// The element size of a dtype code (0 for a code no kernel takes).
inline int elem_bytes(int dtype) {
  return dtype == kFloat32 ? 4 : dtype == kBfloat16 ? 2 : 0;
}

}  // namespace e2a
