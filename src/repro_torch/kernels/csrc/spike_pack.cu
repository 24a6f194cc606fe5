// Spike pack: (..., C) {0,1} in fp32 or bf16 -> (..., C/8) uint8, least
// significant bit first along C, in one pass.
//
//   out[r][b] = sum_{e=0..7} (x[r][8b + e] != 0) << e
//
// Replaces no TPU kernel of its own: the reference packs inside the
// functions that reach pallas_call (spike_pack at
// src/repro/kernels/spike_matmul.py:24, a jnp sum that XLA fuses), and this
// is the pack of every packed arm of the port (the spike matmul's row of
// kernels/__init__.py KERNELS, of which it is an entry point). It took the
// place of three ATen launches (a cast of the whole input to fp32, an fp32
// matrix-vector product with the bit weights, a cast to uint8), which read
// a bf16 input once and wrote and read it again as fp32.
//
// What bounds it: bytes. It reads each spike once in its own dtype (2 or 4
// bytes) and writes one byte per eight, so an H100 at 3.35 TB/s takes at
// least (elements * (size + 1/8)) / 3.35e12 seconds; it does no arithmetic
// worth counting.
//
// Design. The output is the flat (rows * P) byte array, P = C / 8, which
// every consumer reads contiguously. A warp owns tiles of kTileBytes = 256
// consecutive output bytes (grid-stride over tiles, so 200,704 rows of
// the first tokenizer stage's patches never meet a grid.y limit): in step
// k = 0..7 lane l forms byte 32k + l of the tile from its eight elements.
// Neighbouring lanes thus read neighbouring 16 (bf16) or 32 (fp32) bytes,
// a warp's step reads 512 or 1,024 contiguous bytes where a row is that
// long, and all eight steps' loads are issued before any is used (8 or 16
// 16-byte loads in flight per thread). Each lane's eight bytes go through
// shared memory (a byte store per step, one __syncwarp) so that lane l then
// holds bytes 8l .. 8l+7 of the tile and stores them as one 8-byte word: a
// warp's store is 256 contiguous bytes. Row boundaries cost nothing beyond
// the address of a byte's elements, so any P works (C = 520 gives 65), and
// a lane finds its row and byte once a tile by one division, then steps
// 32 bytes a time, carrying into the leading dims.
//
// Two paths, one kernel template (kVec): the vector path loads a byte's
// elements as one (bf16) or two (fp32) 16-byte vectors and needs a unit
// stride along C, a 16-byte aligned base and leading strides that keep
// every row start 16-byte aligned; the scalar path loads each element
// alone at any strides and alignment. kernels/spike_matmul.py pack_path
// picks the path and passes its code; this entry refuses a code it cannot
// take (the vector path on a layout that breaks its alignment), never
// choosing for itself.
//
// A bit is set where the element is nonzero (its bits other than the sign
// are not all 0): on {0,1} spikes, the contract, that is the reference's
// byte; -0 packs as 0.
#include <stdint.h>

#include "elem.cuh"
#include "launch_plan.cuh"

namespace {

constexpr int kThreads = 256;              // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 256;            // output bytes a warp's tile
constexpr int kSteps = kTileBytes / 32;    // bytes a lane forms a tile
constexpr long long kMaxBlocks = 2048;     // grid cap; blocks stride beyond
constexpr long long kMaxBytes = 0x7FFFFFFF;   // 32-bit tile arithmetic

// Path codes (kernels/spike_matmul.py PACK_VECTOR, PACK_SCALAR).
constexpr int kPathVector = 1;
constexpr int kPathScalar = 2;

// The raw bits of an element type and the mask of its bits but the sign.
template <class E>
struct Bits;
template <>
struct Bits<float> {
  using type = uint32_t;
  static constexpr uint32_t kMag = 0x7FFFFFFFu;
};
template <>
struct Bits<e2a::bf16> {
  using type = uint16_t;
  static constexpr uint32_t kMag = 0x7FFFu;
};

struct Args {
  const unsigned char* x;   // the input's first element, as bytes
  uint8_t* out;             // (rows * P) bytes, contiguous
  unsigned d0, d1, d2;      // leading dims, d2 innermost (rows = d0*d1*d2)
  unsigned P;               // output bytes a row, C / 8
  unsigned n;               // output bytes in all
  long long s0, s1, s2, sc; // element strides of the three dims and of C
};

// Bit e of a byte from the eight elements at p, p + sc, ... (scalar path).
template <class E>
__device__ __forceinline__ uint32_t byte_scalar(const unsigned char* p,
                                                long long sc) {
  using B = typename Bits<E>::type;
  uint32_t b = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const B v = *reinterpret_cast<const B*>(p + e * sc * (long long)sizeof(E));
    b |= (uint32_t)(((uint32_t)v & Bits<E>::kMag) != 0u) << e;
  }
  return b;
}

// 16-byte vectors a byte's elements span: 1 of bf16, 2 of fp32.
template <class E>
constexpr int kVecs = (int)(8 * sizeof(E) / 16);

// The byte of eight contiguous elements loaded as 16-byte vectors: four
// 32-bit words of two bf16 each (element 2i in the low half of word i), or
// eight fp32 words.
template <class E>
__device__ __forceinline__ uint32_t vec_byte(const uint4 (&v)[kVecs<E>]);
template <>
__device__ __forceinline__ uint32_t vec_byte<e2a::bf16>(const uint4 (&v)[1]) {
  const uint32_t w[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b |= (uint32_t)((w[i] & 0x7FFFu) != 0u) << (2 * i);
    b |= (uint32_t)((w[i] & 0x7FFF0000u) != 0u) << (2 * i + 1);
  }
  return b;
}
template <>
__device__ __forceinline__ uint32_t vec_byte<float>(const uint4 (&v)[2]) {
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                         v[1].x, v[1].y, v[1].z, v[1].w};
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    b |= (uint32_t)((w[i] & 0x7FFFFFFFu) != 0u) << i;
  return b;
}

template <class E, bool kVec>
__global__ void __launch_bounds__(kThreads)
    spike_pack_kernel(const Args a) {
  __shared__ __align__(8) uint8_t stage[kWarps][kTileBytes];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned tiles = (a.n + kTileBytes - 1) / kTileBytes;
  const long long esz = (long long)sizeof(E);
  const long long step2 = a.s2 * esz, step1 = a.s1 * esz,
                  step0 = a.s0 * esz;
  for (unsigned tile = blockIdx.x * kWarps + warp; tile < tiles;
       tile += gridDim.x * kWarps) {
    const unsigned j0 = tile * kTileBytes + lane;
    // this lane's row (i0, i1, i2) and byte b of the row at step 0
    unsigned row = j0 / a.P, b = j0 - row * a.P;
    unsigned i2 = row, i1 = 0, i0 = 0;
    if (a.d0 * a.d1 != 1) {
      i2 = row % a.d2;
      const unsigned q = row / a.d2;
      i1 = q % a.d1;
      i0 = q / a.d1;
    }
    long long off = i0 * step0 + i1 * step1 + i2 * step2;   // bytes
    const unsigned char* src[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      src[k] = a.x + off + (long long)b * 8 * a.sc * esz;
      b += 32;                  // the lane's next byte, 32 further on
      while (b >= a.P) {        // carried into the next row
        b -= a.P;
        off += step2;
        if (++i2 == a.d2) {
          i2 = 0;
          off += step1 - a.d2 * step2;
          if (++i1 == a.d1) {
            i1 = 0;
            off += step0 - a.d1 * step1;
          }
        }
      }
    }
    uint32_t bytes[kSteps];
    if constexpr (kVec) {
      uint4 v[kSteps][kVecs<E>];
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        if (j0 + 32u * k < a.n)
#pragma unroll
          for (int h = 0; h < kVecs<E>; ++h)
            v[k][h] = __ldg(reinterpret_cast<const uint4*>(src[k]) + h);
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        bytes[k] = j0 + 32u * k < a.n ? vec_byte<E>(v[k]) : 0u;
    } else {
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        bytes[k] = j0 + 32u * k < a.n ? byte_scalar<E>(src[k], a.sc) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) stage[warp][32 * k + lane] = bytes[k];
    __syncwarp();
    const unsigned first = tile * kTileBytes + 8 * lane;
    const uint2 word = *reinterpret_cast<const uint2*>(&stage[warp][8 * lane]);
    if (first + 8 <= a.n) {
      *reinterpret_cast<uint2*>(a.out + first) = word;
    } else {
      const uint8_t* w8 = &stage[warp][8 * lane];
      for (unsigned i = 0; first + i < a.n && i < 8; ++i)
        a.out[first + i] = w8[i];
    }
    __syncwarp();               // the stage is rewritten by the next tile
  }
}

// The launch of a call of n output bytes: blocks of 8 warps, each warp a
// tile of 256 bytes, the grid capped at kMaxBlocks (its blocks then stride).
e2a::Launch pack_plan(long long n, int kernel) {
  e2a::Launch l = e2a::launch_of(kThreads, 1, 0, kernel);
  const long long per_block = (long long)kWarps * kTileBytes;
  const long long blocks = e2a::cdiv(n, per_block);
  const bool capped = blocks > kMaxBlocks;
  return e2a::axis(l, 0, capped ? kMaxBlocks : blocks, per_block, n, capped);
}

// Whether the vector path can read the layout: unit stride along C, the
// base and every row start 16-byte aligned.
bool vector_suits(const void* x, long long d0, long long d1, long long d2,
                  long long s0, long long s1, long long s2, long long sc,
                  int esz) {
  if (sc != 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return false;
  const long long dims[3] = {d0, d1, d2}, strides[3] = {s0, s1, s2};
  for (int i = 0; i < 3; ++i)
    if (dims[i] > 1 && (strides[i] * esz) % 16 != 0) return false;
  return true;
}

// The launches of e2a_spike_pack (none for an empty input); `kernel` in
// the record is the path code. Returns a cudaError_t.
int plan(const void* x, const void* out, long long d0, long long d1,
         long long d2, int C, long long s0, long long s1, long long s2,
         long long sc, int path, int dtype, e2a::Launch* l, int& n) {
  n = 0;
  const int esz = e2a::elem_bytes(dtype);
  if (esz == 0 || C <= 0 || C % 8 != 0 || d0 < 0 || d1 < 0 || d2 < 0 ||
      (path != kPathVector && path != kPathScalar))
    return (int)cudaErrorInvalidValue;
  const long long rows = d0 * d1 * d2;
  if (rows == 0) return 0;
  const long long bytes = rows * (C / 8);
  if (bytes > kMaxBytes || reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (path == kPathVector &&
      !vector_suits(x, d0, d1, d2, s0, s1, s2, sc, esz))
    return (int)cudaErrorInvalidValue;
  l[n++] = pack_plan(bytes, path);
  return 0;
}

template <class E>
int launch(const Args& a, const e2a::Launch& l, cudaStream_t stream) {
  if (l.kernel == kPathVector)
    spike_pack_kernel<E, true><<<e2a::grid_of(l), e2a::block_of(l), 0,
                                 stream>>>(a);
  else
    spike_pack_kernel<E, false><<<e2a::grid_of(l), e2a::block_of(l), 0,
                                  stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the spikes, (d0, d1, d2, C) at element strides (s0, s1, s2, sc), fp32
// or bf16 by dtype (0 fp32, 1 bf16); out: (d0 * d1 * d2, C / 8) uint8,
// contiguous, 8-byte aligned. path: 1 vector, 2 scalar (spike_matmul.py
// pack_path). A leading dim of 1 may carry any stride.
extern "C" int e2a_spike_pack(const void* x, uint8_t* out, long long d0,
                              long long d1, long long d2, int C, long long s0,
                              long long s1, long long s2, long long sc,
                              int path, int dtype, void* stream) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code =
      plan(x, out, d0, d1, d2, C, s0, s1, s2, sc, path, dtype, l, n);
  if (code != 0 || n == 0) return code;
  const Args a = {static_cast<const unsigned char*>(x), out,
                  (unsigned)d0, (unsigned)d1, (unsigned)d2,
                  (unsigned)(C / 8), (unsigned)(d0 * d1 * d2 * (C / 8)),
                  s0, s1, s2, sc};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return e2a::by_dtype(dtype, [&](auto tag) {
    return launch<typename decltype(tag)::type>(a, l[0], s);
  });
}

extern "C" int e2a_spike_pack_plan(const void* x, uint8_t* out, long long d0,
                                   long long d1, long long d2, int C,
                                   long long s0, long long s1, long long s2,
                                   long long sc, int path, int dtype,
                                   long long* records, int cap) {
  e2a::Launch l[e2a::kMaxLaunches];
  int n = 0;
  const int code =
      plan(x, out, d0, d1, d2, C, s0, s1, s2, sc, path, dtype, l, n);
  return e2a::write_plan(code, l, n, records, cap);
}
