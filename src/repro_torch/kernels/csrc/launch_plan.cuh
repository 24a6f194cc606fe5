// The launches an entry point makes, as data.
//
// Every extern "C" entry point computes its launches with a host function
// that fills Launch records (grid, block, dynamic shared memory, whether the
// launcher raises the 48 KB limit first, and per grid axis what a block
// covers of the output), then launches from those records. Its twin,
// e2a_<entry>_plan, takes the entry's arguments without the stream and
// writes the same records to an int64 array without launching anything
// (write_plan): the launch and the report of it come from one function and
// cannot drift apart. repro_torch.analysis.contracts checks the reports
// against the card's limits (grid, threads, shared memory) and against the
// output extents (coverage, no block wholly outside).
#pragma once

#include <cuda_runtime.h>

namespace e2a {

// One launch. Along grid axis a: grid[a] blocks, each covering tile[a]
// elements of an output extent of extent[a] (tile 0: the axis does not cut
// the output); strided[a] where the grid was capped and the blocks stride
// over the axis. kernel tells the launcher which of its kernels (or
// template instances) the record is for.
struct Launch {
  long long grid[3];
  int block[3];
  long long smem;
  int opt_in;
  long long tile[3];
  long long extent[3];
  int strided[3];
  int kernel;
};

// Fields of one record in the plan array, and the most records an entry
// point makes (kernels/build.py: PLAN_FIELDS, MAX_LAUNCHES).
constexpr int kPlanFields = 18;
constexpr int kMaxLaunches = 4;
constexpr long long kSmemDefault = 48 * 1024;   // above: opt-in first

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// A record of a block of bx x by threads; axes set with axis().
inline Launch launch_of(int bx, int by = 1, long long smem = 0,
                        int kernel = 0) {
  Launch l = {};
  l.grid[0] = l.grid[1] = l.grid[2] = 1;
  l.block[0] = bx;
  l.block[1] = by;
  l.block[2] = 1;
  l.smem = smem;
  l.opt_in = smem > kSmemDefault;
  l.kernel = kernel;
  return l;
}

// Sets axis a: `blocks` blocks of `tile` elements over `extent`.
inline Launch& axis(Launch& l, int a, long long blocks, long long tile,
                    long long extent, bool strided = false) {
  l.grid[a] = blocks;
  l.tile[a] = tile;
  l.extent[a] = extent;
  l.strided[a] = strided ? 1 : 0;
  return l;
}

inline dim3 grid_of(const Launch& l) {
  return dim3((unsigned)l.grid[0], (unsigned)l.grid[1], (unsigned)l.grid[2]);
}

inline dim3 block_of(const Launch& l) {
  return dim3((unsigned)l.block[0], (unsigned)l.block[1],
              (unsigned)l.block[2]);
}

// A launch's dynamic shared memory above 48 KB must be asked for. Asks only
// where the record says so. `raised`, where given, is the launcher's record
// (kMaxDevices flags) for one kernel whose shared memory never changes: it
// then asks once per device. A repeat of the request is harmless, so a race
// between two host threads costs nothing. Returns a cudaError_t.
constexpr int kMaxDevices = 64;

inline int raise_smem(const Launch& l, const void* kernel,
                      bool* raised = nullptr) {
  if (!l.opt_in) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const bool once = raised != nullptr && dev < kMaxDevices;
  if (once && raised[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  if (once) raised[dev] = true;
  return 0;
}

// The plan array of an entry point's twin: the n records of `l` when `code`
// is 0, kPlanFields each; returns n, or -code where the entry point would
// refuse the call (and -cudaErrorInvalidValue past `cap` records).
inline int write_plan(int code, const Launch* l, int n, long long* out,
                      int cap) {
  if (code != 0) return -code;
  if (n > cap) return -(int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    long long* o = out + (long long)i * kPlanFields;
    for (int a = 0; a < 3; ++a) {
      o[a] = l[i].grid[a];
      o[3 + a] = l[i].block[a];
      o[8 + a] = l[i].tile[a];
      o[11 + a] = l[i].extent[a];
      o[14 + a] = l[i].strided[a];
    }
    o[6] = l[i].smem;
    o[7] = l[i].opt_in;
    o[17] = l[i].kernel;
  }
  return n;
}

}  // namespace e2a
