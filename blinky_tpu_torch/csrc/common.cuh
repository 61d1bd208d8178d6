// Helpers shared by the kernels (remap_gather.cu, remap_lut.cu, sol.cu,
// ingest.cu, resample.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blinky {

constexpr int kThreads = 256;

// The two out-of-range rules of blinky_tpu's gathers, kept apart on purpose:
//  * clip (fill == 0): jnp.take(..., mode="clip") in remap_gather_impl and
//    host_remap -- the row index is clamped to [0, rows - 1];
//  * fill (fill != 0): jnp.take without a mode in remap_impl -- an index in
//    [-rows, 0) wraps once, anything else reads the dtype's fill value
//    (all bits set: 255 for u8).  Returns -1 for "fill".
__device__ __forceinline__ long long resolve_row(int i, long long rows, int fill) {
  if (!fill) return i < 0 ? 0 : (i >= rows ? rows - 1 : (long long)i);
  long long r = i < 0 ? (long long)i + rows : (long long)i;
  return (r < 0 || r >= rows) ? -1 : r;
}

// A pixel's output row is `per_pixel` work items (vectors or elements).
// Short rows pack several pixels into one block step; a row longer than the
// block is walked by the whole block.  Host and device agree on the split.
__host__ __device__ __forceinline__ int pixels_per_step(int per_pixel) {
  return per_pixel >= kThreads ? 1 : kThreads / per_pixel;
}

// Blocks for a block-stride loop over `steps` block steps: at most one wave
// of `per_sm` resident blocks on every SM (by default 2048 threads per SM),
// at least one block.
inline int wave_blocks(long long steps, int per_sm = 2048 / kThreads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long cap = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (steps < 1) steps = 1;
  return (int)(steps < cap ? steps : cap);
}

}  // namespace blinky
