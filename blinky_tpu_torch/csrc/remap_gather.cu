// K1: the static remap's row gather, written for Hopper (sm_90a).
//
// Replaces blinky_tpu/kernels/remap.py::remap_gather_impl (remap.py:88) and,
// with a tint, remap_gather_tint_impl + apply_tint_rgba (remap.py:109, :140).
// It also serves remap_impl (remap.py:56) when neither its tint LUT nor its
// RGB decode is asked for, with remap_impl's fill rule for out-of-range rows.
//
//   out[p, :] = valid[p] ? src[row(idx[p]), :] : bg[p]      src [rows, B]
//
// What bounds it on the card: bytes.  Per screen pixel it reads a 4-byte
// index, a 1-byte mask and the background, then one source row of B texels
// (B * itemsize bytes, batch innermost), and writes the same number of bytes:
// about 2 * B * itemsize bytes moved per index and no arithmetic to speak of.
// The rows land anywhere in the source, so each index is one scattered read
// of a contiguous row.
//
// What the design does about it: a pixel's row is cut into 16-byte vectors
// when B * itemsize is a multiple of 16 and both pointers are 16-byte
// aligned, else into single texels.  Neighbouring threads take neighbouring
// vectors of one row, then of the next pixel's row, so every warp reads and
// writes contiguous runs.  The per-pixel index, mask and background are read
// once per thread and pixel.  The true-color tint runs on the gathered texels
// in registers, so a tinted render moves no more bytes than a plain one.

#include "common.cuh"
#include "tint.cuh"

namespace {

using blinky::kThreads;
using blinky::splat;
using blinky::tint;  // tint.cuh: the tint's one copy, shared with K10 and K12

// Vec: what one thread moves at a time (uint4 = 16 bytes, or one texel).
// ELEM: the texel's size in bytes (1 = u8 palette index, 4 = packed RGBA).
template <typename Vec, int ELEM>
__global__ void __launch_bounds__(kThreads) remap_gather_kernel(
    const Vec* __restrict__ src, long long rows, int per_pixel,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const void* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, int fill, long long npix,
    Vec* __restrict__ out) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int local = per_pixel >= kThreads ? 0 : (int)threadIdx.x / per_pixel;
  const int first = per_pixel >= kThreads ? (int)threadIdx.x : (int)threadIdx.x % per_pixel;
  if (local >= pps) return;  // the ragged tail of the block when pps * per_pixel < kThreads
  for (long long p = (long long)blockIdx.x * pps + local; p < npix;
       p += (long long)gridDim.x * pps) {
    Vec* dst = out + p * per_pixel;
    if (!valid[p]) {
      const uint32_t w = ELEM == 1 ? 0x01010101u * ((const uint8_t*)bg)[p]
                                   : ((const uint32_t*)bg)[p];
      Vec v;
      splat(v, w);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const long long r = blinky::resolve_row(idx[p], rows, fill);
    if (r < 0) {
      Vec v;
      splat(v, 0xFFFFFFFFu);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const Vec* row = src + r * per_pixel;
    bool tinted = false;
    uint32_t t = 0;
    if constexpr (ELEM == 4) {
      if (tint_mask != nullptr && tint_mask[p]) {
        tinted = true;
        t = tint_rgb[p];
      }
    }
    for (int i = first; i < per_pixel; i += kThreads) {
      Vec v = row[i];
      if constexpr (ELEM == 4) {
        if (tinted) tint(v, t);
      }
      dst[i] = v;
    }
  }
}

template <typename Vec, int ELEM>
int launch(const void* src, long long rows, int per_pixel, const int32_t* idx,
           const uint8_t* valid, const void* bg, const uint32_t* tint_rgb,
           const uint8_t* tint_mask, int fill, long long npix, void* out,
           cudaStream_t stream) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int blocks = blinky::wave_blocks((npix + pps - 1) / pps);
  remap_gather_kernel<Vec, ELEM><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)src, rows, per_pixel, idx, valid, bg, tint_rgb, tint_mask,
      fill, npix, (Vec*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// src [rows, batch] texels of elem_bytes (1 or 4); idx, valid, bg, tint_rgb,
// tint_mask [npix]; out [npix, batch].  tint_rgb/tint_mask are null for no
// tint (elem_bytes 4 only).  fill: 0 = clip rule, 1 = fill rule.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_remap_gather(const void* src, long long rows, int elem_bytes,
                                   int batch, const int32_t* idx, const uint8_t* valid,
                                   const void* bg, const uint32_t* tint_rgb,
                                   const uint8_t* tint_mask, int fill, long long npix,
                                   void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)batch * elem_bytes;
  const bool vec16 = row_bytes % 16 == 0 && (uintptr_t)src % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
  if (elem_bytes == 1) {
    return vec16 ? launch<uint4, 1>(src, rows, (int)(row_bytes / 16), idx, valid, bg,
                                    nullptr, nullptr, fill, npix, out, s)
                 : launch<uint8_t, 1>(src, rows, batch, idx, valid, bg, nullptr,
                                      nullptr, fill, npix, out, s);
  }
  if (elem_bytes == 4) {
    return vec16 ? launch<uint4, 4>(src, rows, (int)(row_bytes / 16), idx, valid, bg,
                                    tint_rgb, tint_mask, fill, npix, out, s)
                 : launch<uint32_t, 4>(src, rows, batch, idx, valid, bg, tint_rgb,
                                       tint_mask, fill, npix, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The message of a CUDA error code returned by any blinky_* entry point.
extern "C" const char* blinky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
