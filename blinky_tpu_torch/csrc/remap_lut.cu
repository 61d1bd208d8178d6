// K2: the static remap's general path with per-element tables, for Hopper
// (sm_90a).
//
// Replaces blinky_tpu/kernels/remap.py::remap_impl (remap.py:56) with its
// rubix tint LUT and/or its palette -> RGB decode, and the decode_rgb take
// that follows an expanded-source gather (remap.py:561-564).
//
//   v = src[row(idx[p]), b]                     row gather, clip or fill rule
//   v = tint_lut[tint[p] * 256 + v]             if rubix (fill 255 past the end)
//   v = valid[p] ? v : bg[p]                    background select
//   out[p, b] = v,  or out[p, b, :] = rgb_lut[v] if decode
//
// What bounds it on the card: bytes.  Per texel it reads one source byte and
// writes one byte (three with the decode); the index, mask, tint and
// background are per pixel.  So the kernel has to keep tens of kilobytes of
// source and output in flight on every SM, as K1 does, while it also looks
// every texel up in a table.
//
// What the design does about it:
//  * Texels move 16 at a time (one uint4 load, one or three uint4 stores)
//    when B % 16 == 0 and both pointers are 16-byte aligned, else one at a
//    time.  Each thread issues kUnroll independent source loads before it
//    uses the first.
//  * The per-pixel operands are read once per pixel, not once per thread:
//    a block takes a chunk of pixels, loads their operands with coalesced
//    loads (the next chunk's while it works on this one), resolves each
//    pixel to a source row or a constant output word, and stages that in
//    shared memory for the threads that move the pixel's texels.
//  * One shared-memory lookup per texel.  The prologue composes the tables:
//    [8][256] bytes for the tint LUT (row 7 is the fill value 255 that
//    tint >= 7 reads past the LUT's end), [256] packed RGB words for the
//    decode, and [8][256] words rgb_lut[tint_lut[t][v]] for both.  Invalid
//    and fill-rule pixels become a constant word, so they read no source.
//    The tables are not replicated: on an H100, uniformly random and
//    all-zero sources (every lane on one word) take the same time to within
//    2 % (chip_smoke.py phase 2), so bank conflicts cost nothing visible.
//  * The decode packs each thread's 16 RGB words into 48 bytes with
//    __byte_perm and stages the warp's 1,536 bytes in shared memory, so
//    the warp stores them as contiguous 512-byte runs.  Three uint4 stores
//    per thread straight to device memory, at a 48-byte lane stride, write
//    partial sectors, and were slower on the card.

#include <type_traits>

#include "common.cuh"

namespace {

using blinky::kThreads;

constexpr int kLutRows = 7;      // palette.tint_lut: 6 plate tints + identity
constexpr int kRows = 8;         // + row 7: tint >= 7 reads past the LUT, fill 255
constexpr int kUnroll = 4;       // work items a thread has in flight
constexpr int kTint = 0, kRgb = 1, kTintRgb = 2;  // the tables asked for

__device__ __forceinline__ uint32_t rgb_word(const uint8_t* rgb_lut, int v) {
  return rgb_lut[3 * v] | (uint32_t)rgb_lut[3 * v + 1] << 8 |
         (uint32_t)rgb_lut[3 * v + 2] << 16;
}

// A pixel as its texels' threads need it (int2 in shared memory):
//   .x >= 0: the source row, and .y the offset of the pixel's table row;
//   .x <  0: every texel of the pixel is the constant .y (an output byte
//            repeated four times, or a packed RGB word).
template <int MODE, typename Entry>
__device__ __forceinline__ int2 describe(int i, uint32_t vtb, long long rows, int fill,
                                         const Entry* tab, const uint32_t* rgb) {
  const int t = MODE == kRgb ? 0 : min((int)((vtb >> 8) & 0xFF), kRows - 1);
  const uint32_t bg = vtb >> 16;
  if ((vtb & 0xFF) == 0)
    return make_int2(-1, MODE == kTint ? 0x01010101u * bg : rgb[bg]);
  const long long r = blinky::resolve_row(i, rows, fill);
  if (r < 0) {  // fill rule: the byte 0xFF, then the tables
    const uint32_t c = tab[t * 256 + 0xFF];
    return make_int2(-1, MODE == kTint ? 0x01010101u * c : c);
  }
  return make_int2((int)r, t * 256);  // r < 2^31: it comes from an int32 index
}

__device__ __forceinline__ uint32_t lut4(uint32_t w, const uint8_t* t) {
  return t[w & 0xFF] | (uint32_t)t[(w >> 8) & 0xFF] << 8 |
         (uint32_t)t[(w >> 16) & 0xFF] << 16 | (uint32_t)t[w >> 24] << 24;
}

// Writes work item e (a vector or a texel of the output) of a pixel
// described by d, whose source texels are v, if `on`.  Every lane of the
// warp calls it: the decode of 16 texels writes 48 bytes, which the warp
// stages in shared memory (`stage`, 1,536 bytes) so that its stores are
// contiguous.  The lanes that are on are a prefix of the warp, on
// consecutive items.
template <int MODE, typename Entry>
__device__ __forceinline__ void put(uint8_t* out, long long e, int2 d, uint4 v, bool on,
                                    const Entry* tab, uint4* stage) {
  const uint32_t k = (uint32_t)d.y;
  if constexpr (MODE == kTint) {
    if (on)
      ((uint4*)out)[e] = d.x < 0 ? make_uint4(k, k, k, k)
                                 : make_uint4(lut4(v.x, tab + k), lut4(v.y, tab + k),
                                              lut4(v.z, tab + k), lut4(v.w, tab + k));
  } else {
    const int lane = (int)threadIdx.x % 32;
    if (on) {
      const uint32_t s[4] = {v.x, v.y, v.z, v.w};
      uint32_t c[16], w[12];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        c[j] = d.x < 0 ? k : tab[k + ((s[j / 4] >> (8 * (j % 4))) & 0xFF)];
#pragma unroll
      for (int g = 0; g < 4; ++g) {  // texel j's 3 bytes at 3 j
        w[3 * g + 0] = __byte_perm(c[4 * g + 0], c[4 * g + 1], 0x4210);
        w[3 * g + 1] = __byte_perm(c[4 * g + 1], c[4 * g + 2], 0x5421);
        w[3 * g + 2] = __byte_perm(c[4 * g + 2], c[4 * g + 3], 0x6542);
      }
      stage[3 * lane + 0] = make_uint4(w[0], w[1], w[2], w[3]);
      stage[3 * lane + 1] = make_uint4(w[4], w[5], w[6], w[7]);
      stage[3 * lane + 2] = make_uint4(w[8], w[9], w[10], w[11]);
    }
    const int n = 3 * __popc(__ballot_sync(0xFFFFFFFFu, on));
    uint4* dst = (uint4*)out + 3 * __shfl_sync(0xFFFFFFFFu, e, 0);
    __syncwarp();
#pragma unroll
    for (int q = lane; q < 96; q += 32)
      if (q < n) dst[q] = stage[q];
    __syncwarp();  // the stage is rewritten by the next call
  }
}

template <int MODE, typename Entry>
__device__ __forceinline__ void put(uint8_t* out, long long e, int2 d, uint8_t v, bool on,
                                    const Entry* tab, uint4*) {
  if (!on) return;
  const uint32_t c = d.x < 0 ? (uint32_t)d.y : (uint32_t)tab[d.y + v];
  if constexpr (MODE == kTint) {
    out[e] = (uint8_t)c;
  } else {
    out[3 * e + 0] = (uint8_t)c;
    out[3 * e + 1] = (uint8_t)(c >> 8);
    out[3 * e + 2] = (uint8_t)(c >> 16);
  }
}

// Vec: what one work item moves (uint4 = 16 texels, or one texel);
// per_pixel: work items per pixel (B / 16, or B).
template <int MODE, typename Vec>
__global__ void __launch_bounds__(kThreads) remap_lut_kernel(
    const Vec* __restrict__ src, long long rows, int per_pixel,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ tint, const uint8_t* __restrict__ bg,
    const uint8_t* __restrict__ tint_lut, const uint8_t* __restrict__ rgb_lut,
    int fill, long long npix, uint8_t* __restrict__ out) {
  using Entry = std::conditional_t<MODE == kTint, uint8_t, uint32_t>;
  constexpr int kEntries = MODE == kRgb ? 256 : kRows * 256;
  __shared__ Entry s_tab[kEntries];
  __shared__ uint32_t s_rgb[MODE == kTintRgb ? 256 : 1];  // the background's decode
  __shared__ int2 s_pix[kUnroll * kThreads];
  __shared__ uint4 s_stage[MODE == kTint ? 1 : 3 * kThreads];  // the decode's stores
  uint4* stage = s_stage + (MODE == kTint ? 0 : 3 * 32 * ((int)threadIdx.x / 32));
  for (int i = threadIdx.x; i < kEntries; i += kThreads) {
    const int v = MODE == kRgb ? i : (i < kLutRows * 256 ? tint_lut[i] : 0xFF);
    if constexpr (MODE == kTint)
      s_tab[i] = (uint8_t)v;
    else
      s_tab[i] = rgb_word(rgb_lut, v);
  }
  if constexpr (MODE == kTintRgb)
    for (int i = threadIdx.x; i < 256; i += kThreads) s_rgb[i] = rgb_word(rgb_lut, i);
  const uint32_t* bg_rgb = MODE == kTintRgb ? s_rgb : (const uint32_t*)s_tab;

  // Short rows (per_pixel < kThreads): a chunk is kUnroll block steps of
  // pps pixels, and a thread moves item `first` of pixel local + u * pps of
  // each.  Long rows: a chunk is one pixel, walked by the whole block.
  const bool long_rows = per_pixel >= kThreads;
  const int pps = blinky::pixels_per_step(per_pixel);
  const int cp = long_rows ? 1 : kUnroll * pps;
  const int local = long_rows ? 0 : (int)threadIdx.x / per_pixel;
  const int first = (int)threadIdx.x % per_pixel;

  // this thread's share of a chunk's operands: pixel threadIdx.x + k * kThreads
  int r_idx[kUnroll];
  uint32_t r_vtb[kUnroll];  // valid | tint << 8 | bg << 16
  auto fetch = [&](long long p0) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = (int)threadIdx.x + k * kThreads;
      const long long p = p0 + j;
      if (j < cp && p < npix) {
        r_idx[k] = idx[p];
        r_vtb[k] = (valid[p] != 0) | (MODE == kRgb ? 0u : (uint32_t)tint[p] << 8) |
                   (uint32_t)bg[p] << 16;
      }
    }
  };

  long long c = blockIdx.x;
  fetch(c * cp);
  __syncthreads();  // the tables
  for (; c * cp < npix; c += gridDim.x) {
    const long long p0 = c * cp;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = (int)threadIdx.x + k * kThreads;
      if (j < cp && p0 + j < npix)
        s_pix[j] = describe<MODE>(r_idx[k], r_vtb[k], rows, fill, s_tab, bg_rgb);
    }
    __syncthreads();
    fetch(p0 + (long long)gridDim.x * cp);  // in flight while this chunk moves

    // The items' control flow is the same in every lane of a warp: the
    // decode's stores are warp-wide.
    Vec v[kUnroll] = {};
    if (long_rows) {
      // items b + u * kThreads + threadIdx.x of the chunk's one pixel
      const int2 d = s_pix[0];
      for (int b = 0; b < per_pixel; b += kUnroll * kThreads) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = b + u * kThreads + (int)threadIdx.x;
          if (i < per_pixel && d.x >= 0) v[u] = src[(long long)d.x * per_pixel + i];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = b + u * kThreads + (int)threadIdx.x;
          put<MODE>(out, p0 * per_pixel + i, d, v[u], i < per_pixel, s_tab, stage);
        }
      }
    } else {
      // items of pixels p0 + local + u * pps; the last chunk may be ragged
      const long long left = local < pps ? npix - p0 - local : 0;
      const long long e0 = (p0 + local) * per_pixel + first;
      int2 d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        d[u] = u * pps < left ? s_pix[u * pps + local] : make_int2(-1, 0);
        if (d[u].x >= 0) v[u] = src[(long long)d[u].x * per_pixel + first];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        put<MODE>(out, e0 + (long long)u * pps * per_pixel, d[u], v[u], u * pps < left,
                  s_tab, stage);
    }
    __syncthreads();  // s_pix is rewritten for the next chunk
  }
}

template <int MODE, typename Vec>
int launch(const void* src, long long rows, int per_pixel, const int32_t* idx,
           const uint8_t* valid, const uint8_t* tint, const uint8_t* bg,
           const uint8_t* tint_lut, const uint8_t* rgb_lut, int fill, long long npix,
           uint8_t* out, cudaStream_t stream) {
  auto kernel = remap_lut_kernel<MODE, Vec>;
  int resident = 0;  // the registers, not the threads, limit the blocks per SM
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, 0);
  const long long cp =
      per_pixel >= kThreads ? 1 : (long long)kUnroll * blinky::pixels_per_step(per_pixel);
  const int blocks = blinky::wave_blocks((npix + cp - 1) / cp, resident);
  kernel<<<blocks, kThreads, 0, stream>>>((const Vec*)src, rows, per_pixel, idx, valid,
                                          tint, bg, tint_lut, rgb_lut, fill, npix, out);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const uint8_t* src, long long rows, int batch, const int32_t* idx,
             const uint8_t* valid, const uint8_t* tint, const uint8_t* bg,
             const uint8_t* tint_lut, const uint8_t* rgb_lut, int fill, long long npix,
             uint8_t* out, cudaStream_t s) {
  const bool vec16 = batch % 16 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec16 ? launch<MODE, uint4>(src, rows, batch / 16, idx, valid, tint, bg, tint_lut,
                                     rgb_lut, fill, npix, out, s)
               : launch<MODE, uint8_t>(src, rows, batch, idx, valid, tint, bg, tint_lut,
                                       rgb_lut, fill, npix, out, s);
}

}  // namespace

// src [rows, batch] u8; idx, valid, tint, bg [npix]; tint_lut [7, 256] u8 or
// null (no rubix); rgb_lut [256, 3] u8 or null (no decode), not both null;
// out [npix, batch] u8, or [npix, batch, 3] with rgb_lut.  fill: 0 = clip
// rule, 1 = fill rule.  Launches on `stream` and returns cudaGetLastError()
// after the launch.
extern "C" int blinky_remap_lut(const uint8_t* src, long long rows, int batch,
                                const int32_t* idx, const uint8_t* valid,
                                const uint8_t* tint, const uint8_t* bg,
                                const uint8_t* tint_lut, const uint8_t* rgb_lut,
                                int fill, long long npix, uint8_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tint_lut != nullptr && rgb_lut != nullptr)
    return dispatch<kTintRgb>(src, rows, batch, idx, valid, tint, bg, tint_lut, rgb_lut,
                              fill, npix, out, s);
  if (tint_lut != nullptr)
    return dispatch<kTint>(src, rows, batch, idx, valid, tint, bg, tint_lut, rgb_lut,
                           fill, npix, out, s);
  if (rgb_lut != nullptr)
    return dispatch<kRgb>(src, rows, batch, idx, valid, tint, bg, tint_lut, rgb_lut,
                          fill, npix, out, s);
  return (int)cudaErrorInvalidValue;
}
