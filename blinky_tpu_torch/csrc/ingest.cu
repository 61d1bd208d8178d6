// K10: the equirect (360-video) gather-and-blend, written for Hopper (sm_90a).
//
// Replaces the device work of blinky_tpu/kernels/ingest.py: the jitted `run`
// of EquirectIngest.__call__ (ingest.py:133, :147-154; also its texel-subset
// view, :176) and of EquirectScreenKernel.__call__ (ingest.py:257, :276-288),
// which XLA lowered to K row gathers, an elementwise float32 blend and an
// elementwise epilogue, each through device memory.  One kernel serves both:
//
//   g[p, :]   = K == 1 ? src[idx[0, p], :]                       (a row copy)
//                      : blend of src[idx[k, p], :] by w[k, p], k = 0..3
//   out[p, :] = g & plate_mask[p]                                (the ingest)
//   out[p, :] = valid[p] ? tint(g, tint_rgb[p]) if tint_mask[p] : bg[p]
//                                                                (the screen)
//
// src [rows, B] packed RGBA; idx, w [K, n]; the per-output operands [n].
//
// The blend is EquirectIngest._blend in NumPy float32, bit for bit: per colour
// channel acc = ((c0*w0 + c1*w1) + c2*w2) + c3*w3 with every product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into
// an FMA), then acc + 0.5, clipped to [0, 255] and truncated; alpha is 0xFF.
// With one tap the row passes through whole, its alpha byte too.  The order
// of the screen epilogue is blend, tint, background select (ingest.py:282-287);
// the plate mask comes after the blend, so an unused plate is all zero, alpha
// too (ingest.py:153).
//
// What bounds it on the card: bytes.  An output row of B texels is B * 4 bytes
// written and up to four source rows of the same length read; neighbouring
// outputs share taps, so the distinct source rows the tables name, not 4 * n,
// are what must come from device memory (the rest is L2's to catch).  The
// blend is about a dozen float32 operations a channel, far under the bytes.
//
// What the design does about it: the work split is K1's (remap_gather.cu).  A
// row is cut into 16-byte vectors of four texels when B % 4 == 0 and both
// pointers are 16-byte aligned, else into single texels; neighbouring threads
// take neighbouring vectors of one output row, so every warp reads and writes
// contiguous runs (at B = 128 one warp moves one 512-byte row).  The K loads
// of a thread are all in flight before the first is used.  The tables, the weights
// and the epilogue's operands are read once per thread and output row.  An
// output that shows the background, or lies on an unused plate, reads no
// source row at all.  Row offsets are 64-bit: a 4096x2048 pano batch of 128
// lanes is 2^32 bytes.  A table index outside [0, rows) is clipped, as the
// plain version clips it; the tables of kernels/ingest.py never hold one.

#include "common.cuh"
#include "tint.cuh"

namespace {

using blinky::kThreads;
using blinky::splat;
using blinky::tint;

// One channel of _blend: K products summed left to right, each operation
// rounded to float32 on its own; then + 0.5, the clip and the truncation.
template <int K>
__device__ __forceinline__ uint32_t blend_channel(const uint32_t (&r)[K], const float (&w)[K],
                                                  int shift) {
  float acc = __fmul_rn((float)((r[0] >> shift) & 0xFFu), w[0]);
#pragma unroll
  for (int k = 1; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn((float)((r[k] >> shift) & 0xFFu), w[k]));
  float v = __fadd_rn(acc, 0.5f);
  v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  return __float2uint_rz(v) << shift;
}

// _blend on one texel, and on a vector of four.
template <int K>
__device__ __forceinline__ uint32_t blend(const uint32_t (&r)[K], const float (&w)[K]) {
  return (0xFFu << 24) | blend_channel<K>(r, w, 0) | blend_channel<K>(r, w, 8) |
         blend_channel<K>(r, w, 16);
}

template <int K>
__device__ __forceinline__ uint4 blend(const uint4 (&r)[K], const float (&w)[K]) {
  uint32_t x[K], y[K], z[K], q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = r[k].x;
    y[k] = r[k].y;
    z[k] = r[k].z;
    q[k] = r[k].w;
  }
  return make_uint4(blend<K>(x, w), blend<K>(y, w), blend<K>(z, w), blend<K>(q, w));
}

__device__ __forceinline__ void and_mask(uint4& v, uint32_t m) {
  v.x &= m;
  v.y &= m;
  v.z &= m;
  v.w &= m;
}
__device__ __forceinline__ void and_mask(uint32_t& v, uint32_t m) { v &= m; }

// Vec: what one thread moves at a time (uint4 = four texels, or one texel).
// K: the taps an output blends (1 = nearest, a row copy; 4 = bilinear).
template <typename Vec, int K>
__global__ void __launch_bounds__(kThreads) equirect_gather_kernel(
    const Vec* __restrict__ src, long long rows, int per_pixel,
    const int32_t* __restrict__ idx, const float* __restrict__ w, long long n,
    const uint32_t* __restrict__ plate_mask, const uint8_t* __restrict__ valid,
    const uint32_t* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, Vec* __restrict__ out) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int local = per_pixel >= kThreads ? 0 : (int)threadIdx.x / per_pixel;
  const int first = per_pixel >= kThreads ? (int)threadIdx.x : (int)threadIdx.x % per_pixel;
  if (local >= pps) return;  // the ragged tail of the block when pps * per_pixel < kThreads
  for (long long p = (long long)blockIdx.x * pps + local; p < n;
       p += (long long)gridDim.x * pps) {
    Vec* dst = out + p * per_pixel;
    if (valid != nullptr && !valid[p]) {
      Vec v;
      splat(v, bg[p]);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const uint32_t mask = plate_mask != nullptr ? plate_mask[p] : 0xFFFFFFFFu;
    if (mask == 0u) {  // an unused plate: nothing of the source shows
      Vec v;
      splat(v, 0u);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const Vec* row[K];
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      row[k] = src + blinky::resolve_row(idx[k * n + p], rows, 0) * per_pixel;
      wk[k] = K == 1 ? 1.0f : w[k * n + p];
    }
    const bool tinted = tint_mask != nullptr && tint_mask[p];
    const uint32_t t = tinted ? tint_rgb[p] : 0u;
    for (int i = first; i < per_pixel; i += kThreads) {
      Vec r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = row[k][i];
      Vec v;
      if constexpr (K == 1) {
        v = r[0];
      } else {
        v = blend<K>(r, wk);
      }
      if (tinted) tint(v, t);
      and_mask(v, mask);
      dst[i] = v;
    }
  }
}

template <typename Vec, int K>
int launch(const void* src, long long rows, int per_pixel, const int32_t* idx, const float* w,
           long long n, const uint32_t* plate_mask, const uint8_t* valid, const uint32_t* bg,
           const uint32_t* tint_rgb, const uint8_t* tint_mask, void* out, cudaStream_t stream) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int blocks = blinky::wave_blocks((n + pps - 1) / pps);
  equirect_gather_kernel<Vec, K><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)src, rows, per_pixel, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
      (Vec*)out);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch(const void* src, long long rows, int batch, const int32_t* idx, const float* w,
             long long n, const uint32_t* plate_mask, const uint8_t* valid, const uint32_t* bg,
             const uint32_t* tint_rgb, const uint8_t* tint_mask, void* out, cudaStream_t s) {
  const bool vec16 = batch % 4 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec16 ? launch<uint4, K>(src, rows, batch / 4, idx, w, n, plate_mask, valid, bg,
                                  tint_rgb, tint_mask, out, s)
               : launch<uint32_t, K>(src, rows, batch, idx, w, n, plate_mask, valid, bg,
                                     tint_rgb, tint_mask, out, s);
}

}  // namespace

// src [rows, batch] packed RGBA; idx [taps, n] int32, w [taps, n] float32
// (w may be null when taps == 1); taps 1 or 4; out [n, batch].  The epilogue
// follows the pointers given: plate_mask [n] alone (the ingest), or valid [n]
// and bg [n] with tint_rgb [n] and tint_mask [n] or without (the screen); all
// null leaves the blend as it is.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_equirect_gather(const void* src, long long rows, int batch,
                                      const int32_t* idx, const float* w, int taps, long long n,
                                      const uint32_t* plate_mask, const uint8_t* valid,
                                      const uint32_t* bg, const uint32_t* tint_rgb,
                                      const uint8_t* tint_mask, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((valid == nullptr) != (bg == nullptr) || (tint_rgb == nullptr) != (tint_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (taps == 1)
    return dispatch<1>(src, rows, batch, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
                       out, s);
  if (taps == 4 && w != nullptr)
    return dispatch<4>(src, rows, batch, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
                       out, s);
  return (int)cudaErrorInvalidValue;
}
