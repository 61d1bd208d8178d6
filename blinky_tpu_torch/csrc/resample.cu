// K11 and K12: the two elementwise passes of the true-colour pipeline that the
// JAX package left to XLA, written for Hopper (sm_90a).
//
// K11, downsample_rgba, replaces blinky_tpu/kernels/remap.py::_downsample_rgba
// (remap.py:370), the resolve step of Session.render_aa:
//
//   in [k*H, k*W, B] packed RGBA -> out [H, W, B]
//   per colour channel: the float32 mean of the k x k block, + 0.5, clipped to
//   [0, 255], truncated; alpha 0xFF.
//
// The channel sum of k*k integers <= 255 is exact in float32 in any order as
// long as it stays under 2^24 (k <= 256, which the wrapper checks), so the
// kernel sums in integers and converts once.  The mean is the sum divided by
// k*k with a correctly rounded divide (__fdiv_rn), as jnp.mean divides; the
// add is rounded on its own (__fadd_rn).
//
// K12, tint_expand_rgba, replaces the jnp branch of
// remap.py::expand_frames_tinted_rgba (remap.py:402), the rubix source
// expansion of frames that are on the device:
//
//   in [P <= 6, M] packed RGBA -> out [12, M]: the raw planes, zero planes up
//   to 6, each plane tinted toward its plate's colour (tint.cuh, integers
//   only, alpha 0xFF), zero planes up to 12.
//
// What bounds them on the card: bytes.  K11 reads its input once and writes
// 1/k^2 of it; K12 reads P planes and writes 12.  Neither has arithmetic to
// speak of.
//
// What the design does about it: both move 16-byte vectors of four texels
// along the innermost (batch) axis when its length is a multiple of 4 and the
// pointers are 16-byte aligned, else single texels; neighbouring threads take
// neighbouring vectors, so K11's k*k reads of a thread are each part of a
// contiguous run of its warp, and K12 is a plain stream.  Offsets are 64-bit.

#include "common.cuh"
#include "tint.cuh"

namespace {

using blinky::kThreads;
using blinky::splat;

constexpr int kPlates = 6;  // MAX_PLATES, fisheye.c:352

struct Sums {
  uint32_t r, g, b;
};

__device__ __forceinline__ void add_texel(Sums& s, uint32_t v) {
  s.r += v & 0xFFu;
  s.g += (v >> 8) & 0xFFu;
  s.b += (v >> 16) & 0xFFu;
}

__device__ __forceinline__ uint32_t mean_channel(uint32_t sum, float count) {
  float v = __fadd_rn(__fdiv_rn((float)sum, count), 0.5f);
  v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  return __float2uint_rz(v);
}

__device__ __forceinline__ uint32_t mean_texel(const Sums& s, float count) {
  return (0xFFu << 24) | mean_channel(s.r, count) | (mean_channel(s.g, count) << 8) |
         (mean_channel(s.b, count) << 16);
}

// Accumulators and moves for one vector of LANES texels.
template <typename Vec>
struct Lanes;
template <>
struct Lanes<uint32_t> {
  Sums s[1] = {};
  __device__ __forceinline__ void add(uint32_t v) { add_texel(s[0], v); }
  __device__ __forceinline__ uint32_t mean(float c) const { return mean_texel(s[0], c); }
};
template <>
struct Lanes<uint4> {
  Sums s[4] = {};
  __device__ __forceinline__ void add(uint4 v) {
    add_texel(s[0], v.x);
    add_texel(s[1], v.y);
    add_texel(s[2], v.z);
    add_texel(s[3], v.w);
  }
  __device__ __forceinline__ uint4 mean(float c) const {
    return make_uint4(mean_texel(s[0], c), mean_texel(s[1], c), mean_texel(s[2], c),
                      mean_texel(s[3], c));
  }
};

// One thread makes one vector of one output pixel: items = H * W * per_pixel.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) downsample_kernel(
    const Vec* __restrict__ in, int k, long long W, int per_pixel, long long items,
    Vec* __restrict__ out) {
  const float count = (float)(k * k);
  const long long in_row = W * k * per_pixel;  // vectors in one input row
  for (long long item = (long long)blockIdx.x * kThreads + threadIdx.x; item < items;
       item += (long long)gridDim.x * kThreads) {
    const long long pix = item / per_pixel;
    const int i = (int)(item % per_pixel);
    const long long y = pix / W, x = pix % W;
    const Vec* block = in + y * k * in_row + x * k * per_pixel + i;
    Lanes<Vec> acc;
    for (int dy = 0; dy < k; ++dy) {
      const Vec* line = block + dy * in_row;
      for (int dx = 0; dx < k; ++dx) acc.add(line[(long long)dx * per_pixel]);
    }
    out[item] = acc.mean(count);
  }
}

template <typename Vec>
int launch_downsample(const void* in, int k, long long H, long long W, int per_pixel, void* out,
                      cudaStream_t stream) {
  const long long items = H * W * per_pixel;
  const int blocks = blinky::wave_blocks((items + kThreads - 1) / kThreads);
  downsample_kernel<Vec><<<blocks, kThreads, 0, stream>>>((const Vec*)in, k, W, per_pixel, items,
                                                          (Vec*)out);
  return (int)cudaGetLastError();
}

struct PlateTints {
  uint32_t rgb[kPlates];
};

// One thread moves one vector of one of the six plate slots: it writes the
// slot's raw plane and its tinted plane, or zeros in both past the planes given.
template <typename Vec>
__global__ void __launch_bounds__(kThreads) tint_expand_kernel(
    const Vec* __restrict__ in, int planes, long long per_plane,
    const __grid_constant__ PlateTints tints, Vec* __restrict__ out) {
  const long long items = kPlates * per_plane;
  for (long long item = (long long)blockIdx.x * kThreads + threadIdx.x; item < items;
       item += (long long)gridDim.x * kThreads) {
    const int q = (int)(item / per_plane);
    Vec raw, tinted;
    if (q < planes) {
      raw = in[item];
      tinted = raw;
      blinky::tint(tinted, tints.rgb[q]);
    } else {
      splat(raw, 0u);
      splat(tinted, 0u);
    }
    out[item] = raw;
    out[item + items] = tinted;
  }
}

template <typename Vec>
int launch_tint_expand(const void* in, int planes, long long per_plane, PlateTints tints,
                       void* out, cudaStream_t stream) {
  const long long items = kPlates * per_plane;
  const int blocks = blinky::wave_blocks((items + kThreads - 1) / kThreads);
  tint_expand_kernel<Vec><<<blocks, kThreads, 0, stream>>>((const Vec*)in, planes, per_plane,
                                                           tints, (Vec*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// in [k*H, k*W, batch] packed RGBA -> out [H, W, batch]; 1 <= k <= 256.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_downsample_rgba(const void* in, int k, long long H, long long W, int batch,
                                      void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > 256 || batch < 1) return (int)cudaErrorInvalidValue;
  const bool vec16 = batch % 4 == 0 && (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec16 ? launch_downsample<uint4>(in, k, H, W, batch / 4, out, s)
               : launch_downsample<uint32_t>(in, k, H, W, batch, out, s);
}

// in [planes <= 6, per_plane] packed RGBA -> out [12, per_plane]; tints: the
// six plates' tint colours, packed RGB (host memory).  Launches on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int blinky_tint_expand_rgba(const void* in, int planes, long long per_plane,
                                       const uint32_t* tints, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (planes < 0 || planes > kPlates) return (int)cudaErrorInvalidValue;
  PlateTints t;
  for (int q = 0; q < kPlates; ++q) t.rgb[q] = tints[q];
  const bool vec16 = per_plane % 4 == 0 && (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec16 ? launch_tint_expand<uint4>(in, planes, per_plane / 4, t, out, s)
               : launch_tint_expand<uint32_t>(in, planes, per_plane, t, out, s);
}
