// The true-colour rubix tint on packed RGBA texels, shared by the kernels that
// apply it: K1 (remap_gather.cu, after its gather), K10 (ingest.cu, after its
// blend) and K12 (resample.cu, the source expansion).
#pragma once

#include <stdint.h>

namespace blinky {

// apply_tint_rgba on one tinted texel: per channel c + ((42 * (t - c)) >> 8)
// in signed int, where >> is an arithmetic (floor) shift as jnp's on int32,
// clipped to 0..255; alpha is forced to 0xFF.
__device__ __forceinline__ uint32_t tint_texel(uint32_t g, uint32_t t) {
  uint32_t res = 0xFFu << 24;
#pragma unroll
  for (int shift = 0; shift < 24; shift += 8) {
    int c = (int)((g >> shift) & 0xFFu);
    int tc = (int)((t >> shift) & 0xFFu);
    int c2 = c + ((42 * (tc - c)) >> 8);
    c2 = c2 < 0 ? 0 : (c2 > 255 ? 255 : c2);
    res |= (uint32_t)c2 << shift;
  }
  return res;
}

__device__ __forceinline__ void tint(uint4& v, uint32_t t) {
  v.x = tint_texel(v.x, t);
  v.y = tint_texel(v.y, t);
  v.z = tint_texel(v.z, t);
  v.w = tint_texel(v.w, t);
}
__device__ __forceinline__ void tint(uint32_t& v, uint32_t t) { v = tint_texel(v, t); }

__device__ __forceinline__ void splat(uint4& v, uint32_t w) { v = make_uint4(w, w, w, w); }
__device__ __forceinline__ void splat(uint32_t& v, uint32_t w) { v = w; }
__device__ __forceinline__ void splat(uint8_t& v, uint32_t w) { v = (uint8_t)w; }

}  // namespace blinky
