// The float32 ray resolve shared by K6 (posed.cu), K8 (lensmap.cu) and K9
// (posed.cu): one camera ray -> the plate it lands on and the texel there.
// It is rays_to_lensmap of blinky_tpu/lensmap/builder.py:165 at float32, as
// blinky_tpu_torch/lensmap/builder.py::rays_to_lensmap_torch evaluates it,
// bit for bit.
//
// Rounding.  nvcc contracts a*b + c into one fused multiply-add by default,
// which rounds once where the plain version rounds twice and moves texel
// boundaries; so every float operation here is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __frcp_rn, __fsqrt_rn), which
// nvcc never contracts, in the plain version's order.
//
// Guards.  Every guard the plain version puts around an IEEE sequence whose
// result is dropped anyway is left out, with its select: the uv divisions
// divide by a zero forward dot, whose infinite or NaN u or v fails the range
// test the guard's pixel fails; u and v are not zeroed before the cast of an
// invalid pixel; the range test of px and py is one unsigned compare each;
// and a globe's unused plate slots repeat plate 0, so the max-dot select
// needs no plate count.  The normalize's zero-length guard is not of that
// kind and stays: a ray whose square underflows keeps its length and may be
// valid.  The normalize's 1 / len is __frcp_rn(len): the correctly rounded
// reciprocal, the same bits as __fdiv_rn(1.f, len) in fewer instructions.
//
// The cube resolver (kCube, K6 only).  On a globe whose six plates face the
// six signed axes, with right and up vectors that are signed axes too (the
// cube: every frame entry is -1, -0, 0 or +1), each dot of the max-dot
// resolve is a signed component of the unit ray.  A product by 0 or +-1 is
// exact and adding the zero products leaves the other unchanged, so each
// dot equals its component but for the sign of a zero.  So kCube takes the
// largest forward dot as the largest magnitude m (two max instructions),
// and the plate as the first, in plate order, of the plates that face the
// direction an axis of magnitude m points to: the strict first max of the
// max-dot select, whose ties IEEE comparison breaks alike for -0 and +0.
// Its rx and ry are the fused sums of the same exact products.  Bit-equal
// to max-dot: rotate_normalize leaves a ray either finite, where the picks
// agree and a zero rz is invalid on both sides (a zero rx or ry gives u or
// v = 0.5 on both), or NaN in its non-finite components and zero in the
// rest, where max-dot reads NaN from every dot and kCube a zero or NaN rz,
// and both fail the range test.
#pragma once

#include <string.h>

#include "common.cuh"

namespace blinky {

constexpr int kMaxPlates = 6;
constexpr int kPlateFloats = 10;  // forward[3], right[3], up[3], dist
constexpr int kRecord = 12;       // shared: right[3], dist, up[3], 0, forward[3], 0

// The globe and the resolve parameters, passed by value (parameter space):
// the six forward dots take their constants straight from the constant bank.
struct Resolve {
  float plates[kMaxPlates * kPlateFloats];  // unused plates repeat plate 0
  int nplates;
  union {
    float fast_dist;  // kFast
    // kCube: for axis a (x, y, z), bits 6a..6a+2 hold the plate that faces
    // +a, bits 6a+3..6a+5 that plate xor the one that faces -a
    int cube_dirs;
  };
  float fast_half;
  int S, expanded;
};

// The plate resolvers: the strict first max of the forward dots, the fast
// globe's, a plate given per ray (a script globe's globe_plate, which
// lensmap/builder.py::script_plates evaluates on the rotated rays first),
// and the cube's (the max-dot select from the ray's signed components).
constexpr int kMaxDot = 0, kFast = 1, kGiven = 2, kCube = 3;

// A frame vector's signed axis, 2 * axis + (1 if it points down the axis):
// -1 unless exactly one entry is nonzero and that entry is +-1.
inline int signed_axis(const float* v) {
  int d = -1;
  for (int a = 0; a < 3; ++a) {
    if (v[a] == 0.f) continue;
    if (d >= 0 || (v[a] != 1.f && v[a] != -1.f)) return -1;
    d = 2 * a + (v[a] < 0.f);
  }
  return d;
}

// kCube's table (Resolve::cube_dirs) from the six plates, or false unless
// every forward, right and up vector is a signed axis and the forward
// vectors are the six signed axes.
inline bool cube_directions(Resolve& r) {
  int plate_of[6] = {-1, -1, -1, -1, -1, -1};
  if (r.nplates != kMaxPlates) return false;
  for (int p = 0; p < kMaxPlates; ++p) {
    const float* f = r.plates + p * kPlateFloats;
    const int d = signed_axis(f);
    if (d < 0 || signed_axis(f + 3) < 0 || signed_axis(f + 6) < 0 || plate_of[d] >= 0)
      return false;
    plate_of[d] = p;
  }
  r.cube_dirs = 0;
  for (int a = 0; a < 3; ++a)
    r.cube_dirs |= (plate_of[2 * a] | (plate_of[2 * a] ^ plate_of[2 * a + 1]) << 3) << (6 * a);
  return true;
}

// plates: a HOST pointer to 6 x 10 floats.  False for arguments no kernel
// takes; kCube only where the caller's kernel has it (cube_ok) and the
// plates are a cube's.
inline bool make_resolve(Resolve& r, const float* plates, int nplates, int resolver,
                         float fast_dist, float fast_half, int S, int expanded,
                         bool cube_ok = false) {
  if (nplates < 1 || nplates > kMaxPlates || resolver < kMaxDot || resolver > kCube ||
      (resolver == kCube && !cube_ok) || S < 1)
    return false;
  memcpy(r.plates, plates, sizeof(r.plates));
  r.nplates = nplates;
  r.fast_dist = fast_dist;
  r.fast_half = fast_half;
  r.S = S;
  r.expanded = expanded;
  return resolver != kCube || cube_directions(r);
}

// The plate records in shared memory (kMaxPlates * kRecord floats, 16-byte
// aligned), written by one thread: only the chosen plate's right, up and
// distance are read from them, as two 16-byte loads (the record stride keeps
// the six plates on disjoint banks).  The caller synchronises.
__device__ __forceinline__ void fill_plate_records(const Resolve& r, float* s_recs) {
#pragma unroll
  for (int p = 0; p < kMaxPlates; ++p) {
    const float* f = r.plates + p * kPlateFloats;
    float* d = s_recs + p * kRecord;
    const float rec[kRecord] = {f[3], f[4], f[5], f[9], f[6], f[7], f[8], 0.f,
                                f[0], f[1], f[2], 0.f};
#pragma unroll
    for (int i = 0; i < kRecord; ++i) d[i] = rec[i];
  }
}

__device__ __forceinline__ float dot3(float x, float y, float z, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), __fmul_rn(z, c));
}

// What a ray resolves to: the clamped plate pc, the texel (px, py) and
// whether the pixel is valid.  px and py of an invalid pixel are whatever
// the casts gave.
struct Texel {
  int pc, px, py;
  bool valid;
};

// One ray -> the unit ray the plate resolve reads.  ROT: rotate it by the
// basis f, rt, up (its forward, right, up rows) first; without it the ray
// is taken as it is, which differs from a rotation by the identity where a
// component is infinite (inf * 0 is NaN).  The rotate pre-pass of a script
// globe (lensmap.cu, blinky_rotate_rays) runs this same code, so the
// script resolves the very rays the kernels resolve.
template <bool ROT>
__device__ __forceinline__ void rotate_normalize(float vx, float vy, float vz, float3 f,
                                                 float3 rt, float3 up, float& x, float& y,
                                                 float& z) {
  x = vx, y = vy, z = vz;
  if (ROT) {
    // ray' = vx * right + vy * up + vz * forward, each component left to right
    x = __fadd_rn(__fadd_rn(__fmul_rn(vx, rt.x), __fmul_rn(vy, up.x)), __fmul_rn(vz, f.x));
    y = __fadd_rn(__fadd_rn(__fmul_rn(vx, rt.y), __fmul_rn(vy, up.y)), __fmul_rn(vz, f.y));
    z = __fadd_rn(__fadd_rn(__fmul_rn(vx, rt.z), __fmul_rn(vy, up.z)), __fmul_rn(vz, f.z));
  }
  // normalize_c with a float32 sqrt: a zero length leaves the ray as it is
  // (a tiny ray whose square underflows stays tiny, and may still be
  // valid), a NaN length is "truthy" and spreads.  The reciprocal runs
  // unconditionally and is selected: a guard around it would cost a branch
  // and a reconvergence a pose-pixel.
  const float len = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                         __fmul_rn(z, z)));
  const float rcp = __frcp_rn(len);
  const float inv = len != 0.f ? rcp : 1.f;
  x = __fmul_rn(x, inv);
  y = __fmul_rn(y, inv);
  z = __fmul_rn(z, inv);
}

// One ray -> its texel.  R: the plate resolver (kMaxDot, kFast, kGiven,
// whose plate is `given`, read by no other resolver, or kCube).  ROT: as for
// rotate_normalize.  recs: the plate records in shared memory.
template <int R, bool ROT>
__device__ __forceinline__ Texel resolve_texel(float vx, float vy, float vz, bool lens_valid,
                                               float3 f, float3 rt, float3 up,
                                               const Resolve& r, const float* recs,
                                               int given = 0) {
  float x, y, z;
  rotate_normalize<ROT>(vx, vy, vz, f, rt, up, x, y, z);

  const float* P = r.plates;
  int plate, pc;
  float rz;  // the chosen plate's forward dot
  if (R == 0) {
    rz = dot3(x, y, z, P[0], P[1], P[2]);
    pc = 0;
#pragma unroll
    for (int k = 1; k < kMaxPlates; ++k) {
      // a globe's unused plates repeat plate 0, whose dot never beats the
      // maximum so far, so every plate is tested with no count and no branch
      const float d = dot3(x, y, z, P[k * kPlateFloats], P[k * kPlateFloats + 1],
                           P[k * kPlateFloats + 2]);
      if (d > rz) {  // strict: the first maximum wins, NaN keeps plate 0
        rz = d;
        pc = k;
      }
    }
    plate = pc;
  } else if constexpr (R == kCube) {
    // the largest forward dot is the largest magnitude m; of the axes that
    // reach it, each names the plate facing the way its sign points, and
    // the first of those plates wins (a NaN ray's rz is zero or NaN: the
    // pixel is invalid, whichever plate this gives)
    const float m = fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
    const float c[3] = {x, y, z};
    int q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int pos = (r.cube_dirs >> (6 * a)) & 7, flip = (r.cube_dirs >> (6 * a + 3)) & 7;
      q[a] = fabsf(c[a]) == m ? pos ^ (flip & (__float_as_int(c[a]) >> 31)) : kMaxPlates - 1;
    }
    pc = min(min(q[0], q[1]), q[2]);
    plate = pc;
    rz = m;
  } else if (R == kGiven) {
    // the script's plate: valid only where it is >= 0, its frame the
    // clipped plate's (rays_to_lensmap, blinky_tpu/lensmap/builder.py:232-236)
    plate = given;
    pc = plate < 0 ? 0 : (plate > r.nplates - 1 ? r.nplates - 1 : plate);
    const float4 fw = *(const float4*)(recs + pc * kRecord + 8);
    rz = dot3(x, y, z, fw.x, fw.y, fw.z);
  } else {
    // globes/fast.lua:10-27: the sharp plate's window, else the wide plate,
    // and nothing behind the camera
    const bool zero = z == 0.f;
    const float den = zero ? 1.f : z;
    const float qx = __fdiv_rn(x, den), qy = __fdiv_rn(y, den);
    const float u = __fmul_rn(zero ? 0.f : qx, r.fast_dist);
    const float v = __fmul_rn(zero ? 0.f : qy, r.fast_dist);
    const bool small = fabsf(u) < r.fast_half && fabsf(v) < r.fast_half;
    plate = z <= 0.f ? -1 : (small ? 0 : 1);
    pc = plate < 0 ? 0 : (plate > r.nplates - 1 ? r.nplates - 1 : plate);
    const float4 fw = *(const float4*)(recs + pc * kRecord + 8);
    rz = dot3(x, y, z, fw.x, fw.y, fw.z);
  }

  // the chosen plate's frame dots (ray_to_plate_uv, fisheye.c:2052-2058)
  const float4 a = *(const float4*)(recs + pc * kRecord);      // right, dist
  const float4 b = *(const float4*)(recs + pc * kRecord + 4);  // up
  float rx, ry;
  if constexpr (R == kCube) {
    // each product by 0 or +-1 is exact, so the fused sums round as dot3
    rx = __fmaf_rn(x, a.x, __fmaf_rn(y, a.y, __fmul_rn(z, a.z)));
    ry = __fmaf_rn(x, b.x, __fmaf_rn(y, b.y, __fmul_rn(z, b.z)));
  } else {
    rx = dot3(x, y, z, a.x, a.y, a.z);
    ry = dot3(x, y, z, b.x, b.y, b.z);
  }
  // The plain version divides by 1 where rz == 0 and then calls the pixel
  // invalid.  Dividing by the zero itself gives an infinite or NaN u or v,
  // which fails the range test below: the same pixels are valid, with the
  // same u and v, and no select is spent on the guard.
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(rx, rz), a.w), 0.5f);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(-ry, rz), a.w), 0.5f);
  const bool uv_valid = u >= 0.f && u <= 1.f && v >= 0.f && v <= 1.f;
  // truncation, fisheye.c:1988; an invalid u or v may cast to anything (the
  // card's conversion of NaN or inf is defined), as its pixel is dropped
  const int S = r.S;
  Texel t;
  t.pc = pc;
  t.px = (int)__fmul_rn(u, (float)S);
  t.py = (int)__fmul_rn(v, (float)S);
  t.valid = lens_valid && plate >= 0 && uv_valid && (unsigned)t.px < (unsigned)S &&
            (unsigned)t.py < (unsigned)S;
  return t;
}

// Whether a valid texel lies on a rubix grid line (set_lensmap_grid,
// fisheye.c:1922-1960), as a table: lensmap/builder.py::rubix_grid_lines
// computes the S flags on the host in double, and the kernels read them from
// a bitmask (bit px % 32 of word px / 32), so they do no double arithmetic.
__device__ __forceinline__ bool on_grid_line(const Texel& t, const uint32_t* lines) {
  return ((lines[t.px >> 5] >> (t.px & 31)) | (lines[t.py >> 5] >> (t.py & 31))) & 1u;
}

// One ray -> the flat source index, or -1 where the pixel is not valid.
// lines: the grid-line bitmask (read only for an expanded source), whose
// off-grid texels read the tinted half.
template <int R, bool ROT>
__device__ __forceinline__ int resolve_index(float vx, float vy, float vz, bool lens_valid,
                                             float3 f, float3 rt, float3 up,
                                             const Resolve& r, const float* recs,
                                             const uint32_t* lines, int given = 0) {
  const Texel t = resolve_texel<R, ROT>(vx, vy, vz, lens_valid, f, rt, up, r, recs, given);
  if (!t.valid) return -1;
  const int S = r.S;
  int idx = t.pc * S * S + t.py * S + t.px;
  if (r.expanded && !on_grid_line(t, lines)) idx += kMaxPlates * S * S;  // the tinted half
  return idx;
}

}  // namespace blinky
