// K5 and K6: the posed path's gather tail and its fused rotate-resolve-gather,
// written for Hopper (sm_90a).
//
// K5, blinky_posed_gather, replaces blinky_tpu/kernels/posed.py:102
// gather_posed (D), the posed pipelines' gather tail:
//
//   out[b, y, x] = valid[b, y/k, x/k] ? src[b, clip(idx[b, y/k, x/k], 0, N-1)]
//                                     : bg[y, x]
//
// K6, blinky_static_ray_posed, replaces blinky_tpu/kernels/static_ray.py:220
// _compiled_static_ray_pipeline (E): per pose, rays_to_lensmap
// (blinky_tpu/lensmap/builder.py:165) of the rotated ray table, the expanded
// source's tinted-half offset, then D.  The per-pose index table (5 bytes a
// build pixel and pose, 663 MB at 1080p and 64 poses) is never written.
//
// What bounds them on the card.  K5 moves bytes and does no arithmetic: a
// 4-byte index and a mask per build pixel and pose, one source texel, the
// screen.  K6 reads the same texels and writes the same screen, but reads
// the 13-byte ray a build pixel once for all its poses, and spends 86
// float32 operations a pose and build pixel on the cube globe (the 3x3
// rotation, the normalize with its sqrt and division, six forward dots and
// the first-max select, whose winning dot is the chosen plate's forward dot,
// the chosen plate's right and up dots, the uv divisions and the truncation;
// chip_smoke.py counts them): at 1080p and 64 poses that is 11.4 G
// operations, 0.34 ms at 33.5 T non-fused float32
// operations a second, against about 0.08 ms for its bytes.  So K6 is bound
// by operations.
//
// What the design does about it.  K5 runs a thread per build pixel and pose
// on a (pixels, poses) grid, so its index, mask and screen accesses
// coalesce.  In K6 one thread per build-grid pixel loads
// its ray once and loops over the kPosesPerBlock poses of its block, whose
// bases sit in shared memory with the globe's plate frames; neighbouring
// threads take neighbouring x, so the ray loads and the screen stores
// coalesce, and the gather reads one texel of the pose's own frame (the
// frame, 7 MB of u8 at S = 1080, and the table fit in the 50 MB L2).  The
// source offset b * N is 64-bit: it passes 2^31 at 154 poses of an
// expanded 1080p source.
//
// Rounding.  K6 must give the indices of its plain version,
// rays_to_lensmap_torch (blinky_tpu_torch/lensmap/builder.py), bit for bit.
// nvcc contracts a*b + c into one fused multiply-add by default, which
// rounds once where the plain version rounds twice and moves texel
// boundaries; so every float operation here is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never
// contracts, in the plain version's order.  The rubix grid test
// (set_lensmap_grid, fisheye.c:1922-1960) divides and takes fmod in double,
// as the C and the JAX package's x64 test mesh do: a float32 grid moves grid
// lines by a pixel where px / unit lands near a block edge.  Only the
// expanded source needs it, because the tint moves the index into the
// tinted half; the other sources skip it.

#include <string.h>

#include "common.cuh"

namespace {

using blinky::kThreads;

constexpr int kMaxPlates = 6;
constexpr int kPlateFloats = 10;  // forward[3], right[3], up[3], dist
constexpr int kPosesPerBlock = 8;

// The globe and the resolve parameters, passed by value.
struct Resolve {
  float plates[kMaxPlates * kPlateFloats];
  int nplates;
  int resolver;  // 0: strict first max of the forward dots; 1: the fast globe
  float fast_dist, fast_half;
  double unit, block, pad;  // the rubix grid, in double
  int S, expanded;
};

__device__ __forceinline__ float dot3(float x, float y, float z, const float* v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, v[0]), __fmul_rn(y, v[1])), __fmul_rn(z, v[2]));
}

// One ray and one pose -> the flat source index, or -1 where the pixel is
// not valid.  `basis` holds the pose's forward, right, up rows; `plates` the
// globe's frames as Resolve::plates lays them out.
__device__ __forceinline__ int resolve_index(float vx, float vy, float vz, bool lens_valid,
                                             const float* basis, const float* plates,
                                             const Resolve& r) {
  // ray' = vx * right + vy * up + vz * forward, each component left to right
  float x = __fadd_rn(__fadd_rn(__fmul_rn(vx, basis[3]), __fmul_rn(vy, basis[6])),
                      __fmul_rn(vz, basis[0]));
  float y = __fadd_rn(__fadd_rn(__fmul_rn(vx, basis[4]), __fmul_rn(vy, basis[7])),
                      __fmul_rn(vz, basis[1]));
  float z = __fadd_rn(__fadd_rn(__fmul_rn(vx, basis[5]), __fmul_rn(vy, basis[8])),
                      __fmul_rn(vz, basis[2]));
  // normalize_c with a float32 sqrt: a zero length leaves the ray as it is,
  // a NaN length is "truthy" and spreads
  const float len = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                         __fmul_rn(z, z)));
  const float inv = len != 0.f ? __fdiv_rn(1.f, len) : 1.f;
  x = __fmul_rn(x, inv);
  y = __fmul_rn(y, inv);
  z = __fmul_rn(z, inv);

  const int n = r.nplates;
  int plate, pc;
  float rz;  // the chosen plate's forward dot
  if (r.resolver == 0) {
    rz = dot3(x, y, z, plates);
    pc = 0;
    for (int k = 1; k < n; ++k) {
      const float d = dot3(x, y, z, plates + k * kPlateFloats);
      if (d > rz) {  // strict: the first maximum wins, NaN keeps plate 0
        rz = d;
        pc = k;
      }
    }
    plate = pc;
  } else {
    // globes/fast.lua:10-27: the sharp plate's window, else the wide plate,
    // and nothing behind the camera
    const bool zero = z == 0.f;
    const float den = zero ? 1.f : z;
    const float u = __fmul_rn(zero ? 0.f : __fdiv_rn(x, den), r.fast_dist);
    const float v = __fmul_rn(zero ? 0.f : __fdiv_rn(y, den), r.fast_dist);
    const bool small = fabsf(u) < r.fast_half && fabsf(v) < r.fast_half;
    plate = z <= 0.f ? -1 : (small ? 0 : 1);
    pc = plate < 0 ? 0 : (plate > n - 1 ? n - 1 : plate);
    rz = dot3(x, y, z, plates + pc * kPlateFloats);
  }

  // the chosen plate's frame dots (ray_to_plate_uv, fisheye.c:2052-2058)
  const float* p = plates + pc * kPlateFloats;
  const float rx = dot3(x, y, z, p + 3);
  const float ry = dot3(x, y, z, p + 6);
  const float dist = p[9];
  const bool zero = rz == 0.f;
  const float den = zero ? 1.f : rz;
  float u = __fadd_rn(__fmul_rn(zero ? 0.f : __fdiv_rn(rx, den), dist), 0.5f);
  float v = __fadd_rn(__fmul_rn(zero ? 0.f : __fdiv_rn(-ry, den), dist), 0.5f);
  const bool uv_valid = !zero && u >= 0.f && u <= 1.f && v >= 0.f && v <= 1.f;
  if (!uv_valid) {  // zeroed before the cast, so nothing casts a NaN
    u = 0.f;
    v = 0.f;
  }
  const int S = r.S;
  const int px = (int)__fmul_rn(u, (float)S);  // truncation, fisheye.c:1988
  const int py = (int)__fmul_rn(v, (float)S);
  const bool valid = lens_valid && plate >= 0 && uv_valid && px >= 0 && px < S &&
                     py >= 0 && py < S;
  if (!valid) return -1;
  int idx = pc * S * S + py * S + px;
  if (r.expanded) {
    const bool ongrid = fmod(__ddiv_rn((double)px, r.unit), r.block) < r.pad ||
                        fmod(__ddiv_rn((double)py, r.unit), r.block) < r.pad;
    if (!ongrid) idx += kMaxPlates * S * S;  // the tinted half
  }
  return idx;
}

// Writes a build pixel's k x k block of one pose's screen.
template <typename T>
__device__ __forceinline__ void write_block(T* __restrict__ out, const T* __restrict__ bg,
                                            long long b, int y, int x, int k, int H, int W,
                                            bool valid, T texel) {
  T* o = out + ((long long)b * H + (long long)y * k) * W + (long long)x * k;
  const T* g = bg + (long long)y * k * W + (long long)x * k;
  for (int dy = 0; dy < k; ++dy)
    for (int dx = 0; dx < k; ++dx)
      o[(long long)dy * W + dx] = valid ? texel : g[(long long)dy * W + dx];
}

// grid: x over build pixels (fewer than 2^31), y over poses; neighbouring
// threads take neighbouring pixels of one pose, so the index, mask and
// screen accesses coalesce and no thread divides in 64 bits
template <typename T>
__global__ void __launch_bounds__(kThreads) posed_gather_kernel(
    const T* __restrict__ src, long long N, int B, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid, const T* __restrict__ bg, int k, int hb, int wb,
    T* __restrict__ out) {
  const int npix = hb * wb;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int y = p / wb, x = p - y * wb;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long q = (long long)b * npix + p;
    const bool v = valid[q] != 0;
    T texel = T(0);
    if (v) {
      const long long i = idx[q];
      texel = src[(long long)b * N + (i < 0 ? 0 : (i >= N ? N - 1 : i))];
    }
    write_block(out, bg, b, y, x, k, hb * k, wb * k, v, texel);
  }
}

// grid: x over build pixels, y over groups of kPosesPerBlock poses
template <typename T>
__global__ void __launch_bounds__(kThreads) static_ray_posed_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const uint8_t* __restrict__ lens_valid, int hb, int wb,
    const float* __restrict__ bases, int B, const Resolve r, const T* __restrict__ src,
    long long N, const T* __restrict__ bg, int k, T* __restrict__ out) {
  __shared__ float s_plates[kMaxPlates * kPlateFloats];
  __shared__ float s_bases[kPosesPerBlock * 9];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxPlates * kPlateFloats; ++i) s_plates[i] = r.plates[i];
  }
  const int b0 = blockIdx.y * kPosesPerBlock;
  const int nb = min(kPosesPerBlock, B - b0);
  for (int i = threadIdx.x; i < nb * 9; i += kThreads) s_bases[i] = bases[(long long)b0 * 9 + i];
  __syncthreads();

  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)hb * wb) return;
  const float rx = vx[p], ry = vy[p], rz = vz[p];
  const bool lv = lens_valid[p] != 0;
  const int y = (int)(p / wb), x = (int)(p - (long long)y * wb);
  for (int j = 0; j < nb; ++j) {
    const long long b = b0 + j;
    const int i = resolve_index(rx, ry, rz, lv, s_bases + j * 9, s_plates, r);
    T texel = T(0);
    if (i >= 0) texel = src[b * N + (i >= N ? N - 1 : i)];
    write_block(out, bg, b, y, x, k, hb * k, wb * k, i >= 0, texel);
  }
}

}  // namespace

// src [batch, N] texels of elem_bytes (1 or 4), pose-major; idx, valid
// [batch, hb, wb]; bg [hb * k, wb * k]; out [batch, hb * k, wb * k].
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_posed_gather(const void* src, long long N, int elem_bytes, int batch,
                                   const int32_t* idx, const uint8_t* valid, const void* bg,
                                   int k, int hb, int wb, void* out, void* stream) {
  const long long npix = (long long)hb * wb;
  if (k < 1 || N < 1 || batch < 1 || npix < 1 || npix >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 blocks((unsigned)((npix + kThreads - 1) / kThreads),
                    (unsigned)(batch < 65535 ? batch : 65535));
  if (elem_bytes == 1) {
    posed_gather_kernel<uint8_t><<<blocks, kThreads, 0, s>>>(
        (const uint8_t*)src, N, batch, idx, valid, (const uint8_t*)bg, k, hb, wb,
        (uint8_t*)out);
  } else if (elem_bytes == 4) {
    posed_gather_kernel<uint32_t><<<blocks, kThreads, 0, s>>>(
        (const uint32_t*)src, N, batch, idx, valid, (const uint32_t*)bg, k, hb, wb,
        (uint32_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// vx, vy, vz [hb, wb] f32 and lens_valid [hb, wb] bool: the ray table;
// bases [batch, 3, 3] f32 (forward, right, up rows); plates: a HOST pointer
// to 6 x 10 floats (forward, right, up, dist of each plate), copied into the
// launch; resolver 0 = max-dot, 1 = the fast globe with fast_dist and
// fast_half; unit, block, pad: the rubix grid in double (read only when
// expanded); S the plate size; src [batch, N] pose-major texels of
// elem_bytes; bg [hb * k, wb * k]; out [batch, hb * k, wb * k].
extern "C" int blinky_static_ray_posed(const float* vx, const float* vy, const float* vz,
                                       const uint8_t* lens_valid, int hb, int wb,
                                       const float* bases, int batch, const float* plates,
                                       int nplates, int resolver, float fast_dist,
                                       float fast_half, double unit, double block,
                                       double pad, int S, int expanded, const void* src,
                                       long long N, int elem_bytes, const void* bg, int k,
                                       void* out, void* stream) {
  if (k < 1 || N < 1 || nplates < 1 || nplates > kMaxPlates || batch < 1)
    return (int)cudaErrorInvalidValue;
  Resolve r;
  memcpy(r.plates, plates, sizeof(r.plates));
  r.nplates = nplates;
  r.resolver = resolver;
  r.fast_dist = fast_dist;
  r.fast_half = fast_half;
  r.unit = unit;
  r.block = block;
  r.pad = pad;
  r.S = S;
  r.expanded = expanded;
  const long long npix = (long long)hb * wb;
  const dim3 grid((unsigned)((npix + kThreads - 1) / kThreads),
                  (unsigned)((batch + kPosesPerBlock - 1) / kPosesPerBlock));
  if (grid.x < 1 || grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1) {
    static_ray_posed_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        vx, vy, vz, lens_valid, hb, wb, bases, batch, r, (const uint8_t*)src, N,
        (const uint8_t*)bg, k, (uint8_t*)out);
  } else if (elem_bytes == 4) {
    static_ray_posed_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        vx, vy, vz, lens_valid, hb, wb, bases, batch, r, (const uint32_t*)src, N,
        (const uint32_t*)bg, k, (uint32_t*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
