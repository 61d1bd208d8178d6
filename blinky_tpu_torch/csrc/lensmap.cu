// K8: the float32 device lensmap builder's resolve, written for Hopper
// (sm_90a).
//
// Replaces rays_to_lensmap (blinky_tpu/lensmap/builder.py:165) under the jit
// of blinky_tpu/lensmap/builder.py:338 _compiled_inverse_builder (F): the
// lens-independent half of the inverse build.  Per screen pixel, the camera
// ray the lens stage left (three float32 planes and the lens's validity
// mask) is rotated by the view basis, normalized and resolved to a plate and
// a texel, and the six tables of the lensmap are written:
//
//   plate     int32  the plate, -1 where the pixel is invalid
//   px, py    int32  the texel, 0 where invalid
//   valid     bool
//   tint      uint8  the plate where valid and off the rubix grid lines, else 6
//   flat_idx  int32  plate * S * S + py * S + px, 0 where invalid
//
// and plates_used[p] is set where some valid pixel chose plate p.  The
// arithmetic is resolve.cuh's, shared with K6 and K9, so the tables equal
// rays_to_lensmap_torch (blinky_tpu_torch/lensmap/builder.py) bit for bit.
//
// What bounds it on the card: bytes.  13 bytes read and 18 written a pixel
// (64.3 MB at 1080p, about 0.019 ms at 3.35 TB/s) against 86 float32
// operations a pixel (0.005 ms): the kernel sits near the launch latency.
// The design is the simple one: a pixel a thread, every access coalesced,
// the globe in the parameter space and the chosen plate's record in shared
// memory as in K6, the grid test read from the host's table, and
// plates_used gathered per warp and per block before one atomic a block.
// K8 always rotates: a build without a view rotates by the identity, as the
// JAX builder does, which differs from no rotation where a ray component is
// infinite (inf * 0 is NaN).
//
// A script globe (a .lua globe_plate) resolves in mode 2, "given plate": the
// JAX builder calls the script on the rotated unit rays (builder.py:228-236);
// here the rotate pre-pass below writes those rays, the script evaluates on
// them as tensors, and K8 reads its int32 plate a pixel (4 more bytes) in
// place of the max-dot scan, with the same clip and plate >= 0 test.
//
// K13, blinky_rotate_rays, is that pre-pass: per pose b and pixel p, the
// ray (vx, vy, vz)[p] rotated by bases[b] and normalized, written as three
// float32 planes [batch, npix]; with no bases, ray b * npix + p normalized
// and not rotated (the zoom sweep's rays, a table a step).  It runs
// resolve.cuh's rotate_normalize, the code K6, K8 and K9 resolve with, so the
// script sees their rays bit for bit.
// Bound by bytes: 12 read a pixel once, 12 written a pose and pixel.

#include "resolve.cuh"

namespace {

using blinky::kMaxPlates;
using blinky::kRecord;
using blinky::kThreads;
using blinky::Resolve;
using blinky::Texel;

// The view basis, by value: forward, right, up rows.
struct Basis {
  float m[9];
};

template <int R>
__global__ void __launch_bounds__(kThreads) lensmap_resolve_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy, const float* __restrict__ vz,
    const uint8_t* __restrict__ lens_valid, long long npix, const Basis basis, const Resolve r,
    const int32_t* __restrict__ given, const uint32_t* __restrict__ grid_lines,
    int32_t* __restrict__ plate,
    int32_t* __restrict__ px, int32_t* __restrict__ py, uint8_t* __restrict__ valid,
    uint8_t* __restrict__ tint, int32_t* __restrict__ flat_idx, int* __restrict__ used) {
  __shared__ __align__(16) float s_recs[kMaxPlates * kRecord];
  __shared__ unsigned s_used;
  extern __shared__ uint32_t s_lines[];  // (S + 31) / 32 words
  const int tid = threadIdx.x;
  if (tid == 0) {
    blinky::fill_plate_records(r, s_recs);
    s_used = 0u;
  }
  for (int i = tid; i < (r.S + 31) / 32; i += kThreads) s_lines[i] = grid_lines[i];
  __syncthreads();

  const float3 f = make_float3(basis.m[0], basis.m[1], basis.m[2]);
  const float3 rt = make_float3(basis.m[3], basis.m[4], basis.m[5]);
  const float3 up = make_float3(basis.m[6], basis.m[7], basis.m[8]);
  const long long p = (long long)blockIdx.x * kThreads + tid;
  unsigned mine = 0u;  // bit pc where this pixel is valid
  if (p < npix) {
    const Texel t = blinky::resolve_texel<R, true>(vx[p], vy[p], vz[p], lens_valid[p] != 0, f,
                                                   rt, up, r, s_recs,
                                                   R == blinky::kGiven ? given[p] : 0);
    const int S = r.S;
    int tn = kMaxPlates;  // TINT_NONE
    if (t.valid) {
      mine = 1u << t.pc;
      if (!blinky::on_grid_line(t, s_lines)) tn = t.pc;
    }
    plate[p] = t.valid ? t.pc : -1;
    px[p] = t.valid ? t.px : 0;
    py[p] = t.valid ? t.py : 0;
    valid[p] = t.valid ? 1 : 0;
    tint[p] = (uint8_t)tn;
    flat_idx[p] = t.valid ? t.pc * S * S + t.py * S + t.px : 0;
  }
  // plates_used: OR over the warp, then the block, then one atomic a plate
  // bit set in the block
  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((tid & 31) == 0 && mine) atomicOr(&s_used, mine);
  __syncthreads();
  if (tid < kMaxPlates && ((s_used >> tid) & 1u)) atomicOr(used + tid, 1);
}

// K13.  grid: x over pixels, y over poses or steps (a grid-stride loop past
// 65535).  ROT: rotate the one table by each pose's basis; else normalize
// table b (vx + b * npix).
template <bool ROT>
__global__ void __launch_bounds__(kThreads) rotate_rays_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy, const float* __restrict__ vz,
    long long npix, const float* __restrict__ bases, int batch, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oz) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long q = (long long)b * npix + p;
    const long long in = ROT ? p : q;
    float3 f = make_float3(0.f, 0.f, 0.f), rt = f, up = f;  // read only when ROT
    if (ROT) {
      const float* m = bases + (long long)b * 9;
      f = make_float3(m[0], m[1], m[2]);
      rt = make_float3(m[3], m[4], m[5]);
      up = make_float3(m[6], m[7], m[8]);
    }
    float x, y, z;
    blinky::rotate_normalize<ROT>(vx[in], vy[in], vz[in], f, rt, up, x, y, z);
    ox[q] = x;
    oy[q] = y;
    oz[q] = z;
  }
}

}  // namespace

// vx, vy, vz [npix] f32 and lens_valid [npix] bool: the lens stage's rays;
// basis: a HOST pointer to 9 floats (forward, right, up rows), copied into
// the launch; plates: a HOST pointer to 6 x 10 floats; resolver 0 = max-dot,
// 1 = the fast globe with fast_dist and fast_half, 2 = the plate given in
// given [npix] int32 (null for the other resolvers); grid_lines: the rubix
// grid-line bitmask on the device (lensmap/builder.py::rubix_grid_lines); S
// the plate size; the six tables [npix] and used [6] int32, zeroed by the
// caller, on the device.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_lensmap_resolve(const float* vx, const float* vy, const float* vz,
                                      const uint8_t* lens_valid, long long npix,
                                      const float* basis, const float* plates, int nplates,
                                      int resolver, float fast_dist, float fast_half,
                                      const int32_t* given, const uint32_t* grid_lines, int S,
                                      int32_t* plate, int32_t* px, int32_t* py, uint8_t* valid,
                                      uint8_t* tint, int32_t* flat_idx, int* used,
                                      void* stream) {
  Resolve r;
  if (npix < 1 || grid_lines == nullptr || (resolver == blinky::kGiven && given == nullptr) ||
      !blinky::make_resolve(r, plates, nplates, resolver, fast_dist, fast_half, S, 0))
    return (int)cudaErrorInvalidValue;
  Basis b;
  memcpy(b.m, basis, sizeof(b.m));
  const long long blocks = (npix + kThreads - 1) / kThreads;
  const size_t smem = (size_t)((S + 31) / 32) * 4;
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (resolver == blinky::kMaxDot)
    lensmap_resolve_kernel<blinky::kMaxDot><<<(unsigned)blocks, kThreads, smem, s>>>(
        vx, vy, vz, lens_valid, npix, b, r, given, grid_lines, plate, px, py, valid, tint,
        flat_idx, used);
  else if (resolver == blinky::kFast)
    lensmap_resolve_kernel<blinky::kFast><<<(unsigned)blocks, kThreads, smem, s>>>(
        vx, vy, vz, lens_valid, npix, b, r, given, grid_lines, plate, px, py, valid, tint,
        flat_idx, used);
  else
    lensmap_resolve_kernel<blinky::kGiven><<<(unsigned)blocks, kThreads, smem, s>>>(
        vx, vy, vz, lens_valid, npix, b, r, given, grid_lines, plate, px, py, valid, tint,
        flat_idx, used);
  return (int)cudaGetLastError();
}

// K13: vx, vy, vz f32 rays, [npix] with bases [batch, 3, 3] f32 on the
// device (forward, right, up rows), or [batch, npix] with bases null (no
// rotation); ox, oy, oz [batch, npix] f32, the unit rays.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_rotate_rays(const float* vx, const float* vy, const float* vz,
                                  long long npix, const float* bases, int batch, float* ox,
                                  float* oy, float* oz, void* stream) {
  if (npix < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(batch < 65535 ? batch : 65535));
  cudaStream_t s = (cudaStream_t)stream;
  if (bases != nullptr)
    rotate_rays_kernel<true><<<grid, kThreads, 0, s>>>(vx, vy, vz, npix, bases, batch, ox, oy,
                                                       oz);
  else
    rotate_rays_kernel<false><<<grid, kThreads, 0, s>>>(vx, vy, vz, npix, bases, batch, ox, oy,
                                                        oz);
  return (int)cudaGetLastError();
}
