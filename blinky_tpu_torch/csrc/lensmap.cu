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
    const uint32_t* __restrict__ grid_lines, int32_t* __restrict__ plate,
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
                                                   rt, up, r, s_recs);
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

}  // namespace

// vx, vy, vz [npix] f32 and lens_valid [npix] bool: the lens stage's rays;
// basis: a HOST pointer to 9 floats (forward, right, up rows), copied into
// the launch; plates: a HOST pointer to 6 x 10 floats; resolver 0 = max-dot,
// 1 = the fast globe with fast_dist and fast_half; grid_lines: the rubix
// grid-line bitmask on the device (lensmap/builder.py::rubix_grid_lines); S
// the plate size; the six tables [npix] and used [6] int32, zeroed by the
// caller, on the device.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_lensmap_resolve(const float* vx, const float* vy, const float* vz,
                                      const uint8_t* lens_valid, long long npix,
                                      const float* basis, const float* plates, int nplates,
                                      int resolver, float fast_dist, float fast_half,
                                      const uint32_t* grid_lines, int S, int32_t* plate,
                                      int32_t* px, int32_t* py, uint8_t* valid, uint8_t* tint,
                                      int32_t* flat_idx, int* used, void* stream) {
  Resolve r;
  if (npix < 1 || grid_lines == nullptr ||
      !blinky::make_resolve(r, plates, nplates, resolver, fast_dist, fast_half, S, 0))
    return (int)cudaErrorInvalidValue;
  Basis b;
  memcpy(b.m, basis, sizeof(b.m));
  const long long blocks = (npix + kThreads - 1) / kThreads;
  const size_t smem = (size_t)((S + 31) / 32) * 4;
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (resolver == 0)
    lensmap_resolve_kernel<0><<<(unsigned)blocks, kThreads, smem, s>>>(
        vx, vy, vz, lens_valid, npix, b, r, grid_lines, plate, px, py, valid, tint, flat_idx,
        used);
  else
    lensmap_resolve_kernel<1><<<(unsigned)blocks, kThreads, smem, s>>>(
        vx, vy, vz, lens_valid, npix, b, r, grid_lines, plate, px, py, valid, tint, flat_idx,
        used);
  return (int)cudaGetLastError();
}
