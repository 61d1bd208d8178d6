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
//
// What bounds K13: bytes, 12 read a pixel once and 12 written a pose and
// pixel (1.62 GB at 1080p and 64 poses, 0.48 ms at 3.35 TB/s), against 26
// float32 operations a pose and pixel (0.10 ms).  The output is a pure write
// stream, 30 times the L2.  What its design does about it:
//  * a thread takes a run of four neighbouring pixels: one float4 load a
//    plane, one float4 store a plane and pose;
//  * and K13_POSES poses: the run's rays stay in registers for all of them,
//    so the table is read once a block of poses, not once a pose;
//  * a block stages its poses' bases once in shared memory, and reads a
//    pose's as three broadcast 16-byte loads;
//  * the grid covers the poses in blocks of K13_POSES (y, a block-stride
//    loop past 65535 blocks) and the runs in x: one pose is a grid over
//    pixels only (the build's call);
//  * streaming stores (__stcs, evict-first), so the write stream does not
//    push the ray table out of L2.
// The unrotated mode is elementwise over batch * npix rays, so it runs as
// one row of that length and one "pose".  A run stores whole float4s where
// its output rows lie on 16 bytes (npix a multiple of four, or one pose, and
// the outputs aligned); its loads are float4s where the three inputs lie on
// 16 bytes too, else four scalar loads (an input view with a storage
// offset).  A row's last run, short when npix % 4 != 0, is stored a pixel
// at a time.  Rotated rows off 16 bytes (npix % 4 != 0 and more than one
// pose) take the kernel with runs of one pixel.

#include "resolve.cuh"

// K13's tuning constants, overridable with -D for bench/posed.py's sweep.
// Chosen at 1080p (NVIDIA H100 80GB HBM3, 700 W; see PERF.md), by events
// around launches of the entry point: 128 threads, 32 poses a thread,
// streaming stores: 0.5520 ms at B = 64 (88 % of the byte bound), 0.0151 ms
// for one pose, 0.1371 ms for 8 unrotated steps.  Runners-up in the same
// run: plain stores in place of __stcs 0.7566 / 0.0182 / 0.1366, so the
// stores are streaming; 8 poses 0.6358, 16 poses 0.6053, 64 poses 0.6075
// at B = 64; 256 threads 0.5696 / 0.0153; 512 threads 0.5700 / 0.0158; 64
// poses and 256 threads 0.6022; 16 poses and plain stores 0.7193.  The
// poses a thread, not the threads, set the rays' reuse: 4 poses took 0.69
// ms.
#ifndef K13_THREADS
#define K13_THREADS 128
#endif
#ifndef K13_POSES
#define K13_POSES 32
#endif

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

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// K13.  grid: x over runs of M pixels of a row of n, y over blocks of
// K13_POSES poses (a block-stride loop past 65535).  ROT: rotate the one
// table by each pose's basis, out[b * n + p]; else normalize element p of
// one row (n = batch * npix, one "pose").  M: 4 (a whole run stores
// float4s; vload: it loads float4s) or 1.
template <bool ROT, int M>
__global__ void __launch_bounds__(K13_THREADS) rotate_rays_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy, const float* __restrict__ vz,
    long long n, const float* __restrict__ bases, int batch, bool vload,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz) {
  constexpr int P = ROT ? K13_POSES : 1;
  __shared__ __align__(16) float s_bases[P * kRecord];
  const int tid = threadIdx.x;
  const long long p0 = ((long long)blockIdx.x * K13_THREADS + tid) * M;
  // the run's pixels: M, or fewer for a row's last run
  const int m = p0 < n ? (int)(n - p0 < M ? n - p0 : M) : 0;
  float rx[M], ry[M], rz[M];
  bool loaded = false;
  if constexpr (M == 4) {
    if (m == 4 && vload) {
      const float4 a = *(const float4*)(vx + p0), b = *(const float4*)(vy + p0),
                   c = *(const float4*)(vz + p0);
      rx[0] = a.x, rx[1] = a.y, rx[2] = a.z, rx[3] = a.w;
      ry[0] = b.x, ry[1] = b.y, ry[2] = b.z, ry[3] = b.w;
      rz[0] = c.x, rz[1] = c.y, rz[2] = c.z, rz[3] = c.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      rx[i] = i < m ? vx[p0 + i] : 0.f;
      ry[i] = i < m ? vy[p0 + i] : 0.f;
      rz[i] = i < m ? vz[p0 + i] : 0.f;
    }
  }
  const float3 none = make_float3(0.f, 0.f, 0.f);  // no rotation: never read
  for (int b0 = blockIdx.y * P; b0 < batch; b0 += gridDim.y * P) {
    const int nb = min(P, batch - b0);
    if (ROT) {
      __syncthreads();  // the previous block of poses' bases are read
      // a pose's record: forward, right, up, then three zeros
      for (int i = tid; i < nb * kRecord; i += K13_THREADS) {
        const int j = i / kRecord, c = i - j * kRecord;
        s_bases[i] = c < 9 ? bases[(long long)(b0 + j) * 9 + c] : 0.f;
      }
      __syncthreads();
    }
    if (m == 0) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (j >= nb) break;
      float3 f = none, rt = none, up = none;
      if (ROT) {
        const float4 e0 = *(const float4*)(s_bases + j * kRecord);
        const float4 e1 = *(const float4*)(s_bases + j * kRecord + 4);
        const float4 e2 = *(const float4*)(s_bases + j * kRecord + 8);
        f = make_float3(e0.x, e0.y, e0.z), rt = make_float3(e0.w, e1.x, e1.y);
        up = make_float3(e1.z, e1.w, e2.x);
      }
      float x[M], y[M], z[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        blinky::rotate_normalize<ROT>(rx[i], ry[i], rz[i], f, rt, up, x[i], y[i], z[i]);
      const long long q = (long long)(b0 + j) * (ROT ? n : 0) + p0;
      if constexpr (M == 4) {
        if (m == 4) {
          __stcs((float4*)(ox + q), make_float4(x[0], x[1], x[2], x[3]));
          __stcs((float4*)(oy + q), make_float4(y[0], y[1], y[2], y[3]));
          __stcs((float4*)(oz + q), make_float4(z[0], z[1], z[2], z[3]));
          continue;
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= m) break;
        __stcs(ox + q + i, x[i]);
        __stcs(oy + q + i, y[i]);
        __stcs(oz + q + i, z[i]);
      }
    }
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
  const bool rot = bases != nullptr;
  // the unrotated mode is one row of batch * npix rays
  const long long n = rot ? npix : npix * batch;
  const int rows = rot ? batch : 1;
  // runs of four: every output row on 16 bytes
  const bool vec = (n % 4 == 0 || rows == 1) && aligned16(ox) && aligned16(oy) && aligned16(oz);
  const bool vload = aligned16(vx) && aligned16(vy) && aligned16(vz);
  const int M = vec ? 4 : 1;
  const long long blocks = ((n + M - 1) / M + K13_THREADS - 1) / K13_THREADS;
  const int P = rot ? K13_POSES : 1;
  const long long pose_blocks = (rows + P - 1) / P;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(pose_blocks < 65535 ? pose_blocks : 65535));
  cudaStream_t s = (cudaStream_t)stream;
  if (rot && vec)
    rotate_rays_kernel<true, 4><<<grid, K13_THREADS, 0, s>>>(vx, vy, vz, n, bases, rows, vload,
                                                             ox, oy, oz);
  else if (rot)
    rotate_rays_kernel<true, 1><<<grid, K13_THREADS, 0, s>>>(vx, vy, vz, n, bases, rows, vload,
                                                             ox, oy, oz);
  else if (vec)
    rotate_rays_kernel<false, 4><<<grid, K13_THREADS, 0, s>>>(vx, vy, vz, n, bases, rows,
                                                              vload, ox, oy, oz);
  else
    rotate_rays_kernel<false, 1><<<grid, K13_THREADS, 0, s>>>(vx, vy, vz, n, bases, rows,
                                                              vload, ox, oy, oz);
  return (int)cudaGetLastError();
}
