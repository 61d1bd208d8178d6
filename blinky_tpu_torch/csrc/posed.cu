// K5, K6 and K9: the posed path's gather tail, its fused
// rotate-resolve-gather, and the fused zoom sweep, written for Hopper
// (sm_90a).
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
// build pixel and pose, 663 MB at 1080p and 64 poses) is never written.  It
// also serves blinky_tpu/kernels/posed.py:136 _compiled_posed_pipeline (G1):
// the lens stage does not depend on the pose, so the fused vmapped builder is
// K6 on a ray table from the float32 lens stage.
//
// K9, blinky_sweep_remap, replaces blinky_tpu/kernels/posed.py:294
// _compiled_sweep_pipeline (G2): per zoom step, rays_to_lensmap of the step's
// own ray table with NO rotation, the tinted-half offset, the clipped gather
// from the ONE shared source, the background select.  It is K6's loop with a
// ray table a step, a source stride of zero and the rotation compiled out.
// What bounds it: bytes, the 13-byte ray a step and pixel (0.65 GB for 24
// steps at 1080p) against 71 float32 operations a step and pixel.  A thread
// takes four neighbouring pixels of one step (float4 ray loads, one 4-byte or
// 16-byte store), or one pixel where the screen or a pointer is off 16 bytes.
//
// What bounds K5 and K6 on the card.  K5 moves bytes and does no arithmetic: a
// 4-byte index and a mask per build pixel and pose, one source texel, the
// screen.  K6 reads the same texels and writes the same screen, but reads
// the 13-byte ray a build pixel once for all its poses, and spends 86
// float32 operations a pose and build pixel on the cube globe (the 3x3
// rotation, the normalize with its sqrt and reciprocal, six forward dots and
// the first-max select, whose winning dot is the chosen plate's forward dot,
// the chosen plate's right and up dots, the uv divisions and the
// truncation; chip_smoke.py counts them): at 1080p and 64 poses that is
// 11.4 G operations, 0.34 ms at 33.5 T non-fused float32 operations a
// second, against about 0.08 ms for its bytes.  So K6 is bound by
// operations.  On the card an IEEE division, reciprocal or square root is a
// sequence of about ten instructions, not one, so the instructions K6 must issue
// lie well above the 86 operations: the issue rate of the SMs (128 lanes a
// clock each), not the float32 rate alone, sets its pace.
//
// What K5's design does about it (K6's shape of work without the resolve).
// A pixel a thread with its three dependent loads (mask, index, texel) and
// k x k one-element stores kept a few bytes in flight a thread, far from the
// 2 MB or so the card needs in flight to hide its memory latency.  So:
//  * a thread takes a run of four neighbouring build pixels: one 16-byte
//    index word and one 4-byte mask word a pose, loaded together and
//    unconditionally;
//  * a block takes a 2D tile of runs (K5_TILE_RUNS wide, 16 x 16 runs by
//    default), not a screen row: a lens maps a compact patch of the screen
//    to a compact patch of a plate in any orientation, so the block's
//    gathers share the source's sectors in L1, where a row of 1024 pixels
//    running across a plate's columns reads about a sector a pixel (1.8x
//    slower at u8 k = 1, chip_smoke.py --sweep);
//  * poses loop inside the block (K5_POSES_PER_BLOCK), the tables of the
//    next K5_POSE_GROUP poses are loaded while this group's are used, and a
//    group's valid texels are all gathered before its first store;
//  * the background is read once a block into registers, and only when one
//    of the run's pixels is invalid;
//  * a screen row of the run is one 4-byte (u8, k = 1), 8-byte (u8, k = 2)
//    or one or two 16-byte words (RGBA).
// Build widths that are not a multiple of four, pointers off 16 bytes and
// render scales k >= 3 take the scalar kernel, a pixel a thread.
//
// What K6's design does about it.
//  * No shared-memory operand a pose and pixel.  The globe's plate frames
//    ride in the launch's parameter space, so the six forward dots take
//    their constants straight from the constant bank; only the chosen
//    plate's right, up and distance are read from shared memory, as two
//    16-byte loads of a 12-float record (the record stride keeps the six
//    plates on disjoint banks).  A pose's basis is three broadcast 16-byte
//    loads, shared by the four pixels of a thread.
//  * A thread takes a run of four neighbouring build pixels of a row and
//    loads their rays as float4 (the ray table is read once per block of
//    poses).  It resolves the run for a group of kPoseGroup poses into
//    registers, then issues all their texel gathers back to back, then
//    stores: 4 x kPoseGroup loads in flight before the first store.  One
//    pose a group was fastest: the gathers' latency is a small part of the
//    time (the previous design lost 0.10 of 1.58 ms to it), and a larger
//    group costs registers, so fewer warps hide the IEEE sequences'
//    latency.
//  * Vector stores: a run's k x k screen block is written as one 4-byte
//    word a row for u8 at k = 1 (two 4-byte words at k = 2), one 16-byte
//    word for RGBA at k = 1 (two a row at k = 2).  Build widths that are not
//    a multiple of four, and every other render scale, take the scalar
//    kernel of this file (K = 0), one element at a time.
//  * The background of a thread's pixels is read once per block, into
//    registers, and only when one of its pixels is invalid; every later
//    pose of the block reuses it.
//  * The resolve itself (resolve.cuh, shared with K8 and K9): the rubix grid
//    test as a table, the reciprocal for the normalize, and no guard whose
//    pixel is invalid either way.
//  * Poses per block, pose group and threads were chosen by measurement
//    (bench/posed.py, 1080p B=64 u8 k=1 and k=2); the choice and its
//    runners-up are at the constants below.
//
//  * Mode 2, a script globe's plates (R == kGiven): the block's plates of
//    every pose are copied into shared memory at its start, one 4-byte
//    cp.async a pose and run, so no resolve waits on a plate; the gather
//    clips its index in 32 bits from the pose's frame.
//  * Mode 3, the cube (R == kCube, the max-dot select on a globe whose
//    plates face the six signed axes, with signed axes for right and up):
//    the six forward dots and their select become the largest magnitude
//    of the unit ray's components and a pick among the plates facing the
//    axes that reach it, and the right and up dots fused sums of exact
//    products; bit-equal to max-dot (resolve.cuh says why).
//
// What is left: 179 SASS instructions a pose-pixel on the main path of the
// max-dot mode, 146.5 in mode 2 and 148.5 in mode 3 (bench/posed.py counts
// them: the loop less the slow paths, the expanded grid test and the
// background read) against the 86 and 58 operations of their bounds (mode 3
// is held to max-dot's 86, the work it stands for), each IEEE sequence some
// ten instructions with its range check and slow-path branch; at 128
// lane-instructions a clock on 132 SMs that alone is about twice the
// operation bound (PERF.md, K6's instruction floor).
//
// Rounding.  K6 and K9 must give the indices of their plain version,
// rays_to_lensmap_torch (blinky_tpu_torch/lensmap/builder.py), bit for bit;
// resolve.cuh says how.  The source offset b * N is 64-bit: it passes 2^31
// at 154 poses of an expanded 1080p source.

#include <limits.h>
#include <string.h>

#include "resolve.cuh"

// The tuning constants, overridable with -D for bench/posed.py's sweep.
// Chosen at 1080p B=64, u8 (NVIDIA H100 80GB HBM3, 700 W; see PERF.md):
// 128 threads, at most 128 registers (4 blocks an SM; ptxas uses 56-96),
// 16 poses a block, one pose a group: 0.8296 / 0.2466 ms at k = 1 / 2.
// Runners-up in the same run: 64 threads 0.8326 / 0.2501; 32 poses a block
// 0.8367 / 0.2573, 8 poses 0.8380 / 0.2466; a group of 2 poses 0.8394 /
// 0.2549; 256 threads 0.8448 / 0.2499; a group of 4 poses 1.0743 /
// 0.3168.  At most 3 blocks an SM changed nothing (0.8289 / 0.2466).
#ifndef K6_THREADS
#define K6_THREADS 128
#endif
#ifndef K6_POSES_PER_BLOCK
#define K6_POSES_PER_BLOCK 16
#endif
#ifndef K6_POSE_GROUP
#define K6_POSE_GROUP 1
#endif
#ifndef K6_MIN_BLOCKS
#define K6_MIN_BLOCKS 4
#endif
// Mode 2 (a script globe's given plates) keeps these constants: swept at
// 1080p B=64 on lfast's plates (bench/posed.py --what given; NVIDIA H100
// 80GB HBM3, 700 W), 16 poses a block and one a group took 0.6807 / 0.6956 /
// 0.2013 ms for u8 k = 1 / RGBA k = 1 / u8 k = 2.  Runners-up in the same
// run: 32 poses 0.6745 / 0.6953 / 0.2131 (a fifth fewer blocks at k = 2, so
// a worse last wave); 8 poses 0.7013 / 0.7133 / 0.2044; 64 poses 0.7614 /
// 0.8785 / 0.2958; a group of 2 poses 0.7030 / 0.7109 / 0.2110; 32 poses in
// groups of 2 0.6833 / 0.7282 / 0.2143.  A prefetch of the run's rays into
// L1 under the staging lost (0.6969 against 0.6954 ms), so the kernel has
// none.
// K5's vector kernel: threads a block, poses a block, poses whose tables
// and gathers are in flight together, and the width of a block's tile in
// runs of four build pixels (its height is K5_THREADS / K5_TILE_RUNS rows).
// Chosen at 1080p B=64 on phase 6's tables (chip_smoke.py --sweep; NVIDIA
// H100 80GB HBM3, 700 W): 256 threads, a tile 16 runs by 16 rows, 4 poses a
// block, 2 a group: 0.3325 / 0.6174 / 0.1628 / 0.4814 ms for u8 k = 1 /
// RGBA k = 1 / u8 k = 2 / RGBA k = 2.  Runners-up in the same run: 8 poses
// a block 0.3330 / 0.6372 / 0.1692 / 0.5110; 2 poses 0.3817 / 0.6040 /
// 0.1603 / 0.5031; 16 poses 0.3399 / 0.6668 / 0.1796 / 0.5440; a tile 8
// runs wide 0.3308 / 0.6221 / 0.1643 / 0.4786, 32 runs 0.3424 / 0.6217 /
// 0.1667 / 0.4885, 256 runs (one screen row of 1024 pixels) 0.6062 /
// 0.8021 / 0.2495 / 0.5235; a group of 1 pose 0.3257 / 0.6242 / 0.1641 /
// 0.5215, of 4 poses 0.3833 / 0.6202 / 0.1635 / 0.5421; 512 threads
// 0.3495 / 0.6135 / 0.1617 / 0.4685.  None is faster on all four.
// Streaming cache hints (__ldcs / __stcs) on the tables and screens were
// tried and lost on every variant, so the kernel has none.
#ifndef K5_THREADS
#define K5_THREADS 256
#endif
#ifndef K5_POSES_PER_BLOCK
#define K5_POSES_PER_BLOCK 4
#endif
#ifndef K5_POSE_GROUP
#define K5_POSE_GROUP 2
#endif
#ifndef K5_TILE_RUNS
#define K5_TILE_RUNS 16
#endif
static_assert(K5_THREADS % K5_TILE_RUNS == 0, "a K5 tile is whole rows of runs");

namespace {

using blinky::kThreads;

using blinky::kMaxPlates;
using blinky::kRecord;
using blinky::Resolve;
using blinky::resolve_index;

constexpr int kRun = 4;           // neighbouring build pixels a thread takes
constexpr int kPosesPerBlock = K6_POSES_PER_BLOCK;
constexpr int kPoseGroup = K6_POSE_GROUP;

// cp.async of 4 bytes from global to shared memory (sm_80 on), and the
// wait for every copy this thread issued
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Four elements of a screen row: one 4-byte word of u8, one 16-byte word of
// RGBA.
template <typename T> struct Quad;
template <> struct Quad<uint8_t> {
  using V = uint32_t;
  __device__ static void put(V& q, int e, uint32_t x) { q |= (x & 0xffu) << (8 * e); }
  __device__ static V select(V t, V m, V g) { return (t & m) | (g & ~m); }
  __device__ static V ones(int e) { return 0xffu << (8 * e); }
};
template <> struct Quad<uint32_t> {
  using V = uint4;
  __device__ static void put(V& q, int e, uint32_t x) {
    if (e == 0) q.x = x; else if (e == 1) q.y = x; else if (e == 2) q.z = x; else q.w = x;
  }
  __device__ static V select(V t, V m, V g) {
    return make_uint4((t.x & m.x) | (g.x & ~m.x), (t.y & m.y) | (g.y & ~m.y),
                      (t.z & m.z) | (g.z & ~m.z), (t.w & m.w) | (g.w & ~m.w));
  }
  __device__ static V ones(int e) {
    return make_uint4(e == 0 ? ~0u : 0u, e == 1 ? ~0u : 0u, e == 2 ? ~0u : 0u,
                      e == 3 ? ~0u : 0u);
  }
};
template <typename V> __device__ __forceinline__ V zero_quad() { return V{}; }
__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// A screen row of a run's k x k blocks, quads s[0 .. K-1]: one 4-byte or
// 8-byte word of u8, one or two 16-byte words of RGBA.
template <typename T, int K>
__device__ __forceinline__ void store_row(T* o, const typename Quad<T>::V* s) {
  using V = typename Quad<T>::V;
  if constexpr (sizeof(T) == 1 && K == 2) {
    *(uint2*)o = make_uint2(s[0], s[1]);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) ((V*)o)[c] = s[c];
  }
}

// K5's vector kernel.  grid: x over 2D tiles of runs of kRun build pixels
// (the build width a multiple of kRun, so a run lies in one row), y over
// blocks of K5_POSES_PER_BLOCK poses.  A tile, not a row, because a lens maps
// a compact patch of the screen to a compact patch of its plate in any
// orientation, so a block's gathers share the source's sectors in L1; a
// row of 1024 pixels across a plate's columns reads a sector a pixel.  K: the render scale, 1 or 2; every pointer
// 16-byte aligned.  A thread loads a pose's 16-byte index word and 4-byte
// mask word together, unconditionally, one pose group ahead of its use;
// gathers the group's valid texels, all before the first store; and writes
// each screen row of the run as whole words.
template <typename T, int K>
__global__ void __launch_bounds__(K5_THREADS) posed_gather_vec(
    const T* __restrict__ src, long long N, int B, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid, const T* __restrict__ bg, int hb, int wb,
    T* __restrict__ out) {
  using Q = Quad<T>;
  using V = typename Q::V;
  constexpr int G = K5_POSE_GROUP;
  const long long npix = (long long)hb * wb;
  // the block's tile: K5_TILE_RUNS runs wide, K5_THREADS / K5_TILE_RUNS rows
  constexpr int kTileRows = K5_THREADS / K5_TILE_RUNS;
  const int tiles_x = (wb / kRun + K5_TILE_RUNS - 1) / K5_TILE_RUNS;
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int x0 = (tx * K5_TILE_RUNS + (int)threadIdx.x % K5_TILE_RUNS) * kRun;
  const int y = ty * kTileRows + (int)threadIdx.x / K5_TILE_RUNS;
  if (x0 >= wb || y >= hb) return;
  const long long p0 = (long long)y * wb + x0;
  const int b0 = blockIdx.y * K5_POSES_PER_BLOCK;
  const int nb = min(K5_POSES_PER_BLOCK, B - b0);
  const long long W = (long long)wb * K;

  int4 iq[G];
  uint32_t vq[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    iq[g] = make_int4(0, 0, 0, 0), vq[g] = 0;
    if (g < nb) {
      const long long q = (long long)(b0 + g) * npix + p0;
      iq[g] = *(const int4*)(idx + q);
      vq[g] = *(const uint32_t*)(valid + q);
    }
  }
  V bgq[K * K];  // the run's background, row dy, quad c at [dy * K + c]
  bool have_bg = false;
  for (int j0 = 0; j0 < nb; j0 += G) {
    int4 ic[G];
    uint32_t vc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ic[g] = iq[g], vc[g] = vq[g];
      iq[g] = make_int4(0, 0, 0, 0), vq[g] = 0;
      if (j0 + G + g < nb) {  // the next group's tables, in flight under this one
        const long long q = (long long)(b0 + j0 + G + g) * npix + p0;
        iq[g] = *(const int4*)(idx + q);
        vq[g] = *(const uint32_t*)(valid + q);
      }
    }
    T val[G][kRun];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* s = src + (long long)(b0 + min(j0 + g, nb - 1)) * N;
      const int ii[kRun] = {ic[g].x, ic[g].y, ic[g].z, ic[g].w};
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const long long t = ii[i];
        val[g][i] = ((vc[g] >> (8 * i)) & 0xffu) ? s[t < 0 ? 0 : (t >= N ? N - 1 : t)] : T(0);
      }
    }
    if (!have_bg) {
      bool hole = false;
#pragma unroll
      for (int g = 0; g < G; ++g)
        hole |= j0 + g < nb && __vcmpeq4(vc[g], 0u) != 0;  // a mask byte of 0
      if (hole) {  // the first invalid pixel of the run: read its background
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int c = 0; c < K; ++c)
            bgq[dy * K + c] = *(const V*)(bg + ((long long)y * K + dy) * W + (long long)x0 * K + 4 * c);
        have_bg = true;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (j0 + g >= nb) break;
      const long long b = b0 + j0 + g;
      V t[K], mk[K];  // quad c of a screen row: texels and their mask
#pragma unroll
      for (int c = 0; c < K; ++c) {
        t[c] = zero_quad<V>(), mk[c] = zero_quad<V>();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (4 * c + e) / K;  // the run's pixel of element e
          Q::put(t[c], e, (uint32_t)val[g][i]);
          if ((vc[g] >> (8 * i)) & 0xffu) mk[c] = mk[c] | Q::ones(e);
        }
      }
      // rows dy of the k x k blocks: the same texels, each row's background
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        T* o = out + ((b * hb + y) * K + dy) * W + (long long)x0 * K;
        V s[K];
#pragma unroll
        for (int c = 0; c < K; ++c)
          s[c] = Q::select(t[c], mk[c], have_bg ? bgq[dy * K + c] : zero_quad<V>());
        store_row<T, K>(o, s);
      }
    }
  }
}

// grid: x over build pixels (fewer than 2^31), y over poses; neighbouring
// threads take neighbouring pixels of one pose, so the index, mask and
// screen accesses coalesce and no thread divides in 64 bits.  K5's scalar
// kernel: build widths that are not a multiple of kRun, pointers off 16
// bytes, render scales k >= 3.
template <typename T>
__global__ void __launch_bounds__(kThreads) posed_gather_kernel(
    const T* __restrict__ src, long long N, int B, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ valid, const T* __restrict__ bg, int k, int hb, int wb,
    T* __restrict__ out) {
  const int npix = hb * wb;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int y = p / wb, x = p - y * wb;
  const int H = hb * k, W = wb * k;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const long long q = (long long)b * npix + p;
    const bool v = valid[q] != 0;
    T texel = T(0);
    if (v) {
      const long long i = idx[q];
      texel = src[(long long)b * N + (i < 0 ? 0 : (i >= N ? N - 1 : i))];
    }
    T* o = out + ((long long)b * H + (long long)y * k) * W + (long long)x * k;
    const T* g = bg + (long long)y * k * W + (long long)x * k;
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx)
        o[(long long)dy * W + dx] = v ? texel : g[(long long)dy * W + dx];
  }
}

// K6.  grid: x over runs of kRun build pixels (row by row, a row's last run
// may be short), y over blocks of kPosesPerBlock poses.  K: the render
// scale of the vector kernels (1 or 2; the build width a multiple of kRun
// and every pointer 16-byte aligned), or 0 for the scalar kernel, which
// takes any width and render scale k.  R: the plate resolver; kGiven reads
// pose b's plate of pixel p at given[b * hb * wb + p]; kCube reads
// r.cube_dirs.
//
// Mode 2's plates.  The block's plates are all in flight before its first
// resolve: at its start each thread copies its run's plates of every pose of
// the block into a shared tile (pose j's at s_given[j * K6_THREADS + tid],
// four int8 plates a word, byte i pixel x0 + i), under the staging of the
// bases and lines, and each pose then reads one word from the tile.  In the
// vector kernels a pose's four plates are one 4-byte cp.async (p0 is a
// multiple of kRun, and so is a pose's plane hb * wb); the scalar kernel,
// and a plates pointer off 4 bytes, read the run's bytes (the bytes past a
// short run are 0).
template <typename T, int K, int R>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS) static_ray_posed_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const uint8_t* __restrict__ lens_valid, int hb, int wb,
    const float* __restrict__ bases, int B, const Resolve r, const int8_t* __restrict__ given,
    const uint32_t* __restrict__ grid_lines, const T* __restrict__ src, long long N,
    const T* __restrict__ bg, int k, T* __restrict__ out) {
  using Q = Quad<T>;
  using V = typename Q::V;
  constexpr bool kGiven = R == blinky::kGiven;
  __shared__ __align__(16) float s_recs[kMaxPlates * kRecord];
  __shared__ __align__(16) float s_bases[kPosesPerBlock * kRecord];
  __shared__ uint32_t s_given[kGiven ? kPosesPerBlock * K6_THREADS : 1];
  extern __shared__ uint32_t s_lines[];  // (S + 31) / 32 words when expanded
  const int tid = threadIdx.x;
  if (tid == 0) blinky::fill_plate_records(r, s_recs);
  const int b0 = blockIdx.y * kPosesPerBlock;
  const int nb = min(kPosesPerBlock, B - b0);
  if constexpr (kGiven) {
    const int runs = (wb + kRun - 1) / kRun;
    const long long q = (long long)blockIdx.x * K6_THREADS + tid;
    if (q < (long long)hb * runs) {
      const int y = (int)(q / runs);
      const int x0 = (int)(q - (long long)y * runs) * kRun;
      const int m = min(kRun, wb - x0);
      const long long plane = (long long)hb * wb;
      const int8_t* g = given + (long long)b0 * plane + (long long)y * wb + x0;
      if (K > 0 && (uintptr_t)given % 4 == 0 && plane % 4 == 0) {
#pragma unroll
        for (int j = 0; j < kPosesPerBlock; ++j)
          if (j < nb) cp_async4(s_given + j * K6_THREADS + tid, g + j * plane);
      } else {
#pragma unroll
        for (int j = 0; j < kPosesPerBlock; ++j) {
          if (j >= nb) break;
          uint32_t w = 0u;
#pragma unroll
          for (int i = 0; i < kRun; ++i)
            if (i < m) w |= (uint32_t)(uint8_t)g[j * plane + i] << (8 * i);
          s_given[j * K6_THREADS + tid] = w;
        }
      }
    }
  }
  // a pose's record: forward, right, up, then three zeros
  for (int i = tid; i < nb * kRecord; i += K6_THREADS) {
    const int j = i / kRecord, c = i - j * kRecord;
    s_bases[i] = c < 9 ? bases[(long long)(b0 + j) * 9 + c] : 0.f;
  }
  if (r.expanded)
    for (int i = tid; i < (r.S + 31) / 32; i += K6_THREADS) s_lines[i] = grid_lines[i];
  if constexpr (kGiven) cp_async_wait_all();
  __syncthreads();

  const int runs = (wb + kRun - 1) / kRun;  // runs a row
  const long long q = (long long)blockIdx.x * K6_THREADS + tid;
  if (q >= (long long)hb * runs) return;
  const int y = (int)(q / runs);
  const int x0 = (int)(q - (long long)y * runs) * kRun;
  const int m = min(kRun, wb - x0);  // pixels in this run (kRun for K > 0)
  const long long p0 = (long long)y * wb + x0;
  float rx[kRun], ry[kRun], rz[kRun];
  bool lv[kRun];
  if (K > 0) {
    const float4 a = *(const float4*)(vx + p0), b = *(const float4*)(vy + p0),
                 c = *(const float4*)(vz + p0);
    const uint32_t l = *(const uint32_t*)(lens_valid + p0);
    rx[0] = a.x, rx[1] = a.y, rx[2] = a.z, rx[3] = a.w;
    ry[0] = b.x, ry[1] = b.y, ry[2] = b.z, ry[3] = b.w;
    rz[0] = c.x, rz[1] = c.y, rz[2] = c.z, rz[3] = c.w;
#pragma unroll
    for (int i = 0; i < kRun; ++i) lv[i] = (l >> (8 * i)) & 0xffu;
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const bool in = i < m;
      rx[i] = in ? vx[p0 + i] : 0.f;
      ry[i] = in ? vy[p0 + i] : 0.f;
      rz[i] = in ? vz[p0 + i] : 0.f;
      lv[i] = in && lens_valid[p0 + i];
    }
  }

  const int kk = K > 0 ? K : k;
  const long long H = (long long)hb * kk, W = (long long)wb * kk;
  const int top = kGiven ? (int)min(N - 1, (long long)INT_MAX) : 0;  // mode 2's clip
  V bgq[K > 0 ? K * K : 1];  // the run's background, row dy, quad c at [dy * K + c]
  bool have_bg = false;
  for (int j0 = 0; j0 < nb; j0 += kPoseGroup) {
    // resolve the group's poses, then issue every gather, then store
    int idx[kPoseGroup][kRun];
#pragma unroll
    for (int g = 0; g < kPoseGroup; ++g) {
      const int j = j0 + g;
      if (j >= nb) {  // a short group (uniform across the block): nothing to resolve
#pragma unroll
        for (int i = 0; i < kRun; ++i) idx[g][i] = -1;
        continue;
      }
      const float4 e0 = *(const float4*)(s_bases + j * kRecord);
      const float4 e1 = *(const float4*)(s_bases + j * kRecord + 4);
      const float4 e2 = *(const float4*)(s_bases + j * kRecord + 8);
      const float3 f = make_float3(e0.x, e0.y, e0.z), rt = make_float3(e0.w, e1.x, e1.y),
                   up = make_float3(e1.z, e1.w, e2.x);
      const uint32_t gw = kGiven ? s_given[j * K6_THREADS + tid] : 0u;  // four plates
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        idx[g][i] = resolve_index<R, true>(rx[i], ry[i], rz[i], lv[i], f, rt, up, r, s_recs,
                                           s_lines, (int)(int8_t)(gw >> (8 * i)));
    }
    T val[kPoseGroup][kRun];
#pragma unroll
    for (int g = 0; g < kPoseGroup; ++g) {
      const long long base = (long long)(b0 + min(j0 + g, nb - 1)) * N;
      if constexpr (kGiven) {
        // the same clip in 32 bits from the pose's frame: an int index
        // never reaches an N past INT_MAX
        const T* s = src + base;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int t = idx[g][i];
          val[g][i] = t >= 0 ? s[min(t, top)] : T(0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int t = idx[g][i];
          val[g][i] = t >= 0 ? src[base + (t >= N ? N - 1 : t)] : T(0);
        }
      }
    }
    if (K > 0) {
      if (!have_bg) {
        bool hole = false;
#pragma unroll
        for (int g = 0; g < kPoseGroup; ++g)
#pragma unroll
          for (int i = 0; i < kRun; ++i) hole |= j0 + g < nb && idx[g][i] < 0;
        if (hole) {  // the first invalid pixel of the run: read its background
#pragma unroll
          for (int dy = 0; dy < (K > 0 ? K : 1); ++dy)
#pragma unroll
            for (int c = 0; c < (K > 0 ? K : 1); ++c)
              bgq[dy * K + c] =
                  *(const V*)(bg + ((long long)y * K + dy) * W + (long long)x0 * K + 4 * c);
          have_bg = true;
        }
      }
#pragma unroll
      for (int g = 0; g < kPoseGroup; ++g) {
        if (j0 + g >= nb) break;
        const long long b = b0 + j0 + g;
#pragma unroll
        for (int c = 0; c < (K > 0 ? K : 1); ++c) {
          V t = zero_quad<V>(), mk = zero_quad<V>();
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = (4 * c + e) / (K > 0 ? K : 1);  // the run's pixel of element e
            Q::put(t, e, (uint32_t)val[g][i]);
            if (idx[g][i] >= 0) mk = mk | Q::ones(e);
          }
#pragma unroll
          for (int dy = 0; dy < (K > 0 ? K : 1); ++dy)
            *(V*)(out + (b * H + (long long)y * K + dy) * W + (long long)x0 * K + 4 * c) =
                Q::select(t, mk, have_bg ? bgq[dy * K + c] : zero_quad<V>());
        }
      }
    } else {
      for (int g = 0; g < kPoseGroup; ++g) {
        if (j0 + g >= nb) break;
        const long long b = b0 + j0 + g;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          if (i >= m) break;
          const long long x = (long long)(x0 + i) * kk;
          for (int dy = 0; dy < kk; ++dy) {
            const long long row = (long long)y * kk + dy;
            T* o = out + (b * H + row) * W + x;
            const T* gb = bg + row * W + x;
            for (int dx = 0; dx < kk; ++dx) o[dx] = idx[g][i] >= 0 ? val[g][i] : gb[dx];
          }
        }
      }
    }
  }
}

// K9.  grid: x over runs of kRun pixels of the flat screen (VEC: npix a
// multiple of kRun and every pointer 16-byte aligned) or over single pixels,
// y over zoom steps.  Step n resolves its own rays, vx + n * npix, with no
// rotation, and gathers from the one source.  R: the plate resolver; kGiven
// reads step n's plate of pixel p at given[n * npix + p].
template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads) sweep_remap_kernel(
    const float* __restrict__ vx, const float* __restrict__ vy,
    const float* __restrict__ vz, const uint8_t* __restrict__ lens_valid, long long npix,
    int steps, const Resolve r, const int8_t* __restrict__ given,
    const uint32_t* __restrict__ grid_lines,
    const T* __restrict__ src, long long N, const T* __restrict__ bg, T* __restrict__ out) {
  using Q = Quad<T>;
  using V = typename Q::V;
  __shared__ __align__(16) float s_recs[kMaxPlates * kRecord];
  extern __shared__ uint32_t s_lines[];  // (S + 31) / 32 words when expanded
  const int tid = threadIdx.x;
  if (tid == 0) blinky::fill_plate_records(r, s_recs);
  if (r.expanded)
    for (int i = tid; i < (r.S + 31) / 32; i += kThreads) s_lines[i] = grid_lines[i];
  __syncthreads();
  constexpr int M = VEC ? kRun : 1;
  const long long p0 = ((long long)blockIdx.x * kThreads + tid) * M;
  if (p0 >= npix) return;
  const float3 none = make_float3(0.f, 0.f, 0.f);  // no rotation: never read
  for (int n = blockIdx.y; n < steps; n += gridDim.y) {
    const long long q0 = (long long)n * npix + p0;
    float rx[M], ry[M], rz[M];
    bool lv[M];
    if constexpr (VEC) {
      const float4 a = *(const float4*)(vx + q0), b = *(const float4*)(vy + q0),
                   c = *(const float4*)(vz + q0);
      const uint32_t l = *(const uint32_t*)(lens_valid + q0);
      rx[0] = a.x, rx[1] = a.y, rx[2] = a.z, rx[3] = a.w;
      ry[0] = b.x, ry[1] = b.y, ry[2] = b.z, ry[3] = b.w;
      rz[0] = c.x, rz[1] = c.y, rz[2] = c.z, rz[3] = c.w;
#pragma unroll
      for (int i = 0; i < M; ++i) lv[i] = (l >> (8 * i)) & 0xffu;
    } else {
      rx[0] = vx[q0], ry[0] = vy[q0], rz[0] = vz[q0];
      lv[0] = lens_valid[q0] != 0;
    }
    int idx[M];
#pragma unroll
    for (int i = 0; i < M; ++i)
      idx[i] = resolve_index<R, false>(rx[i], ry[i], rz[i], lv[i], none, none, none, r,
                                       s_recs, s_lines,
                                       R == blinky::kGiven ? given[q0 + i] : 0);
    T val[M];
#pragma unroll
    for (int i = 0; i < M; ++i) val[i] = idx[i] >= 0 ? src[idx[i] >= N ? N - 1 : idx[i]] : T(0);
    if constexpr (VEC) {
      V t = zero_quad<V>(), mk = zero_quad<V>();
      bool hole = false;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        Q::put(t, i, (uint32_t)val[i]);
        if (idx[i] >= 0) mk = mk | Q::ones(i);
        hole |= idx[i] < 0;
      }
      const V g = hole ? *(const V*)(bg + p0) : zero_quad<V>();
      *(V*)(out + q0) = Q::select(t, mk, g);
    } else {
      out[q0] = idx[0] >= 0 ? val[0] : bg[p0];
    }
  }
}

template <typename T, int R>
int launch_sweep_remap(bool vec, cudaStream_t s, const float* vx, const float* vy,
                       const float* vz, const uint8_t* lv, long long npix, int steps,
                       const Resolve& r, const int8_t* given, const uint32_t* lines,
                       const void* src, long long N, const void* bg, void* out) {
  const size_t smem = r.expanded ? (size_t)((r.S + 31) / 32) * 4 : 0;
  const long long items = vec ? npix / kRun : npix;
  const long long bx = (items + kThreads - 1) / kThreads;
  if (smem > 48 * 1024 || bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)(steps < 65535 ? steps : 65535));
  if (vec)
    sweep_remap_kernel<T, R, true><<<grid, kThreads, smem, s>>>(
        vx, vy, vz, lv, npix, steps, r, given, lines, (const T*)src, N, (const T*)bg,
        (T*)out);
  else
    sweep_remap_kernel<T, R, false><<<grid, kThreads, smem, s>>>(
        vx, vy, vz, lv, npix, steps, r, given, lines, (const T*)src, N, (const T*)bg,
        (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_sweep_remap(int resolver, bool vec, cudaStream_t s, const float* vx,
                         const float* vy, const float* vz, const uint8_t* lv, long long npix,
                         int steps, const Resolve& r, const int8_t* given,
                         const uint32_t* lines, const void* src, long long N, const void* bg,
                         void* out) {
  if (resolver == blinky::kMaxDot)
    return launch_sweep_remap<T, blinky::kMaxDot>(vec, s, vx, vy, vz, lv, npix, steps, r,
                                                  given, lines, src, N, bg, out);
  if (resolver == blinky::kFast)
    return launch_sweep_remap<T, blinky::kFast>(vec, s, vx, vy, vz, lv, npix, steps, r, given,
                                                lines, src, N, bg, out);
  return launch_sweep_remap<T, blinky::kGiven>(vec, s, vx, vy, vz, lv, npix, steps, r, given,
                                               lines, src, N, bg, out);
}

template <typename T, int K, int R>
int launch_static_ray_posed(dim3 grid, size_t smem, cudaStream_t s, const float* vx,
                            const float* vy, const float* vz, const uint8_t* lens_valid,
                            int hb, int wb, const float* bases, int batch, const Resolve& r,
                            const int8_t* given, const uint32_t* grid_lines, const void* src,
                            long long N, const void* bg, int k, void* out) {
  static_ray_posed_kernel<T, K, R><<<grid, K6_THREADS, smem, s>>>(
      vx, vy, vz, lens_valid, hb, wb, bases, batch, r, given, grid_lines, (const T*)src, N,
      (const T*)bg, k, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int dispatch_static_ray_posed(bool vec, int k, dim3 grid, size_t smem, cudaStream_t s,
                              const float* vx, const float* vy, const float* vz,
                              const uint8_t* lv, int hb, int wb, const float* bases,
                              int batch, const Resolve& r, const int8_t* given,
                              const uint32_t* lines, const void* src, long long N,
                              const void* bg, void* out) {
  if (vec && k == 1)
    return launch_static_ray_posed<T, 1, R>(grid, smem, s, vx, vy, vz, lv, hb, wb, bases,
                                            batch, r, given, lines, src, N, bg, k, out);
  if (vec && k == 2)
    return launch_static_ray_posed<T, 2, R>(grid, smem, s, vx, vy, vz, lv, hb, wb, bases,
                                            batch, r, given, lines, src, N, bg, k, out);
  return launch_static_ray_posed<T, 0, R>(grid, smem, s, vx, vy, vz, lv, hb, wb, bases,
                                          batch, r, given, lines, src, N, bg, k, out);
}

template <typename T>
int dispatch_resolver(int resolver, bool vec, int k, dim3 grid, size_t smem, cudaStream_t s,
                      const float* vx, const float* vy, const float* vz, const uint8_t* lv,
                      int hb, int wb, const float* bases, int batch, const Resolve& r,
                      const int8_t* given, const uint32_t* lines, const void* src,
                      long long N, const void* bg, void* out) {
  if (resolver == blinky::kMaxDot)
    return dispatch_static_ray_posed<T, blinky::kMaxDot>(vec, k, grid, smem, s, vx, vy, vz,
                                                         lv, hb, wb, bases, batch, r, given,
                                                         lines, src, N, bg, out);
  if (resolver == blinky::kFast)
    return dispatch_static_ray_posed<T, blinky::kFast>(vec, k, grid, smem, s, vx, vy, vz, lv,
                                                       hb, wb, bases, batch, r, given, lines,
                                                       src, N, bg, out);
  if (resolver == blinky::kCube)
    return dispatch_static_ray_posed<T, blinky::kCube>(vec, k, grid, smem, s, vx, vy, vz, lv,
                                                       hb, wb, bases, batch, r, given, lines,
                                                       src, N, bg, out);
  return dispatch_static_ray_posed<T, blinky::kGiven>(vec, k, grid, smem, s, vx, vy, vz, lv,
                                                      hb, wb, bases, batch, r, given, lines,
                                                      src, N, bg, out);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

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
  if (elem_bytes != 1 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the vector kernel: whole runs, render scale 1 or 2, every table,
  // background and screen pointer 16-byte aligned
  if (wb % kRun == 0 && (k == 1 || k == 2) && aligned16(idx) && aligned16(valid) &&
      aligned16(bg) && aligned16(out)) {
    constexpr int kTileRows = K5_THREADS / K5_TILE_RUNS;
    const long long tiles = (long long)((wb / kRun + K5_TILE_RUNS - 1) / K5_TILE_RUNS) *
                            ((hb + kTileRows - 1) / kTileRows);
    const dim3 grid((unsigned)tiles,
                    (unsigned)((batch + K5_POSES_PER_BLOCK - 1) / K5_POSES_PER_BLOCK));
    if (tiles > 0x7fffffffLL || grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (elem_bytes == 1) {
      if (k == 1)
        posed_gather_vec<uint8_t, 1><<<grid, K5_THREADS, 0, s>>>(
            (const uint8_t*)src, N, batch, idx, valid, (const uint8_t*)bg, hb, wb, (uint8_t*)out);
      else
        posed_gather_vec<uint8_t, 2><<<grid, K5_THREADS, 0, s>>>(
            (const uint8_t*)src, N, batch, idx, valid, (const uint8_t*)bg, hb, wb, (uint8_t*)out);
    } else {
      if (k == 1)
        posed_gather_vec<uint32_t, 1><<<grid, K5_THREADS, 0, s>>>(
            (const uint32_t*)src, N, batch, idx, valid, (const uint32_t*)bg, hb, wb,
            (uint32_t*)out);
      else
        posed_gather_vec<uint32_t, 2><<<grid, K5_THREADS, 0, s>>>(
            (const uint32_t*)src, N, batch, idx, valid, (const uint32_t*)bg, hb, wb,
            (uint32_t*)out);
    }
    return (int)cudaGetLastError();
  }
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
// fast_half, 2 = the plates given in given [batch, hb, wb] int8 (a script
// globe's, clamped to [-1, 6]; null for the other resolvers), 3 = max-dot
// by the cube resolver (refused unless the six plates face the six signed
// axes and every frame vector is a signed axis); grid_lines:
// the rubix grid-line bitmask on the device, bit px
// of word px / 32 for px < S (lensmap/builder.py::rubix_grid_lines; read only
// when expanded, else may be null); S the plate size; src [batch, N]
// pose-major texels of elem_bytes; bg [hb * k, wb * k]; out
// [batch, hb * k, wb * k].
extern "C" int blinky_static_ray_posed(const float* vx, const float* vy, const float* vz,
                                       const uint8_t* lens_valid, int hb, int wb,
                                       const float* bases, int batch, const float* plates,
                                       int nplates, int resolver, float fast_dist,
                                       float fast_half, const int8_t* given,
                                       const uint32_t* grid_lines, int S, int expanded,
                                       const void* src, long long N, int elem_bytes,
                                       const void* bg, int k, void* out, void* stream) {
  Resolve r;
  if (k < 1 || N < 1 || batch < 1 || hb < 1 || wb < 1 || (expanded && grid_lines == nullptr) ||
      (resolver == blinky::kGiven && given == nullptr) ||
      !blinky::make_resolve(r, plates, nplates, resolver, fast_dist, fast_half, S, expanded,
                            true))
    return (int)cudaErrorInvalidValue;
  const long long runs = (long long)hb * ((wb + kRun - 1) / kRun);
  const dim3 grid((unsigned)((runs + K6_THREADS - 1) / K6_THREADS),
                  (unsigned)((batch + kPosesPerBlock - 1) / kPosesPerBlock));
  if ((runs + K6_THREADS - 1) / K6_THREADS > 0x7fffffffLL || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = expanded ? (size_t)((S + 31) / 32) * 4 : 0;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // the vector kernels: whole runs, and every row, run and pointer aligned
  const bool vec = wb % kRun == 0 && aligned16(vx) && aligned16(vy) && aligned16(vz) &&
                   aligned16(lens_valid) && aligned16(bg) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return dispatch_resolver<uint8_t>(resolver, vec, k, grid, smem, s, vx, vy, vz, lens_valid,
                                      hb, wb, bases, batch, r, given, grid_lines, src, N, bg,
                                      out);
  if (elem_bytes == 4)
    return dispatch_resolver<uint32_t>(resolver, vec, k, grid, smem, s, vx, vy, vz,
                                       lens_valid, hb, wb, bases, batch, r, given, grid_lines,
                                       src, N, bg, out);
  return (int)cudaErrorInvalidValue;
}

// vx, vy, vz [steps, npix] f32 and lens_valid [steps, npix] bool: a ray table
// a zoom step; src [N] texels of elem_bytes, the one frame every step gathers
// from; bg and a step of out [npix].  plates, resolver, fast_dist, fast_half,
// grid_lines, S, expanded as for blinky_static_ray_posed; given [steps, npix]
// int8 for resolver 2.  No rotation.
extern "C" int blinky_sweep_remap(const float* vx, const float* vy, const float* vz,
                                  const uint8_t* lens_valid, long long npix, int steps,
                                  const float* plates, int nplates, int resolver,
                                  float fast_dist, float fast_half, const int8_t* given,
                                  const uint32_t* grid_lines, int S, int expanded,
                                  const void* src, long long N, int elem_bytes,
                                  const void* bg, void* out, void* stream) {
  Resolve r;
  if (N < 1 || steps < 1 || npix < 1 || (expanded && grid_lines == nullptr) ||
      (resolver == blinky::kGiven && given == nullptr) ||
      !blinky::make_resolve(r, plates, nplates, resolver, fast_dist, fast_half, S, expanded))
    return (int)cudaErrorInvalidValue;
  const bool vec = npix % kRun == 0 && aligned16(vx) && aligned16(vy) && aligned16(vz) &&
                   aligned16(lens_valid) && aligned16(bg) && aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return dispatch_sweep_remap<uint8_t>(resolver, vec, s, vx, vy, vz, lens_valid, npix, steps,
                                         r, given, grid_lines, src, N, bg, out);
  if (elem_bytes == 4)
    return dispatch_sweep_remap<uint32_t>(resolver, vec, s, vx, vy, vz, lens_valid, npix,
                                          steps, r, given, grid_lines, src, N, bg, out);
  return (int)cudaErrorInvalidValue;
}
