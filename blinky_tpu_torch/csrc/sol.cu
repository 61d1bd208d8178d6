// K3 and K4: the speed-of-light probes, written for Hopper (sm_90a).
//
// K3 replaces the Pallas kernel blinky_tpu/bench/sol.py::_onehot_kernel
// (sol.py:149, pallas_call at :175): a row gather written as a matrix
// product, out[w] = onehot(idx[w]) [T, R] @ src[w] [R, B] with 8-bit
// operands and int32 sums, stored as u8.  It exists to be measured against
// K1, the direct row gather, and it stays a matrix product on the tensor
// cores: T * R * B multiply-adds per window.
//   Bound on the card: the function is a gather, bound by bytes: it reads
//   the rows idx names and writes the output, about 48 MB at the probe's
//   shape (64 windows x 384 x 2048 x 1024), 14 us at 3.35 TB/s.  The
//   product has a floor of its own, operations and bytes together: 51.5 G
//   multiply-adds, 52 us at the H100's 989 int8 TMAC/s, and the whole
//   134 MB source read and the 25 MB output written, 48 us.
//   Design: the transposed product out[w]^T = src[w]^T @ onehot[w]^T, on
//   wgmma.mma_async m64n192k32 .u8.u8 with s32 sums.  wgmma reads an 8-bit
//   operand from shared memory K-major only, and src arrives with B, not R,
//   contiguous, so src is the A operand, built in registers: ldmatrix.trans
//   of 16-bit pairs straight from the tile as TMA lays it down, then
//   __byte_perm, gives each thread its fragment with no transposing pass
//   through shared memory.  The one-hot is the B operand, [t][r] K-major in
//   shared memory with the 128-byte swizzle.  It holds one 1 per row t, so
//   a chunk of 128 source rows costs each row one byte store to clear the
//   last 1 and one to set the next; it never exists in device memory.  Out
//   of range rows have no 1, so garbage source bytes beyond R or B meet
//   only zeros, and their output rows are never stored.
//   Layout: a consumer warpgroup owns 64 columns b (wgmma M) by 192 rows t
//   (wgmma N), with an m64n192k32 per 32 source rows.  M rows g and g + 8
//   of a fragment are the columns 2g and 2g + 1, and the 32 k of a step are
//   permuted (onehot_k) so that lane l of ldmatrix reads source row l of
//   the step: free of bank conflicts, because the swizzle spreads the rows
//   of every group of 8 over all 32 banks.
//   Pipeline: a persistent grid, one block per SM walking a list of (w,
//   b-tile, t-tile) tiles, t-tiles of one source tile next to each other so
//   that they share it in L2; no grid dimension grows with W or T.  A
//   producer warp fills a ring of 4 stages of 128 x 128 source bytes: TMA
//   with mbarriers when B is a multiple of 16 and src is 16-byte aligned
//   (TMA needs 16-byte strides), plain loads otherwise.  Each of the two
//   consumer warpgroups has its own one-hot and retires its wgmma group
//   before it builds the next chunk's fragments (ptxas serialises every
//   wgmma when A registers are written with a group in flight); the two
//   meet only at the ring, so one's wgmma runs while the other builds.
//   The epilogue takes each sum's low byte, stages the tile in shared
//   memory and stores 16-byte vectors (bytes on the ragged path).
//
// K4 replaces the Pallas kernel blinky_tpu/bench/sol.py::_stream_read_kernel
// (sol.py:222, pallas_call at :245): the sum of a [rows, 1024] u8 array into
// one int32 that wraps in two's complement.
//   Bound on the card: bytes; it reads each byte once and writes 4.
//   Design: the TPU's grid runs in order and carries the sum in SMEM from
//   one step to the next; here blocks run in parallel in no order.  Each
//   thread reads 16-byte vectors in a block-stride loop and sums their
//   bytes with dp4a, a warp and then the block reduce by shuffles, and one
//   atomicAdd per block adds the block's partial into the result.  Unsigned
//   sums wrap mod 2^32, which is the int32 wrap of the reference's sum.

#include <cuda.h>
#include <string.h>

#include "common.cuh"
#include "ring.cuh"

namespace {

using blinky::bar_sync;
using blinky::kThreads;
using blinky::mbar_arrive;
using blinky::mbar_arrive_tx;
using blinky::mbar_init;
using blinky::mbar_wait;
using blinky::smem_u32;

// ------------------------------------------------------------------ K3

constexpr int kTileT = 192;     // output rows t per tile: wgmma N
constexpr int kTileB = 128;     // output columns b per tile: 64 per warpgroup (wgmma M)
constexpr int kChunk = 128;     // source rows r per stage: 4 wgmma k steps of 32
constexpr int kStages = 4;      // source stages in the ring
constexpr int kConsumers = 256; // two warpgroups
constexpr int kBlockThreads = kConsumers + 32;  // and one producer warp
constexpr int kStageBytes = kChunk * kTileB;    // [r][b], 128-byte swizzle
constexpr int kOneHotBytes = kTileT * kChunk;   // [t][k], 128-byte swizzle, per warpgroup
constexpr int kOutPitch = 80;   // a staged output row: 64 bytes + 16 against bank conflicts
constexpr int kOutBytes = kTileT * kOutPitch;   // per warpgroup
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kOneHotBytes + 2 * kOutBytes +
                           2 * kStages * 8;

// The byte of a [rows][128] tile under the 128-byte swizzle, as TMA writes
// it and wgmma reads it: 16-byte chunk c of row r lands at chunk c ^ (r % 8).
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// The k of source row d (of a 128-row chunk) in the fragments: step
// d / 32; within it, ldmatrix lane j of matrix m reads row 8m + j, and the
// thread with q = j / 2 holds it in byte 2 * (m % 2) + j % 2 of k group q,
// half m / 2.  So d = 32s + 16h + 8p + j  ->  k = 32s + 16h + 4(j/2) + 2p + j%2.
__device__ __forceinline__ int onehot_k(int d) {
  return (d & ~15) + ((d & 6) << 1) + ((d >> 2) & 2) + (d & 1);
}

// Keeps the compiler from moving a register's uses across a wgmma fence or wait.
__device__ __forceinline__ void reg_fence(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// wgmma's shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart; the start address in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 192] += a[64 x 32] (registers, u8) * b[32 x 192] (shared, u8).
__device__ __forceinline__ void wgmma_m64n192k32(uint32_t* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, 1;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__global__ void __launch_bounds__(kBlockThreads, 1) onehot_gather_kernel(
    const __grid_constant__ CUtensorMap tmap, int use_tma, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ src, int W, int T, int R, int B, uint8_t* __restrict__ out,
    int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const stages = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* const onehot = stages + kStages * kStageBytes;
  uint8_t* const staged = onehot + 2 * kOneHotBytes;
  uint64_t* const bars = (uint64_t*)(staged + 2 * kOutBytes);  // full[kStages], empty[kStages]
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  const int tid = threadIdx.x, lane = tid & 31;
  const long long ntt = ((long long)T + kTileT - 1) / kTileT;
  const long long nbt = ((long long)B + kTileB - 1) / kTileB;
  const long long ntiles = (long long)W * nbt * ntt;
  const int nchunks = (R + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32);                // the producer warp's lanes
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 2 * kOneHotBytes / 16; i += kBlockThreads)
    ((uint4*)onehot)[i] = make_uint4(0, 0, 0, 0);  // the one-hots start empty
  blinky::fence_async_shared();
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warp: source chunks into the ring, tile after tile
    int st = 0;
    uint32_t phase = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long wb = tile / ntt;
      const int w = (int)(wb / nbt), b0 = (int)(wb % nbt) * kTileB;
      for (int c = 0; c < nchunks; ++c) {
        const int r0 = c * kChunk;
        mbar_wait(empty0 + 8 * st, phase ^ 1);
        uint8_t* const dst = stages + st * kStageBytes;
        const uint32_t full = full0 + 8 * st;
        if (use_tma) {
          if (lane == 0) {
            mbar_arrive_tx(full, kStageBytes);  // the whole box, zeros past R and B included
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
                "l"((uint64_t)&tmap), "r"(b0), "r"(r0), "r"(w), "r"(full)
                : "memory");
          } else {
            mbar_arrive(full);
          }
        } else {
          const int nr = min(kChunk, R - r0), nb = min(kTileB, B - b0);
          const uint8_t* s = src + ((long long)w * R + r0) * B + b0;
          for (int rr = 0; rr < nr; ++rr)
            for (int bb = lane; bb < nb; bb += 32) dst[sw128(rr, bb)] = s[(long long)rr * B + bb];
          mbar_arrive(full);  // releases this lane's stores
        }
        if (++st == kStages) st = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---- two consumer warpgroups: warpgroup wg owns columns 64wg .. 64wg + 63 of
  // a tile, and its own one-hot of the tile's 192 rows, so that it syncs with
  // the other one only through the source ring
  const int wg = tid >> 7, warp = (tid >> 5) & 3, i = tid & 127;
  const int q = lane & 3, g = lane >> 2;
  const int lm_chunk = wg * 4 + warp;  // this warp's 16-byte column chunk of a source row
  uint8_t* const oh = onehot + wg * kOneHotBytes;
  uint8_t* const my_out = staged + wg * kOutBytes;
  const uint32_t oh_u32 = smem_u32(oh);
  const int wg_bar = 1 + wg;  // named barrier of this warpgroup's 128 threads
  int st = 0;
  uint32_t phase = 0;
  // this thread's one-hot rows i and i + 128 (if < 192): where each last set a 1
  int prev_a = -1, prev_b = -1;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long wb = tile / ntt;
    const int t0 = (int)(tile % ntt) * kTileT;
    const int w = (int)(wb / nbt), b0 = (int)(wb % nbt) * kTileB;
    // the source rows of rows i and i + 128, or -1 for an empty one-hot row
    auto row_idx = [&](int t) {
      if (t >= kTileT || t0 + t >= T) return -1;
      const int v = idx[(long long)w * T + t0 + t];
      return v >= 0 && v < R ? v : -1;
    };
    const int idx_a = row_idx(i), idx_b = row_idx(i + 128);
    uint32_t acc[kTileT / 2];
#pragma unroll
    for (int k = 0; k < kTileT / 2; ++k) {
      acc[k] = 0;
      reg_fence(acc[k]);
    }
    for (int c = 0; c < nchunks; ++c) {
      // The previous chunk's group is retired before its A registers and its
      // one-hot are rewritten.  (A wgmma's registers may not be written while
      // it runs; with one group kept in flight, ptxas serialises every wgmma.)
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

      // A: the source chunk, 4 k steps of 32 rows, from the stage into registers
      mbar_wait(full0 + 8 * st, phase);
      const uint32_t stage = smem_u32(stages + st * kStageBytes);
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = 32 * s + lane;
        uint32_t x0, x1, x2, x3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                     : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                     : "r"(stage + (uint32_t)(r * 128 + (((lm_chunk ^ r) & 7) << 4)))
                     : "memory");
        // x0: rows 2q, 2q+1 (x1: 8 + 2q, 9 + 2q) of columns 2g, 2g + 1 as
        // (r, b) = (2q, 2g) (2q, 2g+1) (2q+1, 2g) (2q+1, 2g+1); regroup per column
        a[s][0] = __byte_perm(x0, x1, 0x6420);  // M row g (column 2g), k 4q .. 4q + 3
        a[s][1] = __byte_perm(x0, x1, 0x7531);  // M row g + 8 (column 2g + 1)
        a[s][2] = __byte_perm(x2, x3, 0x6420);  // the same, k + 16
        a[s][3] = __byte_perm(x2, x3, 0x7531);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is free for the producer
      if (++st == kStages) st = 0, phase ^= 1;

      // B: the one-hot of the tile's rows for source rows c * 128 .. + 127
      auto set_row = [&](int t, int v, int& prev) {
        if (prev >= 0) oh[prev] = 0;
        const int d = v - c * kChunk;
        prev = v >= 0 && d >= 0 && d < kChunk ? sw128(t, onehot_k(d)) : -1;
        if (prev >= 0) oh[prev] = 1;
      };
      set_row(i, idx_a, prev_a);
      if (i + 128 < kTileT) set_row(i + 128, idx_b, prev_b);
      blinky::fence_async_shared();  // for wgmma's reads
      bar_sync(wg_bar, 128);

      // every operand register is defined before the fence
      uint64_t desc[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        desc[s] = sw128_desc(oh_u32 + 32 * s);  // k step s: +32 bytes
        asm volatile("" : "+l"(desc[s])::"memory");
#pragma unroll
        for (int k = 0; k < 4; ++k) reg_fence(a[s][k]);
      }
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_m64n192k32(acc, a[s], desc[s]);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int k = 0; k < kTileT / 2; ++k) reg_fence(acc[k]);

    // epilogue: acc[4j + 2v + u] is column 16 warp + 2g + v, row 8j + 2q + u
    bar_sync(wg_bar, 128);  // this warpgroup's previous tile is out of the staging rows
#pragma unroll
    for (int j = 0; j < kTileT / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *(uint16_t*)(my_out + (8 * j + 2 * q + u) * kOutPitch + 16 * warp + 2 * g) =
            (uint16_t)((acc[4 * j + u] & 0xFF) | ((acc[4 * j + 2 + u] & 0xFF) << 8));
    bar_sync(wg_bar, 128);
    const int bw = b0 + 64 * wg;
    uint8_t* const out_w = out + ((long long)w * T + t0) * B;
    if (vec_out) {
      for (int v = i; v < kTileT * 4; v += 128) {
        const int t = v >> 2, b = bw + 16 * (v & 3);
        if (t0 + t < T && b < B)
          *(uint4*)(out_w + (long long)t * B + b) =
              *(const uint4*)(my_out + t * kOutPitch + 16 * (v & 3));
      }
    } else {
      for (int v = i; v < kTileT * 64; v += 128) {
        const int t = v >> 6, bb = v & 63;
        if (t0 + t < T && bw + bb < B)
          out_w[(long long)t * B + bw + bb] = my_out[t * kOutPitch + bb];
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// ------------------------------------------------------------------ K4

__global__ void __launch_bounds__(kThreads) stream_read_kernel(
    const uint4* __restrict__ x, long long nvec, unsigned int* __restrict__ out) {
  unsigned int acc = 0;
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    const uint4 v = x[i];
    acc = __dp4a(v.x, 0x01010101u, acc);
    acc = __dp4a(v.y, 0x01010101u, acc);
    acc = __dp4a(v.z, 0x01010101u, acc);
    acc = __dp4a(v.w, 0x01010101u, acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ unsigned int s_warp[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? s_warp[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) atomicAdd(out, acc);
  }
}

}  // namespace

// idx [W, T] i32, src [W, R, B] u8 -> out [W, T, B] u8.  Launches on
// `stream` one block per SM (or per tile, if fewer) and returns the first
// CUDA error of the set-up or cudaGetLastError() after the launch.
extern "C" int blinky_onehot_gather(const int32_t* idx, const uint8_t* src, int W, int T,
                                    int R, int B, uint8_t* out, void* stream) {
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof tmap);
  const int use_tma = R > 0 && B % 16 == 0 && (uintptr_t)src % 16 == 0;
  if (use_tma) {
    static EncodeTiledFn encode = nullptr;
    if (!encode) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err =
          cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
      if (err != cudaSuccess) return (int)err;
      if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
      encode = (EncodeTiledFn)fn;
    }
    // dims innermost first: b, r, w; byte strides of r and w
    const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)R, (cuuint64_t)W};
    const cuuint64_t strides[2] = {(cuuint64_t)B, (cuuint64_t)R * B};
    const cuuint32_t box[3] = {kTileB, kChunk, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)src, dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      onehot_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)W * (((long long)B + kTileB - 1) / kTileB) *
                          (((long long)T + kTileT - 1) / kTileT);
  const int grid = (int)(tiles < sms ? tiles : sms);
  const int vec_out = B % 16 == 0 && (uintptr_t)out % 16 == 0;
  onehot_gather_kernel<<<grid, kBlockThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tmap, use_tma, idx, src, W, T, R, B, out, vec_out);
  return (int)cudaGetLastError();
}

// x: nbytes of u8, 16-byte aligned, nbytes % 16 == 0 -> out: one int32 (as
// its unsigned bits).  Zeroes `out` on `stream`, launches there, and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_stream_read(const void* x, long long nbytes, unsigned int* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  const long long nvec = nbytes / 16;
  const int blocks = blinky::wave_blocks((nvec + kThreads - 1) / kThreads);
  stream_read_kernel<<<blocks, kThreads, 0, s>>>((const uint4*)x, nvec, out);
  return (int)cudaGetLastError();
}
