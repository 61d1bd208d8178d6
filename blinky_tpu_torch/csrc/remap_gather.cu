// K1: the static remap's row gather, written for Hopper (sm_90a).
//
// Replaces blinky_tpu/kernels/remap.py::remap_gather_impl (remap.py:88) and,
// with a tint, remap_gather_tint_impl + apply_tint_rgba (remap.py:109, :140).
// It also serves remap_impl (remap.py:56) when neither its tint LUT nor its
// RGB decode is asked for, with remap_impl's fill rule for out-of-range rows.
//
//   out[p, :] = valid[p] ? src[row(idx[p]), :] : bg[p]      src [rows, B]
//
// What bounds it on the card: bytes.  Per screen pixel it reads a 4-byte
// index, a 1-byte mask and the background, then one source row of B texels
// (B * itemsize bytes, batch innermost), and writes the same number of bytes:
// about 2 * B * itemsize bytes moved per index and no arithmetic to speak of.
// The rows land anywhere in the source, so each index is one scattered read
// of a contiguous row.  To run at the card's 3.35 TB/s, each SM must keep
// tens of KB of those reads in flight.
//
// Two designs, picked by what the row is (kernels/remap.py::ring_path, the
// one place that decides, beside the count of ring launches):
//
// * The register path, for rows under RING_MIN_ROW_BYTES (192) bytes, rows
//   that are no multiple of 16 bytes, and pointers off a 16-byte boundary.
//   A pixel's row is cut into 16-byte vectors when it can be, else into
//   single texels; neighbouring threads take neighbouring vectors of one
//   row, then of the next pixel's row, so every warp reads and writes
//   contiguous runs, and a block step holds many short rows.  The true-
//   colour tint runs on the gathered texels in registers.  Each thread has
//   one load in flight behind two small dependent ones (valid, idx), so it
//   reaches about two thirds of the bound at any row size (60-66 %).
//
// * The ring path (remap_gather_kernel_ring), for longer rows: a
//   persistent grid of one block an SM with a ring of kRingStages stages
//   of kRingStageBytes in shared memory.  A block walks runs of `run`
//   consecutive screen pixels, as many whole rows as a stage holds, at most
//   kRingMaxRun; a row longer than a stage goes in pieces, one pixel a run.
//   Four producer warps share each run.  A producer lane reads its next
//   run's idx, valid and bg with coalesced loads while the current run is in
//   flight, resolves each pixel once (blinky::resolve_row) and asks the
//   Tensor Memory Accelerator for each copied row with one cp.async.bulk
//   into the pixel's slot, counted on the stage's mbarrier.  So no thread's
//   registers hold the data, and an SM keeps up to three stages' bytes in
//   flight.  A warp issues its lanes' bulk copies one at a time (the copy
//   takes uniform registers: ELECT, R2UR, UBLKCP, about 75 cycles a copy),
//   which is why there are four producer warps: with one, 2.07 M copies
//   took 0.59 ms whatever their size up to 256 bytes.  Four consumer warps
//   wait for the stage, write the constant rows (an invalid pixel's
//   background, all bits set for a fill-rule miss) into their slots, run
//   the tint in shared memory, fence the async proxy, and one of them
//   stores the run's contiguous output rows with one bulk store under an
//   evict-first L2 policy, so the screens do not push out source rows that
//   nearby pixels read again.  A stage goes back to the producers once its
//   store has read it.
//
// The threshold and the constants, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (CUDA events around launches of both entry points in turns, on the
// 1080p panini lensmap's rows, fill rule; the register path / the ring, ms):
//   64 B 0.1266 / 0.2068, 128 B 0.2386 / 0.2421, 192 B 0.3473 / 0.2904,
//   256 B 0.4453 / 0.3469, 512 B 0.8858 / 0.6987, 1 KB 1.7574 / 1.3887
//   (65.8 % / 83.3 % of the bound); u32 rows of 256 B at 3840x2160 (render_aa)
//   1.5748 / 1.0116, 512 B on the 360 cell's compacted rows 0.3957 /
//   0.3075, 21,760 B on the 720p compacted rows 14.548 / 13.168.  So the
//   ring takes rows of 192 bytes and up; under that the register path,
//   whose blocks hold many short rows, is as fast or faster.  Of the ring's
//   shapes tried (one, two or four producer warps; 3 x 64 KB, 4 x 48 KB,
//   4 x 32 KB or 6 x 32 KB a block; two blocks an SM of 4 x 16 or 3 x 32 KB;
//   eight producers with runs of 256), four producers and 3 x 64 KB were the
//   fastest or within 2 % of it on every row from 192 bytes, the cells'
//   included.  Without the evict-first stores the ring was 0-3 % slower.

#include "common.cuh"
#include "ring.cuh"
#include "tint.cuh"

namespace {

using blinky::kThreads;
using blinky::splat;
using blinky::tint;  // tint.cuh: the tint's one copy, shared with K10 and K12

// Vec: what one thread moves at a time (uint4 = 16 bytes, or one texel).
// ELEM: the texel's size in bytes (1 = u8 palette index, 4 = packed RGBA).
template <typename Vec, int ELEM>
__global__ void __launch_bounds__(kThreads) remap_gather_kernel(
    const Vec* __restrict__ src, long long rows, int per_pixel,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const void* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, int fill, long long npix,
    Vec* __restrict__ out) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int local = per_pixel >= kThreads ? 0 : (int)threadIdx.x / per_pixel;
  const int first = per_pixel >= kThreads ? (int)threadIdx.x : (int)threadIdx.x % per_pixel;
  if (local >= pps) return;  // the ragged tail of the block when pps * per_pixel < kThreads
  for (long long p = (long long)blockIdx.x * pps + local; p < npix;
       p += (long long)gridDim.x * pps) {
    Vec* dst = out + p * per_pixel;
    if (!valid[p]) {
      const uint32_t w = ELEM == 1 ? 0x01010101u * ((const uint8_t*)bg)[p]
                                   : ((const uint32_t*)bg)[p];
      Vec v;
      splat(v, w);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const long long r = blinky::resolve_row(idx[p], rows, fill);
    if (r < 0) {
      Vec v;
      splat(v, 0xFFFFFFFFu);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const Vec* row = src + r * per_pixel;
    bool tinted = false;
    uint32_t t = 0;
    if constexpr (ELEM == 4) {
      if (tint_mask != nullptr && tint_mask[p]) {
        tinted = true;
        t = tint_rgb[p];
      }
    }
    for (int i = first; i < per_pixel; i += kThreads) {
      Vec v = row[i];
      if constexpr (ELEM == 4) {
        if (tinted) tint(v, t);
      }
      dst[i] = v;
    }
  }
}

template <typename Vec, int ELEM>
int launch(const void* src, long long rows, int per_pixel, const int32_t* idx,
           const uint8_t* valid, const void* bg, const uint32_t* tint_rgb,
           const uint8_t* tint_mask, int fill, long long npix, void* out,
           cudaStream_t stream) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int blocks = blinky::wave_blocks((npix + pps - 1) / pps);
  remap_gather_kernel<Vec, ELEM><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)src, rows, per_pixel, idx, valid, bg, tint_rgb, tint_mask,
      fill, npix, (Vec*)out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- the ring path

using blinky::bar_sync;
using blinky::mbar_arrive;
using blinky::mbar_arrive_tx;
using blinky::mbar_init;
using blinky::mbar_wait;
using blinky::smem_u32;

constexpr int kRingStageBytes = 65536;  // a stage: `run` whole rows, or a piece of one
constexpr int kRingStages = 3;
constexpr int kRingBlocksPerSm = 1;
constexpr int kRingMaxRun = 128;           // pixels a stage
constexpr int kRingProducers = 4;          // producer warps, after four consumer warps
constexpr int kRingConsumers = 128;
constexpr int kRingThreads = kRingConsumers + 32 * kRingProducers;
constexpr int kRingSlots = kRingMaxRun / (32 * kRingProducers);  // pixels a producer lane
static_assert(kRingSlots >= 1 && kRingSlots * 32 * kRingProducers == kRingMaxRun, "run");

enum : uint8_t { kCopied = 0, kConstant = 1, kTinted = 2 };

// A stage's pixels as the producer resolved them, for the consumers.
struct alignas(16) RingSlots {
  uint32_t word[kRingMaxRun];  // a constant row's word, or a tinted row's colour
  uint8_t kind[kRingMaxRun];
  uint8_t work[kRingProducers];  // a producer warp's pixels hold one that is no plain copy
};

constexpr int kRingSmemBytes =
    kRingStages * (kRingStageBytes + (int)sizeof(RingSlots) + 16);  // + two mbarriers a stage

// One run's per-pixel operands in a producer lane's registers: slot j of
// the lane is pixel p0 + first + 32 j, if first + 32 j < end.  Producer
// warp w takes the run's w-th share of `chunk` consecutive pixels, so that
// every warp has copies to issue whatever the run's length.
template <int ELEM>
struct RunOperands {
  int32_t idx[kRingSlots];
  uint32_t bg[kRingSlots], tint[kRingSlots];
  uint8_t valid[kRingSlots], tinted[kRingSlots];

  __device__ __forceinline__ void load(long long p0, int first, int end, const int32_t* gidx,
                                       const uint8_t* gvalid, const void* gbg,
                                       const uint32_t* tint_rgb, const uint8_t* tint_mask) {
#pragma unroll
    for (int j = 0; j < kRingSlots; ++j) {
      const int i = first + 32 * j;
      idx[j] = 0;
      bg[j] = tint[j] = 0;
      valid[j] = tinted[j] = 0;
      if (i < end) {
        const long long p = p0 + i;
        idx[j] = gidx[p];
        valid[j] = gvalid[p];
        bg[j] = ELEM == 1 ? 0x01010101u * ((const uint8_t*)gbg)[p] : ((const uint32_t*)gbg)[p];
        if (ELEM == 4 && tint_mask != nullptr) {
          tinted[j] = tint_mask[p];
          tint[j] = tint_rgb[p];
        }
      }
    }
  }
};

template <int ELEM>
__global__ void __launch_bounds__(kRingThreads) remap_gather_kernel_ring(
    const uint8_t* __restrict__ src, long long rows, int row_bytes, int run, int piece_bytes,
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ valid,
    const void* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, int fill, long long npix,
    uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const stages = smem;
  RingSlots* const slots = (RingSlots*)(smem + kRingStages * kRingStageBytes);
  uint64_t* const bars = (uint64_t*)(slots + kRingStages);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kRingStages);
  const int tid = threadIdx.x;
  const int pieces = (row_bytes + piece_bytes - 1) / piece_bytes;  // > 1 only when run == 1
  const long long runs = (npix + run - 1) / run;

  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(full0 + 8 * s, 32 * kRingProducers);  // the producers, and the stage's bytes
      mbar_init(empty0 + 8 * s, 1);  // the consumer that stored the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kRingConsumers) {
    // ---- the producer warps: operands, one bulk copy a copied row
    const int lane = tid % 32, pw = (tid - kRingConsumers) / 32;
    const int chunk = (run + kRingProducers - 1) / kRingProducers;  // <= 32 * kRingSlots
    const int first = pw * chunk + lane;  // this lane's first pixel of a run
    auto end = [&](long long r) {  // past this warp's last pixel of run r
      return (int)min((long long)(pw + 1) * chunk, min((long long)run, npix - r * run));
    };
    int st = 0;
    uint32_t phase = 0;
    RunOperands<ELEM> next;
    if (blockIdx.x < runs)
      next.load((long long)blockIdx.x * run, first, end(blockIdx.x), idx, valid, bg, tint_rgb,
                tint_mask);
    for (long long r = blockIdx.x; r < runs; r += gridDim.x) {
      const RunOperands<ELEM> cur = next;
      const long long p0 = r * run;
      const int e = end(r);
      const long long rn = r + gridDim.x;
      if (rn < runs)  // in flight while this run's copies are asked for
        next.load(rn * run, first, end(rn), idx, valid, bg, tint_rgb, tint_mask);
      long long row[kRingSlots];
      uint32_t word[kRingSlots];
      uint8_t kind[kRingSlots];
      int copies = 0, work = 0;
#pragma unroll
      for (int j = 0; j < kRingSlots; ++j) {
        row[j] = -1;
        word[j] = cur.bg[j];
        kind[j] = kConstant;
        if (first + 32 * j >= e) {
          kind[j] = kCopied;  // no pixel
        } else if (cur.valid[j]) {
          row[j] = blinky::resolve_row(cur.idx[j], rows, fill);
          if (row[j] < 0) {
            word[j] = 0xFFFFFFFFu;
          } else {
            kind[j] = cur.tinted[j] ? kTinted : kCopied;
            word[j] = cur.tint[j];
          }
        }
        copies += __popc(__ballot_sync(~0u, row[j] >= 0));
        work |= __any_sync(~0u, kind[j] != kCopied);
      }
      for (int pc = 0; pc < pieces; ++pc) {
        mbar_wait(empty0 + 8 * st, phase ^ 1);
        const int c0 = pc * piece_bytes, cb = min(piece_bytes, row_bytes - c0);
        const uint32_t dst = smem_u32(stages + st * kRingStageBytes);
        const uint32_t full = full0 + 8 * st;
        RingSlots& sl = slots[st];
#pragma unroll
        for (int j = 0; j < kRingSlots; ++j) {
          if (first + 32 * j < e) {
            sl.kind[first + 32 * j] = kind[j];
            sl.word[first + 32 * j] = word[j];
          }
        }
        // the warp's bytes are expected before any of its copies can land;
        // each lane's arrival releases its slots
        if (lane == 0) {
          sl.work[pw] = work;
          mbar_arrive_tx(full, copies * cb);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kRingSlots; ++j)
          if (row[j] >= 0)
            blinky::bulk_load(dst + (first + 32 * j) * cb, src + row[j] * row_bytes + c0, cb,
                              full);
        if (lane != 0) mbar_arrive(full);
        if (++st == kRingStages) st = 0, phase ^= 1;
      }
    }
  } else {
    // ---- the consumer warps: constant rows, the tint, the run's bulk store
    const uint64_t policy = blinky::evict_first_policy();
    int st = 0, prev = -1;
    uint32_t phase = 0;
    for (long long r = blockIdx.x; r < runs; r += gridDim.x) {
      const long long p0 = r * run;
      const int n = (int)min((long long)run, npix - p0);
      for (int pc = 0; pc < pieces; ++pc) {
        const int c0 = pc * piece_bytes, cb = min(piece_bytes, row_bytes - c0);
        uint8_t* const stage = stages + st * kRingStageBytes;
        const RingSlots& sl = slots[st];
        mbar_wait(full0 + 8 * st, phase);
        int work = 0;
#pragma unroll
        for (int w = 0; w < kRingProducers; ++w) work |= sl.work[w];
        if (work) {
          const int vecs = cb / 16;
          for (int v = tid; v < n * vecs; v += kRingConsumers) {
            const int i = v / vecs;
            const uint8_t kd = sl.kind[i];
            uint4* const q = (uint4*)stage + v;
            if (kd == kConstant) {
              uint4 w;
              splat(w, sl.word[i]);
              *q = w;
            } else if (ELEM == 4 && kd == kTinted) {
              uint4 w = *q;
              tint(w, sl.word[i]);
              *q = w;
            }
          }
          blinky::fence_async_shared();  // these stores before the bulk store's reads
        }
        bar_sync(1, kRingConsumers);
        if (tid == 0) {
          // pieces == 1: the run's n whole rows, contiguous; else one pixel's piece
          blinky::bulk_store(out + p0 * row_bytes + c0, smem_u32(stage), n * cb, policy);
          blinky::bulk_commit();
          if (prev >= 0) {
            blinky::bulk_wait_read<1>();  // the previous stage's store has read it
            mbar_arrive(empty0 + 8 * prev);
          }
        }
        prev = st;
        if (++st == kRingStages) st = 0, phase ^= 1;
      }
    }
    if (tid == 0) blinky::bulk_wait_all();  // shared memory lives until the stores are done
  }
}

template <int ELEM>
int launch_ring(const void* src, long long rows, int row_bytes, const int32_t* idx,
                const uint8_t* valid, const void* bg, const uint32_t* tint_rgb,
                const uint8_t* tint_mask, int fill, long long npix, void* out,
                cudaStream_t stream) {
  const int whole = kRingStageBytes / row_bytes;  // whole rows a stage holds
  const int run = whole < 1 ? 1 : (whole < kRingMaxRun ? whole : kRingMaxRun);
  const int piece = row_bytes < kRingStageBytes ? row_bytes : kRingStageBytes;
  cudaError_t err = cudaFuncSetAttribute(remap_gather_kernel_ring<ELEM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRingSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = blinky::wave_blocks((npix + run - 1) / run, kRingBlocksPerSm);
  remap_gather_kernel_ring<ELEM><<<blocks, kRingThreads, kRingSmemBytes, stream>>>(
      (const uint8_t*)src, rows, row_bytes, run, piece, idx, valid, bg, tint_rgb, tint_mask,
      fill, npix, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// src [rows, batch] texels of elem_bytes (1 or 4); idx, valid, bg, tint_rgb,
// tint_mask [npix]; out [npix, batch].  tint_rgb/tint_mask are null for no
// tint (elem_bytes 4 only).  fill: 0 = clip rule, 1 = fill rule.  Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_remap_gather(const void* src, long long rows, int elem_bytes,
                                   int batch, const int32_t* idx, const uint8_t* valid,
                                   const void* bg, const uint32_t* tint_rgb,
                                   const uint8_t* tint_mask, int fill, long long npix,
                                   void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)batch * elem_bytes;
  const bool vec16 = row_bytes % 16 == 0 && (uintptr_t)src % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
  if (elem_bytes == 1) {
    return vec16 ? launch<uint4, 1>(src, rows, (int)(row_bytes / 16), idx, valid, bg,
                                    nullptr, nullptr, fill, npix, out, s)
                 : launch<uint8_t, 1>(src, rows, batch, idx, valid, bg, nullptr,
                                      nullptr, fill, npix, out, s);
  }
  if (elem_bytes == 4) {
    return vec16 ? launch<uint4, 4>(src, rows, (int)(row_bytes / 16), idx, valid, bg,
                                    tint_rgb, tint_mask, fill, npix, out, s)
                 : launch<uint32_t, 4>(src, rows, batch, idx, valid, bg, tint_rgb,
                                       tint_mask, fill, npix, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The ring path of blinky_remap_gather, with the same arguments, for rows of
// a multiple of 16 bytes on 16-byte aligned pointers (else
// cudaErrorInvalidValue, and nothing runs); kernels/remap.py::ring_path
// picks it.
extern "C" int blinky_remap_gather_ring(const void* src, long long rows, int elem_bytes,
                                        int batch, const int32_t* idx, const uint8_t* valid,
                                        const void* bg, const uint32_t* tint_rgb,
                                        const uint8_t* tint_mask, int fill, long long npix,
                                        void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)batch * elem_bytes;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > (1 << 30) ||
      (uintptr_t)src % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 1)
    return launch_ring<1>(src, rows, (int)row_bytes, idx, valid, bg, nullptr, nullptr, fill,
                          npix, out, s);
  if (elem_bytes == 4)
    return launch_ring<4>(src, rows, (int)row_bytes, idx, valid, bg, tint_rgb, tint_mask, fill,
                          npix, out, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a CUDA error code returned by any blinky_* entry point.
extern "C" const char* blinky_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
