// K10: the equirect (360-video) gather-and-blend, written for Hopper (sm_90a).
//
// Replaces the device work of blinky_tpu/kernels/ingest.py: the jitted `run`
// of EquirectIngest.__call__ (ingest.py:133, :147-154; also its texel-subset
// view, :176) and of EquirectScreenKernel.__call__ (ingest.py:257, :276-288),
// which XLA lowered to K row gathers, an elementwise float32 blend and an
// elementwise epilogue, each through device memory.  One kernel, in two
// designs, serves both:
//
//   g[p, :]   = K == 1 ? src[idx[0, p], :]                       (a row copy)
//                      : blend of src[idx[k, p], :] by w[k, p], k = 0..3
//   out[p, :] = g & plate_mask[p]                                (the ingest)
//   out[p, :] = valid[p] ? tint(g, tint_rgb[p]) if tint_mask[p] : bg[p]
//                                                                (the screen)
//
// src [rows, B] packed RGBA; idx, w [K, n]; the per-output operands [n].
//
// The blend is EquirectIngest._blend in NumPy float32, bit for bit: per colour
// channel acc = ((c0*w0 + c1*w1) + c2*w2) + c3*w3 with every product and sum
// rounded on its own (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into
// an FMA), then acc + 0.5, clipped to [0, 255] and truncated; alpha is 0xFF.
// With one tap the row passes through whole, its alpha byte too.  The order
// of the screen epilogue is blend, tint, background select (ingest.py:282-287);
// the plate mask comes after the blend, so an unused plate is all zero, alpha
// too (ingest.py:153).
//
// What bounds it on the card: bytes.  An output row of B texels is B * 4 bytes
// written and up to four source rows of the same length read; neighbouring
// outputs share taps, so the distinct source rows the tables name, not 4 * n,
// are what must come from device memory (the rest is L2's to catch).  The
// blend is about a dozen float32 operations a channel, far under the bytes.
//
// Two designs, picked by what the row is (kernels/remap.py::ring_path, K1's
// rule and the one place that decides, beside the count of ring launches,
// equirect_gather.ring_launches):
//
// * The register path (equirect_gather_kernel), for rows under
//   RING_MIN_ROW_BYTES (192) bytes, rows that are no multiple of 16 bytes,
//   and pointers off a 16-byte boundary: K1's old work split.  A row is cut
//   into 16-byte vectors of four texels when B % 4 == 0 and both pointers
//   are 16-byte aligned, else into single texels; neighbouring threads take
//   neighbouring vectors of one output row, so every warp reads and writes
//   contiguous runs.  The K loads of a thread are all in flight before the
//   first is used, behind a dependent chain (valid, plate_mask, idx and w),
//   read once per thread and output row.  It holds four taps at 60-70 % of
//   the bound at every row size tried.
//
// * The ring path (equirect_gather_kernel_ring<K>), for longer rows: K1's
//   ring (remap_gather.cu) with an output's taps in its slot.  A persistent
//   grid of one block an SM with a ring of stages in shared memory
//   (RingShape<K>).  A run is as many consecutive outputs as a stage holds
//   all K taps of, at most kMaxRun; an output whose taps a stage cannot hold
//   goes in pieces, one output a run.  kProducers producer warps share each
//   run: a lane reads its next run's idx, w and epilogue operands with
//   coalesced loads while the current run is in flight, resolves the taps
//   and asks the Tensor Memory Accelerator for each tap's row with a
//   cp.async.bulk into the output's slot, counted on the stage's mbarrier.
//   Taps 0 and 1, and 2 and 3, are horizontal neighbours, one row apart in
//   the pano but at the wrap column (kernels/ingest.py::_build_tables), so
//   when the row is whole such a pair is one copy of both rows: a warp
//   issues its lanes' copies one at a time (about 75 cycles a copy), and
//   pairs halve them.  An output that shows its background or lies on an
//   unused plate copies nothing.  The consumer warps wait for the stage,
//   blend from shared memory in blend<4>'s order and rounding, tint, mask,
//   write the constant rows, and one of them stores the run's contiguous
//   output rows with one bulk store under an evict-first L2 policy, so the
//   outputs do not push out pano rows that neighbouring texels read again.
//   Four taps blend into one of two output buffers, and the stage goes back
//   to the producers as soon as it is read; one tap works in place, and its
//   stage goes back once its store has read it.  The blend converts bytes to
//   float32 and back with a PRMT and an FADD each (blend_texel), not an I2F
//   and an F2I: a texel needs 15 conversions, which issue at 16 a clock on
//   an SM against 128 FADDs.
//
// Both: an output that shows its background, or lies on an unused plate,
// reads no source row at all.  Row offsets are 64-bit: a 4096x2048 pano
// batch of 128 lanes is 2^32 bytes.  A table index outside [0, rows) is
// clipped, as the plain version clips it; the tables of kernels/ingest.py
// never hold one.
//
// The threshold and the constants, measured on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py --sweep k10: CUDA events around launches of both
// entry points and of each -D build in turns, on the 360 cell's compact
// tables, 4096x2048 panos, 720 plates, panini 1280x720, n = 753,737; the
// register path / the ring as committed, ms): B = 16 (64-byte rows)
// 0.0858 / 0.1562, 32 0.1485 / 0.1792, 48 (192 B) 0.2189 / 0.2086, 64
// 0.2820 / 0.2449, 96 0.4287 / 0.3486, 128 0.5499 / 0.4524 (71.6 % / 87.0 %
// of the bound), 256 1.1347 / 0.8786 (68.7 % / 88.7 %); at B = 128 the fused
// screen 0.6954 / 0.5205, with the tint 0.7227 / 0.5552, faces 2.4185 /
// 1.8179, nearest compact 0.2981 / 0.3008 and fused 0.3037 / 0.3062.  So the
// ring takes rows of 192 bytes and up, K1's threshold; under that the
// register path, whose blocks hold many short rows, is faster.  Four taps at
// B = 128: two stages of 64 KB 0.4518-0.4524 ms; of 56, 80 or 88 KB 0.4635,
// 0.4606, 0.4687 (88 KB is the fastest on the fused screen, 0.4966, and
// faces, 1.7606); three of 48 KB 0.4581, four of 40 KB 0.4722; 12 consumer
// warps 0.4542, 6 producers 0.4592, a cap of 128 outputs 0.4519.  Against
// three stages of 48 KB (an earlier call): 4 or 6 consumer warps 0.505 and
// 0.508 ms against 0.4705, 2 or 8 producers 0.495 and 0.479, every tap
// copied on its own 0.4936, and the blend by I2F and F2I 0.5492.  One tap
// at B = 128 reads within 3 % of the register path on every shape tried but
// two stages (0.3187 against 0.2811 ms): it holds a stage until its store.

#include "common.cuh"
#include "ring.cuh"
#include "tint.cuh"

namespace {

using blinky::kThreads;
using blinky::splat;
using blinky::tint;

// One channel of _blend: K products summed left to right, each operation
// rounded to float32 on its own; then + 0.5, the clip and the truncation.
template <int K>
__device__ __forceinline__ uint32_t blend_channel(const uint32_t (&r)[K], const float (&w)[K],
                                                  int shift) {
  float acc = __fmul_rn((float)((r[0] >> shift) & 0xFFu), w[0]);
#pragma unroll
  for (int k = 1; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn((float)((r[k] >> shift) & 0xFFu), w[k]));
  float v = __fadd_rn(acc, 0.5f);
  v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  return __float2uint_rz(v) << shift;
}

// _blend on one texel, and on a vector of four.
template <int K>
__device__ __forceinline__ uint32_t blend(const uint32_t (&r)[K], const float (&w)[K]) {
  return (0xFFu << 24) | blend_channel<K>(r, w, 0) | blend_channel<K>(r, w, 8) |
         blend_channel<K>(r, w, 16);
}

template <int K>
__device__ __forceinline__ uint4 blend(const uint4 (&r)[K], const float (&w)[K]) {
  uint32_t x[K], y[K], z[K], q[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = r[k].x;
    y[k] = r[k].y;
    z[k] = r[k].z;
    q[k] = r[k].w;
  }
  return make_uint4(blend<K>(x, w), blend<K>(y, w), blend<K>(z, w), blend<K>(q, w));
}

__device__ __forceinline__ void and_mask(uint4& v, uint32_t m) {
  v.x &= m;
  v.y &= m;
  v.z &= m;
  v.w &= m;
}
__device__ __forceinline__ void and_mask(uint32_t& v, uint32_t m) { v &= m; }

// Vec: what one thread moves at a time (uint4 = four texels, or one texel).
// K: the taps an output blends (1 = nearest, a row copy; 4 = bilinear).
template <typename Vec, int K>
__global__ void __launch_bounds__(kThreads) equirect_gather_kernel(
    const Vec* __restrict__ src, long long rows, int per_pixel,
    const int32_t* __restrict__ idx, const float* __restrict__ w, long long n,
    const uint32_t* __restrict__ plate_mask, const uint8_t* __restrict__ valid,
    const uint32_t* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, Vec* __restrict__ out) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int local = per_pixel >= kThreads ? 0 : (int)threadIdx.x / per_pixel;
  const int first = per_pixel >= kThreads ? (int)threadIdx.x : (int)threadIdx.x % per_pixel;
  if (local >= pps) return;  // the ragged tail of the block when pps * per_pixel < kThreads
  for (long long p = (long long)blockIdx.x * pps + local; p < n;
       p += (long long)gridDim.x * pps) {
    Vec* dst = out + p * per_pixel;
    if (valid != nullptr && !valid[p]) {
      Vec v;
      splat(v, bg[p]);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const uint32_t mask = plate_mask != nullptr ? plate_mask[p] : 0xFFFFFFFFu;
    if (mask == 0u) {  // an unused plate: nothing of the source shows
      Vec v;
      splat(v, 0u);
      for (int i = first; i < per_pixel; i += kThreads) dst[i] = v;
      continue;
    }
    const Vec* row[K];
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      row[k] = src + blinky::resolve_row(idx[k * n + p], rows, 0) * per_pixel;
      wk[k] = K == 1 ? 1.0f : w[k * n + p];
    }
    const bool tinted = tint_mask != nullptr && tint_mask[p];
    const uint32_t t = tinted ? tint_rgb[p] : 0u;
    for (int i = first; i < per_pixel; i += kThreads) {
      Vec r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = row[k][i];
      Vec v;
      if constexpr (K == 1) {
        v = r[0];
      } else {
        v = blend<K>(r, wk);
      }
      if (tinted) tint(v, t);
      and_mask(v, mask);
      dst[i] = v;
    }
  }
}

template <typename Vec, int K>
int launch(const void* src, long long rows, int per_pixel, const int32_t* idx, const float* w,
           long long n, const uint32_t* plate_mask, const uint8_t* valid, const uint32_t* bg,
           const uint32_t* tint_rgb, const uint8_t* tint_mask, void* out, cudaStream_t stream) {
  const int pps = blinky::pixels_per_step(per_pixel);
  const int blocks = blinky::wave_blocks((n + pps - 1) / pps);
  equirect_gather_kernel<Vec, K><<<blocks, kThreads, 0, stream>>>(
      (const Vec*)src, rows, per_pixel, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
      (Vec*)out);
  return (int)cudaGetLastError();
}

template <int K>
int dispatch(const void* src, long long rows, int batch, const int32_t* idx, const float* w,
             long long n, const uint32_t* plate_mask, const uint8_t* valid, const uint32_t* bg,
             const uint32_t* tint_rgb, const uint8_t* tint_mask, void* out, cudaStream_t s) {
  const bool vec16 = batch % 4 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec16 ? launch<uint4, K>(src, rows, batch / 4, idx, w, n, plate_mask, valid, bg,
                                  tint_rgb, tint_mask, out, s)
               : launch<uint32_t, K>(src, rows, batch, idx, w, n, plate_mask, valid, bg,
                                     tint_rgb, tint_mask, out, s);
}

// ------------------------------------------------------------- the ring path

using blinky::bar_sync;
using blinky::mbar_arrive;
using blinky::mbar_arrive_tx;
using blinky::mbar_init;
using blinky::mbar_wait;
using blinky::smem_u32;

// The ring's shape (the note above; chip_smoke.py --sweep k10 builds others
// with -D and times them against these).  Four taps blend out of the stage
// into an output buffer and give the stage back as soon as it is read, so
// two stages keep the copies going; one tap works in place and holds its
// stage until the store has read it, so it wants three.
#ifndef K10_RING_STAGES_K4
#define K10_RING_STAGES_K4 2
#endif
#ifndef K10_RING_STAGE_BYTES_K4
#define K10_RING_STAGE_BYTES_K4 65536
#endif
#ifndef K10_RING_STAGES_K1
#define K10_RING_STAGES_K1 3
#endif
#ifndef K10_RING_STAGE_BYTES_K1
#define K10_RING_STAGE_BYTES_K1 49152
#endif
#ifndef K10_RING_MAX_RUN
#define K10_RING_MAX_RUN 64
#endif
#ifndef K10_RING_CONSUMERS
#define K10_RING_CONSUMERS 8
#endif
#ifndef K10_RING_PRODUCERS
#define K10_RING_PRODUCERS 4
#endif

constexpr int kMaxRun = K10_RING_MAX_RUN;            // outputs a stage
constexpr int kProducers = K10_RING_PRODUCERS;       // producer warps, after the consumer warps
constexpr int kConsumers = 32 * K10_RING_CONSUMERS;  // consumer threads (the macro counts warps)
constexpr int kRingThreads = kConsumers + 32 * kProducers;
constexpr int kSlots = ((kMaxRun + kProducers - 1) / kProducers + 31) / 32;  // outputs a lane
static_assert(kRingThreads <= 1024, "ring shape");

enum : uint32_t { kBlend = 0, kConstant = 1, kTinted = 2 };

// A stage's outputs as the producers resolved them, for the consumers.
struct alignas(16) RingOut {
  float4 w[kMaxRun];  // the four weights
  uint4 op[kMaxRun];  // a constant row's word, the plate mask, the tint's colour, the kind
};

// The shared memory of a K-tap ring: its stages (a run's tap rows, or a
// piece of one output's), their outputs' operands and two mbarriers each,
// and with four taps two output buffers of a run's output rows.
template <int K>
struct RingShape {
  static constexpr int stages = K == 1 ? K10_RING_STAGES_K1 : K10_RING_STAGES_K4;
  static constexpr int stage_bytes = K == 1 ? K10_RING_STAGE_BYTES_K1 : K10_RING_STAGE_BYTES_K4;
  static constexpr int out_bytes = K == 1 ? 0 : stage_bytes / K;
  static constexpr int smem_bytes =
      stages * (stage_bytes + (int)sizeof(RingOut) + 16) + 2 * out_bytes;
  static_assert(stage_bytes % 64 == 0 && smem_bytes <= 232448,
                "a ring's stages must fit an SM's 227 KB of shared memory");
};

// One byte of a word as an exact float32: the byte below 2^23's exponent,
// less 2^23 (a PRMT and an FADD, where an I2F issues at an eighth of FADD's rate).
__device__ __forceinline__ float byte_float(uint32_t x, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + k)), 8388608.0f);
}

// One texel of _blend from four taps, bit for bit as blend<4>: the same
// products and sums in the same order, then + 0.5 and the clip; the
// truncation is the add of 2^23 rounded toward zero, whose low byte is the
// channel.
__device__ __forceinline__ uint32_t blend_texel(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                                float4 w) {
  uint32_t ch[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float acc = __fmul_rn(byte_float(a, k), w.x);
    acc = __fadd_rn(acc, __fmul_rn(byte_float(b, k), w.y));
    acc = __fadd_rn(acc, __fmul_rn(byte_float(c, k), w.z));
    acc = __fadd_rn(acc, __fmul_rn(byte_float(d, k), w.w));
    const float v = fminf(fmaxf(__fadd_rn(acc, 0.5f), 0.0f), 255.0f);
    ch[k] = __float_as_uint(__fadd_rz(v, 8388608.0f));
  }
  return __byte_perm(__byte_perm(ch[0], ch[1], 0x0040u), ch[2], 0x0410u) | 0xFF000000u;
}

// One run's per-output operands in a producer lane's registers: slot j of
// the lane is output p0 + first + 32 j, if first + 32 j < end.  Producer
// warp w takes the run's w-th share of `chunk` consecutive outputs.
template <int K>
struct RunOps {
  int32_t idx[kSlots][K];
  float w[kSlots][K];
  uint32_t mask[kSlots], bg[kSlots], tint[kSlots];
  uint8_t valid[kSlots], tinted[kSlots];

  __device__ __forceinline__ void load(long long p0, int first, int end, long long n,
                                       const int32_t* gidx, const float* gw,
                                       const uint32_t* plate_mask, const uint8_t* gvalid,
                                       const uint32_t* gbg, const uint32_t* tint_rgb,
                                       const uint8_t* tint_mask) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = first + 32 * j;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        idx[j][k] = 0;
        w[j][k] = 0.0f;
      }
      mask[j] = 0xFFFFFFFFu;
      bg[j] = tint[j] = 0;
      valid[j] = 1;
      tinted[j] = 0;
      if (i < end) {
        const long long p = p0 + i;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          idx[j][k] = gidx[k * n + p];
          if (K > 1) w[j][k] = gw[k * n + p];
        }
        if (plate_mask != nullptr) mask[j] = plate_mask[p];
        if (gvalid != nullptr) {
          valid[j] = gvalid[p];
          bg[j] = gbg[p];
        }
        if (tint_mask != nullptr) {
          tinted[j] = tint_mask[p];
          tint[j] = tint_rgb[p];
        }
      }
    }
  }
};

template <int K>
__global__ void __launch_bounds__(kRingThreads, 1) equirect_gather_kernel_ring(
    const uint8_t* __restrict__ src, long long rows, int row_bytes, int run, int piece_bytes,
    const int32_t* __restrict__ idx, const float* __restrict__ w, long long n,
    const uint32_t* __restrict__ plate_mask, const uint8_t* __restrict__ valid,
    const uint32_t* __restrict__ bg, const uint32_t* __restrict__ tint_rgb,
    const uint8_t* __restrict__ tint_mask, uint8_t* __restrict__ out) {
  constexpr int kStages = RingShape<K>::stages, kStageBytes = RingShape<K>::stage_bytes;
  constexpr int kOutBytes = RingShape<K>::out_bytes;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const stages = smem;
  RingOut* const meta = (RingOut*)(smem + kStages * kStageBytes);
  uint8_t* const outb = (uint8_t*)(meta + kStages);  // two output buffers, four taps only
  uint64_t* const bars = (uint64_t*)(outb + 2 * kOutBytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const int tid = threadIdx.x;
  const int pieces = (row_bytes + piece_bytes - 1) / piece_bytes;  // > 1 only when run == 1
  const long long runs = (n + run - 1) / run;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 32 * kProducers);  // the producers, and the stage's bytes
      mbar_init(empty0 + 8 * s, 1);               // the consumer that stored the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warps: operands, the bulk copies of each output's taps
    const int lane = tid % 32, pw = (tid - kConsumers) / 32;
    const int chunk = (run + kProducers - 1) / kProducers;  // <= 32 * kSlots
    const int first = pw * chunk + lane;  // this lane's first output of a run
    auto end = [&](long long r) {  // past this warp's last output of run r
      return (int)min((long long)(pw + 1) * chunk, min((long long)run, n - r * run));
    };
    // horizontal neighbours (taps 0 and 1, 2 and 3) are adjacent rows of the
    // pano but at the wrap column: one copy of both when the row is whole
    const bool pairs = K == 4 && pieces == 1;
    int st = 0;
    uint32_t phase = 0;
    RunOps<K> next;
    if (blockIdx.x < runs)
      next.load((long long)blockIdx.x * run, first, end(blockIdx.x), n, idx, w, plate_mask,
                valid, bg, tint_rgb, tint_mask);
    for (long long r = blockIdx.x; r < runs; r += gridDim.x) {
      const RunOps<K> cur = next;
      const int e = end(r);
      const long long rn = r + gridDim.x;
      if (rn < runs)  // in flight while this run's copies are asked for
        next.load(rn * run, first, end(rn), n, idx, w, plate_mask, valid, bg, tint_rgb,
                  tint_mask);
      long long row[kSlots][K];
      uint4 op[kSlots];
      bool copied[kSlots];
      int taps = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        copied[j] = false;
        op[j] = make_uint4(cur.bg[j], 0xFFFFFFFFu, 0u, kConstant);  // an invalid pixel
#pragma unroll
        for (int k = 0; k < K; ++k) row[j][k] = 0;
        if (first + 32 * j < e && cur.valid[j]) {
          if (cur.mask[j] == 0u) {  // an unused plate: nothing of the source shows
            op[j].x = 0u;
          } else {
            copied[j] = true;
            taps += K;
            op[j] = make_uint4(0u, cur.mask[j], cur.tint[j], cur.tinted[j] ? kTinted : kBlend);
#pragma unroll
            for (int k = 0; k < K; ++k) row[j][k] = blinky::resolve_row(cur.idx[j][k], rows, 0);
          }
        }
      }
      const int warp_taps = __reduce_add_sync(~0u, taps);
      for (int pc = 0; pc < pieces; ++pc) {
        mbar_wait(empty0 + 8 * st, phase ^ 1);
        const int c0 = pc * piece_bytes, cb = min(piece_bytes, row_bytes - c0);
        const uint32_t dst = smem_u32(stages + st * kStageBytes);
        const uint32_t full = full0 + 8 * st;
        RingOut& m = meta[st];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int i = first + 32 * j;
          if (i < e) {
            m.op[i] = op[j];
            if constexpr (K == 4)
              m.w[i] = make_float4(cur.w[j][0], cur.w[j][1], cur.w[j][2], cur.w[j][3]);
          }
        }
        // the warp's bytes are expected before any of its copies can land;
        // each lane's arrival releases its slots
        if (lane == 0) mbar_arrive_tx(full, warp_taps * cb);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          if (!copied[j]) continue;
          const uint32_t d = dst + (first + 32 * j) * K * cb;
          if constexpr (K == 1) {
            blinky::bulk_load(d, src + row[j][0] * row_bytes + c0, cb, full);
          } else {
#pragma unroll
            for (int k = 0; k < K; k += 2) {
              const long long r0 = row[j][k], r1 = row[j][k + 1];
              if (pairs && r1 == r0 + 1) {
                blinky::bulk_load(d + k * cb, src + r0 * row_bytes, 2 * cb, full);
              } else {
                blinky::bulk_load(d + k * cb, src + r0 * row_bytes + c0, cb, full);
                blinky::bulk_load(d + (k + 1) * cb, src + r1 * row_bytes + c0, cb, full);
              }
            }
          }
        }
        if (lane != 0) mbar_arrive(full);
        if (++st == kStages) st = 0, phase ^= 1;
      }
    }
  } else {
    // ---- the consumer warps: the blend, the epilogue, the run's bulk store
    const uint64_t policy = blinky::evict_first_policy();
    int st = 0, prev = -1, ob = 0;
    uint32_t phase = 0;
    for (long long r = blockIdx.x; r < runs; r += gridDim.x) {
      const long long p0 = r * run;
      const int nn = (int)min((long long)run, n - p0);
      for (int pc = 0; pc < pieces; ++pc) {
        const int c0 = pc * piece_bytes, cb = min(piece_bytes, row_bytes - c0);
        uint8_t* const stage = stages + st * kStageBytes;
        // one tap: in place, as K1's ring; four: into an output buffer, so
        // that the stage goes back to the producers as soon as it is read
        uint8_t* const dst = K == 1 ? stage : outb + ob * kOutBytes;
        const RingOut& m = meta[st];
        mbar_wait(full0 + 8 * st, phase);
        const int vecs = cb / 16, di = kConsumers / vecs, dc = kConsumers % vecs;
        int i = tid / vecs, c = tid % vecs;
        for (int v = tid; v < nn * vecs; v += kConsumers) {
          const uint4 o = m.op[i];
          uint4 x;
          if (o.w == kConstant) {
            splat(x, o.x);
          } else {
            const uint4* in = (const uint4*)(stage + i * K * cb) + c;
            if constexpr (K == 1) {
              x = in[0];
            } else {
              const int t = cb / 16;  // a tap's row in the stage, in vectors
              const uint4 a = in[0], b = in[t], c2 = in[2 * t], d = in[3 * t];
              const float4 wk = m.w[i];
              x = make_uint4(blend_texel(a.x, b.x, c2.x, d.x, wk),
                             blend_texel(a.y, b.y, c2.y, d.y, wk),
                             blend_texel(a.z, b.z, c2.z, d.z, wk),
                             blend_texel(a.w, b.w, c2.w, d.w, wk));
            }
            if (o.w == kTinted) tint(x, o.z);
            and_mask(x, o.y);
          }
          ((uint4*)(dst + i * cb))[c] = x;
          i += di;
          c += dc;
          if (c >= vecs) c -= vecs, ++i;
        }
        blinky::fence_async_shared();  // these stores before the bulk store's reads
        // four taps: the store of two stages ago has read this output buffer
        if (K != 1 && tid == 0) blinky::bulk_wait_read<0>();
        bar_sync(1, kConsumers);
        if (tid == 0) {
          // pieces == 1: the run's nn whole rows, contiguous; else one output's piece
          blinky::bulk_store(out + p0 * row_bytes + c0, smem_u32(dst), nn * cb, policy);
          blinky::bulk_commit();
          if (K != 1) {
            mbar_arrive(empty0 + 8 * st);
          } else if (prev >= 0) {
            blinky::bulk_wait_read<1>();  // the previous stage's store has read it
            mbar_arrive(empty0 + 8 * prev);
          }
        }
        prev = st;
        ob ^= 1;
        if (++st == kStages) st = 0, phase ^= 1;
      }
    }
    if (tid == 0) blinky::bulk_wait_all();  // shared memory lives until the stores are done
  }
}

template <int K>
int launch_ring(const void* src, long long rows, int row_bytes, const int32_t* idx,
                const float* w, long long n, const uint32_t* plate_mask, const uint8_t* valid,
                const uint32_t* bg, const uint32_t* tint_rgb, const uint8_t* tint_mask,
                void* out, cudaStream_t stream) {
  // a run: as many outputs as a stage holds all the taps of, at most kMaxRun;
  // an output whose taps a stage cannot hold goes in pieces, one a run
  constexpr int kStageBytes = RingShape<K>::stage_bytes, smem_bytes = RingShape<K>::smem_bytes;
  const long long per_out = (long long)K * row_bytes;
  const bool whole = per_out <= kStageBytes;
  const int fits = whole ? (int)(kStageBytes / per_out) : 1;
  const int run = fits < kMaxRun ? fits : kMaxRun;
  const int piece = whole ? row_bytes : kStageBytes / K / 16 * 16;
  cudaError_t err = cudaFuncSetAttribute(equirect_gather_kernel_ring<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = blinky::wave_blocks((n + run - 1) / run, 1);
  equirect_gather_kernel_ring<K><<<blocks, kRingThreads, smem_bytes, stream>>>(
      (const uint8_t*)src, rows, row_bytes, run, piece, idx, w, n, plate_mask, valid, bg,
      tint_rgb, tint_mask, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// src [rows, batch] packed RGBA; idx [taps, n] int32, w [taps, n] float32
// (w may be null when taps == 1); taps 1 or 4; out [n, batch].  The epilogue
// follows the pointers given: plate_mask [n] alone (the ingest), or valid [n]
// and bg [n] with tint_rgb [n] and tint_mask [n] or without (the screen); all
// null leaves the blend as it is.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_equirect_gather(const void* src, long long rows, int batch,
                                      const int32_t* idx, const float* w, int taps, long long n,
                                      const uint32_t* plate_mask, const uint8_t* valid,
                                      const uint32_t* bg, const uint32_t* tint_rgb,
                                      const uint8_t* tint_mask, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((valid == nullptr) != (bg == nullptr) || (tint_rgb == nullptr) != (tint_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (taps == 1)
    return dispatch<1>(src, rows, batch, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
                       out, s);
  if (taps == 4 && w != nullptr)
    return dispatch<4>(src, rows, batch, idx, w, n, plate_mask, valid, bg, tint_rgb, tint_mask,
                       out, s);
  return (int)cudaErrorInvalidValue;
}

// The ring path of blinky_equirect_gather, with the same arguments, for rows
// of a multiple of 16 bytes on 16-byte aligned pointers (else
// cudaErrorInvalidValue, and nothing runs); kernels/remap.py::ring_path picks
// it, as it does for K1.
extern "C" int blinky_equirect_gather_ring(const void* src, long long rows, int batch,
                                           const int32_t* idx, const float* w, int taps,
                                           long long n, const uint32_t* plate_mask,
                                           const uint8_t* valid, const uint32_t* bg,
                                           const uint32_t* tint_rgb, const uint8_t* tint_mask,
                                           void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)batch * 4;
  if ((valid == nullptr) != (bg == nullptr) || (tint_rgb == nullptr) != (tint_mask == nullptr) ||
      row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > (1 << 30) ||
      (uintptr_t)src % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (taps == 1)
    return launch_ring<1>(src, rows, (int)row_bytes, idx, w, n, plate_mask, valid, bg, tint_rgb,
                          tint_mask, out, s);
  if (taps == 4 && w != nullptr)
    return launch_ring<4>(src, rows, (int)row_bytes, idx, w, n, plate_mask, valid, bg, tint_rgb,
                          tint_mask, out, s);
  return (int)cudaErrorInvalidValue;
}
