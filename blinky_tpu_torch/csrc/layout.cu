// K7: the posed path's pose-major layout, written for Hopper (sm_90a).
//
// Replaces the jnp.transpose of blinky_tpu/kernels/posed.py:91
// (prep_posed_inputs), the first step of the JAX package's posed kernels:
//
//   out[b, t] = t < T ? in[t * ld + b] : 0        in [T, ld], out [B, n_out]
//
// The caller's frames [P, S, S, B] hold a texel's B poses side by side (the
// batch innermost, ld = B, or ld > B for a batch slice of a wider array);
// the posed kernel wants each pose's frame contiguous.  Texels T..n_out-1
// are the zero planes that pad P < 6 plates to 6.
//
// What bounds it on the card: bytes.  Every input byte is read once and
// every output byte, the zero planes included, is written once; there is no
// arithmetic.  PyTorch's strided copy moves a byte per thread with a 64-byte
// stride on one side and runs at about 45 GB/s each way.
//
// What the design does about it.  A block takes a tile of 256 texels and
// 64 bytes of their rows (64 u8 poses or 16 RGBA words), and a second grid
// dimension walks the rest of the rows.
//  * Reads: each thread loads four 16-byte vectors, all issued before the
//    first is stored, so a warp reads whole 64-byte row chunks.
//  * The tile sits in shared memory with an 80-byte row stride: two rows 4
//    apart fall 16 banks apart, so the loads' quarter-warps and the
//    transpose's half-warps are free of bank conflicts.
//  * u8: a thread reads 16 rows of one 4-pose word column and turns each
//    4x4 byte block around with two rounds of __byte_perm, giving 16
//    texels of 4 poses: four 16-byte stores.  The warp's second half reads
//    its rows in the order i ^ 4, which keeps the halves 16 banks apart.
//    RGBA: a thread gathers 4 texels of one pose into one 16-byte store.
//  * Long rows (blinky_posed_layout_rows; kernels/posed.py::long_row_path
//    picks it for the vector path's shapes with rows of 128 bytes and more
//    of u8, 256 of RGBA) take posed_layout_rows: the same tile code on 128
//    bytes of a row (u8) or 256 (RGBA) a block, a warp reading 512 bytes of
//    whole row runs, the shared rows 16 bytes longer than the run (which
//    keeps the vector path's bank spacing), and the chunks of one texel
//    tile next to each other in a one-dimensional grid.  The vector path's grid put the ~1,000
//    blocks resident at once on one 64-byte column of rows, which at
//    B = 1024 is 64 bytes of every 1 KB over some 270 MB, and ran at
//    67.6 % of the byte bound from 256-byte rows up (6.33 ms at the posed
//    cell's [6, 1080, 1080, 1024] u8 against 4.28 ms).  Runs of 128 or 256
//    bytes a row take it to 83.0-83.5 % (u8 B = 1024, 2048) and 85.5 %
//    (RGBA), within a few points of the card's own copy rate (x + 1 over
//    1 GiB: 86.4 %); the run length does most of it: 64-byte runs with the
//    chunks next to each other reach 77-80 %, and which grid index runs
//    fastest moves 256-byte runs by 0-0.5 points and 128-byte runs by 1.5-2
//    (chip_smoke.py --sweep; NVIDIA H100 80GB HBM3, 700 W).  u8 takes 128
//    bytes: its byte transposes want the six blocks an SM that a 36-KB tile
//    allows (256 bytes, three blocks of 68 KB: 82.1 % at B = 1024); RGBA,
//    whose transpose is four word loads, takes 256 (128 bytes: 82.1 %).  On
//    rows shorter than a block's run the vector path is as fast or faster
//    (RGBA at B = 32: 79.6 against 77.6 %).  Bound: bytes, at about the
//    copy rate.
//  * Every other shape of blinky_posed_layout (a ragged B, a row stride or
//    pointer off 16 bytes, an output row not a multiple of 16 bytes) takes
//    one of two kernels built for it:
//    - posed_layout_tile stages a tile of texel rows in shared memory with
//      16-byte loads, aligned down at each end and masked, eight of them
//      issued before the first shared store.  A contiguous ragged batch
//      (ld == B, rows of at most 256 bytes) is one span of memory a tile,
//      read as such; a batch slice (ld > B: render_posed's chunks) reads
//      each row's B·E bytes from its sector in one or a few loads, in
//      chunks of at most 256 bytes of poses.  The tile is written out as
//      16-byte words of each pose's texel run, neighbouring threads on
//      neighbouring words of one pose: u8 reads 4 poses of a row as one
//      funnel-shifted word and turns 4x4 byte blocks as the vector path
//      does, RGBA gathers 4 texels of one pose.  Shared words are
//      XOR-swizzled within each 128-byte line (word w at w ^ (w >> 5) mod
//      32), so the strided column reads of any row length spread over the
//      banks.
//    - posed_layout_column serves a one-pose slice (B == 1, ld > 1): a
//      warp's loads on neighbouring rows, K7_COLUMN_LOADS of them a
//      thread, turned around in shared memory and written as 16-byte
//      words.  Each load costs its row's 32-byte sector at least (the
//      sector floor, T x 32 bytes read); on the H100 it costs a 64-byte
//      segment, whatever the L2 fetch granularity limit is set to
//      (chip_smoke.py --sweep), so the card's own floor is T x 64 bytes.
//  * Frames whose texels are not evenly strided (a transpose of the two
//    plate axes, say) take the strided path, blinky_posed_layout_strided:
//    scalar tiles of a 32-bit shared word an element, each element read at
//    its own four strides,
//    with the tile's read order following whichever of the pose and the
//    texel column is unit-strided.  jnp.transpose takes any array, and so
//    does K7.

#include "common.cuh"

namespace {

using blinky::kThreads;  // 256: one texel of the tile a thread
constexpr int kTileTexels = 256;
constexpr int kChunkBytes = 64;   // bytes of a texel's row one tile holds
constexpr int kScalarElems = 2048;  // the strided path's tile, texels x poses
constexpr int kSpanBytes = 256;     // the longest row read as one span, and a slice's chunk
constexpr int kTileBytes = 32768;   // shared memory a tile aims at
constexpr int kTileLoads = 8;       // 16-byte loads a thread issues before storing them

// The column path's loads a thread (a block takes this many times kThreads
// texels); overridable with -D.  Chosen on the 1080p one-pose slice
// (chip_smoke.py --sweep; NVIDIA H100 80GB HBM3, 700 W): u8 / RGBA with 1
// load a thread 0.1507 / 0.2056 ms, 2 loads 0.1507 / 0.2160, 4 loads
// 0.1505 / 0.2249, 16 loads 0.1504 / 0.2372, against permute().contiguous()'s
// 0.1530 / 0.2292.  Occupancy alone keeps 2048 loads in flight an SM; more
// loads a thread spread a block's reads over more of memory at once, which
// RGBA's rows, 256 bytes apart, pay for.
#ifndef K7_COLUMN_LOADS
#define K7_COLUMN_LOADS 1
#endif

// The long-row path's shape (chosen by chip_smoke.py --sweep, the note
// above): 64-byte chunks of a texel row a block, for u8 and for RGBA rows,
// and K7_ROW_ORDER 0 for the chunks of one texel tile running fastest in
// the grid (1: the texel tile fastest, as in the vector path's grid).
#ifndef K7_ROW_CHUNKS_U8
#define K7_ROW_CHUNKS_U8 2
#endif
#ifndef K7_ROW_CHUNKS_RGBA
#define K7_ROW_CHUNKS_RGBA 4
#endif
#ifndef K7_ROW_ORDER
#define K7_ROW_ORDER 0
#endif

// 4x4 byte transpose: a[j] holds 4 poses of texel j; o[p] gets texels 0..3
// of pose p, in two rounds of __byte_perm.
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* o) {
  const uint32_t x0 = __byte_perm(a[0], a[1], 0x5140), x1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t y0 = __byte_perm(a[2], a[3], 0x5140), y1 = __byte_perm(a[2], a[3], 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[1] = __byte_perm(x0, y0, 0x7632);
  o[2] = __byte_perm(x1, y1, 0x5410);
  o[3] = __byte_perm(x1, y1, 0x7632);
}

// One tile of the vector paths: texels t0 .. t0 + kTileTexels - 1 and
// bytes col0 .. col0 + 64 NC - 1 of their rows, staged in `tile` at a row
// stride of 64 NC + 16 bytes, then written pose-major.  E: element bytes,
// 1 (u8) or 4 (RGBA).
template <int E, int NC>
__device__ __forceinline__ void layout_tile(const uint8_t* __restrict__ in, long long ld_bytes,
                                            long long T, int row_bytes, long long n_out,
                                            uint8_t* __restrict__ out, long long t0, int col0,
                                            uint8_t* tile) {
  constexpr int kRow = kChunkBytes * NC + 16;    // the tile's row stride
  constexpr int kUnits = 4 * NC;                 // 16-byte units of a tile row
  constexpr int kLoads = kTileTexels * kUnits / kThreads;
  const int tid = threadIdx.x;
  const int units = min(kChunkBytes * NC, row_bytes - col0) / 16;  // units the rows hold

  uint4 v[kLoads];
  int rows[kLoads], us[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = j * kThreads + tid;
    if (NC == 1) {
      // a warp takes 8 rows x 4 units; quarter q holds rows q and q + 4
      const int w = i >> 5, lane = i & 31;
      rows[j] = w * 8 + ((lane & 7) >> 2) * 4 + (lane >> 3);
      us[j] = lane & 3;
    } else {
      // a warp takes 512 bytes of whole row runs; a quarter, 128 bytes of one row
      rows[j] = i / kUnits;
      us[j] = i % kUnits;
    }
    const long long t = t0 + rows[j];
    v[j] = make_uint4(0, 0, 0, 0);
    if (t < T && us[j] < units)
      v[j] = *(const uint4*)(in + t * ld_bytes + col0 + us[j] * 16);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) *(uint4*)(tile + rows[j] * kRow + us[j] * 16) = v[j];
  __syncthreads();

  if (E == 1) {
    // thread: word column c (poses col0 + 4c .. + 3), texels 16 g .. 16 g + 15,
    // for each 64-byte chunk k of the tile
    const int g = tid >> 4, h = g & 1;
    const long long tt = t0 + g * 16;
    if (tt >= n_out) return;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = (tid & 15) + 16 * k;
      if (c >= units * 4) return;
      uint32_t a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        a[i] = *(const uint32_t*)(tile + (g * 16 + (i ^ (h << 2))) * kRow + c * 4);
      // o[q][j] = texels 4q..4q+3 of pose j (q in the read order, so q ^ h
      // is the texel group)
      uint32_t o[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) transpose4(a + 4 * q, o[q]);
      const long long b0 = col0 + c * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 s = h ? make_uint4(o[1][j], o[0][j], o[3][j], o[2][j])
                          : make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
        *(uint4*)(out + (b0 + j) * n_out + tt) = s;
      }
    }
  } else {
    // thread: pose p of the tile, texels 4 g .. 4 g + 3, four times, for
    // each 64-byte chunk k of the tile
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int p = (tid & 15) + 16 * k;
      if (p >= units * 4) return;
      const long long b = col0 / 4 + p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = j * 16 + (tid >> 4);
        const long long tt = t0 + g * 4;
        if (tt >= n_out) break;
        const uint8_t* r = tile + g * 4 * kRow + p * 4;
        const uint4 s = make_uint4(*(const uint32_t*)r, *(const uint32_t*)(r + kRow),
                                   *(const uint32_t*)(r + 2 * kRow),
                                   *(const uint32_t*)(r + 3 * kRow));
        *(uint4*)(out + (b * n_out + tt) * 4) = s;
      }
    }
  }
}

// The vector path.  grid.x: texel tiles; grid.y: 64-byte chunks of a row.
template <int E>
__global__ void __launch_bounds__(kThreads) posed_layout_vec(
    const uint8_t* __restrict__ in, long long ld_bytes, long long T, int row_bytes,
    long long n_out, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[kTileTexels * (kChunkBytes + 16)];
  layout_tile<E, 1>(in, ld_bytes, T, row_bytes, n_out, out,
                    (long long)blockIdx.x * kTileTexels, blockIdx.y * kChunkBytes, tile);
}

// The long-row path: a one-dimensional grid of `tiles` texel tiles x
// `chunks` chunks of 64 NC bytes of a row, in K7_ROW_ORDER.
template <int E, int NC>
__global__ void __launch_bounds__(kThreads) posed_layout_rows(
    const uint8_t* __restrict__ in, long long ld_bytes, long long T, int row_bytes,
    long long n_out, long long tiles, int chunks, uint8_t* __restrict__ out) {
  extern __shared__ uint4 row_tile[];
  const long long b = blockIdx.x;
  const long long ti = K7_ROW_ORDER ? b % tiles : b / chunks;
  const int chunk = (int)(K7_ROW_ORDER ? b / tiles : b % chunks);
  layout_tile<E, NC>(in, ld_bytes, T, row_bytes, n_out, out, ti * kTileTexels,
                     chunk * kChunkBytes * NC, (uint8_t*)row_tile);
}

// A shared word's place: XOR its line (32 words) into its bank, a
// permutation within each 128-byte line.
__device__ __forceinline__ int swz(int w) { return w ^ ((w >> 5) & 31); }

// The tile path.  E: element bytes, 1 (u8) or 4 (RGBA).  A block takes tt
// texels (a multiple of 64) of the poses c0 .. c0 + cb - 1; grid.x: texel
// tiles, grid.y: pose chunks.  SPAN: ld == B == cb, so the tile's rows are
// one contiguous span, staged as read; else row r's bytes stage at r * rs
// (rs = nc 16-byte chunks), from the 16-byte boundary below the row.
// ovec: every output word is 16 bytes and 16-byte aligned.
template <int E, bool SPAN>
__global__ void __launch_bounds__(kThreads) posed_layout_tile(
    const uint8_t* __restrict__ in, long long ld_bytes, long long T, int B, int cb, int tt,
    int nc, int rs, long long n_out, int ovec, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * tt;
  const int c0 = blockIdx.y * cb;
  const int nb = min(cb, B - c0);  // poses of this chunk
  const int R = nb * E;            // bytes of a row the chunk takes
  const int rows = (int)max(0LL, min((long long)tt, T - t0));  // rows holding texels
  const uint8_t* first = in + t0 * ld_bytes + (long long)c0 * E;
  // the 16-byte chunks to stage: SPAN, chunk i of the span's aligned cover;
  // else chunk i % nc of row i / nc, where it meets the row's bytes
  const int head0 = (int)((uintptr_t)first & 15);
  const int total = SPAN ? (rows ? (head0 + rows * R + 15) >> 4 : 0) : rows * nc;
  for (int base = 0; base < total; base += kTileLoads * kThreads) {
    uint4 v[kTileLoads];
    int slot[kTileLoads];
#pragma unroll
    for (int k = 0; k < kTileLoads; ++k) {
      const int i = base + k * kThreads + tid;
      v[k] = make_uint4(0, 0, 0, 0);
      slot[k] = -1;
      if (i >= total) continue;
      const uint8_t* a;
      if (SPAN) {
        a = first - head0 + 16 * i;
        slot[k] = 4 * i;
      } else {
        const int r = i / nc, c = i - r * nc;
        const uint8_t* row = first + r * ld_bytes;
        const int h = (int)((uintptr_t)row & 15);
        if (16 * c >= h + R) continue;
        a = row - h + 16 * c;
        slot[k] = (r * rs + 16 * c) >> 2;
      }
      v[k] = *(const uint4*)a;
    }
#pragma unroll
    for (int k = 0; k < kTileLoads; ++k) {
      if (slot[k] < 0) continue;
      const int w = slot[k];
      tile[swz(w)] = v[k].x;
      tile[swz(w + 1)] = v[k].y;
      tile[swz(w + 2)] = v[k].z;
      tile[swz(w + 3)] = v[k].w;
    }
  }
  __syncthreads();

  // byte offset in the tile of row r's pose b (of the chunk)
  auto at = [&](int r, int b) -> int {
    if (SPAN) return head0 + r * R + b * E;
    return r * rs + (int)((uintptr_t)(first + r * ld_bytes) & 15) + b * E;
  };
  if (E == 1) {
    // thread: 4 poses (quad q) x 16 texels (group g), g running fastest
    const int ng = tt / 16, nq = (nb + 3) / 4;
    for (int i = tid; i < ng * nq; i += kThreads) {
      const int g = i % ng, q = i / ng;
      const long long tg = t0 + g * 16;
      if (tg >= n_out) continue;
      uint32_t a[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = g * 16 + j;
        a[j] = 0;
        if (r < rows) {
          const int o = at(r, 4 * q), w = o >> 2;
          a[j] = __funnelshift_r(tile[swz(w)], tile[swz(w + 1)], (o & 3) * 8);
        }
      }
      uint32_t o[4][4];  // o[x][p]: texels 4x .. 4x + 3 of pose p
#pragma unroll
      for (int x = 0; x < 4; ++x) transpose4(a + 4 * x, o[x]);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (4 * q + p >= nb) break;
        uint8_t* dst = out + (long long)(c0 + 4 * q + p) * n_out + tg;
        const uint4 s = make_uint4(o[0][p], o[1][p], o[2][p], o[3][p]);
        if (ovec) {
          *(uint4*)dst = s;
        } else {
          const uint32_t ws[4] = {s.x, s.y, s.z, s.w};
          for (int e = 0; e < 16 && tg + e < n_out; ++e) dst[e] = (uint8_t)(ws[e >> 2] >> (8 * (e & 3)));
        }
      }
    }
  } else {
    // thread: one pose b x 4 texels (group g), g running fastest
    const int ng = tt / 4;
    for (int i = tid; i < ng * nb; i += kThreads) {
      const int g = i % ng, b = i / ng;
      const long long tg = t0 + g * 4;
      if (tg >= n_out) continue;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = g * 4 + j;
        w[j] = r < rows ? tile[swz(at(r, b) >> 2)] : 0u;
      }
      uint32_t* dst = (uint32_t*)out + (long long)(c0 + b) * n_out + tg;
      if (ovec) {
        *(uint4*)dst = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int j = 0; j < 4 && tg + j < n_out; ++j) dst[j] = w[j];
      }
    }
  }
}

// The one-pose slice (B == 1, ld > 1): a block takes K7_COLUMN_LOADS x
// kThreads texels.  Load j of a thread reads texel j * kThreads + tid, so a
// warp's loads walk neighbouring rows, as the card's memory wants; all of a
// thread's loads are issued before the first is used.  The texels turn
// around in shared memory and leave as 16-byte words.
template <int E>
__global__ void __launch_bounds__(kThreads) posed_layout_column(
    const uint8_t* __restrict__ in, long long ld_bytes, long long T, long long n_out,
    int ovec, uint8_t* __restrict__ out) {
  constexpr int L = K7_COLUMN_LOADS, n = L * kThreads;  // texels a block
  __shared__ __align__(16) uint8_t col[n * E];
  const int tid = threadIdx.x;
  const long long tb = (long long)blockIdx.x * n;
  uint32_t v[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const long long t = tb + j * kThreads + tid;
    v[j] = 0;
    if (t < T) v[j] = E == 1 ? (uint32_t)in[t * ld_bytes] : *(const uint32_t*)(in + t * ld_bytes);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (E == 1)
      col[j * kThreads + tid] = (uint8_t)v[j];
    else
      ((uint32_t*)col)[j * kThreads + tid] = v[j];
  }
  __syncthreads();
  if (ovec) {  // the block's texels as 16-byte words, neighbouring threads on neighbouring words
    for (int u = tid; u < n * E / 16; u += kThreads) {
      const long long t = tb + u * 16 / E;
      if (t < n_out) *(uint4*)(out + t * E) = *(const uint4*)(col + 16 * u);
    }
  } else {
    for (int i = tid; i < n; i += kThreads)
      if (tb + i < n_out)
        for (int e = 0; e < E; ++e) out[(tb + i) * E + e] = col[i * E + e];
  }
}

// The strided path: the scalar path's tiles over frames [P, S, S, B] with any
// four element strides sp, sy, sx, sb.  pose_fast: read the tile with the pose
// running fastest (a unit-strided batch), else with the texel running fastest
// (a unit-strided column).
template <typename Elem>
__global__ void __launch_bounds__(kThreads) posed_layout_strided(
    const Elem* __restrict__ in, long long sp, long long sy, long long sx, long long sb,
    int S, long long T, int B, int tt, int tb, int pose_fast, long long n_out,
    Elem* __restrict__ out) {
  __shared__ uint32_t tile[2 * kScalarElems];  // tt * (tb + 1) words at most
  const long long t0 = (long long)blockIdx.x * tt;
  const int b0 = blockIdx.y * tb;
  const int n = tt * tb;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int r, c;
    if (pose_fast) {
      r = i / tb, c = i - r * tb;
    } else {
      c = i / tt, r = i - c * tt;
    }
    const long long t = t0 + r;
    uint32_t v = 0u;
    if (t < T && b0 + c < B) {
      const long long pl = t / ((long long)S * S), rem = t - pl * S * S;
      const long long y = rem / S, x = rem - y * S;
      v = (uint32_t)in[pl * sp + y * sy + x * sx + (long long)(b0 + c) * sb];
    }
    tile[r * (tb + 1) + c] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / tt, r = i - c * tt;
    const long long t = t0 + r;
    if (t < n_out && b0 + c < B)
      out[(long long)(b0 + c) * n_out + t] = (Elem)tile[r * (tb + 1) + c];
  }
}

// The vector paths' shapes: rows, their stride and the output rows
// multiples of 16 bytes, both pointers on 16-byte boundaries.
bool vec_shape(const void* in, long long ld, int batch, int elem_bytes, long long n_out,
               const void* out) {
  return ((long long)batch * elem_bytes) % 16 == 0 && (ld * elem_bytes) % 16 == 0 &&
         (n_out * elem_bytes) % 16 == 0 && (uintptr_t)in % 16 == 0 &&
         (uintptr_t)out % 16 == 0;
}

template <int E>
int launch_rows(const void* in, long long ld_bytes, long long T, int row_bytes, long long n_out,
                void* out, cudaStream_t s) {
  constexpr int NC = E == 1 ? K7_ROW_CHUNKS_U8 : K7_ROW_CHUNKS_RGBA;
  constexpr int kBytes = kChunkBytes * NC;  // bytes of a row a block
  constexpr int kSmem = kTileTexels * (kBytes + 16);
  const int chunks = (row_bytes + kBytes - 1) / kBytes;
  const long long tiles = (n_out + kTileTexels - 1) / kTileTexels;
  if (tiles * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(posed_layout_rows<E, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  posed_layout_rows<E, NC><<<(unsigned)(tiles * chunks), kThreads, kSmem, s>>>(
      (const uint8_t*)in, ld_bytes, T, row_bytes, n_out, tiles, chunks, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// in: T texels of elem_bytes (1 or 4), texel t's `batch` poses at in + t * ld
// (ld >= batch, in elements); out: [batch, n_out], texels T..n_out-1 zero.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int blinky_posed_layout(const void* in, long long ld, long long T, int batch,
                                   int elem_bytes, long long n_out, void* out,
                                   void* stream) {
  if (batch < 1 || ld < batch || T < 0 || n_out < T || (elem_bytes != 1 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long row_bytes = (long long)batch * elem_bytes;
  if (vec_shape(in, ld, batch, elem_bytes, n_out, out)) {
    const dim3 grid((unsigned)((n_out + kTileTexels - 1) / kTileTexels),
                    (unsigned)((row_bytes + kChunkBytes - 1) / kChunkBytes));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (elem_bytes == 1)
      posed_layout_vec<1><<<grid, kThreads, 0, s>>>((const uint8_t*)in, ld, T, (int)row_bytes,
                                                  n_out, (uint8_t*)out);
    else
      posed_layout_vec<4><<<grid, kThreads, 0, s>>>((const uint8_t*)in, ld * 4, T,
                                                  (int)row_bytes, n_out, (uint8_t*)out);
  } else {
    const long long ld_bytes = ld * elem_bytes;
    const int ovec = (n_out * elem_bytes) % 16 == 0 && (uintptr_t)out % 16 == 0;
    const uint8_t* src = (const uint8_t*)in;
    uint8_t* dst = (uint8_t*)out;
    if (batch == 1 && ld > 1) {
      const long long per = (long long)K7_COLUMN_LOADS * kThreads;
      const long long blocks = (n_out + per - 1) / per;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      if (elem_bytes == 1)
        posed_layout_column<1><<<(unsigned)blocks, kThreads, 0, s>>>(src, ld_bytes, T, n_out,
                                                                    ovec, dst);
      else
        posed_layout_column<4><<<(unsigned)blocks, kThreads, 0, s>>>(src, ld_bytes, T, n_out,
                                                                    ovec, dst);
      return (int)cudaGetLastError();
    }
    // a contiguous batch of rows up to kSpanBytes is one span a tile; else
    // chunks of kSpanBytes of poses, each row staged from its own sector
    const bool span = ld == batch && row_bytes <= kSpanBytes;
    const int cb = span ? batch : (batch < kSpanBytes / elem_bytes ? batch : kSpanBytes / elem_bytes);
    const int R = cb * elem_bytes;
    // a row's 16-byte chunks: its head is fixed when the row stride is a
    // multiple of 16 bytes (the chunks' first poses are too), else any
    const int head = (int)(((uintptr_t)in) & 15);
    const int nc = ld_bytes % 16 == 0 ? (head + R + 15) / 16 : (15 + R + 15) / 16;
    const int rs = span ? R : nc * 16;  // the tile's bytes a row
    int tt = kTileBytes / rs / 64 * 64;
    tt = tt < 64 ? 64 : (tt > 8192 ? 8192 : tt);
    const size_t smem = ((size_t)tt * rs + 16 + 16 + 127) / 128 * 128;
    const long long bx = (n_out + tt - 1) / tt;
    const long long by = (batch + cb - 1) / cb;
    if (bx > 0x7fffffffLL || by > 65535 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)bx, (unsigned)by);
    if (elem_bytes == 1) {
      if (span)
        posed_layout_tile<1, true><<<grid, kThreads, smem, s>>>(src, ld_bytes, T, batch, cb, tt,
                                                               nc, rs, n_out, ovec, dst);
      else
        posed_layout_tile<1, false><<<grid, kThreads, smem, s>>>(src, ld_bytes, T, batch, cb, tt,
                                                                nc, rs, n_out, ovec, dst);
    } else {
      if (span)
        posed_layout_tile<4, true><<<grid, kThreads, smem, s>>>(src, ld_bytes, T, batch, cb, tt,
                                                               nc, rs, n_out, ovec, dst);
      else
        posed_layout_tile<4, false><<<grid, kThreads, smem, s>>>(src, ld_bytes, T, batch, cb, tt,
                                                                nc, rs, n_out, ovec, dst);
    }
  }
  return (int)cudaGetLastError();
}

// The long-row path (kernels/posed.py::long_row_path picks it): the same
// arguments as blinky_posed_layout, for the vector path's shapes only (else
// cudaErrorInvalidValue, and nothing runs).
extern "C" int blinky_posed_layout_rows(const void* in, long long ld, long long T, int batch,
                                        int elem_bytes, long long n_out, void* out,
                                        void* stream) {
  if (batch < 1 || ld < batch || T < 0 || n_out < T || (elem_bytes != 1 && elem_bytes != 4) ||
      !vec_shape(in, ld, batch, elem_bytes, n_out, out))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_bytes = batch * elem_bytes;
  return elem_bytes == 1 ? launch_rows<1>(in, ld, T, row_bytes, n_out, out, s)
                         : launch_rows<4>(in, ld * 4, T, row_bytes, n_out, out, s);
}

// in: frames [P, S, S, batch] of elem_bytes (1 or 4) with the element strides
// sp, sy, sx, sb (any layout, none negative); out: [batch, n_out], texels
// P * S * S .. n_out - 1 zero.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int blinky_posed_layout_strided(const void* in, long long sp, long long sy,
                                           long long sx, long long sb, int P, int S, int batch,
                                           int elem_bytes, long long n_out, void* out,
                                           void* stream) {
  const long long T = (long long)P * S * S;
  if (batch < 1 || P < 0 || S < 1 || n_out < T || sp < 0 || sy < 0 || sx < 0 || sb < 0 ||
      (elem_bytes != 1 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  const int tb = batch < 32 ? batch : 32;
  const int tt = kScalarElems / tb;
  const dim3 grid((unsigned)((n_out + tt - 1) / tt), (unsigned)((batch + tb - 1) / tb));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int pose_fast = sb <= sx;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 1)
    posed_layout_strided<uint8_t><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)in, sp, sy, sx, sb, S, T, batch, tt, tb, pose_fast, n_out,
        (uint8_t*)out);
  else
    posed_layout_strided<uint32_t><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)in, sp, sy, sx, sb, S, T, batch, tt, tb, pose_fast, n_out,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}
