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
//  * A ragged B, a row stride or pointer off 16 bytes, or an output row not
//    a multiple of 16 bytes takes the scalar path of the same file: the
//    same tiles with one element a thread and a 32-bit shared word an
//    element.
//  * Frames whose texels are not evenly strided (a transpose of the two
//    plate axes, say) take the strided path, blinky_posed_layout_strided:
//    the scalar tiles again, each element read at its own four strides,
//    with the tile's read order following whichever of the pose and the
//    texel column is unit-strided.  jnp.transpose takes any array, and so
//    does K7.

#include "common.cuh"

namespace {

using blinky::kThreads;  // 256: one texel of the tile a thread
constexpr int kTileTexels = 256;
constexpr int kChunkBytes = 64;   // bytes of a texel's row one tile holds
constexpr int kStride = 80;       // the tile's row stride in shared memory
constexpr int kScalarElems = 2048;  // the scalar path's tile, texels x poses

// The vector path.  E: element bytes, 1 (u8) or 4 (RGBA).  grid.x: texel
// tiles; grid.y: 64-byte chunks of a row.
template <int E>
__global__ void __launch_bounds__(kThreads) posed_layout_vec(
    const uint8_t* __restrict__ in, long long ld_bytes, long long T, int row_bytes,
    long long n_out, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tile[kTileTexels * kStride];
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * kTileTexels;
  const int col0 = blockIdx.y * kChunkBytes;
  const int units = min(kChunkBytes, row_bytes - col0) / 16;  // 16-byte units in the chunk

  // a warp takes 8 rows x 4 units; quarter q holds rows q and q + 4
  uint4 v[4];
  int rows[4], us[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = j * kThreads + tid, w = i >> 5, lane = i & 31;
    rows[j] = w * 8 + ((lane & 7) >> 2) * 4 + (lane >> 3);
    us[j] = lane & 3;
    const long long t = t0 + rows[j];
    v[j] = make_uint4(0, 0, 0, 0);
    if (t < T && us[j] < units)
      v[j] = *(const uint4*)(in + t * ld_bytes + col0 + us[j] * 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) *(uint4*)(tile + rows[j] * kStride + us[j] * 16) = v[j];
  __syncthreads();

  if (E == 1) {
    // thread: word column c (poses col0 + 4c .. + 3), texels 16 g .. 16 g + 15
    const int c = tid & 15, g = tid >> 4, h = g & 1;
    if (c >= units * 4) return;
    const long long tt = t0 + g * 16;
    if (tt >= n_out) return;
    uint32_t a[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      a[i] = *(const uint32_t*)(tile + (g * 16 + (i ^ (h << 2))) * kStride + c * 4);
    // 4x4 byte transposes: o[q][j] = texels 4q..4q+3 of pose j (q in the
    // read order, so q ^ h is the texel group)
    uint32_t o[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x0 = __byte_perm(a[4 * q], a[4 * q + 1], 0x5140);
      const uint32_t x1 = __byte_perm(a[4 * q], a[4 * q + 1], 0x7362);
      const uint32_t y0 = __byte_perm(a[4 * q + 2], a[4 * q + 3], 0x5140);
      const uint32_t y1 = __byte_perm(a[4 * q + 2], a[4 * q + 3], 0x7362);
      o[q][0] = __byte_perm(x0, y0, 0x5410);
      o[q][1] = __byte_perm(x0, y0, 0x7632);
      o[q][2] = __byte_perm(x1, y1, 0x5410);
      o[q][3] = __byte_perm(x1, y1, 0x7632);
    }
    const long long b0 = col0 + c * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 s = h ? make_uint4(o[1][j], o[0][j], o[3][j], o[2][j])
                        : make_uint4(o[0][j], o[1][j], o[2][j], o[3][j]);
      *(uint4*)(out + (b0 + j) * n_out + tt) = s;
    }
  } else {
    // thread: pose c of the chunk, texels 4 g .. 4 g + 3, four times
    const long long b = col0 / 4 + (tid & 15);
    if ((tid & 15) >= units * 4) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = j * 16 + (tid >> 4);
      const long long tt = t0 + g * 4;
      if (tt >= n_out) break;
      const uint8_t* r = tile + g * 4 * kStride + (tid & 15) * 4;
      const uint4 s = make_uint4(*(const uint32_t*)r, *(const uint32_t*)(r + kStride),
                                 *(const uint32_t*)(r + 2 * kStride),
                                 *(const uint32_t*)(r + 3 * kStride));
      *(uint4*)(out + (b * n_out + tt) * 4) = s;
    }
  }
}

// The scalar path: tiles of tt texels x tb poses (tt * tb <= kScalarElems),
// one element a thread.  grid.x: texel tiles; grid.y: pose tiles.
template <typename Elem>
__global__ void __launch_bounds__(kThreads) posed_layout_scalar(
    const Elem* __restrict__ in, long long ld, long long T, int B, int tt, int tb,
    long long n_out, Elem* __restrict__ out) {
  __shared__ uint32_t tile[2 * kScalarElems];  // tt * (tb + 1) words at most
  const long long t0 = (long long)blockIdx.x * tt;
  const int b0 = blockIdx.y * tb;
  const int n = tt * tb;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / tb, c = i - r * tb;
    const long long t = t0 + r;
    tile[r * (tb + 1) + c] = (t < T && b0 + c < B) ? (uint32_t)in[t * ld + b0 + c] : 0u;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int c = i / tt, r = i - c * tt;
    const long long t = t0 + r;
    if (t < n_out && b0 + c < B)
      out[(long long)(b0 + c) * n_out + t] = (Elem)tile[r * (tb + 1) + c];
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
  const bool vec = row_bytes % 16 == 0 && (ld * elem_bytes) % 16 == 0 &&
                   (n_out * elem_bytes) % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec) {
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
    const int tb = batch < 32 ? batch : 32;
    const int tt = kScalarElems / tb;
    const dim3 grid((unsigned)((n_out + tt - 1) / tt), (unsigned)((batch + tb - 1) / tb));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (elem_bytes == 1)
      posed_layout_scalar<uint8_t><<<grid, kThreads, 0, s>>>(
          (const uint8_t*)in, ld, T, batch, tt, tb, n_out, (uint8_t*)out);
    else
      posed_layout_scalar<uint32_t><<<grid, kThreads, 0, s>>>(
          (const uint32_t*)in, ld, T, batch, tt, tb, n_out, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
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
