// Native host runtime of blinky_tpu_torch: a copy of the JAX package's
// blinky_tpu/native/src/blinky_native.cpp, compiled with the same flags, so
// that both packages compute the same bits on the host.
//
// The reference implements its runtime in C with hand-written x86 assembly
// fast paths (engine/common/d_draw.S, surf8.S, ...); this file is the host
// runtime around the device path: PCX codec (reference: WritePCXplate,
// engine/NQ/fisheye.c:1396-1465), palette nearest-color search
// (create_palmap, fisheye.c:835-908), the batch layout packer feeding the
// device ([B,P,S,S] u8 -> [P,S,S,B]), the forward quad fill, glibc libm
// loops, PNG unfiltering and GIF LZW.
//
// Exposed via a C ABI for ctypes; built at first use by
// blinky_tpu_torch/native/__init__.py into blinky_tpu_torch/build/.

#include <math.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// fan elementwise work out over threads for large arrays (each element
// is independent, so threading cannot change any result bit)
template <typename Fn>
static void parallel_map(long n, Fn fn) {
  const long kThreshold = 1 << 16;
  unsigned hw = std::thread::hardware_concurrency();
  if (n < kThreshold || hw < 2) {
    fn(0, n);
    return;
  }
  const unsigned nt = hw < 16 ? hw : 16;
  const long per = (n + nt - 1) / nt;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < nt; ++t) {
    const long lo = t * per;
    const long hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back([=]() { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

extern "C" {

// ---------------------------------------------------------------- palette

// find_closest_pal_index (fisheye.c:835-855): squared-distance scan,
// first minimum wins.
int pal_nearest(const uint8_t* pal, int r, int g, int b) {
  int mindist = 256 * 256 * 256;
  int minindex = 0;
  for (int i = 0; i < 256; ++i) {
    const int dr = (int)pal[3 * i + 0] - r;
    const int dg = (int)pal[3 * i + 1] - g;
    const int db = (int)pal[3 * i + 2] - b;
    const int dist = dr * dr + dg * dg + db * db;
    if (dist < mindist) {
      mindist = dist;
      minindex = i;
    }
  }
  return minindex;
}

// create_palmap (fisheye.c:857-908): 6 tint palettes, C integer arithmetic
// (arithmetic shift on possibly-negative products).
void palmap_build(const uint8_t* pal, uint8_t* out /* [6][256] */) {
  static const int tints[6][3] = {
      {255, 255, 255}, {0, 0, 255},   {255, 0, 0},
      {255, 255, 0},   {255, 0, 255}, {0, 255, 255},
  };
  const int percent = 256 / 6;
  for (int j = 0; j < 6; ++j) {
    for (int i = 0; i < 256; ++i) {
      int r = pal[3 * i + 0];
      int g = pal[3 * i + 1];
      int b = pal[3 * i + 2];
      r += percent * (tints[j][0] - r) >> 8;
      g += percent * (tints[j][1] - g) >> 8;
      b += percent * (tints[j][2] - b) >> 8;
      if (r < 0) r = 0;
      if (r > 255) r = 255;
      if (g < 0) g = 0;
      if (g > 255) g = 255;
      if (b < 0) b = 0;
      if (b > 255) b = 255;
      out[j * 256 + i] = (uint8_t)pal_nearest(pal, r, g, b);
    }
  }
}

// ------------------------------------------------------------------- PCX

// Reference-mode encoder body (fisheye.c:1445-1448): bytes >= 0xC0 escaped
// as a run of one.  Returns bytes written (caller sizes out >= 2*w*h).
long pcx_encode_body_ref(const uint8_t* img, long n, uint8_t* out) {
  uint8_t* p = out;
  for (long i = 0; i < n; ++i) {
    const uint8_t col = img[i];
    if ((col & 0xC0) == 0xC0) *p++ = 0xC1;
    *p++ = col;
  }
  return (long)(p - out);
}

// Standard PCX RLE encoder body (max run 63).
long pcx_encode_body_rle(const uint8_t* img, int w, int h, uint8_t* out) {
  uint8_t* p = out;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + (long)y * w;
    int i = 0;
    while (i < w) {
      int run = 1;
      while (i + run < w && row[i + run] == row[i] && run < 63) ++run;
      const uint8_t val = row[i];
      if (run > 1 || val >= 0xC0) *p++ = (uint8_t)(0xC0 | run);
      *p++ = val;
      i += run;
    }
  }
  return (long)(p - out);
}

// RLE decode body: returns 0 on success, -1 on truncated input.
int pcx_decode_body(const uint8_t* data, long n, uint8_t* out, long total) {
  long pos = 0, o = 0;
  while (o < total) {
    if (pos >= n) return -1;
    const uint8_t b = data[pos++];
    if (b >= 0xC0) {
      const int run = b & 0x3F;
      if (pos >= n) return -1;
      const uint8_t v = data[pos++];
      if (o + run > total) return -1;
      memset(out + o, v, (size_t)run);
      o += run;
    } else {
      out[o++] = b;
    }
  }
  return 0;
}

// Decode many same-size PCX bodies in parallel (dataset loading fast path).
// datas/lens: per-item body pointers/lengths; out: [count, total] u8.
int pcx_decode_body_many(const uint8_t** datas, const long* lens, int count,
                         uint8_t* out, long total, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::vector<int> rc(count, 0);
  std::vector<std::thread> ts;
  const int per = (count + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int lo = t * per;
    const int hi = lo + per < count ? lo + per : count;
    if (lo >= hi) break;
    ts.emplace_back([=, &rc]() {
      for (int i = lo; i < hi; ++i)
        rc[i] = pcx_decode_body(datas[i], lens[i], out + (long)i * total, total);
    });
  }
  for (auto& th : ts) th.join();
  for (int i = 0; i < count; ++i)
    if (rc[i] != 0) return -1;
  return 0;
}

// ------------------------------------------------------- forward raster

// Forward-path quad rasterization for one plate: walks the texel grid in
// the reference's exact order (rows descending, cols ascending,
// resume_lensmap_forward, engine/NQ/fisheye.c:2126-2217) and scanline-
// fills each texel's screen quad (draw_quad, fisheye.c:2246-2338) with
// last-writer-wins stores.  This is the host-side latency-critical path
// at lens switch for forward-only lenses — the reference's acknowledged
// slow path, time-sliced there, native here.
//
// lx, ly: [(S+1)*(S+1)] i32 corner screen coords (row-major, row = v).
// ok:     [(S+1)*(S+1)] u8 corner validity.
// owned:  [S*S] u8, texel-corner ownership by this plate.
// plate_a/px_a/py_a: [H*W] i32 accumulators (plate_a preset to -1).
// Returns 1 if any pixel was written.
static const int kMaxDiff = 20;  // fisheye.c:2271

int forward_rasterize_plate(const int32_t* lx, const int32_t* ly,
                            const uint8_t* ok, const uint8_t* owned,
                            const uint8_t* offgrid, long S,
                            long W, long H, int plate, int32_t* plate_a,
                            int32_t* px_a, int32_t* py_a, uint8_t* tint_a) {
  const long C = S + 1;  // corner grid pitch
  int wrote = 0;
  for (long py = S - 1; py >= 0; --py) {      // fisheye.c:2138
    const uint8_t* orow = owned + py * S;
    for (long px = 0; px < S; ++px) {
      if (!orow[px]) continue;
      const long c00 = py * C + px;
      if (!(ok[c00] && ok[c00 + 1] && ok[c00 + C] && ok[c00 + C + 1]))
        continue;
      // clockwise: tl, tr, br, bl (fisheye.c:2250)
      const int qx[4] = {lx[c00], lx[c00 + 1], lx[c00 + C + 1], lx[c00 + C]};
      const int qy[4] = {ly[c00], ly[c00 + 1], ly[c00 + C + 1], ly[c00 + C]};
      int minx = qx[0], maxx = qx[0], miny = qy[0], maxy = qy[0];
      for (int i = 1; i < 4; ++i) {
        if (qx[i] < minx) minx = qx[i];
        else if (qx[i] > maxx) maxx = qx[i];
        if (qy[i] < miny) miny = qy[i];
        else if (qy[i] > maxy) maxy = qy[i];
      }
      if (maxx - minx > kMaxDiff || maxy - miny > kMaxDiff) continue;

      // emit helper: bounds-checked last-writer-wins store.  The tint
      // byte is only WRITTEN for off-grid texels (set_lensmap_grid,
      // fisheye.c:1955-1958) — an on-grid overwrite keeps the previous
      // pixel's tint, so tint must be tracked per write, not derived
      // from the final px/py.
      const int texel_offgrid = offgrid[py * S + px];
      #define EMIT(EX, EY)                                             \
        do {                                                           \
          const long ex = (EX), ey = (EY);                             \
          if (ex >= 0 && ex < W && ey >= 0 && ey < H) {                \
            const long o = ey * W + ex;                                \
            plate_a[o] = plate;                                        \
            px_a[o] = (int32_t)px;                                     \
            py_a[o] = (int32_t)py;                                     \
            if (texel_offgrid) tint_a[o] = (uint8_t)plate;             \
            wrote = 1;                                                 \
          }                                                            \
        } while (0)

      if (miny == maxy && minx == maxx) {  // single pixel
        EMIT(qx[0], qy[0]);
        continue;
      }
      if (miny == maxy) {  // horizontal line
        for (int tx = minx; tx <= maxx; ++tx) EMIT(tx, miny);
        continue;
      }
      if (minx == maxx) {  // vertical line
        for (int ty = miny; ty <= maxy; ++ty) EMIT(qx[0], ty);
        continue;
      }
      for (int yy = miny; yy <= maxy; ++yy) {
        int tx0 = minx, tx1 = maxx;
        int txi = 0;
        int j = 3;
        for (int i = 0; i < 4; ++i) {
          const int iy = qy[i], jy = qy[j];
          if ((iy < yy && yy <= jy) || (jy < yy && yy <= iy)) {
            const int v = (int)(qx[i] + (double)(yy - iy) / (jy - iy) *
                                            (qx[j] - qx[i]));
            if (txi == 0) tx0 = v; else tx1 = v;
            if (++txi == 2) break;
          }
          j = i;
        }
        if (tx0 > tx1) { const int t = tx0; tx0 = tx1; tx1 = t; }
        if (tx1 - tx0 > kMaxDiff) goto next_texel;  // fisheye.c:2327-2331
        for (int xx = tx0; xx <= tx1; ++xx) EMIT(xx, yy);
      }
    next_texel:;
      #undef EMIT
    }
  }
  return wrote;
}

// ---------------------------------------------------------------- layout

// [B, P, S, S] u8 -> [P, S, S, B] u8 (batch-innermost device layout).
// Cache-blocked over the trailing image axis.
void pack_batch(const uint8_t* src, uint8_t* dst, long B, long P, long S) {
  const long img = S * S;        // one plate image
  const long frame = P * img;    // one input frame
  const long nthreads_max = (long)std::thread::hardware_concurrency();
  long nthreads = nthreads_max > 0 ? nthreads_max : 1;
  if (nthreads > P) nthreads = P;
  std::vector<std::thread> ts;
  for (long t = 0; t < nthreads; ++t) {
    ts.emplace_back([=]() {
      for (long p = t; p < P; p += nthreads) {
        uint8_t* dplane = dst + p * img * B;
        const uint8_t* splane = src + p * img;
        for (long i = 0; i < img; ++i) {
          uint8_t* drow = dplane + i * B;
          const uint8_t* scol = splane + i;
          for (long b = 0; b < B; ++b) drow[b] = scol[b * frame];
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// [P, S, S, B] u8 -> [B, P, S, S] u8.
void unpack_batch(const uint8_t* src, uint8_t* dst, long B, long P, long S) {
  const long img = S * S;
  const long frame = P * img;
  for (long p = 0; p < P; ++p) {
    const uint8_t* splane = src + p * img * B;
    uint8_t* dplane = dst + p * img;
    for (long i = 0; i < img; ++i) {
      const uint8_t* srow = splane + i * B;
      uint8_t* dcol = dplane + i;
      for (long b = 0; b < B; ++b) dcol[b * frame] = srow[b];
    }
  }
}

// ---------------------------------------------------------------- libm

// Elementwise glibc libm over float64 arrays.  The reference's lens math
// is Lua 5.2 doubles, and Lua's math.* are direct libm calls — while
// NumPy's SIMD float64 transcendentals differ from glibc by 1 ulp on a
// few percent of inputs (measured: acos/asin/tanh/exp/atan2/...).  The
// float64 oracle path therefore routes through here to be bit-identical
// to what the reference engine computes.  Op codes match
// xmath._LIBM_UNARY / _LIBM_BINARY.
enum {
  U_SIN, U_COS, U_TAN, U_ASIN, U_ACOS, U_ATAN,
  U_SINH, U_COSH, U_TANH, U_LOG, U_LOG10, U_EXP, U_SQRT,
};
enum { B_ATAN2, B_FMOD, B_POW, B_HYPOT };

void libm_unary(int op, const double* x, double* out, long n) {
  double (*f)(double) = nullptr;
  switch (op) {
    case U_SIN: f = sin; break;
    case U_COS: f = cos; break;
    case U_TAN: f = tan; break;
    case U_ASIN: f = asin; break;
    case U_ACOS: f = acos; break;
    case U_ATAN: f = atan; break;
    case U_SINH: f = sinh; break;
    case U_COSH: f = cosh; break;
    case U_TANH: f = tanh; break;
    case U_LOG: f = log; break;
    case U_LOG10: f = log10; break;
    case U_EXP: f = exp; break;
    case U_SQRT: f = sqrt; break;
    default: return;
  }
  parallel_map(n, [=](long lo, long hi) {
    for (long i = lo; i < hi; ++i) out[i] = f(x[i]);
  });
}

void libm_binary(int op, const double* a, const double* b, double* out, long n) {
  double (*f)(double, double) = nullptr;
  switch (op) {
    case B_ATAN2: f = atan2; break;
    case B_FMOD: f = fmod; break;
    case B_POW: f = pow; break;
    case B_HYPOT: f = hypot; break;
    default: return;
  }
  parallel_map(n, [=](long lo, long hi) {
    for (long i = lo; i < hi; ++i) out[i] = f(a[i], b[i]);
  });
}

// PNG scanline unfilter (spec section 6): scan = [h][1 + w*channels]
// (filter byte + filtered row), out = [h][w*channels].  Sequential by
// nature (each row depends on the previous; Sub/Average/Paeth also on
// the left pixel), which is exactly why the Python fallback is slow.
// Returns 0 on success, -1 on an unknown filter byte.
int png_unfilter(const unsigned char* scan, unsigned char* out,
                 long h, long stride, int bpp) {
  for (long y = 0; y < h; ++y) {
    const unsigned char* cur = scan + y * (stride + 1);
    int f = cur[0];
    cur += 1;
    unsigned char* row = out + y * stride;
    const unsigned char* prev = y ? out + (y - 1) * stride : nullptr;
    switch (f) {
      case 0:
        for (long x = 0; x < stride; ++x) row[x] = cur[x];
        break;
      case 1:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          row[x] = (unsigned char)(cur[x] + a);
        }
        break;
      case 2:
        for (long x = 0; x < stride; ++x) {
          int b = prev ? prev[x] : 0;
          row[x] = (unsigned char)(cur[x] + b);
        }
        break;
      case 3:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          row[x] = (unsigned char)(cur[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long x = 0; x < stride; ++x) {
          int a = x >= bpp ? row[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[x] = (unsigned char)(cur[x] + pr);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// GIF LZW codestream (GIF89a spec appendix F): variable-width codes
// (min_code_size+1 .. 12 bits, LSB-first), CLEAR emitted up front and on
// table overflow, EOI terminating.  The codestream here is raw (no
// 255-byte sub-block framing — the Python layer does that with array
// slicing).  Encoder and decoder advance code width under the identical
// rule (after adding entry `next`, bump when next == 1<<width), which
// keeps them in lockstep across CLEARs.

struct GifBitWriter {
  unsigned char* out;
  long cap, pos;
  unsigned int acc;
  int nbits;
  bool overflow;
  void put(int code, int width) {
    if (overflow) return;  // stop accumulating: nbits would otherwise
                           // grow past 32 and the shift would be UB
    acc |= ((unsigned int)code) << nbits;
    nbits += width;
    while (nbits >= 8) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = (unsigned char)(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = (unsigned char)(acc & 0xFF);
      acc = 0; nbits = 0;
    }
  }
};

long gif_lzw_encode(const unsigned char* px, long n, int min_code_size,
                    unsigned char* out, long cap) {
  if (min_code_size < 2 || min_code_size > 8) return -1;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  const int nsym = clear;
  GifBitWriter w{out, cap, 0, 0, 0, false};
  int width = min_code_size + 1;
  int next = eoi + 1;
  // (prefix_code, char) -> code table, rows indexed prefix*256+c.
  // Entries are valid only when their epoch stamp matches: a CLEAR
  // (which fires every ~4k symbols on photographic frames) is then an
  // O(1) epoch bump instead of a 1M-entry sweep of the 4 MB table —
  // the sweep cost ~2 GB of memory traffic per 1080p frame.  vectors,
  // not raw new[]: freed at thread exit instead of leaking per thread.
  static thread_local std::vector<int> table;
  static thread_local std::vector<int> stamp;
  static thread_local int epoch = 0;
  if (table.empty()) {
    table.assign(4096L * 256, 0);
    stamp.assign(4096L * 256, 0);
  }
  (void)nsym;
  auto reset = [&]() {
    if (epoch == INT32_MAX) {  // stamp wrap: one real sweep, then reuse
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 0;
    }
    ++epoch;
  };
  reset();
  w.put(clear, width);
  if (n > 0) {
    int prefix = px[0];
    for (long i = 1; i < n; ++i) {
      int c = px[i];
      long key = (long)prefix * 256 + c;
      if (stamp[key] == epoch) { prefix = table[key]; continue; }
      w.put(prefix, width);
      if (w.overflow) return -1;
      if (next < 4096) {
        // bump on the PRE-add counter: the encoder's table runs one
        // entry ahead of the decoder's (the decoder adds its entry only
        // on the NEXT code), so checking post-add would widen one code
        // too early and desync at each power-of-two boundary
        if (next == (1 << width) && width < 12) width++;
        table[key] = next++;
        stamp[key] = epoch;
      } else {
        w.put(clear, width);
        reset();
        width = min_code_size + 1;
        next = eoi + 1;
      }
      prefix = c;
    }
    w.put(prefix, width);
  }
  w.put(eoi, width);
  w.flush();
  return w.overflow ? -1 : w.pos;
}

long gif_lzw_decode(const unsigned char* in, long nbytes, int min_code_size,
                    unsigned char* out, long cap) {
  if (min_code_size < 2 || min_code_size > 8) return -1;
  const int clear = 1 << min_code_size, eoi = clear + 1;
  // vectors, not raw new[]: freed at thread exit instead of leaking
  static thread_local std::vector<int> prefix_v;
  static thread_local std::vector<unsigned char> suffix_v, stack_v;
  if (prefix_v.empty()) {
    prefix_v.assign(4096, 0);
    suffix_v.assign(4096, 0);
    stack_v.assign(4096, 0);
  }
  int* prefix = prefix_v.data();
  unsigned char* suffix = suffix_v.data();
  unsigned char* stack = stack_v.data();
  int width = min_code_size + 1;
  int next = eoi + 1;
  int prev = -1;
  long bitpos = 0, written = 0;
  const long nbits_total = nbytes * 8;
  while (true) {
    if (bitpos + width > nbits_total) return -1;  // ran off the stream
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    if (code == clear) {
      width = min_code_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    long sp = 0;
    int cur;
    if (prev < 0) {
      if (code >= clear) return -1;  // first code must be a literal
      stack[sp++] = (unsigned char)code;
      cur = code;
    } else if (code < next && code != eoi) {
      cur = code;
      while (cur >= clear + 2) { stack[sp++] = suffix[cur]; cur = prefix[cur]; }
      stack[sp++] = (unsigned char)cur;
    } else if (code == next && next < 4096) {
      // KwKwK case: string(prev) + first(string(prev))
      cur = prev;
      while (cur >= clear + 2) { stack[sp++] = suffix[cur]; cur = prefix[cur]; }
      stack[sp++] = (unsigned char)cur;
      // emit first char again at the end: handled below by repeating
      // after reversal (we push it at the FRONT of the reversed output)
      if (written + sp + 1 > cap) return -1;
      for (long i = sp - 1; i >= 0; --i) out[written++] = stack[i];
      out[written++] = stack[sp - 1];  // first char of string(prev)
      if (next < 4096) {
        prefix[next] = prev;
        suffix[next] = stack[sp - 1];
        ++next;
        if (next == (1 << width) && width < 12) width++;
      }
      prev = code;
      continue;
    } else {
      return -1;  // code beyond table: corrupt stream
    }
    if (written + sp > cap) return -1;
    for (long i = sp - 1; i >= 0; --i) out[written++] = stack[i];
    if (prev >= 0 && next < 4096) {
      prefix[next] = prev;
      suffix[next] = stack[sp - 1];  // first char of string(code)
      ++next;
      if (next == (1 << width) && width < 12) width++;
    }
    prev = code;
  }
  return written;
}

}  // extern "C"
