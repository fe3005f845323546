// PNG scanline filter reconstruction and application.
//
// The PNG filter pass is the one inherently row-sequential stage of the
// PNG pipeline (filters Up/Average/Paeth reference the previous row,
// Sub/Average/Paeth the previous pixel), so it runs on the host while
// the device handles everything downstream (bit expansion, palette,
// colour mapping). Reference behaviour: libpng's reconstruction as
// driven by src/pngcodec.cc; this is an independent implementation of
// the PNG spec (RFC 2083 §6).
#include <cstdlib>
#include <cstring>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include "picha_native.h"

namespace {

inline uint8_t paeth_predict(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

#ifdef __AVX2__
// Pixel-stepped SSE reconstruction for the serial filters (the
// standard libpng-style vectorisation, implemented independently):
// one 3/4-byte pixel per iteration with the maths in 16-bit lanes —
// the row recurrence stays, the per-byte branches go. The last pixel
// runs scalar so 4-byte loads never cross the buffer end.

inline __m128i load_px(const uint8_t* p) {
  return _mm_cvtsi32_si128(*(const int32_t*)p);  // 4 bytes (bpp<=4)
}

inline void store_px(uint8_t* p, __m128i v, int bpp) {
  uint32_t w = (uint32_t)_mm_cvtsi128_si32(v);
  if (bpp == 4) {
    memcpy(p, &w, 4);
  } else {
    p[0] = (uint8_t)w;
    p[1] = (uint8_t)(w >> 8);
    p[2] = (uint8_t)(w >> 16);
  }
}

void unfilter_avg_sse(const uint8_t* in, uint8_t* out, const uint8_t* prev,
                      int rowbytes, int bpp) {
  const __m128i zero = _mm_setzero_si128();
  __m128i a = zero;  // previous output pixel, 16-bit lanes
  int i = 0;
  int safe = rowbytes - bpp;  // last pixel handled scalar
  for (; i + bpp <= safe; i += bpp) {
    __m128i b = _mm_unpacklo_epi8(load_px(prev + i), zero);
    __m128i x = _mm_unpacklo_epi8(load_px(in + i), zero);
    __m128i avg = _mm_srli_epi16(_mm_add_epi16(a, b), 1);
    __m128i o = _mm_and_si128(_mm_add_epi16(x, avg),
                              _mm_set1_epi16(0xFF));
    store_px(out + i, _mm_packus_epi16(o, o), bpp);
    a = o;
  }
  for (; i < rowbytes; ++i) {
    int av = i >= bpp ? out[i - bpp] : 0;
    out[i] = (uint8_t)(in[i] + ((av + prev[i]) >> 1));
  }
}

void unfilter_paeth_sse(const uint8_t* in, uint8_t* out,
                        const uint8_t* prev, int rowbytes, int bpp) {
  const __m128i zero = _mm_setzero_si128();
  __m128i a = zero, c = zero;  // out[i-bpp], prev[i-bpp] in 16-bit lanes
  int i = 0;
  int safe = rowbytes - bpp;
  for (; i + bpp <= safe; i += bpp) {
    __m128i b = _mm_unpacklo_epi8(load_px(prev + i), zero);
    __m128i x = _mm_unpacklo_epi8(load_px(in + i), zero);
    // pa=|b-c| pb=|a-c| pc=|a+b-2c|, pick smallest with a<=b<=c ties
    __m128i pa = _mm_sub_epi16(_mm_max_epi16(b, c), _mm_min_epi16(b, c));
    __m128i pb = _mm_sub_epi16(_mm_max_epi16(a, c), _mm_min_epi16(a, c));
    __m128i pab = _mm_add_epi16(_mm_sub_epi16(a, c), _mm_sub_epi16(b, c));
    __m128i pc = _mm_max_epi16(pab, _mm_sub_epi16(zero, pab));
    // cond_a = pa <= pb && pa <= pc; cond_b = pb <= pc (tie order a,b,c)
    __m128i not_a = _mm_or_si128(_mm_cmpgt_epi16(pa, pb),
                                 _mm_cmpgt_epi16(pa, pc));
    __m128i not_b = _mm_cmpgt_epi16(pb, pc);
    __m128i bc = _mm_or_si128(_mm_andnot_si128(not_b, b),
                              _mm_and_si128(not_b, c));
    __m128i pred = _mm_or_si128(_mm_andnot_si128(not_a, a),
                                _mm_and_si128(not_a, bc));
    __m128i o = _mm_and_si128(_mm_add_epi16(x, pred),
                              _mm_set1_epi16(0xFF));
    store_px(out + i, _mm_packus_epi16(o, o), bpp);
    a = o;
    c = b;
  }
  for (; i < rowbytes; ++i) {
    int av = i >= bpp ? out[i - bpp] : 0;
    int cv = i >= bpp ? prev[i - bpp] : 0;
    out[i] = (uint8_t)(in[i] + paeth_predict(av, prev[i], cv));
  }
}
#endif  // __AVX2__

void unfilter_row(uint8_t type, const uint8_t* in, uint8_t* out,
                  const uint8_t* prev, int rowbytes, int bpp) {
  switch (type) {
    case 0:  // None
      memcpy(out, in, rowbytes);
      break;
    case 1:  // Sub
      for (int i = 0; i < bpp; ++i) out[i] = in[i];
      for (int i = bpp; i < rowbytes; ++i) out[i] = (uint8_t)(in[i] + out[i - bpp]);
      break;
    case 2:  // Up
      if (prev) {
        int i = 0;
#ifdef __AVX2__
        for (; i + 32 <= rowbytes; i += 32) {
          __m256i x = _mm256_loadu_si256((const __m256i*)(in + i));
          __m256i p = _mm256_loadu_si256((const __m256i*)(prev + i));
          _mm256_storeu_si256((__m256i*)(out + i), _mm256_add_epi8(x, p));
        }
#endif
        for (; i < rowbytes; ++i) out[i] = (uint8_t)(in[i] + prev[i]);
      } else {
        memcpy(out, in, rowbytes);
      }
      break;
    case 3:  // Average
#ifdef __AVX2__
      if (prev && (bpp == 3 || bpp == 4) && rowbytes > 2 * bpp) {
        unfilter_avg_sse(in, out, prev, rowbytes, bpp);
        break;
      }
#endif
      for (int i = 0; i < rowbytes; ++i) {
        int a = i >= bpp ? out[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
      }
      break;
    case 4:  // Paeth
#ifdef __AVX2__
      if (prev && (bpp == 3 || bpp == 4) && rowbytes > 2 * bpp) {
        unfilter_paeth_sse(in, out, prev, rowbytes, bpp);
        break;
      }
#endif
      for (int i = 0; i < rowbytes; ++i) {
        int a = i >= bpp ? out[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
        out[i] = (uint8_t)(in[i] + paeth_predict(a, b, c));
      }
      break;
  }
}

void filter_row(uint8_t type, const uint8_t* in, uint8_t* out,
                const uint8_t* prev, int rowbytes, int bpp) {
  switch (type) {
    case 0:
      memcpy(out, in, rowbytes);
      break;
    case 1:
      for (int i = 0; i < rowbytes; ++i)
        out[i] = (uint8_t)(in[i] - (i >= bpp ? in[i - bpp] : 0));
      break;
    case 2:
      for (int i = 0; i < rowbytes; ++i)
        out[i] = (uint8_t)(in[i] - (prev ? prev[i] : 0));
      break;
    case 3:
      for (int i = 0; i < rowbytes; ++i) {
        int a = i >= bpp ? in[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        out[i] = (uint8_t)(in[i] - ((a + b) >> 1));
      }
      break;
    case 4:
      for (int i = 0; i < rowbytes; ++i) {
        int a = i >= bpp ? in[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
        out[i] = (uint8_t)(in[i] - paeth_predict(a, b, c));
      }
      break;
  }
}

// libpng-style heuristic: minimise the sum of absolute signed deltas.
uint32_t row_cost(const uint8_t* row, int rowbytes) {
  uint32_t s = 0;
  for (int i = 0; i < rowbytes; ++i) {
    int8_t v = (int8_t)row[i];
    s += v < 0 ? -v : v;
  }
  return s;
}

}  // namespace

PICHA_API int picha_png_unfilter(const uint8_t* in, uint8_t* out, int height,
                                 int rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + (size_t)y * (rowbytes + 1);
    uint8_t* dst = out + (size_t)y * rowbytes;
    uint8_t type = src[0];
    if (type > 4) return -1;
    unfilter_row(type, src + 1, dst, prev, rowbytes, bpp);
    prev = dst;
  }
  return 0;
}

PICHA_API int picha_png_filter(const uint8_t* in, uint8_t* out, int height,
                               int rowbytes, int bpp, int strategy) {
  if (strategy > 4) strategy = -1;  // unknown strategies fall back to adaptive
  uint8_t* scratch =
      strategy < 0 ? (uint8_t*)malloc((size_t)rowbytes) : nullptr;
  if (strategy < 0 && !scratch) return -1;  // OOM: error, don't deref null
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + (size_t)y * rowbytes;
    uint8_t* dst = out + (size_t)y * (rowbytes + 1);
    if (strategy >= 0 && strategy <= 4) {
      dst[0] = (uint8_t)strategy;
      filter_row((uint8_t)strategy, src, dst + 1, prev, rowbytes, bpp);
    } else {
      // adaptive: try each filter, keep the cheapest
      uint32_t best_cost = ~0u;
      int best = 0;
      for (int t = 0; t <= 4; ++t) {
        filter_row((uint8_t)t, src, scratch, prev, rowbytes, bpp);
        uint32_t c = row_cost(scratch, rowbytes);
        if (c < best_cost) {
          best_cost = c;
          best = t;
          memcpy(dst + 1, scratch, rowbytes);
        }
      }
      dst[0] = (uint8_t)best;
    }
    prev = src;
  }
  free(scratch);
  return 0;
}
