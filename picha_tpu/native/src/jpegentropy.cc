// Segment-parallel baseline JPEG entropy decode (host fast path).
//
// The reference runs libjpeg's serial scanline loop on one libuv
// thread per image (/root/reference/src/jpegcodec.cc:100-106); its
// entropy decode cannot use more than one core per image. This kernel
// exploits what restart markers guarantee — DC predictors and the bit
// phase reset at every RSTn, so restart segments are independent — and
// decodes them in parallel across host threads. The host side of the
// split (structure parse, 0xFF00 unstuffing, segment bounds) lives in
// ops/jpeg_scan.parse_baseline; this file is the pure compute stage,
// mirroring ops/jpeg_scan.decode_reference exactly (that numpy decoder
// is the tested oracle; both must match libjpeg bit-for-bit).
//
// Outputs are natural-order (blocks_h, blocks_w, 64) int16 planes with
// absolute DC, identical layout to picha_jpeg_coef_read (jpegshim.cc).
// The caller pre-zeroes the outputs: a malformed stream that ends
// early simply leaves the remaining blocks zero (libjpeg pads with a
// warning in the same situation).

#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

#include "picha_native.h"

namespace {

// zigzag position k -> natural (row-major) index (JPEG figure A.6)
const uint8_t kZigzagNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// MSB-first bit reader over one unstuffed segment; reads past the end
// return 1-bits (the convention parse_baseline's oracle decoder and
// the device kernel share — a truncated stream walks to a harmless EOB).
struct BitReader {
  const uint8_t* d;
  int64_t n;      // bytes
  int64_t pos;    // next unread bit
  uint64_t acc;   // bottom `cnt` bits are the next bits of the stream
  int cnt;

  BitReader(const uint8_t* data, int64_t nbytes)
      : d(data), n(nbytes), pos(0), acc(0), cnt(0) {}

  inline void ensure(int need) {
    if (cnt >= need) return;
    // bulk refill to >= 49 bits (acc caps at 56) so the refill runs
    // once per ~3 symbols instead of per peek. (pos+cnt) is always
    // byte-aligned: refills add whole bytes, consumption comes off acc
    int64_t b = (pos + cnt) >> 3;
    int room = (56 - cnt) >> 3;  // whole bytes that fit
    if (b + 8 <= n) {
      // one unaligned big-endian load covers the whole refill
      uint64_t w;
      std::memcpy(&w, d + b, 8);
      w = __builtin_bswap64(w);
      acc = (acc << (8 * room)) | (w >> (64 - 8 * room));
      cnt += 8 * room;
      return;
    }
    do {
      acc = (acc << 8) | (b < n ? d[b] : 0xFFu);
      ++b;
      cnt += 8;
    } while (cnt <= 48);
  }

  // take `k` bits below the already-consumed prefix of the current
  // ensure window (no refill check: the caller ensured enough)
  inline uint32_t take(int consumed, int k) const {
    if (k == 0) return 0;
    return (uint32_t)((acc >> (cnt - consumed - k)) & ((1u << k) - 1));
  }

  inline void consume(int k) {
    cnt -= k;
    pos += k;
  }
};

struct Tables {
  const int64_t* limit;    // (ntab, 17)
  const int64_t* mincode;  // (ntab, 17)
  const int64_t* valptr;   // (ntab, 17)
  const int32_t* hv;       // (ntab, 256)
  // 8-bit lookahead (libjpeg's HUFF_LOOKAHEAD idea): for an 8-bit
  // prefix whose code is <= 8 bits, sym/len in one load; len 0 falls
  // back to the canonical limit walk (long codes, corrupt prefixes).
  std::vector<int16_t> lut_sym;  // (ntab, 256)
  std::vector<uint8_t> lut_len;  // (ntab, 256)

  void build_lut(const int32_t* nbits, int ntab) {
    lut_sym.assign((size_t)ntab * 256, 0);
    lut_len.assign((size_t)ntab * 256, 0);
    for (int tb = 0; tb < ntab; ++tb) {
      const int32_t* hvrow = hv + (int64_t)tb * 256;
      const int32_t* nb = nbits + (int64_t)tb * 17;
      int code = 0, p = 0;
      for (int l = 1; l <= 8; ++l) {
        for (int i = 0; i < nb[l] && p < 256; ++i, ++code, ++p) {
          int base = code << (8 - l);
          for (int k = 0; k < (1 << (8 - l)); ++k) {
            lut_sym[(size_t)tb * 256 + base + k] = (int16_t)hvrow[p];
            lut_len[(size_t)tb * 256 + base + k] = (uint8_t)l;
          }
        }
        code <<= 1;
      }
    }
  }
};

// Canonical Huffman decode (JPEG F.2.2.3), identical numerics to
// jpeg_scan.decode_reference: clen = 1 + #(P >= limit[1..16]) clamped
// to 16, value index clamped into the 256-entry table so corrupt
// streams stay in-bounds (garbage-in, garbage-out, never UB). Does
// NOT consume; *len reports the code length for the caller's fused
// consume.
inline int huff_peek_slow(const Tables& t, int tab, uint32_t P, int* len) {
  const int64_t* limit = t.limit + (int64_t)tab * 17;
  int clen = 16;
  for (int l = 1; l < 16; ++l) {
    if ((int64_t)P < limit[l]) {
      clen = l;
      break;
    }
  }
  int64_t idx = (int64_t)(P >> (16 - clen)) -
                (t.mincode + (int64_t)tab * 17)[clen] +
                (t.valptr + (int64_t)tab * 17)[clen];
  if (idx < 0) idx = 0;
  if (idx > 255) idx = 255;
  *len = clen;
  return t.hv[(int64_t)tab * 256 + idx];
}

inline int huff_peek(const Tables& t, int tab, uint32_t P, int* len) {
  uint32_t p8 = P >> 8;
  int l = t.lut_len[(size_t)tab * 256 + p8];
  if (l) {
    *len = l;
    return t.lut_sym[(size_t)tab * 256 + p8];
  }
  return huff_peek_slow(t, tab, P, len);
}

inline int extend(uint32_t v, int size) {
  if (size == 0) return 0;
  return (int)v >= (1 << (size - 1)) ? (int)v : (int)v - (1 << size) + 1;
}

struct Geometry {
  int ncomp;
  const int* h_samp;
  const int* v_samp;
  const int* blocks_w;
  const int* blocks_h;
  const int* dc_tab;  // per component: row into the table arrays
  const int* ac_tab;
  int64_t mcus;
  int64_t mcus_per_row;
  int64_t ri;  // MCUs per restart segment
};

void decode_segment(const uint8_t* data, const int64_t* seg_off, int s,
                    const Geometry& g, const Tables& t,
                    int16_t* const* out) {
  BitReader rd(data + seg_off[s], seg_off[s + 1] - seg_off[s]);
  int pred[4] = {0, 0, 0, 0};
  int64_t mcu0 = (int64_t)s * g.ri;
  int64_t nmcu = std::min<int64_t>(g.ri, g.mcus - mcu0);
  int16_t scratch[64];
  for (int64_t m = 0; m < nmcu; ++m) {
    int64_t mcu = mcu0 + m;
    int64_t my = mcu / g.mcus_per_row, mx = mcu % g.mcus_per_row;
    for (int ci = 0; ci < g.ncomp; ++ci) {
      int bw = g.blocks_w[ci], bh = g.blocks_h[ci];
      for (int dy = 0; dy < g.v_samp[ci]; ++dy) {
        for (int dx = 0; dx < g.h_samp[ci]; ++dx) {
          int64_t row = my * g.v_samp[ci] + dy;
          int64_t col = mx * g.h_samp[ci] + dx;
          int16_t* blk = (row < bh && col < bw)
                             ? out[ci] + (row * bw + col) * 64
                             : scratch;  // stream-only dummy block
          std::memset(blk, 0, 64 * sizeof(int16_t));
          // one ensure(32) covers code (<=16) + value (<=15) bits, so
          // each symbol is one refill check + one fused extraction
          // DC
          rd.ensure(32);
          int len;
          int size =
              huff_peek(t, g.dc_tab[ci], (uint32_t)rd.take(0, 16), &len) & 15;
          pred[ci] += extend(rd.take(len, size), size);
          rd.consume(len + size);
          blk[0] = (int16_t)pred[ci];
          // AC
          int z = 1;
          const int ac = g.ac_tab[ci];
          while (z < 64) {
            rd.ensure(32);
            int sym = huff_peek(t, ac, (uint32_t)rd.take(0, 16), &len);
            int run = sym >> 4, sz = sym & 15;
            if (sz == 0) {
              rd.consume(len);
              if (run == 15) {
                z += 16;
                continue;
              }
              break;  // EOB
            }
            z += run;
            int v = extend(rd.take(len, sz), sz);
            rd.consume(len + sz);
            if (z < 64) blk[kZigzagNat[z]] = (int16_t)v;
            ++z;
          }
        }
      }
    }
  }
}

}  // namespace

PICHA_API int picha_jpeg_entropy_segments(
    const uint8_t* data, const int64_t* seg_off, int nseg, int64_t mcus,
    int64_t restart_interval, int64_t mcus_per_row, int ncomp,
    const int* h_samp, const int* v_samp, const int* blocks_w,
    const int* blocks_h, const int* dc_tab, const int* ac_tab,
    const int64_t* limit, const int64_t* mincode, const int64_t* valptr,
    const int32_t* hv, const int32_t* nbits, int ntab, int nthreads,
    int16_t* const* out) {
  if (ncomp < 1 || ncomp > 4 || nseg < 1 || mcus_per_row < 1 ||
      restart_interval < 1 || ntab < 1)
    return -1;
  for (int ci = 0; ci < ncomp; ++ci) {
    if (dc_tab[ci] < 0 || dc_tab[ci] >= ntab || ac_tab[ci] < 0 ||
        ac_tab[ci] >= ntab)
      return -1;
    if (h_samp[ci] < 1 || h_samp[ci] > 4 || v_samp[ci] < 1 || v_samp[ci] > 4)
      return -1;
  }
  Geometry g{ncomp,    h_samp, v_samp, blocks_w,     blocks_h,
             dc_tab,   ac_tab, mcus,   mcus_per_row, restart_interval};
  Tables t{limit, mincode, valptr, hv, {}, {}};
  t.build_lut(nbits, ntab);
  int T = std::min<int>(std::max(nthreads, 1), nseg);
  if (T <= 1) {
    for (int s = 0; s < nseg; ++s) decode_segment(data, seg_off, s, g, t, out);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int ti = 0; ti < T; ++ti) {
    threads.emplace_back([&, ti] {
      for (int s = ti; s < nseg; s += T)
        decode_segment(data, seg_off, s, g, t, out);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}
