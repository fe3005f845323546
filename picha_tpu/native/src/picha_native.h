// C ABI for picha_tpu's host-side native runtime.
//
// The device owns the pixel math (XLA); this library owns the
// inherently serial bitstream work the reference did in C++ on libuv
// threads (SURVEY.md §2): PNG scanline filter (re)construction, JPEG
// entropy coding via libjpeg (full host path + raw DCT-coefficient
// import/export for the device pixel-stage path), TIFF LZW/PackBits, and
// a libwebp shim. All functions are thread-safe (no globals) and
// release the GIL naturally (called via ctypes).
#pragma once
#include <stddef.h>
#include <stdint.h>

#define PICHA_API extern "C" __attribute__((visibility("default")))

// Free any buffer returned through an out-parameter by this library.
PICHA_API void picha_free(void* p);

// ---- PNG scanline filters (the row-sequential recurrence) ----------------
// in:  height * (1 + rowbytes) bytes of filtered scanlines
// out: height * rowbytes reconstructed bytes
// bpp: filter delta distance in bytes (max(1, channels*bytedepth))
// returns 0, or -1 on an invalid filter byte
PICHA_API int picha_png_unfilter(const uint8_t* in, uint8_t* out,
                                 int height, int rowbytes, int bpp);

// strategy -1 = adaptive per-row minimum-sum-of-absolute-differences
// heuristic, 0..4 = fixed filter. out: height * (1 + rowbytes) bytes.
PICHA_API int picha_png_filter(const uint8_t* in, uint8_t* out,
                               int height, int rowbytes, int bpp,
                               int strategy);

// ---- JPEG (libjpeg-backed entropy + host reference path) -----------------
// want_channels: 0 = source default (grey stays grey, colour -> rgb),
//                1 = grey, 3 = rgb.
// CMYK/YCCK sources are folded to RGB with the reference's
// rgb = c*k/255 rule (src/jpegcodec.cc:36-42) when rgb is requested.
PICHA_API int picha_jpeg_stat(const uint8_t* src, size_t len,
                              int* width, int* height, int* channels);
// scale_denom 1 (default) or 2/4/8: DCT-scaled decode (output dims =
// ceil(dim/scale_denom); the IDCT runs at reduced block size).
PICHA_API int picha_jpeg_decode(const uint8_t* src, size_t len,
                                int want_channels, int scale_denom,
                                uint8_t* out, int out_stride, char** err);
// quality clamped 0..100 (default handling is the caller's), baseline
// Huffman tables; channels 1 -> grayscale, 3 -> YCbCr 4:2:0 (libjpeg
// defaults, matching the reference's encoder src/jpegcodec.cc:334-370).
// restart_mcus > 0 writes DRI + restart markers every restart_mcus
// MCUs — makes the scan parallel-decodable (the device entropy decoder
// gets exactly known entry states per segment).
// optimize: Huffman-optimized scan; subsample444: force 1x1 sampling
// (colour default is libjpeg's 4:2:0) — option parity with the device
// encode branch.
PICHA_API int picha_jpeg_encode(const uint8_t* src, int width, int height,
                                int stride, int channels, int quality,
                                int restart_mcus, int progressive,
                                int optimize, int subsample444,
                                uint8_t** out, size_t* outlen, char** err);

// Segment-parallel baseline entropy decode (jpegentropy.cc): restart
// segments are DC/phase-independent, so they decode on nthreads host
// threads concurrently — per-image parallelism libjpeg's serial loop
// cannot offer. Inputs come from ops/jpeg_scan.parse_baseline: `data`
// = concatenated 0xFF00-unstuffed segments with seg_off (nseg+1)
// boundaries; limit/mincode/valptr (ntab,17) int64 and hv (ntab,256)
// int32 rows from derive_tables; dc_tab/ac_tab index rows per
// component; nbits (ntab,17) int32 = per-length code counts (slot 0
// unused) for the 8-bit lookahead LUT. `out` = per-component
// natural-order (bh,bw,64) int16 planes, PRE-ZEROED by the caller
// (truncated streams leave trailing blocks zero, like libjpeg's
// warn-and-pad).
PICHA_API int picha_jpeg_entropy_segments(
    const uint8_t* data, const int64_t* seg_off, int nseg, int64_t mcus,
    int64_t restart_interval, int64_t mcus_per_row, int ncomp,
    const int* h_samp, const int* v_samp, const int* blocks_w,
    const int* blocks_h, const int* dc_tab, const int* ac_tab,
    const int64_t* limit, const int64_t* mincode, const int64_t* valptr,
    const int32_t* hv, const int32_t* nbits, int ntab, int nthreads,
    int16_t* const* out);

// Raw DCT coefficient access for the device pixel-stage path.
typedef struct PichaJpegCoefs PichaJpegCoefs;  // opaque
PICHA_API int picha_jpeg_coef_open(const uint8_t* src, size_t len,
                                   PichaJpegCoefs** handle, char** err);
// info[0]=ncomp info[1]=width info[2]=height info[3]=jpeg_color_space
//   (1 grayscale, 2 RGB, 3 YCbCr, 4 CMYK, 5 YCCK)
PICHA_API int picha_jpeg_coef_info(PichaJpegCoefs* h, int* info);
// per-component: comp_info[0]=h_samp [1]=v_samp [2]=blocks_w (width in
// blocks, padded) [3]=blocks_h [4]=downsampled_w [5]=downsampled_h
PICHA_API int picha_jpeg_coef_comp_info(PichaJpegCoefs* h, int comp,
                                        int* comp_info, uint16_t* qtable64);
// copies the (blocks_h, blocks_w, 64) int16 coefficient tensor
PICHA_API int picha_jpeg_coef_read(PichaJpegCoefs* h, int comp, int16_t* out);
PICHA_API void picha_jpeg_coef_close(PichaJpegCoefs* h);

// Assemble a JPEG from quantised coefficients (device encode path).
// comps: ncomp arrays of (blocks_h*blocks_w*64) int16; samp factors and
// qtables per component; grey: ncomp==1. jpeg_color_space 2 (JCS_RGB)
// writes an RGB-tagged file ('R','G','B' ids + Adobe APP14) for
// untransformed 3-component planes; anything else = default
// (grayscale / JFIF YCbCr).
PICHA_API int picha_jpeg_coef_write(int width, int height, int ncomp,
                                    const int16_t** comps,
                                    const int* h_samp, const int* v_samp,
                                    const int* blocks_w, const int* blocks_h,
                                    const uint16_t** qtables,
                                    int jpeg_color_space,
                                    int optimize_huffman, int restart_mcus,
                                    uint8_t** out, size_t* outlen, char** err);

// ---- TIFF compression primitives -----------------------------------------
PICHA_API int picha_lzw_decode(const uint8_t* src, size_t srclen,
                               uint8_t* out, size_t outcap, size_t* outlen);
PICHA_API int picha_lzw_encode(const uint8_t* src, size_t srclen,
                               uint8_t** out, size_t* outlen);
PICHA_API int picha_packbits_decode(const uint8_t* src, size_t srclen,
                                    uint8_t* out, size_t outcap,
                                    size_t* outlen);

// Raw 4:2:0 plane encode (jpeg_write_raw_data: fDCT+quant+Huffman
// only; planes padded to ceil16 / half that).
PICHA_API int picha_jpeg_encode_raw420(const uint8_t* y, const uint8_t* cb,
                                       const uint8_t* cr, int width,
                                       int height, int quality,
                                       int restart_mcus, uint8_t** out,
                                       size_t* outlen, char** err);

// Raw 4:2:0 plane decode (Huffman+IDCT only; see jpegshim.cc). Returns
// 0 ok, 1 unsupported-layout (fall back), -1 error (err set).
// scale_denom in {2,4,8} selects libjpeg's scaled IDCT: plane dims and
// buffer padding become ceil16(ceil(dim/denom)); other values = full.
// one-call raw-domain transcode (decode raw -> banded resize -> raw
// re-encode, GIL-free): windows in the picha_resize_u8 layout, built
// against the scaled source geometry when scale_denom is 2/4/8;
// returns 1 for unsupported layouts and 2 when gamut_guard > 0 trips
// (source clip mass > guard, see rawguard.cc) — caller falls back to
// the RGB path either way
PICHA_API int picha_jpeg_transcode_raw420(
    const uint8_t* src, size_t len, int src_w, int src_h, int dst_w,
    int dst_h, int scale_denom, const int32_t* yxs, const float* yxw,
    int yxk, const int32_t* yys, const float* yyw, int yyk,
    const int32_t* cxs, const float* cxw, int cxk, const int32_t* cys,
    const float* cyw, int cyk, int quality, int restart_mcus,
    double gamut_guard, uint8_t** out, size_t* outlen, char** err);
PICHA_API int picha_jpeg_decode_raw420(const uint8_t* src, size_t len,
                                       uint8_t* y, uint8_t* cb, uint8_t* cr,
                                       int scale_denom, char** err);
// Mean per-channel LSB by which the implied RGB of padded 4:2:0 planes
// exceeds [0,255] (even rows sampled; arithmetic identical between the
// AVX2 and scalar builds — see rawguard.cc). The raw transcode path's
// divergence from the staged path is bounded by this nonlinearity.
PICHA_API double picha_raw420_clip_mass(const uint8_t* y, const uint8_t* cb,
                                        const uint8_t* cr, int w, int h,
                                        int wpad);
// Same-grid chroma layout (scaled raw decode's effective-4:4:4 planes).
PICHA_API double picha_raw444_clip_mass(const uint8_t* y, const uint8_t* cb,
                                        const uint8_t* cr, int w, int h,
                                        int wpad);

// ---- host separable resize (native single-image fast path) ----------------
// Uniform tap windows per output index (start + k zero-padded float32
// taps, the reference resize.cc weight numerics built in Python).
// The scalar (non-x86) fallback replicates the AVX2 kernel's exact
// rounding events (raw 0-255 space, vertical pass first, FMA over the
// 8-wide column body, double-rounded tail columns), so host-path bytes
// are reproducible ACROSS architectures — verified bit-for-bit by
// native/check_scalar_parity.sh (both legs compiled on one x86 host).
PICHA_API int picha_resize_u8(const uint8_t* src, int sh, int sw, int ch,
                              uint8_t* dst, int dh, int dw,
                              const int32_t* xstart, const float* xw,
                              int xk, const int32_t* ystart,
                              const float* yw, int yk);
PICHA_API int picha_resize_u16(const uint16_t* src, int sh, int sw, int ch,
                               uint16_t* dst, int dh, int dw,
                               const int32_t* xstart, const float* xw,
                               int xk, const int32_t* ystart,
                               const float* yw, int yk);
// int16 fixed-point u8 kernel (q15 taps, s*64 samples, 16 lanes/op):
// ~2x the f32 kernel, within occasional +-1 of it at pack thresholds.
// Returns 2 (caller must fall back to picha_resize_u8) when taps
// exceed the q15/overflow guard or the build lacks AVX2.
PICHA_API int picha_resize_u8_i16(const uint8_t* src, int sh, int sw,
                                  int ch, uint8_t* dst, int dh, int dw,
                                  const int32_t* xstart, const float* xw,
                                  int xk, const int32_t* ystart,
                                  const float* yw, int yk);
// Same-size single-channel i16 variant (the draft-Y correction):
// bit-identical arithmetic to picha_resize_u8_i16 but transpose-free —
// requires identity-size windows (consecutive starts + one shared
// interior tap vector); returns 2 otherwise so callers fall back.
PICHA_API int picha_resize_u8_i16_same(const uint8_t* src, int h, int w,
                                       uint8_t* dst, const int32_t* xstart,
                                       const float* xw, int xk,
                                       const int32_t* ystart,
                                       const float* yw, int yk);

// ---- CCITT fax (TIFF compressions 2, 3, 4) --------------------------------
// Decodes a T.4/T.6 bitstream (MSB-first; caller pre-reverses
// FillOrder=2 data) into one byte per pixel, 0=white 1=black. comp: 2 =
// modified-Huffman RLE, 3 = Group 3 (options = T4Options tag: bit0
// 2-D), 4 = Group 4. Missing rows are padded white; rows_done reports
// how many rows actually decoded.
PICHA_API int picha_fax_decode(const uint8_t* src, size_t len, int width,
                               int height, int comp, uint32_t options,
                               uint8_t* out, int* rows_done, char** err);

// ---- sparse coefficient packing (device upload wire format) ------------------
// Emits (gap uint8, value int8) pairs for the nonzeros of an int16 plane
// plus an int8-overflow correction list; see sparsepack.cc. Caller sizes
// gaps/vals for n + n/255 + 2 entries and corr_* for n entries.
PICHA_API int picha_gap8_pack(const int16_t* coefs, size_t n,
                              uint8_t* gaps, int8_t* vals, size_t* npairs,
                              int32_t* corr_idx, int16_t* corr_val,
                              size_t* ncorr);
// Nibble variant: 1 byte/nonzero primary + gap8 side stream for
// |v| > 7 escapes. prim sized n + n/15 + 2; side arrays as gap8.
PICHA_API int picha_gap4_pack(const int16_t* coefs, size_t n,
                              uint8_t* prim, size_t* nprim,
                              uint8_t* sgaps, int8_t* svals, size_t* nsec,
                              int32_t* corr_idx, int16_t* corr_val,
                              size_t* ncorr);
// Batch wire assembly for one component plane across nb images, one
// scan: `begin` packs every image into internal scratch and reports
// the per-image entry counts; the caller sizes the padded rows and
// `finish` copies each image's streams into its final (nb, k1)/(nb,
// k2) row (no-op-code padding) plus the batch-flat correction list,
// then frees the handle (always, even on error).
PICHA_API int picha_gap4_batch_begin(const int16_t* const* coefs, int nb,
                                     size_t n, void** handle,
                                     int64_t* nprim, int64_t* nsec,
                                     int64_t* ncorr);
PICHA_API int picha_gap4_batch_finish(void* handle, uint8_t* prim,
                                      size_t k1, uint8_t* sgaps,
                                      int8_t* svals, size_t k2,
                                      int32_t* corr_idx, int16_t* corr_val,
                                      size_t kc);

// ---- WebP (libwebp shim) -------------------------------------------------
PICHA_API int picha_webp_stat(const uint8_t* src, size_t len,
                              int* width, int* height, int* has_alpha);
// channels: 3 (rgb) or 4 (rgba); out must hold height*stride bytes
PICHA_API int picha_webp_decode(const uint8_t* src, size_t len, int channels,
                                uint8_t* out, int stride,
                                int width, int height);
// preset: 0 default 1 picture 2 photo 3 drawing 4 icon 5 text
// lossless: use default preset + lossless mode (reference
// src/webpcodec.cc:155-195); exact preserves RGB under transparent alpha
// method: libwebp's speed/size trade (0 fastest .. 6 slowest/smallest),
// <0 keeps the preset's own value (beyond-reference option).
// segments: 1..4 analysis segments, <=0 keeps the preset's own.
PICHA_API int picha_webp_encode(const uint8_t* src, int width, int height,
                                int stride, int channels, int preset,
                                float quality, int alpha_quality, int exact,
                                int lossless, int method, int segments,
                                int alpha_filtering,
                                uint8_t** out, size_t* outlen);
