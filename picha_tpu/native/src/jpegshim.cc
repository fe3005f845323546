// JPEG host stages over libjpeg.
//
// Two roles (SURVEY.md §7 step 5):
//  * full host decode/encode — the bit-parity reference path, same
//    library the reference used (src/jpegcodec.cc), independent code;
//  * raw DCT coefficient import/export (jpeg_read_coefficients /
//    jpeg_write_coefficients) — the serial entropy stage of the device
//    pipeline, where dequant+IDCT+upsample+YCbCr->RGB run on-chip.
//
// All error paths convert libjpeg longjmp aborts into error strings
// (caller frees with picha_free), mirroring the reference's setjmp
// traps (src/jpegcodec.cc:47,125-131).
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include "picha_native.h"

namespace {

struct ErrorTrap {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
  char msg[JMSG_LENGTH_MAX];
};

void on_error(j_common_ptr cinfo) {
  ErrorTrap* trap = (ErrorTrap*)cinfo->err;
  cinfo->err->format_message(cinfo, trap->msg);
  longjmp(trap->jmp, 1);
}

void on_emit(j_common_ptr, int) {}  // swallow warnings

void setup_trap(jpeg_error_mgr* err, ErrorTrap* trap) {
  jpeg_std_error(err);
  err->error_exit = on_error;
  err->emit_message = on_emit;
  trap->msg[0] = 0;
}

char* dup_error(const ErrorTrap& trap) {
  return strdup(trap.msg[0] ? trap.msg : "jpeg error");
}

// Fold (already Adobe-inverted) CMYK to RGB: rgb = c*k/255 — the
// reference's rule (src/jpegcodec.cc:36-42).
void cmyk_row_to_rgb(const uint8_t* cmyk, uint8_t* rgb, int width) {
  for (int i = 0; i < width; ++i, cmyk += 4, rgb += 3) {
    rgb[0] = (uint8_t)(int(cmyk[0]) * cmyk[3] / 255);
    rgb[1] = (uint8_t)(int(cmyk[1]) * cmyk[3] / 255);
    rgb[2] = (uint8_t)(int(cmyk[2]) * cmyk[3] / 255);
  }
}

}  // namespace

PICHA_API void picha_free(void* p) { free(p); }

PICHA_API int picha_jpeg_stat(const uint8_t* src, size_t len, int* width,
                              int* height, int* channels) {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  if (setjmp(trap.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, src, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *width = (int)cinfo.image_width;
  *height = (int)cinfo.image_height;
  // default output space channel count: grayscale -> 1, everything the
  // decoder folds to colour -> 3 (CMYK reported as 3: decode folds it)
  *channels = cinfo.jpeg_color_space == JCS_GRAYSCALE ? 1 : 3;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

PICHA_API int picha_jpeg_decode(const uint8_t* src, size_t len,
                                int want_channels, int scale_denom,
                                uint8_t* out, int out_stride,
                                char** err) {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  uint8_t* cmyk_row = nullptr;
  if (setjmp(trap.jmp)) {
    free(cmyk_row);
    jpeg_destroy_decompress(&cinfo);
    if (err) *err = dup_error(trap);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, src, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);

  bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
              cinfo.jpeg_color_space == JCS_YCCK;
  if (want_channels == 1) {
    cinfo.out_color_space = JCS_GRAYSCALE;
    cmyk = false;
  } else if (want_channels == 3 && !cmyk) {
    cinfo.out_color_space = JCS_RGB;
  }
  // cmyk sources keep JCS_CMYK output; folded per row below

  // DCT-scaled decode (1/2, 1/4, 1/8): the IDCT runs at reduced block
  // size — the draft-mode fast path every thumbnailer uses
  if (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned)scale_denom;
  }
  jpeg_start_decompress(&cinfo);
  int w = (int)cinfo.output_width;
  if (cmyk) cmyk_row = (uint8_t*)malloc((size_t)w * 4);

  for (unsigned y = 0; y < cinfo.output_height; ++y) {
    uint8_t* dst = out + (size_t)y * out_stride;
    if (cmyk) {
      JSAMPROW p = cmyk_row;
      jpeg_read_scanlines(&cinfo, &p, 1);
      cmyk_row_to_rgb(cmyk_row, dst, w);
    } else {
      JSAMPROW p = dst;
      jpeg_read_scanlines(&cinfo, &p, 1);
    }
  }
  jpeg_finish_decompress(&cinfo);
  free(cmyk_row);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

PICHA_API int picha_jpeg_encode(const uint8_t* src, int width, int height,
                                int stride, int channels, int quality,
                                int restart_mcus, int progressive,
                                int optimize, int subsample444,
                                uint8_t** out, size_t* outlen, char** err) {
  jpeg_compress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  unsigned char* buf = nullptr;
  unsigned long buflen = 0;
  if (setjmp(trap.jmp)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    if (err) *err = dup_error(trap);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buflen);

  cinfo.image_width = (JDIMENSION)width;
  cinfo.image_height = (JDIMENSION)height;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  if (quality < 0) quality = 0;
  if (quality > 100) quality = 100;
  jpeg_set_quality(&cinfo, quality, TRUE /* force_baseline */);
  // restart markers make the scan parallel-decodable (each segment is
  // an independent bitstream with reset DC prediction) — the device
  // entropy decoder exploits them; small intervals cost ~2 bytes/MCU
  if (restart_mcus > 0) cinfo.restart_interval = (unsigned)restart_mcus;
  // libjpeg's stock spectral-selection/successive-approximation script
  // (beyond the reference, which wrote baseline only)
  if (progressive) jpeg_simple_progression(&cinfo);
  // option parity with the device encode branch (codecs/jpeg.py): these
  // must not silently depend on the backend
  if (optimize) cinfo.optimize_coding = TRUE;
  if (subsample444 && channels == 3) {
    for (int c = 0; c < cinfo.num_components; ++c) {
      cinfo.comp_info[c].h_samp_factor = 1;
      cinfo.comp_info[c].v_samp_factor = 1;
    }
  }
  jpeg_start_compress(&cinfo, TRUE);
  for (int y = 0; y < height; ++y) {
    JSAMPROW p = (JSAMPROW)(src + (size_t)y * stride);
    jpeg_write_scanlines(&cinfo, &p, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = (uint8_t*)buf;
  *outlen = (size_t)buflen;
  return 0;
}

// Decode to raw 4:2:0 planes (jpeg_read_raw_data): Huffman + IDCT only,
// skipping libjpeg's chroma upsample and YCbCr->RGB stages. The caller
// resizes the planes directly (Y with the exact cubic weights, chroma
// with the composed downsample.resize.upsample operator — the same
// linear composition the device fused path uses) and re-encodes via
// picha_jpeg_encode_raw420, so the whole host pipeline stays in the
// source's native colour space. Returns 1 (no error string) when the
// source is not 3-component YCbCr 2x2/1x1/1x1 so callers can fall back
// to the standard RGB path. Planes must be padded like the encoder's:
// Y (ceil16(h), ceil16(w)), Cb/Cr half that (libjpeg writes
// width_in_blocks*DCT_scaled_size <= those widths per row).
// scale_denom in {2,4,8} selects libjpeg's scaled IDCT: for 4:2:0
// sources the chroma planes come out at the SAME ceil(dim/denom)
// geometry as Y, i.e. the output is effectively 4:4:4 at the scaled
// size. At denom=2 the chroma samples are EXACT (full 8x8 IDCT of the
// native-resolution chroma plane) and only Y is the draft
// approximation; at denom=4/8 libjpeg picks chroma DCT_scaled_size 4/2
// so chroma is ALSO a scaled approximate IDCT — callers needing exact
// chroma must stay at denom<=2 (the shipped draft path does). Buffers
// for scaled decodes: all three planes
// ceil16(ceil(w/denom)) x ceil16(ceil(h/denom)).
PICHA_API int picha_jpeg_decode_raw420(const uint8_t* src, size_t len,
                                       uint8_t* y, uint8_t* cb, uint8_t* cr,
                                       int scale_denom, char** err) {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  if (setjmp(trap.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    if (err) *err = dup_error(trap);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, src, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);

  if (cinfo.jpeg_color_space != JCS_YCbCr || cinfo.num_components != 3 ||
      cinfo.comp_info[0].h_samp_factor != 2 ||
      cinfo.comp_info[0].v_samp_factor != 2 ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      cinfo.comp_info[2].h_samp_factor != 1 ||
      cinfo.comp_info[2].v_samp_factor != 1) {
    jpeg_destroy_decompress(&cinfo);
    return 1;  // unsupported layout: caller falls back, not an error
  }
  cinfo.raw_data_out = TRUE;
  if (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned)scale_denom;
  }
  jpeg_start_decompress(&cinfo);

  int w = (int)cinfo.output_width;
  int h = (int)cinfo.output_height;
  int wpad = (w + 15) & ~15;
  int hpad = (h + 15) & ~15;
  // per-component rows per iMCU row: v_samp x DCT_scaled_size (Y 16
  // full-size / 8 at denom 2; chroma 8 in both — the scaled IDCT
  // applies to Y only, chroma keeps its full 8x8 IDCT)
  int ylines = cinfo.comp_info[0].v_samp_factor *
               cinfo.comp_info[0].DCT_scaled_size;
  int clines = cinfo.comp_info[1].v_samp_factor *
               cinfo.comp_info[1].DCT_scaled_size;
  // chroma lands on the scaled-Y grid (stride wpad) when scaling is on,
  // on the half grid (stride wpad/2) at full size. Key the choice on
  // scale_denom — NOT on downsampled_width == w, which falsely matches
  // full-size decodes of 1-pixel-wide sources (ceil(1/2) == 1 == w) and
  // would overrun the half-grid chroma buffers.
  bool scaled = scale_denom == 2 || scale_denom == 4 || scale_denom == 8;
  int cstride = scaled ? wpad : wpad / 2;

  JSAMPROW yrows[16], cbrows[16], crrows[16];
  JSAMPARRAY planes[3] = {yrows, cbrows, crrows};
  while (cinfo.output_scanline < cinfo.output_height) {
    int imcu = (int)cinfo.output_scanline / ylines;
    for (int i = 0; i < ylines; ++i)
      yrows[i] = (JSAMPROW)(y + (size_t)(imcu * ylines + i) * wpad);
    for (int i = 0; i < clines; ++i) {
      cbrows[i] = (JSAMPROW)(cb + (size_t)(imcu * clines + i) * cstride);
      crrows[i] = (JSAMPROW)(cr + (size_t)(imcu * clines + i) * cstride);
    }
    jpeg_read_raw_data(&cinfo, planes, (JDIMENSION)ylines);
  }
  (void)hpad;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode from pre-computed 4:2:0 planes (jpeg_write_raw_data): the device
// already did RGB->YCbCr and chroma downsampling; the host does only
// fDCT + quantisation + Huffman. Planes must be padded: Y to
// (ceil16(h), ceil16(w)), Cb/Cr to half that.
PICHA_API int picha_jpeg_encode_raw420(const uint8_t* y, const uint8_t* cb,
                                       const uint8_t* cr, int width,
                                       int height, int quality,
                                       int restart_mcus, uint8_t** out,
                                       size_t* outlen, char** err) {
  jpeg_compress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  unsigned char* buf = nullptr;
  unsigned long buflen = 0;
  if (setjmp(trap.jmp)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    if (err) *err = dup_error(trap);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buflen);

  int wpad = (width + 15) & ~15;
  int hpad = (height + 15) & ~15;

  cinfo.image_width = (JDIMENSION)width;
  cinfo.image_height = (JDIMENSION)height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  if (quality < 0) quality = 0;
  if (quality > 100) quality = 100;
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.raw_data_in = TRUE;
  cinfo.comp_info[0].h_samp_factor = 2;
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  if (restart_mcus > 0) cinfo.restart_interval = (unsigned)restart_mcus;
  jpeg_start_compress(&cinfo, TRUE);

  JSAMPROW yrows[16], cbrows[8], crrows[8];
  JSAMPARRAY planes[3] = {yrows, cbrows, crrows};
  while (cinfo.next_scanline < cinfo.image_height) {
    int base = (int)cinfo.next_scanline;
    for (int i = 0; i < 16; ++i) {
      int r = base + i;
      if (r >= hpad) r = hpad - 1;
      yrows[i] = (JSAMPROW)(y + (size_t)r * wpad);
    }
    for (int i = 0; i < 8; ++i) {
      int r = base / 2 + i;
      if (r >= hpad / 2) r = hpad / 2 - 1;
      cbrows[i] = (JSAMPROW)(cb + (size_t)r * (wpad / 2));
      crrows[i] = (JSAMPROW)(cr + (size_t)r * (wpad / 2));
    }
    jpeg_write_raw_data(&cinfo, planes, 16);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = (uint8_t*)buf;
  *outlen = (size_t)buflen;
  return 0;
}

// One-call raw-domain transcode: decode raw 4:2:0 planes -> banded
// separable resize (int16 fixed-point kernel with f32 fallback, see
// hostresize.cc) -> raw 4:2:0 re-encode, entirely inside one native
// call with the GIL released — per-image Python/ctypes overhead drops
// to a single crossing, and on multi-core hosts pool threads run the
// whole transcode concurrently. Window tables arrive from Python
// (ops/raw420.py caches them per geometry). Returns 1 (no error
// string) for layouts the raw path doesn't take — caller falls back.
// gamut_guard > 0 enables the clip-mass check (rawguard.cc): sources
// whose implied RGB clips more than `gamut_guard` LSB on average —
// the regime where the raw path's linearity diverges from the staged
// path's mid-pipeline clamp — return 2 so callers take the exact path.
PICHA_API int picha_jpeg_transcode_raw420(
    const uint8_t* src, size_t len, int src_w, int src_h, int dst_w,
    int dst_h, int scale_denom, const int32_t* yxs, const float* yxw,
    int yxk, const int32_t* yys, const float* yyw, int yyk,
    const int32_t* cxs, const float* cxw, int cxk, const int32_t* cys,
    const float* cyw, int cyk, int quality, int restart_mcus,
    double gamut_guard, uint8_t** out, size_t* outlen, char** err) {
  // the decode writes rows per the bitstream's header dims; buffers
  // here are sized from the caller's src_w/src_h, so the two MUST
  // agree or the plane writes run off the heap — verify, don't trust
  int hw = 0, hh = 0, hc = 0;
  if (picha_jpeg_stat(src, len, &hw, &hh, &hc) != 0 || hw != src_w ||
      hh != src_h) {
    if (err) *err = strdup("transcode dims disagree with JPEG header");
    return -1;
  }
  // scaled (draft) decode shrinks the plane geometry the windows map
  // from: callers build their windows against these effective dims
  int denom =
      (scale_denom == 2 || scale_denom == 4 || scale_denom == 8)
          ? scale_denom
          : 1;
  int sw = (src_w + denom - 1) / denom, sh = (src_h + denom - 1) / denom;
  int wpi = (sw + 15) & ~15, hpi = (sh + 15) & ~15;
  int wpo = (dst_w + 15) & ~15, hpo = (dst_h + 15) & ~15;
  // scaled decodes emit chroma on the Y grid (exact 8x8 IDCT at
  // denom=2, scaled approximate at 4/8 — see picha_jpeg_decode_raw420
  // above); full-size decodes on the half grid
  bool cfull = denom > 1;
  size_t csz = cfull ? (size_t)hpi * wpi : (size_t)hpi * wpi / 4;
  int ciw = cfull ? wpi : wpi / 2, cih = cfull ? hpi : hpi / 2;
  std::vector<uint8_t> y((size_t)hpi * wpi), cbp(csz), crp(csz);
  int rc = picha_jpeg_decode_raw420(src, len, y.data(), cbp.data(),
                                    crp.data(), denom, err);
  if (rc != 0) return rc;
  if (gamut_guard > 0.0) {
    double mass =
        cfull ? picha_raw444_clip_mass(y.data(), cbp.data(), crp.data(),
                                       sw, sh, wpi)
              : picha_raw420_clip_mass(y.data(), cbp.data(), crp.data(),
                                       sw, sh, wpi);
    if (mass > gamut_guard)
      return 2;  // gamut risk: caller takes the staged exact path
  }
  std::vector<uint8_t> yo((size_t)hpo * wpo), cbo((size_t)hpo * wpo / 4),
      cro((size_t)hpo * wpo / 4);
  auto rsz = [](const uint8_t* s, int sh, int sw, uint8_t* d, int dh,
                int dw, const int32_t* xs, const float* xw, int xk,
                const int32_t* ys2, const float* yw2, int yk2) {
    int r = 2;
    if (sh == dh && sw == dw)  // draft-Y correction: transpose-free
      r = picha_resize_u8_i16_same(s, sh, sw, d, xs, xw, xk, ys2, yw2,
                                   yk2);
    if (r == 2)
      r = picha_resize_u8_i16(s, sh, sw, 1, d, dh, dw, xs, xw, xk, ys2,
                              yw2, yk2);
    if (r == 2)
      r = picha_resize_u8(s, sh, sw, 1, d, dh, dw, xs, xw, xk, ys2, yw2,
                          yk2);
    return r;
  };
  if (rsz(y.data(), hpi, wpi, yo.data(), hpo, wpo, yxs, yxw, yxk, yys,
          yyw, yyk) != 0 ||
      rsz(cbp.data(), cih, ciw, cbo.data(), hpo / 2, wpo / 2, cxs,
          cxw, cxk, cys, cyw, cyk) != 0 ||
      rsz(crp.data(), cih, ciw, cro.data(), hpo / 2, wpo / 2, cxs,
          cxw, cxk, cys, cyw, cyk) != 0) {
    if (err) *err = strdup("raw420 resize failed");
    return -1;
  }
  return picha_jpeg_encode_raw420(yo.data(), cbo.data(), cro.data(),
                                  dst_w, dst_h, quality, restart_mcus,
                                  out, outlen, err);
}

// ---------------------------------------------------------------------------
// Raw coefficient access (device pixel-stage path)
// ---------------------------------------------------------------------------

struct PichaJpegCoefs {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  jvirt_barray_ptr* arrays = nullptr;
  bool open = false;
};

PICHA_API int picha_jpeg_coef_open(const uint8_t* src, size_t len,
                                   PichaJpegCoefs** handle, char** err) {
  PichaJpegCoefs* h = new PichaJpegCoefs;
  h->cinfo.err = &h->trap.mgr;
  setup_trap(&h->trap.mgr, &h->trap);
  if (setjmp(h->trap.jmp)) {
    if (err) *err = dup_error(h->trap);
    if (h->open) jpeg_destroy_decompress(&h->cinfo);
    delete h;
    return -1;
  }
  jpeg_create_decompress(&h->cinfo);
  h->open = true;
  jpeg_mem_src(&h->cinfo, src, (unsigned long)len);
  jpeg_read_header(&h->cinfo, TRUE);
  h->arrays = jpeg_read_coefficients(&h->cinfo);
  if (!h->arrays) {
    if (err) *err = strdup("jpeg coefficient read failed");
    jpeg_destroy_decompress(&h->cinfo);
    delete h;
    return -1;
  }
  *handle = h;
  return 0;
}

PICHA_API int picha_jpeg_coef_info(PichaJpegCoefs* h, int* info) {
  info[0] = h->cinfo.num_components;
  info[1] = (int)h->cinfo.image_width;
  info[2] = (int)h->cinfo.image_height;
  info[3] = (int)h->cinfo.jpeg_color_space;
  return 0;
}

PICHA_API int picha_jpeg_coef_comp_info(PichaJpegCoefs* h, int comp,
                                        int* comp_info, uint16_t* qtable64) {
  if (comp < 0 || comp >= h->cinfo.num_components) return -1;
  jpeg_component_info* ci = &h->cinfo.comp_info[comp];
  comp_info[0] = ci->h_samp_factor;
  comp_info[1] = ci->v_samp_factor;
  comp_info[2] = (int)ci->width_in_blocks;
  comp_info[3] = (int)ci->height_in_blocks;
  comp_info[4] = (int)ci->downsampled_width;
  comp_info[5] = (int)ci->downsampled_height;
  JQUANT_TBL* qt = ci->quant_table;
  if (!qt) qt = h->cinfo.quant_tbl_ptrs[ci->quant_tbl_no];
  if (!qt) return -2;
  for (int i = 0; i < DCTSIZE2; ++i) qtable64[i] = qt->quantval[i];
  return 0;
}

PICHA_API int picha_jpeg_coef_read(PichaJpegCoefs* h, int comp, int16_t* out) {
  if (comp < 0 || comp >= h->cinfo.num_components) return -1;
  if (setjmp(h->trap.jmp)) return -1;
  jpeg_component_info* ci = &h->cinfo.comp_info[comp];
  JDIMENSION bw = ci->width_in_blocks, bh = ci->height_in_blocks;
  for (JDIMENSION row = 0; row < bh; ++row) {
    JBLOCKARRAY rows = (h->cinfo.mem->access_virt_barray)(
        (j_common_ptr)&h->cinfo, h->arrays[comp], row, 1, FALSE);
    memcpy(out + (size_t)row * bw * DCTSIZE2, rows[0],
           (size_t)bw * DCTSIZE2 * sizeof(int16_t));
  }
  return 0;
}

PICHA_API void picha_jpeg_coef_close(PichaJpegCoefs* h) {
  if (!h) return;
  if (setjmp(h->trap.jmp) == 0) {
    jpeg_finish_decompress(&h->cinfo);
  }
  jpeg_destroy_decompress(&h->cinfo);
  delete h;
}

PICHA_API int picha_jpeg_coef_write(int width, int height, int ncomp,
                                    const int16_t** comps, const int* h_samp,
                                    const int* v_samp, const int* blocks_w,
                                    const int* blocks_h,
                                    const uint16_t** qtables,
                                    int jpeg_color_space,
                                    int optimize_huffman, int restart_mcus,
                                    uint8_t** out,
                                    size_t* outlen, char** err) {
  jpeg_compress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = &trap.mgr;
  setup_trap(&trap.mgr, &trap);
  unsigned char* buf = nullptr;
  unsigned long buflen = 0;
  if (setjmp(trap.jmp)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    if (err) *err = dup_error(trap);
    return -1;
  }
  if (ncomp != 1 && ncomp != 3) {
    // jpeg_set_colorspace would silently pin num_components to 3 and
    // drop extra planes — refuse instead of emitting a corrupt file
    if (err) *err = strdup("coef_write supports 1 or 3 components");
    return -2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buflen);

  cinfo.image_width = (JDIMENSION)width;
  cinfo.image_height = (JDIMENSION)height;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  if (jpeg_color_space == JCS_RGB && ncomp == 3) {
    // coefficients of an RGB-tagged source (Adobe transform=0 or
    // 'R','G','B' ids) are stored untransformed — the output must say
    // so (component ids 'R','G','B' + Adobe APP14, no JFIF) or every
    // decoder would apply the YCbCr matrix to raw RGB planes
    jpeg_set_colorspace(&cinfo, JCS_RGB);
  }
  cinfo.optimize_coding = optimize_huffman ? TRUE : FALSE;
  if (restart_mcus > 0) cinfo.restart_interval = (unsigned)restart_mcus;

  // one quant slot per component (sharing a slot would let a later
  // component's table overwrite an earlier one's)
  for (int c = 0; c < ncomp; ++c) {
    cinfo.comp_info[c].h_samp_factor = h_samp[c];
    cinfo.comp_info[c].v_samp_factor = v_samp[c];
    int tbl = c < NUM_QUANT_TBLS ? c : NUM_QUANT_TBLS - 1;
    if (c > 0 && memcmp(qtables[c], qtables[c - 1],
                        DCTSIZE2 * sizeof(uint16_t)) == 0) {
      tbl = cinfo.comp_info[c - 1].quant_tbl_no;  // share identical tables
    }
    cinfo.comp_info[c].quant_tbl_no = tbl;
    unsigned int basic[DCTSIZE2];
    for (int i = 0; i < DCTSIZE2; ++i) basic[i] = qtables[c][i];
    jpeg_add_quant_table(&cinfo, tbl, basic, 100, FALSE);
  }

  // build virtual coefficient arrays; the transcoder walks them in
  // v_samp-row chunks, so round dims up to sampling multiples and
  // pre-zero the padding (as jdcoefct does on the decode side)
  jvirt_barray_ptr* arrays = (jvirt_barray_ptr*)(cinfo.mem->alloc_small)(
      (j_common_ptr)&cinfo, JPOOL_IMAGE, ncomp * sizeof(jvirt_barray_ptr));
  for (int c = 0; c < ncomp; ++c) {
    JDIMENSION bw = (JDIMENSION)((blocks_w[c] + h_samp[c] - 1) / h_samp[c] *
                                 h_samp[c]);
    JDIMENSION bh = (JDIMENSION)((blocks_h[c] + v_samp[c] - 1) / v_samp[c] *
                                 v_samp[c]);
    arrays[c] = (cinfo.mem->request_virt_barray)(
        (j_common_ptr)&cinfo, JPOOL_IMAGE, TRUE, bw, bh,
        (JDIMENSION)v_samp[c]);
  }
  jpeg_write_coefficients(&cinfo, arrays);
  for (int c = 0; c < ncomp; ++c) {
    for (int row = 0; row < blocks_h[c]; ++row) {
      JBLOCKARRAY rows = (cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, arrays[c], (JDIMENSION)row, 1, TRUE);
      memcpy(rows[0], comps[c] + (size_t)row * blocks_w[c] * DCTSIZE2,
             (size_t)blocks_w[c] * DCTSIZE2 * sizeof(int16_t));
    }
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = (uint8_t*)buf;
  *outlen = (size_t)buflen;
  return 0;
}
