// libwebp shim.
//
// The reference linked libwebp for the whole codec
// (src/webpcodec.cc); the VP8/VP8L entropy stages are host-serial so
// we do the same, exposing a flat C ABI with the reference's option
// surface: presets (default/picture/photo/drawing/icon/text/lossless),
// quality, alphaQuality, exact (src/webpcodec.cc:155-195).
// Compiled with WITH_LIBWEBP when the system library is present;
// otherwise every entry point fails and picha_webp_available() reports
// 0, so the WebP codec stays unregistered (catalog.py).
#include <cstdlib>
#include <cstring>

#ifdef WITH_LIBWEBP
#include <webp/decode.h>
#include <webp/encode.h>
#endif

#include "picha_native.h"

PICHA_API int picha_webp_available() {
#ifdef WITH_LIBWEBP
  return 1;
#else
  return 0;
#endif
}

#ifdef WITH_LIBWEBP

PICHA_API int picha_webp_stat(const uint8_t* src, size_t len, int* width,
                              int* height, int* has_alpha) {
  WebPBitstreamFeatures feat;
  if (WebPGetFeatures(src, len, &feat) != VP8_STATUS_OK) return -1;
  *width = feat.width;
  *height = feat.height;
  *has_alpha = feat.has_alpha;
  return 0;
}

PICHA_API int picha_webp_decode(const uint8_t* src, size_t len, int channels,
                                uint8_t* out, int stride, int width,
                                int height) {
  size_t outsize = (size_t)stride * height;
  uint8_t* r = channels == 4
                   ? WebPDecodeRGBAInto(src, len, out, outsize, stride)
                   : WebPDecodeRGBInto(src, len, out, outsize, stride);
  return r ? 0 : -1;
}

PICHA_API int picha_webp_encode(const uint8_t* src, int width, int height,
                                int stride, int channels, int preset,
                                float quality, int alpha_quality, int exact,
                                int lossless, int method, int segments,
                                int alpha_filtering,
                                uint8_t** out, size_t* outlen) {
  WebPConfig config;
  WebPPreset p = WEBP_PRESET_DEFAULT;
  switch (preset) {
    case 1: p = WEBP_PRESET_PICTURE; break;
    case 2: p = WEBP_PRESET_PHOTO; break;
    case 3: p = WEBP_PRESET_DRAWING; break;
    case 4: p = WEBP_PRESET_ICON; break;
    case 5: p = WEBP_PRESET_TEXT; break;
    default: break;
  }
  if (!WebPConfigPreset(&config, p, quality)) return -1;
  if (lossless) config.lossless = 1;
  config.alpha_quality = alpha_quality;
  config.exact = exact;
  if (method >= 0) config.method = method;  // <0: keep the preset's own
  // <=0: keep the preset's own (1..4 valid); fewer segments skip most
  // of the per-macroblock analysis at a small size cost
  if (segments > 0) config.segments = segments;
  // 0 none / 1 fast / 2 best predictive alpha filtering; <0 keeps the
  // preset's own (1). The alpha plane is coded by the LOSSLESS coder
  // whose effort follows `method` — on alpha-heavy content it can
  // dominate the whole encode (measured 79% on the bench corpus)
  if (alpha_filtering >= 0) config.alpha_filtering = alpha_filtering;
  if (!WebPValidateConfig(&config)) return -1;

  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return -1;
  pic.width = width;
  pic.height = height;
  pic.use_argb = 1;  // reference sets use_argb (src/webpcodec.cc:197-220)
  int ok = channels == 4 ? WebPPictureImportRGBA(&pic, src, stride)
                         : WebPPictureImportRGB(&pic, src, stride);
  if (!ok) {
    WebPPictureFree(&pic);
    return -2;
  }

  WebPMemoryWriter writer;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  ok = WebPEncode(&config, &pic);
  WebPPictureFree(&pic);
  if (!ok) {
    WebPMemoryWriterClear(&writer);
    return -3;
  }
  // copy into a plain-malloc buffer: writer.mem belongs to libwebp's
  // allocator, and the caller frees through picha_free (free)
  *out = (uint8_t*)malloc(writer.size);
  if (!*out) {
    WebPMemoryWriterClear(&writer);
    return -4;
  }
  memcpy(*out, writer.mem, writer.size);
  *outlen = writer.size;
  WebPMemoryWriterClear(&writer);
  return 0;
}

#else  // !WITH_LIBWEBP

PICHA_API int picha_webp_stat(const uint8_t*, size_t, int*, int*, int*) {
  return -1;
}

PICHA_API int picha_webp_decode(const uint8_t*, size_t, int, uint8_t*, int,
                                int, int) {
  return -1;
}

PICHA_API int picha_webp_encode(const uint8_t*, int, int, int, int, int,
                                float, int, int, int, int, int, int,
                                uint8_t**, size_t*) {
  return -1;
}

#endif  // WITH_LIBWEBP
