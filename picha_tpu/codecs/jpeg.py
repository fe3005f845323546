"""JPEG codec.

Two execution paths, same surface (SURVEY.md §7 step 5):

  * host path (default for the single-image API): libjpeg end to end
    via native/jpegshim.cc — handles baseline, progressive, restart
    markers, grayscale, CMYK/YCCK with the reference's c*k/255 fold
    (src/jpegcodec.cc:36-42). Bit-parity reference.
  * TPU path (``opts['backend'] == 'tpu'``, and the batched pipeline):
    host entropy decode to DCT coefficients, then the fused
    dequant+IDCT+upsample+YCbCr graph in ops/jpeg_tpu.py. Held to
    ≤1 LSB of the host path by tests.

Pixel selection follows the reference (src/jpegcodec.cc:112-121):
grayscale sources decode to 'grey', everything else to 'rgb'; there is
no pixel option. Encode accepts 'rgb'/'grey' only — the reference
mis-encoded other formats as if RGB (jpegcodec.cc:345-352, masked by
its negotiation bug); we reject instead, and the API layer's
negotiation converts first (SURVEY.md appendix).

Options: quality 0-100, default 85, clamped (jpegcodec.cc:434-441);
decode ``scaleDenom`` in {1,2,4,8} (extension): DCT-scaled decode at
1/N size via the reduced IDCT — the draft-mode fast path (~2-3x faster
at 1/2; output differs from full-decode+resize, it is a different
resampling); ``restartInterval`` (extension, default 0) writes DRI +
restart markers every N MCUs — segments become independently decodable, which
the device entropy decoder exploits for exact parallel entry states;
``progressive`` (extension, default False) writes libjpeg's stock
spectral-selection/successive-approximation scan script (the reference
encoded baseline only; its decoder — and ours — reads both).
"""
from __future__ import annotations

import numpy as np

from ..errors import CodecError, InvalidOptionsError
from ..image import Image
from ..native import lib as native

DEFAULT_QUALITY = 85


def stat(buf: bytes):
    st = native.jpeg_stat(bytes(buf))
    if st is None:
        return None
    w, h, ch = st
    return {"width": w, "height": h, "pixel": "grey" if ch == 1 else "rgb"}


def decode(buf: bytes, opts: dict) -> Image:
    buf = bytes(buf)
    st = native.jpeg_stat(buf)
    if st is None:
        raise CodecError("not a JPEG file")
    w, h, ch = st
    if opts.get("autoOrient", opts.get("auto_orient", False)):
        # pixel-domain EXIF auto-orient (extension; the TIFF codec
        # already normalises orientations 1-8 the same way via
        # TIFFReadRGBAImageOriented parity). Lossless alternative:
        # transformJpeg op='autoOrient'.
        from . import jpeg_markers
        from .tiff import _orient

        orient = jpeg_markers.exif_orientation(buf) or 1
        if orient != 1:
            img = decode(buf, {k: v for k, v in opts.items()
                               if k not in ("autoOrient", "auto_orient")})
            arr = np.ascontiguousarray(_orient(img.to_array(), orient))
            return Image.from_array(arr, img.pixel)
    try:
        denom = int(opts.get("scaleDenom", opts.get("scale_denom", 1)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("scaleDenom must be 1, 2, 4 or 8") from e
    if denom not in (1, 2, 4, 8):
        raise InvalidOptionsError("scaleDenom must be 1, 2, 4 or 8")
    req = opts.get("pixel")
    if req is not None:
        # extension over the reference (which always used the source's
        # default space, jpegcodec.cc:112-121): let libjpeg convert
        if req not in ("rgb", "grey"):
            raise InvalidOptionsError("jpeg decode supports pixel rgb/grey")
        ch = 1 if req == "grey" else 3
    if opts.get("backend") == "tpu":
        if denom > 1:
            # the device coefficient path decodes at full size; silently
            # returning different geometry for the same opts dict
            # depending on backend would be a trap
            raise InvalidOptionsError(
                "scaleDenom > 1 is not supported with backend='tpu' "
                "(use the host path, or resize after decode)")
        from ..ops import jpeg_tpu

        # segment-parallel host entropy decode when the file has
        # restart markers and cores are available (single-image
        # latency; see native/src/jpegentropy.cc)
        co = native.jpeg_coefficients(buf)
        if req == "grey" and co.color_space == 3 \
                and co.comps[0]["h_samp"] == max(c["h_samp"]
                                                 for c in co.comps) \
                and co.comps[0]["v_samp"] == max(c["v_samp"]
                                                 for c in co.comps):
            # libjpeg's grayscale output from a YCbCr source is the raw
            # Y plane (jdcolor grayscale passthrough) — converting via
            # RGB would clip out-of-gamut chroma first and diverge by
            # several LSBs on saturated content, breaking the <=1 LSB
            # host-parity invariant for this option combination. Only
            # valid when Y is at full resolution (a legal file may
            # subsample LUMA below chroma; dropping the other comps
            # would then change hmax and silently halve the geometry)
            co = native.JpegCoefficients.from_parts(
                co.width, co.height, 1, [co.comps[0]])
        arr = jpeg_tpu.decode_coefficients(co)
        pixel = "grey" if arr.shape[-1] == 1 else "rgb"
        img = Image.from_array(arr, pixel)
        if req is not None and req != pixel:
            from ..ops.colorconvert import color_convert_image

            img = color_convert_image(img, {"pixel": req})
        return img
    if denom > 1:
        w, h = -(-w // denom), -(-h // denom)
    arr = native.jpeg_decode(buf, ch, w, h, scale_denom=denom)
    return Image.from_array(arr, "grey" if ch == 1 else "rgb")


def encode(img: Image, opts: dict) -> bytes:
    if img.pixel not in ("rgb", "grey"):
        raise InvalidOptionsError(
            f"jpeg encode supports rgb/grey, got {img.pixel}")
    try:
        quality = int(opts.get("quality", DEFAULT_QUALITY))
        restart = int(opts.get("restartInterval",
                               opts.get("restart_interval", 0)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid jpeg encode options") from e
    quality = max(0, min(100, quality))
    if restart < 0:
        raise InvalidOptionsError("restartInterval must be >= 0")
    progressive = bool(opts.get("progressive", False))
    subsample = bool(opts.get("subsample", True))
    optimize = bool(opts.get("optimize", False))
    arr = img.to_array()
    if opts.get("backend") == "tpu":
        from ..ops import jpeg_tpu

        if progressive:
            raise InvalidOptionsError(
                "progressive encode is host-only (backend='tpu' writes "
                "baseline scans)")
        comps = jpeg_tpu.encode_to_coefficients(
            arr, quality, subsample=subsample)
        return native.jpeg_coef_write(
            img.width, img.height, comps,
            optimize_huffman=optimize,
            restart=restart)
    # host path honors the same option set (same opts dict must not
    # behave differently per backend)
    return native.jpeg_encode(arr, quality, restart=restart,
                              progressive=progressive,
                              optimize=optimize, subsample=subsample)


def transcode(buf: bytes, opts: dict) -> bytes:
    """One-call JPEG -> resized JPEG (beyond-reference API: the
    framework's fastest single-machine path made public).

    opts: width, height (required), quality (default 85), filter /
    filterScale (reference resize semantics, ops/resize.py),
    restartInterval. 4:2:0 YCbCr sources take the GIL-free raw-domain
    native path (ops/raw420.py — one crossing, int16 AVX2 banded
    resize, measured ≤1 LSB of the staged path on photographic
    content); anything else falls back to decode -> resize -> encode
    with identical option semantics.

    copyMarkers (default False): carry the source's COM/APP1..APP15
    metadata segments (EXIF, ICC, XMP) into the output — jpegtran
    -copy all semantics (codecs/jpeg_markers.py)."""
    from ..ops.raw420 import transcode_raw420
    from ..ops.resize import parse_resize_options
    from . import jpeg_markers

    try:
        w, h = int(opts["width"]), int(opts["height"])
    except KeyError as e:
        raise InvalidOptionsError("transcode requires width and height") \
            from e
    except (TypeError, ValueError) as e:  # same taxonomy as decode/encode
        raise InvalidOptionsError("invalid transcode dimensions") from e
    if w <= 0 or h <= 0:
        raise InvalidOptionsError("invalid transcode dimensions")
    try:
        quality = max(0, min(100, int(opts.get("quality",
                                               DEFAULT_QUALITY))))
        restart = int(opts.get("restartInterval",
                               opts.get("restart_interval", 0)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid transcode options") from e
    if restart < 0:  # same validation as encode(), path-independent
        raise InvalidOptionsError("restartInterval must be >= 0")
    progressive = bool(opts.get("progressive", False))
    copy_markers = bool(opts.get("copyMarkers",
                                 opts.get("copy_markers", False)))
    draft = bool(opts.get("draft", False))

    def finish(out):
        if copy_markers:
            return jpeg_markers.splice_markers(
                out, jpeg_markers.copyable_markers(bytes(buf)))
        return out

    fname, fscale = parse_resize_options(opts)
    if not progressive:  # the raw-domain fast path emits baseline scans
        if draft:
            # opt-in (like decode's scaleDenom): for any target <=
            # source/2, the scale_denom=2 raw decode + fitted Y
            # correction (composed with the remaining resize for
            # sub-half targets) — chroma stays exact; ~0.6-0.9 LSB of
            # the exact path at the lowest cost of any config
            # (ops/raw420.py transcode_raw420_draft)
            from ..ops.raw420 import transcode_raw420_draft

            out = transcode_raw420_draft(buf, w, h, fname, fscale,
                                         quality, restart=restart)
            if out is not None:
                return finish(out)
        out = transcode_raw420(buf, w, h, fname, fscale, quality,
                               restart=restart)
        if out is not None:
            return finish(out)
    from ..ops.resize import resize_image

    img = decode(buf, {})
    small = resize_image(img, {"width": w, "height": h,
                               **{k: opts[k] for k in
                                  ("filter", "filterScale", "filter_scale")
                                  if k in opts}})
    return finish(encode(small, {"quality": quality,
                                 "restartInterval": restart,
                                 "progressive": progressive}))


def transform(buf: bytes, opts: dict) -> bytes:
    """Lossless coefficient-domain transform (beyond-reference API;
    jpegtran's feature class — see ops/jpeg_transform.py for the math
    and the trim semantics).

    opts: op ('transpose' | 'fliph' | 'flipv' | 'rot90' | 'rot180' |
    'rot270' | 'transverse' | 'crop' | 'autoOrient'), perfect (raise
    instead of iMCU-snapping, default False), optimize
    (Huffman-optimized output scan), restartInterval; crop additionally
    takes x, y, width, height (origin snaps down to the iMCU grid,
    jpegtran -crop). 'autoOrient' reads the EXIF orientation and
    applies the lossless transform that makes the image upright
    (no-op passthrough when already upright or untagged).

    copyMarkers (default False): carry the source's COM/APP1..APP15
    metadata segments (EXIF, ICC, XMP) into the output, jpegtran
    -copy all semantics; autoOrient additionally resets the copied
    EXIF orientation tag to 1 so viewers don't rotate twice."""
    from ..ops.jpeg_transform import (OPS, crop_coefficients,
                                      transform_coefficients)
    from . import jpeg_markers

    # validate the options BEFORE the entropy decode (the dominant
    # cost) so invalid requests fail for free
    op = opts.get("op")
    copy_markers = bool(opts.get("copyMarkers",
                                 opts.get("copy_markers", False)))
    auto_oriented = False
    if op in ("autoOrient", "auto_orient"):
        orient = jpeg_markers.exif_orientation(bytes(buf))
        op = jpeg_markers.ORIENT_OPS.get(orient or 1)
        if op is None:
            return bytes(buf)  # already upright: lossless passthrough
        auto_oriented = True
    if op != "crop" and op not in OPS:
        raise InvalidOptionsError(
            f"unknown transform op {op!r}; one of "
            f"{sorted(OPS) + ['crop', 'autoOrient']}")
    perfect = bool(opts.get("perfect", False))
    try:
        restart = int(opts.get("restartInterval",
                               opts.get("restart_interval", 0)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid transform options") from e
    if restart < 0:
        raise InvalidOptionsError("restartInterval must be >= 0")
    if op == "crop":
        try:
            x, y = int(opts.get("x", 0)), int(opts.get("y", 0))
            w, h = int(opts["width"]), int(opts["height"])
        except KeyError as e:
            raise InvalidOptionsError("crop requires width and height") \
                from e
        except (TypeError, ValueError) as e:
            raise InvalidOptionsError("invalid crop geometry") from e
    co = native.jpeg_coefficients(bytes(buf))
    if op == "crop":
        w, h, comps = crop_coefficients(co, x, y, w, h, perfect)
    else:
        w, h, comps = transform_coefficients(co, op, perfect)
    # preserve the source colorspace tag: RGB-tagged files (Adobe
    # transform=0 / 'R','G','B' ids) must come back out RGB-tagged or
    # decoders would apply the YCbCr matrix to untransformed planes
    out = native.jpeg_coef_write(
        w, h, comps, optimize_huffman=bool(opts.get("optimize", False)),
        restart=restart, color_space=co.color_space)
    if copy_markers:
        segs = jpeg_markers.copyable_markers(bytes(buf))
        if auto_oriented:
            segs = jpeg_markers.reset_exif_orientation(segs)
        out = jpeg_markers.splice_markers(out, segs)
    return out


class JpegCodec:
    mimetype = "image/jpeg"
    encodes = ["rgb", "grey"]  # jpegcodec.cc:512-514

    @staticmethod
    def stat(buf):
        return stat(bytes(buf))

    @staticmethod
    def decode_sync(buf, opts):
        return decode(buf, opts)

    @staticmethod
    def encode_sync(img, opts):
        return encode(img, opts)


CODEC = JpegCodec()
