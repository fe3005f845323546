"""picha_tpu — a device-native image pipeline with the capabilities of
jhs67/picha.

Public surface mirrors the reference (index.js:1-233): ``Image``,
``catalog``, format-sniffing ``stat``/``decode``/``decodeSync``,
per-format ``stat*/decode*(Sync)/encode*(Sync)``, ``resize(Sync)``,
``colorConvert(Sync)`` — plus the batched device pipeline API under
``picha_tpu.pipeline`` which is where the throughput lives.

Async convention: ``op(args..., cb)`` where ``cb(err, result)`` runs on
a pool thread (reference used libuv workers); every async op also
returns a concurrent.futures.Future.
"""
from __future__ import annotations

from typing import Callable, Optional

from . import catalog as _catalog_mod
from .errors import (CodecError, InvalidImageError, InvalidOptionsError,
                     PichaError, UnsupportedFormatError)
from .image import Image
from .ops.colorconvert import color_convert_image
from .ops.resize import resize_image
from .runtime.executor import run_async

__version__ = "0.4.0"  # keep in sync with pyproject.toml: this value
# keys the stream_best race cache (pipeline/serving.py), so a stale
# version would let new-kernel deployments inherit an old winner

__all__ = [
    "Image", "catalog", "PichaError", "InvalidImageError",
    "InvalidOptionsError", "UnsupportedFormatError", "CodecError",
    "resize", "resizeSync", "resize_sync",
    "colorConvert", "colorConvertSync", "color_convert", "color_convert_sync",
    "stat", "decode", "decodeSync", "decode_sync",
]

_catalog_mod.load_default_codecs()
catalog = _catalog_mod.catalog


# ---------------------------------------------------------------------------
# resize / colorConvert (index.js:13-33)
# ---------------------------------------------------------------------------

def resize_sync(img: Image, opts: dict) -> Image:
    return resize_image(img, opts)


def resize(img: Image, opts: dict, cb: Optional[Callable] = None):
    return run_async(lambda: resize_image(img, opts), cb)


def color_convert_sync(img: Image, opts: dict) -> Image:
    return color_convert_image(img, opts)


def color_convert(img: Image, opts: dict, cb: Optional[Callable] = None):
    return run_async(lambda: color_convert_image(img, opts), cb)


resizeSync = resize_sync
colorConvert = color_convert
colorConvertSync = color_convert_sync


# ---------------------------------------------------------------------------
# Encode-format negotiation (index.js:37-72).
# The reference's isSupported had an operator-precedence bug that made
# auto-conversion dead (index.js:48-50); we implement the intended
# membership test (SURVEY.md appendix).
# ---------------------------------------------------------------------------

SUPPORTED_MAP = {
    "rgb": ["rgba", "r16g16b16", "r16g16b16a16", "grey", "greya", "r16"],
    "rgba": ["r16g16b16a16", "rgb", "r16g16b16", "greya", "r16g16", "grey"],
    "grey": ["greya", "r16", "rgb", "rgba", "r16g16", "r16g16b16"],
    "greya": ["r16g16", "rgba", "r16g16b16a16", "grey", "r16", "rgb"],
    "r16": ["r16g16", "r16g16b16", "r16g16b16a16", "grey", "greya", "rgb"],
    "r16g16": ["r16g16b16", "r16g16b16a16", "greya", "r16", "grey", "rgb"],
    "r16g16b16": ["r16g16b16a16", "rgb", "rgba", "grey", "greya", "r16"],
    "r16g16b16a16": ["rgba", "r16g16b16", "rgb", "greya", "r16g16", "r16"],
}


def choose_supported(pixel: str, encodes: list) -> str:
    prefs = SUPPORTED_MAP.get(pixel)
    if prefs is None:
        raise InvalidOptionsError(f"invalid pixel format: {pixel}")
    for p in prefs:
        if p in encodes:
            return p
    return encodes[0]


def to_supported_sync(img: Image, encodes: list) -> Image:
    if img.pixel in encodes:
        return img
    return color_convert_sync(img, {"pixel": choose_supported(img.pixel, encodes)})


# ---------------------------------------------------------------------------
# Per-format API assembly (index.js:76-196)
# ---------------------------------------------------------------------------

def _make_format_api(mimetype: str, name: str):
    codec = catalog.get(mimetype)
    if codec is None:
        return
    g = globals()

    from .runtime import metrics

    def stat_fn(buf):
        return codec.stat(bytes(buf) if not isinstance(buf, (bytes, bytearray)) else buf)

    def decode_sync_fn(buf, opts: Optional[dict] = None) -> Image:
        metrics.count(f"decode.{name.lower()}")
        metrics.count("bytes_in", len(buf))
        with metrics.timer(f"decode.{name.lower()}"):
            return codec.decode_sync(buf, opts or {})

    def decode_fn(buf, opts=None, cb=None):
        if callable(opts):
            cb, opts = opts, None
        # through the sync wrapper so metrics count async traffic too
        return run_async(lambda: decode_sync_fn(buf, opts), cb)

    def encode_sync_fn(img: Image, opts: Optional[dict] = None) -> bytes:
        metrics.count(f"encode.{name.lower()}")
        with metrics.timer(f"encode.{name.lower()}"):
            out = codec.encode_sync(to_supported_sync(img, codec.encodes),
                                    opts or {})
        metrics.count("bytes_out", len(out))
        return out

    def encode_fn(img, opts=None, cb=None):
        if callable(opts):
            cb, opts = opts, None
        return run_async(lambda: encode_sync_fn(img, opts), cb)

    g[f"stat{name}"] = stat_fn
    g[f"decode{name}"] = decode_fn
    g[f"decode{name}Sync"] = decode_sync_fn
    g[f"encode{name}"] = encode_fn
    g[f"encode{name}Sync"] = encode_sync_fn
    # snake_case aliases
    lower = name.lower()
    g[f"stat_{lower}"] = stat_fn
    g[f"decode_{lower}"] = decode_fn
    g[f"decode_{lower}_sync"] = decode_sync_fn
    g[f"encode_{lower}"] = encode_fn
    g[f"encode_{lower}_sync"] = encode_sync_fn
    g[f"{lower}Encodes"] = codec.encodes
    __all__.extend([f"stat{name}", f"decode{name}", f"decode{name}Sync",
                    f"encode{name}", f"encode{name}Sync"])


_make_format_api("image/jpeg", "Jpeg")
_make_format_api("image/png", "Png")
_make_format_api("image/tiff", "Tiff")
_make_format_api("image/webp", "WebP")

if "image/jpeg" in catalog:
    def transcodeJpegSync(buf, opts: dict) -> bytes:
        """One-call JPEG -> resized JPEG (beyond-reference API; see
        codecs/jpeg.py transcode): the raw-domain fast path for 4:2:0
        sources, decode->resize->encode fallback otherwise."""
        from .codecs import jpeg as _jpeg
        from .runtime import metrics

        metrics.count("transcode.jpeg")
        metrics.count("bytes_in", len(buf))
        with metrics.timer("transcode.jpeg"):
            out = _jpeg.transcode(bytes(buf), opts)
        metrics.count("bytes_out", len(out))
        return out

    def transcodeJpeg(buf, opts=None, cb=None):
        if callable(opts):
            cb, opts = opts, None
        return run_async(lambda: transcodeJpegSync(buf, opts or {}), cb)

    transcode_jpeg_sync = transcodeJpegSync
    transcode_jpeg = transcodeJpeg
    __all__.extend(["transcodeJpeg", "transcodeJpegSync"])

    def transformJpegSync(buf, opts: dict) -> bytes:
        """Lossless coefficient-domain transform (beyond-reference API;
        jpegtran's feature class): transpose / fliph / flipv / rot90 /
        rot180 / rot270 / transverse / crop / autoOrient (EXIF) without
        requantisation; copyMarkers carries EXIF/ICC/XMP through. See
        codecs/jpeg.py transform and ops/jpeg_transform.py."""
        from .codecs import jpeg as _jpeg
        from .runtime import metrics

        metrics.count("transform.jpeg")
        metrics.count("bytes_in", len(buf))
        with metrics.timer("transform.jpeg"):
            out = _jpeg.transform(bytes(buf), opts)
        metrics.count("bytes_out", len(out))
        return out

    def transformJpeg(buf, opts=None, cb=None):
        if callable(opts):
            cb, opts = opts, None
        return run_async(lambda: transformJpegSync(buf, opts or {}), cb)

    transform_jpeg_sync = transformJpegSync
    transform_jpeg = transformJpeg
    __all__.extend(["transformJpeg", "transformJpegSync"])


# ---------------------------------------------------------------------------
# Format sniffing (index.js:200-233)
# ---------------------------------------------------------------------------

def stat(buf) -> Optional[dict]:
    for mimetype, codec in catalog.items():
        st = codec.stat(buf)
        if st:
            st["mimetype"] = mimetype
            return st
    return None


def decode_sync(buf, opts: Optional[dict] = None) -> Image:
    for codec in catalog.values():
        try:
            img = codec.decode_sync(buf, opts or {})
            if img is not None:
                return img
        except InvalidOptionsError:
            # deviation from the reference's fall-through (index.js:
            # 214-220): a codec that RECOGNIZED the buffer but rejected
            # the options must surface that, not be masked as
            # 'unsupported image file' (unknown keys are ignored by
            # every codec, so this only fires on genuinely bad values)
            raise
        except Exception:  # noqa: BLE001 — sniffing falls through (index.js:214-220)
            continue
    raise UnsupportedFormatError("unsupported image file")


def decode(buf, opts=None, cb=None):
    if callable(opts):
        cb, opts = opts, None
    return run_async(lambda: decode_sync(buf, opts), cb)


decodeSync = decode_sync
