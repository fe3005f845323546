"""WebP codec over the libwebp shim (native/webpshim.cc).

The reference linked libwebp for the full codec (src/webpcodec.cc);
VP8/VP8L entropy coding is host-serial so the shim does the same.
Parity surface:

  * decode to 'rgba' when the bitstream has alpha else 'rgb'
    (webpcodec.cc:63-67, 105-109); no other formats
  * encode accepts rgb/rgba (webpcodec.cc:399-401) with options:
    preset ('default', 'picture', 'photo', 'drawing', 'icon', 'text',
    'lossless'), quality (default 85), alphaQuality (default 100),
    exact flag; 'lossless' = default preset + lossless mode
    (webpcodec.cc:155-195); beyond-reference: method (0 fastest ..
    6 slowest/smallest, libwebp's speed/size trade), segments (1..4),
    alphaFiltering (0 none / 1 fast / 2 best)
  * stat -> {width, height, pixel} via WebPGetFeatures

DEFAULT deviation from the reference (measured, round 5): lossy
encodes default to method 3 instead of libwebp's method 4 — ~1.13x
the encode speed at +3.4% bytes (within the bench's ≤+5% honesty
gate), identical round-trip error (1.83-1.84 LSB both ways on the
bench corpus), and the alpha plane stays bit-exact at alphaQuality
100. Context: the alpha coder's effort follows `method` and costs
~64% of an RGBA encode on complex alpha, so `method` is the one knob
that moves both planes. `{"method": 4}` reproduces the reference's
exact default behavior; the lossless preset keeps libwebp's own
defaults.
"""
from __future__ import annotations

import operator

from ..errors import CodecError, InvalidOptionsError
from ..image import Image
from ..native import lib as native

if not native.webp_available():
    # catalog.load_default_codecs reports this as "codec unavailable"
    raise ImportError("the native library was built without libwebp")

_PRESETS = {"default": 0, "picture": 1, "photo": 2, "drawing": 3,
            "icon": 4, "text": 5, "lossless": 0}

DEFAULT_QUALITY = 85.0  # webpcodec.cc:156
DEFAULT_ALPHA_QUALITY = 100  # webpcodec.cc:188-189


def stat(buf: bytes):
    st = native.webp_stat(bytes(buf))
    if st is None:
        return None
    w, h, has_alpha = st
    return {"width": w, "height": h, "pixel": "rgba" if has_alpha else "rgb"}


def decode(buf: bytes, opts: dict) -> Image:
    buf = bytes(buf)
    st = native.webp_stat(buf)
    if st is None:
        raise CodecError("not a WebP file")
    w, h, has_alpha = st
    channels = 4 if has_alpha else 3
    arr = native.webp_decode(buf, channels, w, h)
    return Image.from_array(arr, "rgba" if has_alpha else "rgb")


def encode(img: Image, opts: dict) -> bytes:
    if img.pixel not in ("rgb", "rgba"):
        raise InvalidOptionsError(
            f"webp encode supports rgb/rgba, got {img.pixel}")
    preset_name = opts.get("preset", "default")
    if preset_name not in _PRESETS:
        raise InvalidOptionsError("invalid preset")
    try:
        quality = float(opts.get("quality", DEFAULT_QUALITY))
        alpha_quality = int(opts.get("alphaQuality",
                                     opts.get("alpha_quality",
                                              DEFAULT_ALPHA_QUALITY)))
    except (TypeError, ValueError) as e:
        raise InvalidOptionsError("invalid webp encode options") from e
    # clamp into libwebp's valid 0-100 range (like the jpeg codec's
    # quality clamp) instead of surfacing WebPValidateConfig's opaque
    # CodecError for an options mistake
    quality = max(0.0, min(100.0, quality))
    alpha_quality = max(0, min(100, alpha_quality))
    exact = bool(opts.get("exact", False))
    lossless = preset_name == "lossless"

    def int_opt(name, snake, lo, hi, default):
        v = opts.get(name, opts.get(snake, None))
        if v is None:
            return default
        # operator.index() accepts any integral type (incl. numpy ints,
        # matching the int() coercion of quality/alphaQuality) while
        # rejecting floats; bools are integral so exclude them explicitly
        if isinstance(v, bool):
            raise InvalidOptionsError(
                f"webp {name} must be an int in {lo}..{hi}")
        try:
            v = operator.index(v)
        except TypeError:
            raise InvalidOptionsError(
                f"webp {name} must be an int in {lo}..{hi}")
        if not lo <= v <= hi:
            raise InvalidOptionsError(
                f"webp {name} must be an int in {lo}..{hi}")
        return v

    # lossy default: method 3 (module docstring — measured deviation);
    # lossless keeps libwebp's own effort
    method = int_opt("method", "method", 0, 6,
                     -1 if lossless else 3)
    segments = int_opt("segments", "segments", 1, 4, -1)
    alpha_f = int_opt("alphaFiltering", "alpha_filtering", 0, 2, -1)
    return native.webp_encode(img.to_array(), _PRESETS[preset_name], quality,
                              alpha_quality, exact, lossless,
                              method, segments, alpha_f)


class WebPCodec:
    mimetype = "image/webp"
    encodes = ["rgb", "rgba"]  # webpcodec.cc:399-401

    @staticmethod
    def stat(buf):
        return stat(bytes(buf))

    @staticmethod
    def decode_sync(buf, opts):
        return decode(buf, opts)

    @staticmethod
    def encode_sync(img, opts):
        return encode(img, opts)


CODEC = WebPCodec()
