"""Pixel-format conversion.

Semantics follow the reference's channel-conversion table
(src/colorconvert.cc:24-134) over a normalised-float intermediate:

  unpack -> channel map -> pack

Channel rules:
  * grey replication 1->3/4 (cc:43-59)
  * luma reduction 3/4 -> 1/2 with weights r=.299 g=.587 b=.114
    (defaults colorconvert.h:12), renormalised to sum 1 (cc:18-21)
  * alpha synthesised as 1.0 where absent (cc:38, 57, 108)
  * alpha preserved by 2->4 (grey->rgb replicate + alpha, cc:78-85)
    and 4->2 (luma + alpha, cc:119-125)
  * alpha dropped on ->rgb (cc:127-134)

Deliberate deviation (SURVEY.md appendix): the reference's 2->3
(greya->rgb) produced ``[grey, alpha, 0]`` (cc:69-75) — an evident bug.
We implement grey replication ``[g, g, g]``.

The op is implemented once over a float32 (H, W, C) tensor, with numpy
and jax array namespaces interchangeable — XLA fuses the whole
unpack/map/pack chain into a single elementwise kernel on the device.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from ..errors import InvalidImageError, InvalidOptionsError
from ..image import Image
from ..pixels import pixel_format, pack_f32, unpack_f32

DEFAULT_WEIGHTS = (0.299, 0.587, 0.114)  # reference colorconvert.h:12


def normalize_weights(red=None, green=None, blue=None):
    """Apply defaults then renormalise to sum 1 (cc:6-22). Mirrors the
    reference's NaN handling exactly: getSettings keeps the default for
    a NaN weight (`if (d == d) s.rFactor = d`, cc:8-14) — propagating
    it would turn the luma (and the whole image) into NaN garbage.
    Non-numeric values raise the library's typed error like every
    other option path."""

    def coerce(v, default):
        if v is None:
            return default
        try:
            v = float(v)
        except (TypeError, ValueError) as e:
            raise InvalidOptionsError("invalid colour weight") from e
        return default if math.isnan(v) else v

    r = coerce(red, DEFAULT_WEIGHTS[0])
    g = coerce(green, DEFAULT_WEIGHTS[1])
    b = coerce(blue, DEFAULT_WEIGHTS[2])
    if r + g + b == 0:
        raise InvalidOptionsError("colour weights must not sum to zero")
    n = 1.0 / (r + g + b)
    # float32 to match the reference's float math (cc:18-21)
    return (np.float32(r * n), np.float32(g * n), np.float32(b * n))


def map_channels(x, src_channels: int, dst_channels: int, weights, xp):
    """Map a float (..., srcC) tensor to (..., dstC).

    `xp` is the array namespace (numpy or jax.numpy) so the same rules
    serve the host path and the jitted device path.
    """
    sc, dc = src_channels, dst_channels
    if sc == dc:
        return x

    def luma(t):
        r, g, b = weights
        return t[..., 0] * r + t[..., 1] * g + t[..., 2] * b

    def ones():
        # built lazily: on the numpy host path an unconditional
        # (H, W, 1) float allocation is pure wasted bandwidth for the
        # branches that never synthesize alpha (XLA would DCE it,
        # numpy cannot)
        return xp.ones_like(x[..., :1])

    if sc == 1:
        grey = x[..., 0:1]
        if dc == 2:
            return xp.concatenate([grey, ones()], axis=-1)
        if dc == 3:
            return xp.concatenate([grey, grey, grey], axis=-1)
        if dc == 4:
            return xp.concatenate([grey, grey, grey, ones()], axis=-1)
    elif sc == 2:
        grey, alpha = x[..., 0:1], x[..., 1:2]
        if dc == 1:
            return grey
        if dc == 3:
            # deviation from reference cc:69-75 ([g, a, 0]); see module doc
            return xp.concatenate([grey, grey, grey], axis=-1)
        if dc == 4:
            return xp.concatenate([grey, grey, grey, alpha], axis=-1)
    elif sc == 3:
        if dc == 1:
            return luma(x)[..., None]
        if dc == 2:
            return xp.concatenate([luma(x)[..., None], ones()], axis=-1)
        if dc == 4:
            return xp.concatenate([x, ones()], axis=-1)
    elif sc == 4:
        if dc == 1:
            return luma(x[..., :3])[..., None]
        if dc == 2:
            return xp.concatenate([luma(x[..., :3])[..., None], x[..., 3:4]], axis=-1)
        if dc == 3:
            return x[..., :3]
    raise InvalidOptionsError(f"no conversion {sc} -> {dc} channels")


def convert_array(arr: np.ndarray, dst_pixel: str, *, red_weight=None,
                  green_weight=None, blue_weight=None) -> np.ndarray:
    """Host path: (H, W, C) channel array -> converted channel array."""
    dst_fmt = pixel_format(dst_pixel)
    weights = normalize_weights(red_weight, green_weight, blue_weight)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    src_c = arr.shape[-1]
    if src_c == dst_fmt.channels and arr.dtype == dst_fmt.dtype:
        return arr.copy()
    f = unpack_f32(arr)
    out = map_channels(f, src_c, dst_fmt.channels, weights, np)
    return pack_f32(out, dst_fmt.dtype)


@functools.lru_cache(maxsize=None)
def _jit_convert(src_pixel: str, dst_pixel: str, weights):
    import jax
    import jax.numpy as jnp

    from ..pixels import jpack, junpack_f32

    src_fmt = pixel_format(src_pixel)
    dst_fmt = pixel_format(dst_pixel)

    def fn(arr):
        f = junpack_f32(arr)
        out = map_channels(f, src_fmt.channels, dst_fmt.channels, weights, jnp)
        return jpack(out, dst_fmt.dtype)

    return jax.jit(fn)


def convert_batch(arr, src_pixel: str, dst_pixel: str, *, red_weight=None,
                  green_weight=None, blue_weight=None):
    """device path: (..., H, W, C) batched conversion, jitted per format pair."""
    weights = normalize_weights(red_weight, green_weight, blue_weight)
    return _jit_convert(src_pixel, dst_pixel, weights)(arr)


def color_convert_image(img: Image, opts: dict) -> Image:
    """Image-level op matching the reference's colorConvert(Sync)
    (src/colorconvert.cc:155-188): same-format is a plain copy."""
    dst_pixel = opts.get("pixel")
    if dst_pixel is None:
        raise InvalidOptionsError("colorConvert requires opts['pixel']")
    if dst_pixel == img.pixel:
        return img.clone()
    src_fmt = img.format
    dst_fmt = pixel_format(dst_pixel)
    if src_fmt.channels == dst_fmt.channels and src_fmt.dtype == dst_fmt.dtype:
        # same geometry, different name cannot happen among the 8 formats
        raise InvalidImageError("inconsistent pixel formats")
    out = convert_array(
        img.to_array(), dst_pixel,
        red_weight=opts.get("redWeight", opts.get("red_weight")),
        green_weight=opts.get("greenWeight", opts.get("green_weight")),
        blue_weight=opts.get("blueWeight", opts.get("blue_weight")),
    )
    return Image.from_array(out, dst_pixel)
