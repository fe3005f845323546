"""Pixel-format model.

The eight pixel formats of the reference (src/picha.h:79-92) with their
byte/channel geometry (src/picha.h:118-172) and the normalised-float
pack/unpack numerics (src/picha.h:96-114):

  unpack: u / MAX                      (linear scale to [0, 1])
  pack:   floor(clip(f * MAX + 0.5, 0, MAX))   (round-half-up, clamp)

The reference JS layer had a typo ('r16b16' for 'r16g16',
lib/image.js:31) which made the r16g16 format unconstructible from JS;
per SURVEY.md appendix we implement the intended 'r16g16'.

Everything here is host-side metadata plus numpy/JAX packing helpers.
The JAX versions pin exact round-half-up semantics so the device path is
bit-identical to the CPU path (SURVEY.md §7 "hard parts" (a)).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .errors import InvalidOptionsError


@dataclasses.dataclass(frozen=True)
class PixelFormat:
    name: str
    bytes_per_pixel: int
    channels: int
    dtype: np.dtype  # per-channel storage dtype

    @property
    def max_value(self) -> int:
        return int(np.iinfo(self.dtype).max)

    @property
    def is_deep(self) -> bool:
        return self.dtype == np.uint16

    @property
    def has_alpha(self) -> bool:
        return self.channels in (2, 4)

    @property
    def is_color(self) -> bool:
        return self.channels in (3, 4)


_U8 = np.dtype(np.uint8)
_U16 = np.dtype(np.uint16)

PIXEL_FORMATS: dict[str, PixelFormat] = {
    "rgb": PixelFormat("rgb", 3, 3, _U8),
    "rgba": PixelFormat("rgba", 4, 4, _U8),
    "grey": PixelFormat("grey", 1, 1, _U8),
    "greya": PixelFormat("greya", 2, 2, _U8),
    "r16": PixelFormat("r16", 2, 1, _U16),
    "r16g16": PixelFormat("r16g16", 4, 2, _U16),
    "r16g16b16": PixelFormat("r16g16b16", 6, 3, _U16),
    "r16g16b16a16": PixelFormat("r16g16b16a16", 8, 4, _U16),
}

# 8-bit <-> deep (16-bit) pairings by channel count.
DEEP_OF = {"grey": "r16", "greya": "r16g16", "rgb": "r16g16b16", "rgba": "r16g16b16a16"}
SHALLOW_OF = {v: k for k, v in DEEP_OF.items()}


def pixel_format(name: str) -> PixelFormat:
    try:
        return PIXEL_FORMATS[name]
    except KeyError:
        raise InvalidOptionsError(f"invalid pixel format {name}") from None


def pixel_size(name: str) -> int:
    """Bytes per pixel, 0 for unknown names (reference lib/image.js:34-36)."""
    fmt = PIXEL_FORMATS.get(name)
    return fmt.bytes_per_pixel if fmt else 0


def pixel_channels(name: str) -> int:
    fmt = PIXEL_FORMATS.get(name)
    return fmt.channels if fmt else 0


# ---------------------------------------------------------------------------
# numpy pack/unpack (host reference path)
# ---------------------------------------------------------------------------

def unpack_f32(channels: np.ndarray) -> np.ndarray:
    """Integer channel array -> float32 in [0, 1] (src/picha.h:98-105)."""
    maxv = np.float32(np.iinfo(channels.dtype).max)
    return channels.astype(np.float32) / maxv


def pack_f32(values: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Float [0,1] array -> integer channels, round-half-up with clamp
    (src/picha.h:107-114: T(max(0, min(MAX, v*MAX + 0.5))) — C truncation
    after a clamp to [0, MAX] is floor)."""
    maxv = np.float32(np.iinfo(dtype).max)
    scaled = values.astype(np.float32) * maxv + np.float32(0.5)
    return np.floor(np.clip(scaled, 0.0, maxv)).astype(dtype)


# ---------------------------------------------------------------------------
# JAX pack/unpack (device path) — lazily imported so the host-only surface
# works without initialising a backend.
# ---------------------------------------------------------------------------

def junpack_f32(channels):
    import jax.numpy as jnp

    maxv = jnp.float32(np.iinfo(np.dtype(channels.dtype)).max)
    return channels.astype(jnp.float32) / maxv


def jpack(values, dtype):
    import jax.numpy as jnp

    maxv = float(np.iinfo(np.dtype(dtype)).max)
    scaled = values.astype(jnp.float32) * jnp.float32(maxv) + jnp.float32(0.5)
    return jnp.floor(jnp.clip(scaled, 0.0, maxv)).astype(dtype)
