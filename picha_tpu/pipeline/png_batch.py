"""Batched PNG pipeline: host inflate+unfilter, spec transforms on the device.

SURVEY.md §7 step 4 splits PNG decode into the serial stages (inflate,
filter reconstruction — host, native/pngfilter.cc) and the pixel
transforms (palette lookup, sub-byte expansion, tRNS alpha, grey<->rgb,
depth moves — reference pngcodec.cc:138-168), which are pure array maps
and run batched under jit here. Images are bucketed by
(width, height, bit_depth, colour_type) — same-signature batches share
one compiled transform graph, mirroring the JPEG pipeline's buckets.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..codecs import png as png_codec
from ..pixels import pixel_format


def host_stage(buf: bytes):
    """bytes -> (header, raw samples (H, W, C) ints, palette, trns).

    Inflate + unfilter + bit unpacking on the host (the row-sequential
    parts); value transforms stay untouched for the device stage."""
    buf = bytes(buf)
    h = png_codec._parse_header(buf)
    samples, palette, trns = png_codec._decode_samples(buf, h)
    return h, samples, palette, trns


def signature(h) -> tuple:
    return (h.width, h.height, h.bit_depth, h.color_type)


@functools.lru_cache(maxsize=128)
def _jit_transform(sig: tuple, target: str, has_trns_alpha: bool):
    """Device transform graph for one (geometry, colour-type) bucket.

    Implements the same mapping as png._to_target for the batched case
    (palette -> rgb via take, grey replication / BT.709 fixed-point
    luma, alpha synthesis, 16->8 high-byte chop)."""
    import jax
    import jax.numpy as jnp

    width, height, bit_depth, color_type = sig
    fmt = pixel_format(target)

    def fn(samples, palette, trns_alpha):
        depth = bit_depth
        alpha = None
        if color_type == png_codec.CT_PALETTE:
            idx = samples[..., 0]
            rgb = jnp.take(palette, idx, axis=0)  # (N,H,W,3)
            if has_trns_alpha:
                alpha = jnp.take(trns_alpha, idx, axis=0)
            color = rgb
            depth = 8
        else:
            if color_type == png_codec.CT_GREY and bit_depth < 8:
                factor = 255 // ((1 << bit_depth) - 1)
                samples = (samples * factor).astype(jnp.uint8)
                depth = 8
            if color_type in (png_codec.CT_GREYA, png_codec.CT_RGBA):
                alpha = samples[..., -1]
                color = samples[..., :-1]
            else:
                color = samples

        maxval = 65535 if depth == 16 else 255
        if fmt.is_color and color.shape[-1] == 1:
            color = jnp.repeat(color, 3, axis=-1)
        elif not fmt.is_color and color.shape[-1] == 3:
            r = color[..., 0].astype(jnp.uint32)
            g = color[..., 1].astype(jnp.uint32)
            b = color[..., 2].astype(jnp.uint32)
            grey = (png_codec._GREY_R * r + png_codec._GREY_G * g
                    + png_codec._GREY_B * b + 16384) >> 15
            color = grey.astype(color.dtype)[..., None]

        if fmt.has_alpha:
            if alpha is None:
                alpha = jnp.full(color.shape[:-1], maxval, color.dtype)
            out = jnp.concatenate([color, alpha[..., None].astype(color.dtype)],
                                  axis=-1)
        else:
            out = color
        if fmt.is_deep:
            return out.astype(jnp.uint16)
        if depth == 16:
            out = (out >> 8).astype(jnp.uint8)
        return out.astype(jnp.uint8)

    return jax.jit(fn)


class PngBatchPipeline:
    """Batched PNG decode: host serial stages on pool threads, spec
    transforms (+ downstream crop/resize via ImageBatchPipeline-style
    composition) on device.

    >>> out = PngBatchPipeline()(png_bytes_list)     # (N, H, W, C)
    """

    def __init__(self, pixel: Optional[str] = None, deep: bool = False,
                 num_threads: int = 8):
        self.pixel = pixel
        self.deep = deep
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="picha-png")

    def __call__(self, bufs: Sequence[bytes]):
        import jax.numpy as jnp

        parts = list(self._pool.map(host_stage, bufs))
        sigs = {signature(h) for h, *_ in parts}
        if len(sigs) != 1:
            raise ValueError("mixed PNG signatures; bucket inputs first")
        h0 = parts[0][0]
        target = png_codec._resolve_pixel(h0, self.pixel, self.deep)

        samples = np.stack([s for _, s, _, _ in parts])
        # palette/tRNS are small per-image tables; absent ones become
        # identity/opaque so one graph serves the bucket
        if h0.color_type == png_codec.CT_PALETTE:
            pal = np.zeros((len(parts), 256, 3), np.uint8)
            ta = np.full((len(parts), 256), 255, np.uint8)
            has_trns = any(t is not None for _, _, _, t in parts)
            for i, (_, _, p, t) in enumerate(parts):
                if p is None:
                    raise png_codec.CodecError("palette PNG missing PLTE")
                # crafted files can carry >256 PLTE entries / tRNS
                # bytes; clamp instead of a raw broadcast ValueError
                pal[i, : min(256, p.shape[0])] = p[:256]
                if t is not None:
                    tv = np.frombuffer(t, np.uint8)[:256]
                    ta[i, : tv.size] = tv
            # per-image tables -> flat take via offset indices
            fn = _jit_transform(signature(h0), target, has_trns)
            n = len(parts)
            flat_pal = pal.reshape(-1, 3)
            flat_ta = ta.reshape(-1)
            offs = (np.arange(n, dtype=np.int32) * 256)[:, None, None]
            idx = samples[..., 0].astype(np.int32) + offs
            return fn(idx[..., None], jnp.asarray(flat_pal),
                      jnp.asarray(flat_ta))
        if any(t is not None for _, _, _, t in parts):
            # colour-key tRNS (exact-match alpha) is rare; use the exact
            # single-image transform per item and stack
            out = np.stack([
                png_codec._to_target(s, hh, p, t, target)
                for hh, s, p, t in parts])
            return jnp.asarray(out)
        fn = _jit_transform(signature(h0), target, False)
        return fn(samples, jnp.zeros((1, 3), np.uint8),
                  jnp.zeros((1,), np.uint8))


def encode_filtered(batch: np.ndarray, level: int = 4,
                    strategy=None) -> list:
    """Batched PNG encode with the FILTER pass on device: one jit
    filters (and adaptively searches) every image of an rgb/rgba/grey
    uint8 batch (ops/png_filter_tpu.py — the encode direction has no
    serial recurrence, unlike unfiltering), then the host runs only
    deflate + chunk assembly per image.

    strategy None reproduces the codec default exactly: the device
    emits the up/sub/MSD candidate streams and the host applies the
    same contiguous-block l1-deflate probe the single-image encoder
    uses (codecs/png.py _probe_filter), so outputs are byte-identical
    to `encodePngSync` image by image. An int 0..4/-1 pins one
    strategy. The reference ran this whole pass inside libpng on the
    host (pngcodec.cc:391-392)."""
    import struct

    from ..codecs.png import PNG_SIGNATURE, _chunk
    from ..native import lib as native
    from ..ops.png_filter_tpu import filter_batch

    if batch.ndim != 4 or batch.dtype != np.uint8:
        raise ValueError("encode_filtered expects (N, H, W, C) uint8")
    n, h, w, ch = batch.shape
    rows = batch.reshape(n, h, w * ch)
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rb = w * ch

    if strategy is None and h >= 16 and h * (rb + 1) >= (1 << 16):
        cands = [np.asarray(filter_batch(rows, ch, s)) for s in (2, 1, -1)]
        n_blk = max(8, h // 8)
        r0 = (h - n_blk) // 2
        chosen = []
        for i in range(n):
            best = None
            for f in cands:
                sample = np.ascontiguousarray(f[i, r0:r0 + n_blk])
                est = len(native.zlib_deflate(sample, 1))
                if best is None or est < best[0] * 0.995:
                    best = (est, f[i])
            chosen.append(best[1])
    else:
        s = -1 if strategy is None else int(strategy)
        filt = np.asarray(filter_batch(rows, ch, s))
        chosen = [filt[i] for i in range(n)]

    out = []
    for i in range(n):
        idat = native.zlib_deflate(
            np.ascontiguousarray(chosen[i]).reshape(-1), level)
        ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
        out.append(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                   + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
    return out
