"""Batched PNG encode-side filtering + adaptive search on the device.

The reference runs PNG filtering inside libpng on the host
(pngcodec.cc:391-392 -> png_write_image); our host path mirrors it in
AVX2 (native/src/pngfilter.cc). This op is the device-native form for
BATCHED encodes: unlike UNfiltering (whose sub/paeth left-dependency
is a serial recurrence), the encode direction predicts every byte from
the ORIGINAL source neighbours, so all five filters and the per-row
adaptive search vectorize over (N, H, RB) with no scan at all — pure
shifted subtracts, an |int8| row reduction, and a 5-way select.

Bit-exact contract: byte-identical to `native.png_filter` for every
strategy, including the adaptive tie-break (first minimal filter in
type order, strict-< like pngfilter.cc row_cost/best_cost). Pinned by
tests/test_png_filter_tpu.py across filter types, bpp widths, and
first-row edge semantics.

Deployment note: the batched filter+search offloads the host's filter
pass at the cost of a raw-frame round trip to the device. The host
path stays the default until a measurement on the card says otherwise
(not measured on the H100); the op is wired as
`PngBatchPipeline.filter_batch` for batch consumers.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def _build(shape: tuple, bpp: int, strategy: int):
    import jax
    import jax.numpy as jnp

    N, H, RB = shape

    def filters(x):
        # neighbours in the ORIGINAL-source domain (filter_row reads
        # `in`/`prev` = unfiltered rows; first row's prev is zeros)
        xi = x.astype(jnp.int32)
        a = jnp.pad(xi[:, :, :-bpp], ((0, 0), (0, 0), (bpp, 0))) \
            if bpp < RB else jnp.zeros_like(xi)
        b = jnp.pad(xi[:, :-1, :], ((0, 0), (1, 0), (0, 0)))
        c = jnp.pad(xi[:, :-1, :-bpp], ((0, 0), (1, 0), (bpp, 0))) \
            if bpp < RB else jnp.zeros_like(xi)
        # paeth predictor (pngfilter.cc paeth_predict): ties a<=b<=c
        p = a + b - c
        pa, pb, pc = jnp.abs(p - a), jnp.abs(p - b), jnp.abs(p - c)
        paeth = jnp.where((pa <= pb) & (pa <= pc), a,
                          jnp.where(pb <= pc, b, c))
        preds = (jnp.zeros_like(xi), a, b, (a + b) >> 1, paeth)
        return [((xi - pr) & 0xFF).astype(jnp.uint8) for pr in preds]

    def fn(x):
        res = filters(x)
        if 0 <= strategy <= 4:
            out = res[strategy]
            tb = jnp.full((N, H, 1), strategy, jnp.uint8)
            return jnp.concatenate([tb, out], axis=2)
        # adaptive: minimise sum of |int8(residual)| per row; strict-<
        # scan order 0..4 => argmin's first-minimum matches the C
        stacked = jnp.stack(res)                       # (5, N, H, RB)
        v = stacked.astype(jnp.int32)
        cost = jnp.sum(jnp.minimum(v, 256 - v) * (v > 0), axis=3)
        best = jnp.argmin(cost, axis=0).astype(jnp.uint8)   # (N, H)
        oh = best[None] == jnp.arange(5, dtype=jnp.uint8)[:, None, None]
        out = jnp.sum(jnp.where(oh[..., None], stacked, 0),
                      axis=0).astype(jnp.uint8)
        return jnp.concatenate([best[:, :, None], out], axis=2)

    return jax.jit(fn)


def filter_batch(batch: np.ndarray, bpp: int, strategy: int = -1):
    """(N, H, RB) uint8 source rows -> (N, H, RB+1) uint8 filtered rows
    (type byte + residuals), byte-identical to native.png_filter run
    per image. strategy: -1 adaptive (MSD heuristic) or 0..4 fixed."""
    if batch.ndim != 3 or batch.dtype != np.uint8:
        raise ValueError("filter_batch expects (N, H, RB) uint8")
    if not (-1 <= strategy <= 4):
        raise ValueError("strategy must be -1 (adaptive) or 0..4")
    fn = _build(batch.shape, int(bpp), int(strategy))
    return fn(batch)
