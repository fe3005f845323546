"""Batched TIFF pipeline: host entropy decode, array transforms on the device.

SURVEY.md §7 step 6: replace pixel stages with device kernels
opportunistically. TIFF's per-image work splits into the serial
entropy stages (LZW / inflate / PackBits — host, native/src) and pure
array maps that batch under jit:

  predictor undo (cumsum over the row axis), 16-bit byte-order fold,
  sub-byte sample expansion (shift/mask), photometric transforms
  (grey invert / replicate, palette take, CMYK fold, YCbCr fixed
  point), alpha fill, orientation normalisation

mirroring the single-image path in codecs/tiff.py (reference decode:
TIFFReadRGBAImageOriented, /root/reference/src/tiffcodec.cc:130-137).
Images bucket by geometry signature like the JPEG/PNG pipelines;
layouts the device graph doesn't cover (tiles, planar, fax, JPEG,
subsampled YCbCr) fall back to the single-image host decoder.
"""
from __future__ import annotations

import functools
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..codecs import tiff as T
from ..errors import CodecError


def host_stage(buf: bytes, index: int = 0):
    """bytes -> (sig, rows (H, rowbytes) uint8, colormap or None), or
    ("fallback", rgba array) for layouts outside the device graph."""
    buf = bytes(buf)
    endian, ifds = T._parse_ifds(buf)
    if index < 0 or index >= len(ifds):
        raise CodecError("invalid directory index")
    ifd = ifds[index]
    try:
        return _host_stage_parsed(buf, endian, ifd, index)
    except (TypeError, ValueError) as e:
        # crafted tag types leak non-numeric values into arithmetic
        raise CodecError("malformed TIFF tags") from e


def _host_stage_parsed(buf, endian, ifd, index):
    width = int(ifd.one(T.T_WIDTH, 0))
    height = int(ifd.one(T.T_HEIGHT, 0))
    if width <= 0 or height <= 0:
        raise CodecError("bad TIFF dimensions")
    spp = int(ifd.one(T.T_SPP, 1))
    # same crafted-header caps as the single-image codec (tiff.py): a
    # 200-byte file claiming giant dims must fail typed before the
    # size-derived np.empty below
    if width > 1_000_000 or height > 1_000_000 \
            or spp <= 0 or width * height * spp > 2**31:
        raise CodecError("TIFF dimensions exceed limit")
    bits = int(ifd.get(T.T_BITS, [1])[0])
    comp = int(ifd.one(T.T_COMPRESSION, T.C_NONE))
    fillorder = int(ifd.one(T.T_FILLORDER, 1))
    photometric = int(ifd.one(T.T_PHOTOMETRIC, 1))
    planar = int(ifd.one(T.T_PLANAR, 1))
    predictor = int(ifd.one(T.T_PREDICTOR, 1))
    orientation = int(ifd.one(T.T_ORIENTATION, 1))
    subs = ifd.get(T.T_YCBCR_SUBSAMPLING, [2, 2]) if photometric == 6 else [1, 1]

    device_ok = (
        comp in (T.C_NONE, T.C_LZW, T.C_ADEFLATE, T.C_DEFLATE, T.C_PACKBITS)
        and planar == 1
        and T.T_TILE_OFFSETS not in ifd.tags
        and photometric in (0, 1, 2, 3, 5, 6)
        and bits in (1, 2, 4, 8, 16)
        and (photometric != 6 or list(subs)[:2] == [1, 1])
        # anything the device transform can't honor routes to the
        # single-image codec, which validates and raises typed errors
        # (predictor 3 would silently skip the undo; CMYK/RGB with too
        # few samples would IndexError inside the jit graph)
        and predictor in (1, 2)
        and not (photometric == 5 and spp < 4)
        and not (photometric == 2 and spp < 3)
    )
    if not device_ok:
        from ..codecs.tiff import decode as tiff_decode

        img = tiff_decode(buf, {"index": index})
        return ("fallback", img.to_array())

    offsets = ifd.get(T.T_STRIP_OFFSETS)
    if offsets is None:
        raise CodecError("TIFF missing strip offsets")
    rps = int(ifd.one(T.T_ROWS_PER_STRIP, height)) or height
    if rps < 1:
        # signed-overflow crafted values would run the strip loop zero
        # times and return the uninitialized np.empty canvas below
        raise CodecError("bad TIFF RowsPerStrip")
    counts = ifd.get(T.T_STRIP_COUNTS)
    nstrips = math.ceil(height / rps)
    rowbytes = (width * spp * bits + 7) // 8
    if counts is None:
        if comp != T.C_NONE:
            raise CodecError("TIFF missing StripByteCounts")
        counts = [rowbytes * min(rps, height - s * rps) for s in range(nstrips)]
    if len(counts) < nstrips or len(offsets) < nstrips:
        raise CodecError("TIFF strip tables too short")
    rows = np.empty((height, rowbytes), np.uint8)
    for s in range(nstrips):
        y0 = s * rps
        nrows = min(rps, height - y0)
        seg = buf[offsets[s] : offsets[s] + counts[s]]
        if fillorder == 2:
            seg = T._BITREV[np.frombuffer(seg, np.uint8)].tobytes()
        raw = T._decompress(seg, comp, rowbytes * nrows)
        if len(raw) < rowbytes * nrows:
            raise CodecError("TIFF strip too short")
        rows[y0 : y0 + nrows] = np.frombuffer(
            raw, np.uint8, rowbytes * nrows).reshape(nrows, rowbytes)

    extras = ifd.get(T.T_EXTRASAMPLES)
    sig = (width, height, spp, bits, photometric, predictor, orientation,
           endian, bool(extras))
    cmap = None
    if photometric == 3:
        cm = ifd.get(T.T_COLORMAP)
        if cm is None:
            raise CodecError("palette TIFF missing colormap")
        n = len(cm) // 3
        lut = (np.array(cm, dtype=np.uint32).reshape(3, n).T >> 8
               ).astype(np.uint8)
        cmap = np.zeros((1 << bits, 3), np.uint8)
        cmap[: lut.shape[0]] = lut[: 1 << bits]
    return (sig, rows, cmap)


def signature(item) -> tuple:
    return item[0]


@functools.lru_cache(maxsize=128)
def _jit_transform(sig: tuple):
    """(N, H, rowbytes) uint8 rows (+ palettes) -> (N, H', W', 4) rgba
    uint8, replicating codecs/tiff.py decode()'s array pipeline."""
    import jax
    import jax.numpy as jnp

    (width, height, spp, bits, photometric, predictor, orientation,
     endian, has_extras) = sig
    maxv = (1 << bits) - 1

    def fn(rows, cmaps):
        # -- samples ------------------------------------------------------
        if bits == 16:
            b = rows.reshape(rows.shape[0], height, -1, 2).astype(jnp.int32)
            hi, lo = (b[..., 1], b[..., 0]) if endian == "<" else \
                     (b[..., 0], b[..., 1])
            samples = (hi << 8) | lo
            samples = samples[:, :, : width * spp].reshape(
                -1, height, width, spp)
        elif bits == 8:
            samples = rows[:, :, : width * spp].reshape(
                -1, height, width, spp).astype(jnp.int32)
        else:
            per = 8 // bits
            shifts = jnp.arange(per - 1, -1, -1, dtype=jnp.int32) * bits
            ex = (rows[:, :, :, None].astype(jnp.int32) >> shifts) & maxv
            ex = ex.reshape(rows.shape[0], height, -1)
            samples = ex[:, :, : width * spp].reshape(-1, height, width, spp)
        if predictor == 2:
            wrap = (1 << bits) if bits in (8, 16) else None
            if wrap is None:
                raise CodecError("predictor unsupported for sub-byte samples")
            samples = jnp.cumsum(samples, axis=2) % wrap

        def to8(x):
            if bits == 16:
                return x >> 8
            if bits == 8:
                return x
            return (x * 255) // maxv

        # -- photometric --------------------------------------------------
        alpha = None
        if photometric in (0, 1):
            grey = to8(samples[..., 0])
            if photometric == 0:
                grey = 255 - grey
            rgb = jnp.repeat(grey[..., None], 3, axis=-1)
            if spp > 1 and has_extras:
                alpha = to8(samples[..., 1])
        elif photometric == 2:
            rgb = to8(samples[..., :3])
            if spp > 3:
                alpha = to8(samples[..., 3])
        elif photometric == 3:
            idx = samples[..., 0]
            rgb = jax.vmap(lambda lut, ix: jnp.take(lut, ix, axis=0))(
                cmaps, idx)
        elif photometric == 5:
            c8 = to8(samples[..., :4])
            c, m, y, k = (c8[..., i] for i in range(4))
            rgb = jnp.stack([(255 - c) * (255 - k) // 255,
                             (255 - m) * (255 - k) // 255,
                             (255 - y) * (255 - k) // 255], axis=-1)
            if spp > 4:
                alpha = to8(samples[..., 4])
        elif photometric == 6:
            y = samples[..., 0]
            cb = samples[..., 1] - 128
            cr = samples[..., 2] - 128
            r = y + ((91881 * cr + 32768) >> 16)
            g = y - ((22554 * cb + 46802 * cr + 32768) >> 16)
            b = y + ((116130 * cb + 32768) >> 16)
            rgb = jnp.clip(jnp.stack([r, g, b], -1), 0, 255)
        else:
            raise CodecError(f"unsupported TIFF photometric {photometric}")

        if alpha is None:
            alpha = jnp.full(rgb.shape[:-1], 255, jnp.int32)
        out = jnp.concatenate([rgb, alpha[..., None]], axis=-1)
        out = out.astype(jnp.uint8)
        # -- orientation (static per signature) ----------------------------
        if orientation == 2:
            out = out[:, :, ::-1]
        elif orientation == 3:
            out = out[:, ::-1, ::-1]
        elif orientation == 4:
            out = out[:, ::-1]
        elif orientation in (5, 6, 7, 8):
            out = out.transpose(0, 2, 1, 3)
            if orientation == 6:
                out = out[:, :, ::-1]
            elif orientation == 7:
                out = out[:, ::-1, ::-1]
            elif orientation == 8:
                out = out[:, ::-1]
        return out

    return jax.jit(fn)


class TiffBatchPipeline:
    """Batched TIFF decode to rgba, device transforms per bucket.

    >>> out = TiffBatchPipeline()(bufs)   # (N, H, W, 4) uint8
    """

    def __init__(self, index: int = 0, num_threads: Optional[int] = None):
        self.index = index
        self._pool = ThreadPoolExecutor(max_workers=num_threads or 8,
                                        thread_name_prefix="picha-tiff")

    def __call__(self, bufs: Sequence[bytes]):
        items = list(self._pool.map(
            lambda b: host_stage(b, self.index), bufs))
        sigs = {it[0] for it in items}
        if len(sigs) != 1:
            raise ValueError(
                "mixed-signature batch; group by tiff_batch.signature first")
        if items[0][0] == "fallback":
            return np.stack([it[1] for it in items])
        sig = items[0][0]
        rows = np.stack([it[1] for it in items])
        if items[0][2] is not None:
            cmaps = np.stack([it[2] for it in items])
        else:
            cmaps = np.zeros((len(items), 1, 3), np.uint8)
        return _jit_transform(sig)(rows, cmaps)
