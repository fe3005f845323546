"""ctypes bindings over libpicha_native.so.

ctypes releases the GIL for the duration of each foreign call, so the
runtime's pool threads (runtime/executor.py) get real host parallelism
for entropy stages — the replacement for the reference's libuv
worker pattern.
"""
from __future__ import annotations

import ctypes as C
import threading

import numpy as np

from ..errors import CodecError
from . import build as _build

_lock = threading.Lock()
_lib = None


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(C.POINTER(C.c_uint8))


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = C.CDLL(str(_build.build()))
            except OSError:
                # built on another host, against libraries this one
                # lacks: rebuild here
                lib = C.CDLL(str(_build.build(force=True)))

            lib.picha_free.argtypes = [C.c_void_p]
            lib.picha_free.restype = None

            lib.picha_png_unfilter.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
                C.c_int, C.c_int, C.c_int]
            lib.picha_png_unfilter.restype = C.c_int
            lib.picha_png_filter.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
                C.c_int, C.c_int, C.c_int, C.c_int]
            lib.picha_png_filter.restype = C.c_int

            lib.picha_zlib_inflate.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.c_uint8), C.c_size_t, C.POINTER(C.c_size_t)]
            lib.picha_zlib_inflate.restype = C.c_int
            lib.picha_zlib_deflate.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.c_int,
                C.POINTER(C.c_uint8), C.c_size_t]
            lib.picha_zlib_deflate.restype = C.c_longlong
            lib.picha_zlib_deflate_bound.argtypes = [C.c_size_t, C.c_int]
            lib.picha_zlib_deflate_bound.restype = C.c_size_t
            try:  # stale .so from an older build may lack the symbol
                lib.picha_crc32.argtypes = [
                    C.c_uint32, C.POINTER(C.c_uint8), C.c_size_t]
                lib.picha_crc32.restype = C.c_longlong
            except AttributeError:
                pass

            lib.picha_jpeg_stat.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int)]
            lib.picha_jpeg_stat.restype = C.c_int
            lib.picha_jpeg_decode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.c_int, C.c_int,
                C.POINTER(C.c_uint8), C.c_int, C.POINTER(C.c_char_p)]
            lib.picha_jpeg_decode.restype = C.c_int
            lib.picha_jpeg_encode.argtypes = [
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
                C.POINTER(C.POINTER(C.c_uint8)),
                C.POINTER(C.c_size_t), C.POINTER(C.c_char_p)]
            lib.picha_jpeg_encode.restype = C.c_int

            lib.picha_jpeg_entropy_segments.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_int64), C.c_int,
                C.c_int64, C.c_int64, C.c_int64, C.c_int,
                C.POINTER(C.c_int), C.POINTER(C.c_int),
                C.POINTER(C.c_int), C.POINTER(C.c_int),
                C.POINTER(C.c_int), C.POINTER(C.c_int),
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64), C.POINTER(C.c_int32),
                C.POINTER(C.c_int32), C.c_int, C.c_int,
                C.POINTER(C.POINTER(C.c_int16))]
            lib.picha_jpeg_entropy_segments.restype = C.c_int

            lib.picha_jpeg_decode_raw420.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.POINTER(C.c_uint8),
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8), C.c_int,
                C.POINTER(C.c_char_p)]
            lib.picha_jpeg_decode_raw420.restype = C.c_int

            _wins = [C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int]
            lib.picha_jpeg_transcode_raw420.argtypes = (
                [C.POINTER(C.c_uint8), C.c_size_t, C.c_int, C.c_int,
                 C.c_int, C.c_int, C.c_int] + _wins * 4
                + [C.c_int, C.c_int, C.c_double,
                   C.POINTER(C.POINTER(C.c_uint8)),
                   C.POINTER(C.c_size_t), C.POINTER(C.c_char_p)])
            lib.picha_jpeg_transcode_raw420.restype = C.c_int

            lib.picha_raw420_clip_mass.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int]
            lib.picha_raw420_clip_mass.restype = C.c_double

            lib.picha_jpeg_encode_raw420.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint8),
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int, C.c_int,
                C.POINTER(C.POINTER(C.c_uint8)), C.POINTER(C.c_size_t),
                C.POINTER(C.c_char_p)]
            lib.picha_jpeg_encode_raw420.restype = C.c_int

            lib.picha_jpeg_coef_open.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.c_void_p), C.POINTER(C.c_char_p)]
            lib.picha_jpeg_coef_open.restype = C.c_int
            lib.picha_jpeg_coef_info.argtypes = [C.c_void_p, C.POINTER(C.c_int)]
            lib.picha_jpeg_coef_info.restype = C.c_int
            lib.picha_jpeg_coef_comp_info.argtypes = [
                C.c_void_p, C.c_int, C.POINTER(C.c_int), C.POINTER(C.c_uint16)]
            lib.picha_jpeg_coef_comp_info.restype = C.c_int
            lib.picha_jpeg_coef_read.argtypes = [
                C.c_void_p, C.c_int, C.POINTER(C.c_int16)]
            lib.picha_jpeg_coef_read.restype = C.c_int
            lib.picha_jpeg_coef_close.argtypes = [C.c_void_p]
            lib.picha_jpeg_coef_close.restype = None
            lib.picha_jpeg_coef_write.argtypes = [
                C.c_int, C.c_int, C.c_int,
                C.POINTER(C.POINTER(C.c_int16)),
                C.POINTER(C.c_int), C.POINTER(C.c_int),
                C.POINTER(C.c_int), C.POINTER(C.c_int),
                C.POINTER(C.POINTER(C.c_uint16)), C.c_int, C.c_int,
                C.c_int,
                C.POINTER(C.POINTER(C.c_uint8)), C.POINTER(C.c_size_t),
                C.POINTER(C.c_char_p)]
            lib.picha_jpeg_coef_write.restype = C.c_int

            lib.picha_lzw_decode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.POINTER(C.c_uint8),
                C.c_size_t, C.POINTER(C.c_size_t)]
            lib.picha_lzw_decode.restype = C.c_int
            lib.picha_lzw_encode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.POINTER(C.c_uint8)), C.POINTER(C.c_size_t)]
            lib.picha_lzw_encode.restype = C.c_int
            lib.picha_lzw_decode_multi.argtypes = [
                C.POINTER(C.c_uint8), C.POINTER(C.c_uint64),
                C.POINTER(C.c_uint64), C.c_int, C.POINTER(C.c_uint8),
                C.POINTER(C.c_uint64), C.POINTER(C.c_uint64),
                C.POINTER(C.c_uint64)]
            lib.picha_lzw_decode_multi.restype = C.c_int
            lib.picha_packbits_decode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.POINTER(C.c_uint8),
                C.c_size_t, C.POINTER(C.c_size_t)]
            lib.picha_packbits_decode.restype = C.c_int

            lib.picha_fax_decode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.c_int, C.c_int,
                C.c_int, C.c_uint32, C.POINTER(C.c_uint8),
                C.POINTER(C.c_int), C.POINTER(C.c_char_p)]
            lib.picha_fax_decode.restype = C.c_int

            lib.picha_gap8_pack.argtypes = [
                C.POINTER(C.c_int16), C.c_size_t,
                C.POINTER(C.c_uint8), C.POINTER(C.c_int8),
                C.POINTER(C.c_size_t), C.POINTER(C.c_int32),
                C.POINTER(C.c_int16), C.POINTER(C.c_size_t)]
            lib.picha_gap8_pack.restype = C.c_int
            lib.picha_gap4_pack.argtypes = [
                C.POINTER(C.c_int16), C.c_size_t,
                C.POINTER(C.c_uint8), C.POINTER(C.c_size_t),
                C.POINTER(C.c_uint8), C.POINTER(C.c_int8),
                C.POINTER(C.c_size_t), C.POINTER(C.c_int32),
                C.POINTER(C.c_int16), C.POINTER(C.c_size_t)]
            lib.picha_gap4_pack.restype = C.c_int
            lib.picha_gap4_batch_begin.argtypes = [
                C.POINTER(C.c_void_p), C.c_int, C.c_size_t,
                C.POINTER(C.c_void_p),
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64)]
            lib.picha_gap4_batch_begin.restype = C.c_int
            lib.picha_gap4_batch_finish.argtypes = [
                C.c_void_p,
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.c_uint8), C.POINTER(C.c_int8), C.c_size_t,
                C.POINTER(C.c_int32), C.POINTER(C.c_int16), C.c_size_t]
            lib.picha_gap4_batch_finish.restype = C.c_int

            lib.picha_resize_u8.argtypes = [
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int,
                C.POINTER(C.c_uint8), C.c_int, C.c_int,
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int,
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int]
            lib.picha_resize_u8.restype = C.c_int
            lib.picha_resize_u8_i16.argtypes = lib.picha_resize_u8.argtypes
            lib.picha_resize_u8_i16.restype = C.c_int
            lib.picha_resize_u8_i16_same.argtypes = [
                C.POINTER(C.c_uint8), C.c_int, C.c_int,
                C.POINTER(C.c_uint8),
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int,
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int]
            lib.picha_resize_u8_i16_same.restype = C.c_int
            lib.picha_resize_u16.argtypes = [
                C.POINTER(C.c_uint16), C.c_int, C.c_int, C.c_int,
                C.POINTER(C.c_uint16), C.c_int, C.c_int,
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int,
                C.POINTER(C.c_int32), C.POINTER(C.c_float), C.c_int]
            lib.picha_resize_u16.restype = C.c_int

            lib.picha_webp_available.argtypes = []
            lib.picha_webp_available.restype = C.c_int
            lib.picha_webp_stat.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t,
                C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int)]
            lib.picha_webp_stat.restype = C.c_int
            lib.picha_webp_decode.argtypes = [
                C.POINTER(C.c_uint8), C.c_size_t, C.c_int,
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int]
            lib.picha_webp_decode.restype = C.c_int
            lib.picha_webp_encode.argtypes = [
                C.POINTER(C.c_uint8), C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_float, C.c_int, C.c_int, C.c_int, C.c_int,
                C.c_int, C.c_int,
                C.POINTER(C.POINTER(C.c_uint8)), C.POINTER(C.c_size_t)]
            lib.picha_webp_encode.restype = C.c_int

            _lib = lib
        return _lib


def take_buffer(lib, ptr, length: int) -> bytes:
    """Copy a lib-allocated buffer into Python and free it."""
    try:
        return C.string_at(ptr, length)
    finally:
        lib.picha_free(ptr)


def take_error(lib, errp) -> str:
    if errp.value is None:
        return "native codec error"
    try:
        return errp.value.decode("utf-8", "replace")
    finally:
        lib.picha_free(errp)


# ---------------------------------------------------------------------------
# PNG filters
# ---------------------------------------------------------------------------

def png_unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    lib = get_lib()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(height * rowbytes, dtype=np.uint8)
    rc = lib.picha_png_unfilter(_u8ptr(raw), _u8ptr(out), height, rowbytes, bpp)
    if rc != 0:
        raise CodecError("invalid PNG filter type")
    return out


def png_filter(img: np.ndarray, height: int, rowbytes: int, bpp: int,
               strategy: int = -1) -> np.ndarray:
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty(height * (rowbytes + 1), dtype=np.uint8)
    lib.picha_png_filter(_u8ptr(img), _u8ptr(out), height, rowbytes, bpp, strategy)
    return out


_libdeflate_ok = None


def have_libdeflate() -> bool:
    """True when the native lib was built against libdeflate."""
    global _libdeflate_ok
    if _libdeflate_ok is None:
        lib = get_lib()
        probe = np.zeros(1, dtype=np.uint8)
        n = C.c_size_t()
        rc = lib.picha_zlib_inflate(_u8ptr(probe), 0, _u8ptr(probe), 0,
                                    C.byref(n))
        _libdeflate_ok = rc != 3
    return _libdeflate_ok


def _zlib_inflate_fallback(buf, as_array: bool):
    """:mod:`zlib` path — keeps any bytes beyond ``expected`` (some
    writers pad past the last scanline) and maps the untyped
    ``zlib.error`` to the codec error contract."""
    import zlib

    try:
        raw = zlib.decompress(buf)
    except zlib.error as e:
        raise CodecError(f"zlib stream is corrupt: {e}") from None
    return np.frombuffer(raw, dtype=np.uint8) if as_array else raw


def zlib_inflate(buf, expected: int, as_array: bool = False):
    """Whole-buffer zlib decompress — libdeflate when built in, with a
    transparent :mod:`zlib` fallback (library unavailable, or the
    stream holds MORE than ``expected`` bytes — zlib semantics keep the
    extras and some writers pad). Returns the decompressed payload
    (ndarray when ``as_array``, else bytes); raises CodecError on
    corrupt streams — callers never see ``zlib.error``."""
    if not have_libdeflate():
        return _zlib_inflate_fallback(buf, as_array)
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    # deflate expands at most ~1032:1, so an `expected` beyond that is a
    # crafted-header claim the stream cannot fill — route to the zlib
    # fallback (tiny actual output -> the caller's typed truncation
    # error) instead of allocating the claimed size
    if expected > src.size * 1032 + 4096:
        return _zlib_inflate_fallback(buf, as_array)
    out = np.empty(max(expected, 1), dtype=np.uint8)
    n = C.c_size_t()
    rc = lib.picha_zlib_inflate(_u8ptr(src), src.size, _u8ptr(out),
                                expected, C.byref(n))
    if rc in (2, 3):
        return _zlib_inflate_fallback(buf, as_array)
    if rc != 0:
        raise CodecError("zlib stream is corrupt")
    out = out[: n.value]
    return out if as_array else out.tobytes()


def crc32(data, crc: int = 0) -> int:
    """CRC-32 (zlib polynomial) — libdeflate's vectorised path when
    built in (~10x zlib's table walk; PNG chunk verification was
    ~2.5 ms of every 1080p decode), zlib.crc32 otherwise. Accepts any
    buffer; chainable via `crc` like zlib.crc32."""
    lib = get_lib()
    if not hasattr(lib, "picha_crc32") or not have_libdeflate():
        import zlib

        return zlib.crc32(data, crc) & 0xFFFFFFFF
    src = np.frombuffer(data, dtype=np.uint8)
    return lib.picha_crc32(crc & 0xFFFFFFFF, _u8ptr(src), src.size) \
        & 0xFFFFFFFF


def zlib_deflate(buf, level: int = 6):
    """zlib-format compress — libdeflate when built in (levels 0-12;
    zlib's 0-9 map 1:1 and libdeflate at the same number is faster AND
    tighter), else :mod:`zlib` (level clamped to its 0-9 range).
    Always returns the compressed bytes."""
    if not have_libdeflate():
        import zlib

        payload = buf.tobytes() if hasattr(buf, "tobytes") else buf
        return zlib.compress(payload, min(level, 9))
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    cap = lib.picha_zlib_deflate_bound(src.size, level)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.picha_zlib_deflate(_u8ptr(src), src.size, level, _u8ptr(out),
                               cap)
    if n == -3:  # built without libdeflate after all — belt and braces
        import zlib

        return zlib.compress(src.tobytes(), min(level, 9))
    if n <= 0:
        raise CodecError("deflate failed")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

def jpeg_stat(buf: bytes):
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    w, h, ch = C.c_int(), C.c_int(), C.c_int()
    rc = lib.picha_jpeg_stat(_u8ptr(src), src.size, C.byref(w), C.byref(h), C.byref(ch))
    if rc != 0:
        return None
    return w.value, h.value, ch.value


def jpeg_decode(buf: bytes, want_channels: int, width: int, height: int,
                scale_denom: int = 1) -> np.ndarray:
    """scale_denom 2/4/8 decodes at 1/N scale via the reduced-size IDCT
    (libjpeg draft mode); width/height are the SCALED dims
    (ceil(full/N))."""
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    ch = want_channels
    out = np.empty((height, width, ch), dtype=np.uint8)
    err = C.c_char_p()
    rc = lib.picha_jpeg_decode(_u8ptr(src), src.size, ch, scale_denom,
                               _u8ptr(out),
                               width * ch, C.byref(err))
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return out


def jpeg_encode(arr: np.ndarray, quality: int, restart: int = 0,
                progressive: bool = False, optimize: bool = False,
                subsample: bool = True) -> bytes:
    """restart > 0 writes DRI + restart markers every `restart` MCUs,
    making the scan parallel-decodable (the device entropy decoder gets
    exactly known entry states per segment; ~2 bytes/MCU cost).
    progressive emits libjpeg's stock spectral/successive script;
    optimize emits Huffman-optimized tables; subsample=False forces
    4:4:4 (option parity with the device encode branch)."""
    lib = get_lib()
    arr = np.ascontiguousarray(arr)
    h, w, ch = arr.shape
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    err = C.c_char_p()
    rc = lib.picha_jpeg_encode(_u8ptr(arr.reshape(-1)), w, h, w * ch, ch,
                               quality, restart, int(progressive),
                               int(optimize), int(not subsample),
                               C.byref(out), C.byref(outlen), C.byref(err))
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return take_buffer(lib, out, outlen.value)


def jpeg_decode_raw420(buf: bytes, width: int, height: int,
                       scale_denom: int = 1):
    """Huffman + IDCT only: decode a 4:2:0 YCbCr JPEG to padded planes
    (y (ceil16(h), ceil16(w)) u8, cb/cr half that) without the upsample
    and colour-convert stages. scale_denom in {2,4,8} decodes Y through
    libjpeg's scaled IDCT: all plane dims become ceil(dim/denom)
    (padded) and chroma comes out on the SAME grid as Y. At denom=2
    only the luma IDCT is scaled — the chroma planes are the exact 8x8
    IDCT of the native-resolution chroma, so only Y is a draft. At
    denom=4/8 libjpeg selects chroma DCT_scaled_size 4/2, i.e. chroma
    is ALSO a scaled (approximate) IDCT — don't rely on exact chroma
    beyond denom=2 (the shipped draft path is hardwired to 2).
    Returns None for layouts the raw path doesn't take (grayscale,
    CMYK, 4:4:4/4:2:2) — callers fall back to jpeg_decode."""
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    # the C decode writes rows per the BITSTREAM's dims; the buffers
    # here are sized from the caller's — verify they agree or the plane
    # writes would run off the heap
    st = jpeg_stat(buf)
    if st is None or st[0] != width or st[1] != height:
        raise CodecError("raw420 dims disagree with JPEG header")
    denom = scale_denom if scale_denom in (2, 4, 8) else 1
    ow, oh = -(-width // denom), -(-height // denom)
    wpad, hpad = (ow + 15) & ~15, (oh + 15) & ~15
    ch, cw = (hpad, wpad) if denom > 1 else (hpad // 2, wpad // 2)
    y = np.empty((hpad, wpad), np.uint8)
    cb = np.empty((ch, cw), np.uint8)
    cr = np.empty((ch, cw), np.uint8)
    err = C.c_char_p()
    rc = lib.picha_jpeg_decode_raw420(
        _u8ptr(src), src.size, _u8ptr(y.reshape(-1)), _u8ptr(cb.reshape(-1)),
        _u8ptr(cr.reshape(-1)), denom, C.byref(err))
    if rc == 1:
        return None
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return y, cb, cr


def jpeg_encode_raw420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       width: int, height: int, quality: int,
                       restart: int = 0) -> bytes:
    """Encode from padded 4:2:0 planes: y (ceil16(h), ceil16(w)) u8,
    cb/cr half-size. Host does only fDCT+quant+Huffman."""
    lib = get_lib()
    y = np.ascontiguousarray(y)
    cb = np.ascontiguousarray(cb)
    cr = np.ascontiguousarray(cr)
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    err = C.c_char_p()
    rc = lib.picha_jpeg_encode_raw420(
        _u8ptr(y.reshape(-1)), _u8ptr(cb.reshape(-1)), _u8ptr(cr.reshape(-1)),
        width, height, quality, restart, C.byref(out), C.byref(outlen),
        C.byref(err))
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return take_buffer(lib, out, outlen.value)


def jpeg_transcode_raw420(buf: bytes, src_w: int, src_h: int, dst_w: int,
                          dst_h: int, ywin_x, ywin_y, cwin_x, cwin_y,
                          quality: int, restart: int = 0,
                          gamut_guard: float = 0.0, scale_denom: int = 1):
    """One native call: raw 4:2:0 decode -> banded resize (i16 kernel,
    f32 fallback) -> raw re-encode, GIL released throughout. Window
    tuples are (starts int32, taps float32 (n, k)) in the
    picha_resize_u8 layout (ops/raw420.py builds and caches them);
    with scale_denom in {2,4,8} the decode runs libjpeg's scaled IDCT
    and the windows must map from the SCALED plane geometry
    (ceil(src/denom), padded). Returns encoded bytes, or None for
    layouts the raw path doesn't take — including, when gamut_guard >
    0, sources whose implied-RGB clip mass exceeds the guard (the raw
    path's only real divergence from the staged exact path; callers
    fall back to it)."""
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    err = C.c_char_p()

    def wargs(win):
        s, w = win
        return [s.ctypes.data_as(C.POINTER(C.c_int32)),
                w.ctypes.data_as(C.POINTER(C.c_float)), w.shape[1]]

    rc = lib.picha_jpeg_transcode_raw420(
        _u8ptr(src), src.size, src_w, src_h, dst_w, dst_h,
        scale_denom if scale_denom in (2, 4, 8) else 1,
        *wargs(ywin_x), *wargs(ywin_y), *wargs(cwin_x), *wargs(cwin_y),
        quality, restart, float(gamut_guard),
        C.byref(out), C.byref(outlen), C.byref(err))
    if rc in (1, 2):
        return None
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return take_buffer(lib, out, outlen.value)


def raw420_clip_mass(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     width: int, height: int) -> float:
    """Mean per-channel LSB by which the implied RGB of padded 4:2:0
    planes exceeds [0,255] (rawguard.cc; even rows sampled)."""
    lib = get_lib()
    y = np.ascontiguousarray(y)
    cb = np.ascontiguousarray(cb)
    cr = np.ascontiguousarray(cr)
    return float(lib.picha_raw420_clip_mass(
        _u8ptr(y.reshape(-1)), _u8ptr(cb.reshape(-1)),
        _u8ptr(cr.reshape(-1)), width, height, y.shape[1]))


class JpegCoefficients:
    """Entropy-decoded JPEG: quantised DCT coefficients + tables.

    The device pixel-stage input (ops/jpeg_tpu.py): per component a
    (blocks_h, blocks_w, 64) int16 tensor and a (64,) uint16 qtable.
    """

    __slots__ = ("width", "height", "ncomp", "color_space", "comps")

    @classmethod
    def from_parts(cls, width, height, color_space, comps):
        """Alternate constructor for coefficient sets produced outside
        libjpeg (the native segment decoder, DCT-domain ROI regions):
        keeps forged-instance construction in one place so __init__
        invariants can't silently diverge from it."""
        co = object.__new__(cls)
        co.width, co.height = width, height
        co.ncomp, co.color_space = len(comps), color_space
        co.comps = comps
        return co

    def __init__(self, buf: bytes):
        lib = get_lib()
        src = np.frombuffer(buf, dtype=np.uint8)
        handle = C.c_void_p()
        err = C.c_char_p()
        rc = lib.picha_jpeg_coef_open(_u8ptr(src), src.size, C.byref(handle),
                                      C.byref(err))
        if rc != 0:
            raise CodecError(take_error(lib, err))
        try:
            info = (C.c_int * 4)()
            lib.picha_jpeg_coef_info(handle, info)
            self.ncomp, self.width, self.height, self.color_space = list(info)
            self.comps = []
            for c in range(self.ncomp):
                cinfo = (C.c_int * 6)()
                qtable = np.empty(64, dtype=np.uint16)
                rc = lib.picha_jpeg_coef_comp_info(
                    handle, c, cinfo, qtable.ctypes.data_as(C.POINTER(C.c_uint16)))
                if rc != 0:
                    raise CodecError("jpeg component info failed")
                h_samp, v_samp, bw, bh, dw, dh = list(cinfo)
                coefs = np.empty((bh, bw, 64), dtype=np.int16)
                rc = lib.picha_jpeg_coef_read(
                    handle, c, coefs.ctypes.data_as(C.POINTER(C.c_int16)))
                if rc != 0:
                    raise CodecError("jpeg coefficient read failed")
                self.comps.append({
                    "h_samp": h_samp, "v_samp": v_samp,
                    "blocks_w": bw, "blocks_h": bh,
                    "width": dw, "height": dh,
                    "qtable": qtable, "coefs": coefs,
                })
        finally:
            lib.picha_jpeg_coef_close(handle)


def jpeg_entropy_decode(info, nthreads: int = 0):
    """Segment-parallel native entropy decode of a parsed baseline scan
    (ops/jpeg_scan.parse_baseline output) -> a JpegCoefficients-shaped
    object, bit-exact vs libjpeg (tested in test_huffman_decode.py).

    Restart segments reset the DC predictors and the bit phase, so they
    decode concurrently on `nthreads` host threads (0 = cpu count) —
    per-image parallelism the reference's serial libjpeg scanline loop
    cannot offer (/root/reference/src/jpegcodec.cc:100-106). Files
    without restart markers are one segment and decode serially."""
    import os

    from ..ops.jpeg_scan import derive_tables

    lib = get_lib()
    ncomp = info.ncomp
    sig = info.comp_sig
    hmax = max(h for h, _, _ in info.comps)
    vmax = max(v for _, v, _ in info.comps)

    # table rows, deduped in first-use order; per-component row ids
    rows, row_of = [], {}
    nbits_rows = []
    dc_tab, ac_tab = [], []
    for ci in range(ncomp):
        for cls, dest in ((0, dc_tab), (1, ac_tab)):
            key = (cls, info.scan_tables[ci][cls])
            if key not in row_of:
                row_of[key] = len(rows)
                rows.append(derive_tables(*info.huffman[key]))
                nbits_rows.append([0] + list(info.huffman[key][0]))
            dest.append(row_of[key])
    limit = np.ascontiguousarray(np.stack([r[0] for r in rows]), np.int64)
    mincode = np.ascontiguousarray(np.stack([r[1] for r in rows]), np.int64)
    valptr = np.ascontiguousarray(np.stack([r[2] for r in rows]), np.int64)
    hv = np.ascontiguousarray(np.stack([r[3] for r in rows]), np.int32)
    nbits = np.ascontiguousarray(np.array(nbits_rows), np.int32)

    data = b"".join(info.segments)
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    seg_off = np.zeros(len(info.segments) + 1, np.int64)
    np.cumsum([len(s) for s in info.segments], out=seg_off[1:])

    outs = [np.zeros((bh, bw, 64), np.int16) for bh, bw, _, _ in sig]
    out_ptrs = (C.POINTER(C.c_int16) * ncomp)(
        *[o.ctypes.data_as(C.POINTER(C.c_int16)) for o in outs])

    def ints(vals):
        return (C.c_int * ncomp)(*vals)

    mcus = info.mcus
    ri = info.restart_interval or mcus
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    rc = lib.picha_jpeg_entropy_segments(
        _u8ptr(arr), seg_off.ctypes.data_as(C.POINTER(C.c_int64)),
        len(info.segments), mcus, ri, -(-info.width // (8 * hmax)),
        ncomp, ints(h for h, _, _ in info.comps),
        ints(v for _, v, _ in info.comps),
        ints(c[1] for c in sig), ints(c[0] for c in sig),
        ints(dc_tab), ints(ac_tab),
        limit.ctypes.data_as(C.POINTER(C.c_int64)),
        mincode.ctypes.data_as(C.POINTER(C.c_int64)),
        valptr.ctypes.data_as(C.POINTER(C.c_int64)),
        hv.ctypes.data_as(C.POINTER(C.c_int32)),
        nbits.ctypes.data_as(C.POINTER(C.c_int32)),
        len(rows), nthreads, out_ptrs)
    if rc != 0:
        raise CodecError("native entropy decode failed")

    return JpegCoefficients.from_parts(info.width, info.height,
                                       info.color_space, [{
        "h_samp": h, "v_samp": v,
        "blocks_w": bw, "blocks_h": bh,
        "width": -(-info.width * h // hmax),
        "height": -(-info.height * v // vmax),
        "qtable": q, "coefs": outs[ci],
    } for ci, ((bh, bw, _, _), (h, v, q)) in enumerate(zip(sig, info.comps))])


def jpeg_coefficients(buf: bytes, nthreads: int = 0) -> JpegCoefficients:
    """Fastest available host entropy decode for one image: the
    segment-parallel native decoder when the file is baseline with >1
    restart segment and >1 thread is worth using, else libjpeg.
    Single-thread libjpeg is ~1.4-1.6x faster than the native kernel
    (measured, docs/PERFORMANCE.md), so the native path only wins when
    it can actually spread segments over threads."""
    import os

    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    # cheap DRI-marker scan before the full parse: restart-free files
    # (most web-sourced JPEGs) would otherwise pay a marker walk plus a
    # whole-scan unstuff copy per image just to fall back to libjpeg
    # (0xFFDD cannot appear inside entropy data — 0xFF is stuffed)
    if nthreads > 1 and b"\xff\xdd" in buf:
        from ..ops.jpeg_scan import parse_baseline

        info = parse_baseline(buf)
        if info is not None and len(info.segments) > 1:
            return jpeg_entropy_decode(info, nthreads=nthreads)
    return JpegCoefficients(buf)


def jpeg_coef_write(width: int, height: int, comps: list,
                    optimize_huffman: bool = False,
                    restart: int = 0, color_space: int = 0) -> bytes:
    """comps: list of dicts with coefs (bh, bw, 64) int16, qtable (64,)
    uint16, h_samp, v_samp. color_space 2 (JCS_RGB) tags 3-component
    output as untransformed RGB ('R','G','B' ids + Adobe APP14); other
    values = default grayscale / JFIF YCbCr."""
    lib = get_lib()
    n = len(comps)
    coef_arrays = [np.ascontiguousarray(c["coefs"], dtype=np.int16) for c in comps]
    qtables = [np.ascontiguousarray(c["qtable"], dtype=np.uint16) for c in comps]
    comp_ptrs = (C.POINTER(C.c_int16) * n)(
        *[a.ctypes.data_as(C.POINTER(C.c_int16)) for a in coef_arrays])
    q_ptrs = (C.POINTER(C.c_uint16) * n)(
        *[q.ctypes.data_as(C.POINTER(C.c_uint16)) for q in qtables])
    h_samp = (C.c_int * n)(*[c["h_samp"] for c in comps])
    v_samp = (C.c_int * n)(*[c["v_samp"] for c in comps])
    bw = (C.c_int * n)(*[c["coefs"].shape[1] for c in comps])
    bh = (C.c_int * n)(*[c["coefs"].shape[0] for c in comps])
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    err = C.c_char_p()
    rc = lib.picha_jpeg_coef_write(width, height, n, comp_ptrs, h_samp, v_samp,
                                   bw, bh, q_ptrs, int(color_space),
                                   int(optimize_huffman),
                                   restart, C.byref(out), C.byref(outlen),
                                   C.byref(err))
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return take_buffer(lib, out, outlen.value)


# ---------------------------------------------------------------------------
# TIFF compression primitives
# ---------------------------------------------------------------------------

def lzw_decode(buf: bytes, expected: int) -> bytes:
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(expected, dtype=np.uint8)
    outlen = C.c_size_t()
    rc = lib.picha_lzw_decode(_u8ptr(src), src.size, _u8ptr(out), expected,
                              C.byref(outlen))
    if rc != 0:
        raise CodecError("LZW decode failed")
    return out[:outlen.value].tobytes()


def lzw_decode_multi(buf, offsets, lengths, caps):
    """Decode many independent LZW segments (TIFF strips share one
    underlying file buffer) in ONE native call — per-call ctypes
    overhead (~50 us) dominates small-strip decode otherwise. Returns
    a list of bytes objects, one per segment."""
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    n = len(offsets)
    in_off = np.asarray(offsets, np.uint64)
    in_len = np.asarray(lengths, np.uint64)
    caps_a = np.asarray(caps, np.uint64)
    out_off = np.zeros(n, np.uint64)
    np.cumsum(caps_a[:-1], out=out_off[1:])
    out = np.empty(int(caps_a.sum()), np.uint8)
    got = np.zeros(n, np.uint64)
    u64p = lambda a: a.ctypes.data_as(C.POINTER(C.c_uint64))  # noqa: E731
    rc = lib.picha_lzw_decode_multi(_u8ptr(src), u64p(in_off),
                                    u64p(in_len), n, _u8ptr(out),
                                    u64p(out_off), u64p(caps_a), u64p(got))
    if rc != 0:
        raise CodecError(f"LZW decode failed (strip {-rc - 1})")
    return [out[int(o):int(o) + int(g)].tobytes()
            for o, g in zip(out_off, got)]


def lzw_encode(buf: bytes) -> bytes:
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    rc = lib.picha_lzw_encode(_u8ptr(src), src.size, C.byref(out), C.byref(outlen))
    if rc != 0:
        raise CodecError("LZW encode failed")
    return take_buffer(lib, out, outlen.value)


def packbits_decode(buf: bytes, expected: int) -> bytes:
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(expected, dtype=np.uint8)
    outlen = C.c_size_t()
    rc = lib.picha_packbits_decode(_u8ptr(src), src.size, _u8ptr(out), expected,
                                   C.byref(outlen))
    if rc != 0:
        raise CodecError("PackBits decode failed")
    return out[:outlen.value].tobytes()


# ---------------------------------------------------------------------------
# WebP
# ---------------------------------------------------------------------------

def webp_available() -> bool:
    """Whether the library was built against libwebp (optional)."""
    return bool(get_lib().picha_webp_available())


def webp_stat(buf: bytes):
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    w, h, a = C.c_int(), C.c_int(), C.c_int()
    rc = lib.picha_webp_stat(_u8ptr(src), src.size, C.byref(w), C.byref(h),
                             C.byref(a))
    if rc != 0:
        return None
    return w.value, h.value, bool(a.value)


def webp_decode(buf: bytes, channels: int, width: int, height: int) -> np.ndarray:
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((height, width, channels), dtype=np.uint8)
    rc = lib.picha_webp_decode(_u8ptr(src), src.size, channels,
                               _u8ptr(out), width * channels, width, height)
    if rc != 0:
        raise CodecError("WebP decode failed")
    return out


def webp_encode(arr: np.ndarray, preset: int, quality: float,
                alpha_quality: int, exact: bool, lossless: bool,
                method: int = -1, segments: int = -1,
                alpha_filtering: int = -1) -> bytes:
    lib = get_lib()
    arr = np.ascontiguousarray(arr)
    h, w, ch = arr.shape
    out = C.POINTER(C.c_uint8)()
    outlen = C.c_size_t()
    rc = lib.picha_webp_encode(_u8ptr(arr.reshape(-1)), w, h, w * ch, ch,
                               preset, quality, alpha_quality, int(exact),
                               int(lossless), method, segments,
                               alpha_filtering,
                               C.byref(out), C.byref(outlen))
    if rc != 0:
        raise CodecError(f"WebP encode failed ({rc})")
    return take_buffer(lib, out, outlen.value)


# ---------------------------------------------------------------------------
# Sparse coefficient packing (device upload wire format)
# ---------------------------------------------------------------------------

def gap8_pack(coefs: np.ndarray):
    """Pack an int16 coefficient plane into (gaps u8, vals i8, corr_idx
    i32, corr_val i16) — the gap-delta wire format (sparsepack.cc).

    index_i = cumsum(gaps)[i] - 1; dense[idx] += val, then the
    correction list repairs |v| > 127 at flat positions."""
    lib = get_lib()
    flat = np.ascontiguousarray(coefs.reshape(-1), dtype=np.int16)
    n = flat.size
    cap = n + n // 255 + 2
    gaps = np.empty(cap, np.uint8)
    vals = np.empty(cap, np.int8)
    # worst case every coefficient overflows int8; untouched pages are
    # free, so size for it outright
    corr_idx = np.empty(max(1, n), np.int32)
    corr_val = np.empty(max(1, n), np.int16)
    npairs = C.c_size_t()
    ncorr = C.c_size_t()
    rc = lib.picha_gap8_pack(
        flat.ctypes.data_as(C.POINTER(C.c_int16)), n,
        _u8ptr(gaps), vals.ctypes.data_as(C.POINTER(C.c_int8)),
        C.byref(npairs),
        corr_idx.ctypes.data_as(C.POINTER(C.c_int32)),
        corr_val.ctypes.data_as(C.POINTER(C.c_int16)), C.byref(ncorr))
    if rc != 0:
        raise CodecError("gap8 pack failed")
    k, c = npairs.value, ncorr.value
    return gaps[:k], vals[:k], corr_idx[:c].copy(), corr_val[:c].copy()


# ---------------------------------------------------------------------------
# CCITT fax (TIFF compressions 2/3/4)
# ---------------------------------------------------------------------------

def fax_decode(buf: bytes, width: int, height: int, comp: int,
               options: int = 0) -> np.ndarray:
    """Decode a T.4/T.6 segment to (height, width) uint8 of 0/1
    (0 = white). Short streams pad the remaining rows white, matching
    libtiff's tolerance."""
    lib = get_lib()
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((height, width), np.uint8)
    rows = C.c_int()
    err = C.c_char_p()
    rc = lib.picha_fax_decode(_u8ptr(src), src.size, width, height, comp,
                              options, _u8ptr(out.reshape(-1)),
                              C.byref(rows), C.byref(err))
    if rc != 0:
        raise CodecError(take_error(lib, err))
    return out


def gap4_pack(coefs: np.ndarray):
    """Nibble wire format: 1 byte per nonzero — (gap<<4 | value-code) —
    plus a gap8 side stream for |v| > 7 escapes and the usual int16
    correction list (sparsepack.cc picha_gap4_pack)."""
    lib = get_lib()
    flat = np.ascontiguousarray(coefs.reshape(-1), dtype=np.int16)
    n = flat.size
    prim = np.empty(n + n // 15 + 2, np.uint8)
    sgaps = np.empty(n + n // 255 + 2, np.uint8)
    svals = np.empty(n + n // 255 + 2, np.int8)
    corr_idx = np.empty(max(1, n), np.int32)
    corr_val = np.empty(max(1, n), np.int16)
    nprim = C.c_size_t()
    nsec = C.c_size_t()
    ncorr = C.c_size_t()
    rc = lib.picha_gap4_pack(
        flat.ctypes.data_as(C.POINTER(C.c_int16)), n,
        _u8ptr(prim), C.byref(nprim),
        _u8ptr(sgaps), svals.ctypes.data_as(C.POINTER(C.c_int8)),
        C.byref(nsec),
        corr_idx.ctypes.data_as(C.POINTER(C.c_int32)),
        corr_val.ctypes.data_as(C.POINTER(C.c_int16)), C.byref(ncorr))
    if rc != 0:
        raise CodecError("gap4 pack failed")
    k, ns, nc = nprim.value, nsec.value, ncorr.value
    return (prim[:k], sgaps[:ns], svals[:ns],
            corr_idx[:nc].copy(), corr_val[:nc].copy())


def gap4_pack_batch(planes, k1_granule: int = 8192, k2_granule: int = 4096,
                    kc_granule: int = 1024, k_floor=None,
                    headroom: float = 1.0):
    """Pack a batch of same-shape int16 coefficient planes straight
    into the padded gap4 wire rows (sparsepack.cc batch entry points):
    a count pass sizes the rows, the pack pass writes each image's
    primary/side streams into its final row including the no-op
    padding, and the int16 corrections land batch-flat with +j*m
    offsets. Returns (k1, k2, kc, prim (nb,k1) u8, sgaps (nb,k2) u8,
    svals (nb,k2) i8, corr_idx (kc,) i32, corr_val (kc,) i16) — byte
    identical to assembling per-image gap4_pack outputs, ~4x cheaper
    on one core."""
    lib = get_lib()
    nb = len(planes)
    flats = [np.ascontiguousarray(p.reshape(-1), dtype=np.int16)
             for p in planes]
    n = flats[0].size
    ptrs = (C.c_void_p * nb)(*[f.ctypes.data for f in flats])
    np1 = np.empty(nb, np.int64)
    np2 = np.empty(nb, np.int64)
    np3 = np.empty(nb, np.int64)
    handle = C.c_void_p()
    rc = lib.picha_gap4_batch_begin(
        ptrs, nb, n, C.byref(handle),
        np1.ctypes.data_as(C.POINTER(C.c_int64)),
        np2.ctypes.data_as(C.POINTER(C.c_int64)),
        np3.ctypes.data_as(C.POINTER(C.c_int64)))
    if rc != 0:
        raise CodecError("gap4 batch pack failed")

    from ..bucketing import bucket_geometric as bucket

    # Content-dependent sizes feed jit static keys, and every fresh
    # size bucket mints a new graph (tens of seconds to compile). Two
    # defenses (padding rows
    # are no-op encoded, so a larger k only costs wire bytes):
    #   * k_floor: caller's high-water sizes (TrainingInput's monotone
    #     per-signature ks) absorb draws at or below the floor;
    #   * headroom > 1: applied only when MINTING (no floor, or this
    #     batch exceeded it) so the new bucket covers later, slightly
    #     larger draws instead of chasing each one. Applying it to
    #     every batch would make the floor a moving target.
    def size(raw, granule, floor):
        k = bucket(max(1, int(raw)), granule)
        if floor is not None and k <= floor:
            return floor
        return bucket(max(1, int(raw * headroom)), granule)

    fl = (None, None, None) if k_floor is None else k_floor
    k1 = size(np1.max(), k1_granule, fl[0])
    k2 = size(np2.max(), k2_granule, fl[1])
    kc = size(np3.sum(), kc_granule, fl[2])
    prim = np.empty((nb, k1), np.uint8)
    sgaps = np.empty((nb, k2), np.uint8)
    svals = np.empty((nb, k2), np.int8)
    corr_idx = np.empty(kc, np.int32)
    corr_val = np.empty(kc, np.int16)
    rc = lib.picha_gap4_batch_finish(
        handle, _u8ptr(prim.reshape(-1)), k1,
        _u8ptr(sgaps.reshape(-1)),
        svals.ctypes.data_as(C.POINTER(C.c_int8)), k2,
        corr_idx.ctypes.data_as(C.POINTER(C.c_int32)),
        corr_val.ctypes.data_as(C.POINTER(C.c_int16)), kc)
    if rc != 0:
        raise CodecError("gap4 batch finish failed")
    return k1, k2, kc, prim, sgaps, svals, corr_idx, corr_val


# ---------------------------------------------------------------------------
# Host separable resize (native single-image fast path)
# ---------------------------------------------------------------------------

def resize_u8(arr: np.ndarray, dw: int, dh: int,
              xstart: np.ndarray, xw: np.ndarray,
              ystart: np.ndarray, yw: np.ndarray,
              precision: str = "f32") -> np.ndarray:
    """(H, W, C) uint8|uint16 -> (dh, dw, C) same dtype with precomputed
    uniform tap windows (ops/resize.py resize_windows — reference
    float32 weights). 16-bit arrays route to picha_resize_u16 (the deep
    r16* leg of resize.cc:136-149). precision="i16" takes the ~2x
    fixed-point u8 kernel (occasional +-1 vs f32 at pack thresholds;
    silently falls back to f32 when the taps exceed its q15 guard) —
    used by the raw-domain transcode where the parity budget has
    room; golden-parity callers keep the f32 default."""
    lib = get_lib()
    if arr.dtype == np.uint16:
        arr = np.ascontiguousarray(arr)
        sh, sw, ch = arr.shape
        out = np.empty((dh, dw, ch), np.uint16)
        u16p = lambda a: a.ctypes.data_as(C.POINTER(C.c_uint16))  # noqa: E731
        rc = lib.picha_resize_u16(
            u16p(arr), sh, sw, ch, u16p(out), dh, dw,
            xstart.ctypes.data_as(C.POINTER(C.c_int32)),
            xw.ctypes.data_as(C.POINTER(C.c_float)), xw.shape[1],
            ystart.ctypes.data_as(C.POINTER(C.c_int32)),
            yw.ctypes.data_as(C.POINTER(C.c_float)), yw.shape[1])
        if rc != 0:
            raise CodecError("native resize failed")
        return out
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    sh, sw, ch = arr.shape
    out = np.empty((dh, dw, ch), np.uint8)
    args = (_u8ptr(arr.reshape(-1)), sh, sw, ch, _u8ptr(out.reshape(-1)),
            dh, dw,
            xstart.ctypes.data_as(C.POINTER(C.c_int32)),
            xw.ctypes.data_as(C.POINTER(C.c_float)), xw.shape[1],
            ystart.ctypes.data_as(C.POINTER(C.c_int32)),
            yw.ctypes.data_as(C.POINTER(C.c_float)), yw.shape[1])
    rc = 2
    if precision == "i16same" and ch == 1 and (sh, sw) == (dh, dw):
        # transpose-free same-size correction kernel: bit-identical to
        # the i16 kernel for identity-size windows, ~2.5-3x faster
        rc = lib.picha_resize_u8_i16_same(
            _u8ptr(arr.reshape(-1)), sh, sw, _u8ptr(out.reshape(-1)),
            *args[7:])
    if rc == 2 and precision in ("i16", "i16same"):
        rc = lib.picha_resize_u8_i16(*args)
    if rc == 2:  # guard tripped (or f32 requested): exact kernel
        rc = lib.picha_resize_u8(*args)
    if rc != 0:
        raise CodecError("native resize failed")
    return out
