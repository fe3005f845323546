"""Separable image resize, device-first.

The reference (src/resize.cc) streams rows through a float ring buffer,
applying per-output contribution windows precomputed by makeContribs
(resize.cc:19-50). On the device the same math is a pair of dense matmuls with
banded weight matrices:

    tmp = Wh @ rows   (horizontal pass)     out = Wv @ tmp  (vertical)

which puts all the FLOPs in matmuls and lets XLA fuse unpack (u8->f32)
and pack (f32->u8, round-half-up) into the same kernel. Weight
construction reproduces resize.cc:19-50 numerics in float32, including:

  * output centres at (i + 0.5) * scale accumulated in float32
    (resize.cc:99,101 ``center += scale``)
  * window [ceil(c - fsupport), floor(c + fsupport)] clamped to the
    source, with exact-zero edge taps trimmed (resize.cc:29-34)
  * kernel widening on downscale: fscale = max(scale, 1, 1/support)
    (resize.cc:22,74-75)
  * per-window renormalisation to sum 1 (resize.cc:45-48)

Filter set and semantics (resize.cc:200-280):
  cubic (default, support 2), lanczos (lanczos-2), catmulrom & mitchel
  (Mitchell B/C family, B=C=0.333 for mitchel), box (support .5),
  triangle (support 1); all wrapped in ScaledFilter: support *= s,
  f(x) = base(x/s)/s.  filterScale default **0.70**; naming a filter
  explicitly resets it to 1.0 unless filterScale is also given
  (resize.cc:174, 179-198).
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np

from ..errors import InvalidImageError, InvalidOptionsError
from ..image import Image
from ..pixels import pixel_format

F32 = np.float32


# ---------------------------------------------------------------------------
# Filters (float32 scalar functions, reference resize.cc:200-260)
# ---------------------------------------------------------------------------

def _cubic(o):
    o = abs(o)
    return F32(1.0) - F32(o) * F32(o) * (F32(0.75) - F32(0.25) * F32(o))


def _triangle(o):
    return F32(1.0) - F32(abs(o))


def _box(o):
    return F32(1.0)


def _mitchell_family(B, C):
    B, C = F32(B), F32(C)
    A3 = F32((12 - 9 * B - 6 * C) / 6)
    A2 = F32((-18 + 12 * B + 6 * C) / 6)
    A0 = F32((6 - 2 * B) / 6)
    B3 = F32((-B - 6 * C) / 6)
    B2 = F32((6 * B + 30 * C) / 6)
    B1 = F32((-12 * B - 48 * C) / 6)
    B0 = F32((8 * B + 24 * C) / 6)

    def f(o):
        x = F32(abs(o))
        if x < 1:
            return F32(A0 + x * x * (A2 + x * A3))
        return F32(B0 + x * (B1 + x * (B2 + x * B3)))

    return f


def _lanczos2(o):
    x = F32(o) * F32(math.pi)
    x2 = F32(x * x)
    if x2 == 0:
        return F32(1.0)
    return F32(F32(2.0) * F32(math.sin(x)) * F32(math.sin(x / F32(2.0))) / x2)


FILTERS = {
    "cubic": (2.0, _cubic),
    "lanczos": (2.0, _lanczos2),
    "catmulrom": (2.0, _mitchell_family(0.0, 0.5)),
    "mitchel": (2.0, _mitchell_family(0.333, 0.333)),
    "box": (0.5, _box),
    "triangle": (1.0, _triangle),
}

DEFAULT_FILTER = "cubic"
DEFAULT_FILTER_SCALE = 0.70  # resize.cc:174


def parse_resize_options(opts: dict):
    """(filter, filterScale) with the reference's defaulting quirk
    (resize.cc:179-198): naming a filter resets scale to 1.0."""
    name = opts.get("filter")
    scale = DEFAULT_FILTER_SCALE
    if name is not None:
        scale = 1.0
        if name not in FILTERS:
            raise InvalidOptionsError("invalid filter mode")
    else:
        name = DEFAULT_FILTER
    fs = opts.get("filterScale", opts.get("filter_scale"))
    if fs is not None:
        try:
            fs = float(fs)
        except (TypeError, ValueError) as e:
            # the reference coerces via NumberValue -> NaN -> the same
            # 'invalid filter width' throw (resize.cc:187-191)
            raise InvalidOptionsError("invalid filter width") from e
        if not (fs > 0) or math.isnan(fs):
            raise InvalidOptionsError("invalid filter width")
        scale = fs
    return name, scale


# ---------------------------------------------------------------------------
# Contribution weights -> dense (dst, src) float32 matrix
# ---------------------------------------------------------------------------

def _iter_contribs(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float, row_start: int = 0,
                   row_count: int = None):
    """Yield (i, left, normalized weights) per output row, with the
    reference's float32 arithmetic (resize.cc:19-50 + ScaledFilter
    resize.cc:262-268). The centre accumulator is advanced through the
    skipped rows so windows match the full-matrix construction exactly."""
    base_support, base = FILTERS[filter_name]
    s = F32(filter_scale)
    support = F32(s * F32(base_support))

    def filt(x):
        return F32(base(F32(x) / s) / s)

    scale = F32(F32(src_size) / F32(dst_size))
    fscale = F32(max(max(scale, F32(1.0)), F32(F32(1.0) / support)))
    fsupport = F32(support * fscale)
    iscale = F32(F32(1.0) / fscale)
    if row_count is None:
        row_count = dst_size - row_start

    center = F32(F32(0.5) * scale)
    for _ in range(row_start):
        center = F32(center + scale)
    for i in range(row_start, row_start + row_count):
        left = int(max(F32(0.0), F32(math.ceil(center - fsupport))))
        right = int(min(F32(src_size - 1), F32(math.floor(center + fsupport))))
        while left < right and filt(F32(center - left) * iscale) == 0:
            left += 1
        while right > left and filt(F32(center - right) * iscale) == 0:
            right -= 1
        taps = np.arange(left, right + 1)
        w = np.array([filt(F32(center - F32(j)) * iscale) for j in taps],
                     dtype=np.float32)
        # sequential f32 accumulation in tap order — numpy's pairwise
        # sum differs by 1 ulp for windows > 8 taps, and the reference
        # (resize.cc:39-43) accumulates totalweight sequentially
        total = F32(0.0)
        for v in w:
            total = F32(total + F32(v))
        if not total > 0:
            raise InvalidImageError("degenerate resize window")
        yield i, left, w * F32(F32(1.0) / total)
        center = F32(center + scale)


def window_bounds(dst_size: int, src_size: int, filter_name: str,
                  filter_scale: float, rows) -> dict:
    """UNTRIMMED analytic window [left, right) per requested output row
    — the same F32 centre walk as _iter_contribs, before the zero-tap
    trim. Untrimmed extents are monotone in the row index; the trimmed
    ones are NOT (cubic kernels hit exact zeros at integer offsets), so
    halo sizing from extreme rows must use these bounds."""
    base_support, _ = FILTERS[filter_name]
    s = F32(filter_scale)
    support = F32(s * F32(base_support))
    scale = F32(F32(src_size) / F32(dst_size))
    fsc = F32(max(max(scale, F32(1.0)), F32(F32(1.0) / support)))
    fsupport = F32(support * fsc)
    want = sorted(set(rows))
    out = {}
    center = F32(F32(0.5) * scale)
    wi = 0
    for i in range(dst_size):
        if wi >= len(want):
            break
        if i == want[wi]:
            left = int(max(F32(0.0), F32(math.ceil(center - fsupport))))
            right = int(min(F32(src_size - 1),
                            F32(math.floor(center + fsupport))))
            out[i] = (left, right + 1)
            wi += 1
        center = F32(center + scale)
    return out


@functools.lru_cache(maxsize=512)
def resize_weights(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float) -> np.ndarray:
    """Dense (dst_size, src_size) float32 contribution matrix."""
    W = np.zeros((dst_size, src_size), dtype=np.float32)
    for i, left, w in _iter_contribs(dst_size, src_size, filter_name,
                                     filter_scale):
        W[i, left:left + w.size] = w
    return W


def resize_weight_rows(dst_size: int, src_size: int, filter_name: str,
                       filter_scale: float, row_start: int, row_count: int,
                       col_start: int, col_count: int) -> np.ndarray:
    """A (row_count, col_count) window of the contribution matrix,
    built without materialising the dense matrix (gigapixel-scale
    callers: parallel/spatial.py). Taps outside the column window raise
    — the caller's window must cover every row's support."""
    block = np.zeros((row_count, col_count), dtype=np.float32)
    for i, left, w in _iter_contribs(dst_size, src_size, filter_name,
                                     filter_scale, row_start, row_count):
        lo = left - col_start
        if lo < 0 or lo + w.size > col_count:
            raise InvalidImageError(
                f"resize window for output row {i} (cols {left}.."
                f"{left + w.size}) exceeds the provided column window")
        block[i - row_start, lo:lo + w.size] = w
    return block


# ---------------------------------------------------------------------------
# Banded (tiled) execution plan — large sizes
#
# The dense (dst, src) matmul costs O(dst*src) MACs although the
# contribution matrix is banded with bandwidth ~2*support*scale
# (resize.cc:78-79 maxcontrib). For big images we tile the output axis:
# each tile of TILE outputs reads one contiguous input slice of
# uniform length, giving a (T, TILE, in_len) block-banded weight tensor
# and a batched small matmul — O(dst*in_len) MACs, in_len ≈
# TILE*scale + kernel width. Numerically identical taps (the blocks are
# slices of the same float32 matrix; extra entries are exact zeros).
# ---------------------------------------------------------------------------

BANDED_THRESHOLD = 512  # use the banded plan when src_size exceeds this
BAND_TILE = 64


@functools.lru_cache(maxsize=256)
def banded_resize_plan(dst_size: int, src_size: int, filter_name: str,
                       filter_scale: float, tile: int = BAND_TILE):
    """Banded plan: (starts (T,) int32, weights (T, tile, in_len) f32,
    dst_pad), built DIRECTLY from the contribution windows — never the
    dense (dst, src) matrix, whose lru-cached src*dst floats would pin
    gigabytes on gigapixel axes (the gigapixel-sharded resize routes
    its horizontal pass through here). Windows are clamped inside
    [0, src) for the XLA gather path.

    _iter_contribs trims zero boundary taps, so each row's [left,
    left+size) endpoints are nonzero and the per-tile extents equal the
    dense matrix's nonzero-column extents exactly — bit-identical plan
    to the old slice-the-dense-matrix construction (tests pin this
    against the dense einsum)."""
    T = -(-dst_size // tile)
    dst_pad = T * tile
    rows = list(_iter_contribs(dst_size, src_size, filter_name,
                               filter_scale))
    los, his = [], []
    for t in range(T):
        seg = rows[t * tile:(t + 1) * tile]
        if not seg:  # all-zero padding tile
            los.append(0)
            his.append(1)
        else:
            los.append(min(left for _, left, _ in seg))
            his.append(max(left + w.size for _, left, w in seg))
    in_len = min(src_size, max(h - l for l, h in zip(los, his)))
    # clamp windows inside [0, src): starts[t] <= src - in_len and
    # in_len <= src, so every placement below stays in range; coverage
    # holds because window width <= in_len
    starts = np.array([min(l, max(0, src_size - in_len)) for l in los],
                      dtype=np.int32)
    weights = np.zeros((T, tile, in_len), np.float32)
    for i, left, w in rows:
        t, r = divmod(i, tile)
        off = left - int(starts[t])
        weights[t, r, off:off + w.size] = w
    return starts, weights, dst_pad


# Matmul precision of the resize contractions (dense, banded and the
# sharded resize in parallel/spatial.py): DEFAULT (TF32 on the GPU).
# Measured on the H100 (PERF.md precision table): at most 1 LSB from a
# float64 numpy resize at DEFAULT and at HIGHEST alike (float32
# rounding at .5 boundaries), with no consistent time difference — so
# the cheapest precision.
RESIZE_PRECISION = "default"


def _apply_axis(x, dst_size: int, src_size: int, filter_name: str,
                fscale: float, axis: int):
    """Resize one spatial axis of a float32 (..., H, W, C) tensor.

    Traceable; picks the dense or banded plan by source size."""
    import jax
    import jax.numpy as jnp

    if src_size <= BANDED_THRESHOLD:
        w = jnp.asarray(resize_weights(dst_size, src_size, filter_name, fscale))
        if axis == -2:  # width
            return jnp.einsum("ow,...hwc->...hoc", w, x,
                              preferred_element_type=jnp.float32,
                              precision=RESIZE_PRECISION)
        return jnp.einsum("oh,...hwc->...owc", w, x,
                          preferred_element_type=jnp.float32,
                          precision=RESIZE_PRECISION)

    starts, weights, dst_pad = banded_resize_plan(dst_size, src_size,
                                                  filter_name, fscale)
    in_len = weights.shape[2]
    x2 = jnp.moveaxis(x, axis, -2)  # (..., L, C)

    def slice_one(s):
        return jax.lax.dynamic_slice_in_dim(x2, s, in_len, axis=-2)

    gathered = jax.vmap(slice_one)(jnp.asarray(starts))  # (T, ..., in_len, C)
    out = jnp.einsum("toi,t...ic->t...oc", jnp.asarray(weights), gathered,
                     preferred_element_type=jnp.float32,
                     precision=RESIZE_PRECISION)
    # (T, ..., tile, C) -> (..., T*tile, C) -> crop -> original axis order
    out = jnp.moveaxis(out, 0, -3)  # (..., T, tile, C)
    out = out.reshape(out.shape[:-3] + (dst_pad, out.shape[-1]))
    out = out[..., :dst_size, :]
    return jnp.moveaxis(out, -2, axis)


def resize_f32(f, dst_w: int, dst_h: int, filter_name: str, fscale: float):
    """Resize a float32 (..., H, W, C) tensor — the shared traceable core
    (horizontal then vertical, as resize.cc:103-132)."""
    src_h, src_w = f.shape[-3], f.shape[-2]
    tmp = _apply_axis(f, dst_w, src_w, filter_name, fscale, axis=-2)
    return _apply_axis(tmp, dst_h, src_h, filter_name, fscale, axis=-3)


# ---------------------------------------------------------------------------
# JAX execution
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _jit_resize(dtype_name: str, dst_w: int, dst_h: int, filter_name: str,
                fscale: float):
    import jax

    from ..pixels import jpack, junpack_f32

    def fn(img):
        f = junpack_f32(img)
        out = resize_f32(f, dst_w, dst_h, filter_name, fscale)
        return jpack(out, np.dtype(dtype_name))

    return jax.jit(fn)


def resize_array(arr: np.ndarray, width: int, height: int,
                 filter: str = None, filter_scale: float = None):
    """(H, W, C) or (N, H, W, C) channel array -> resized array (same rank).

    Small inputs run in numpy, single host images through the native
    C++ resize, everything else on the default JAX device."""
    opts = {}
    if filter is not None:
        opts["filter"] = filter
    if filter_scale is not None:
        opts["filterScale"] = filter_scale
    name, fscale = parse_resize_options(opts)
    if _host_cheap(arr, width, height) and not _is_jax_array(arr):
        return _resize_numpy(np.asarray(arr), width, height, name, fscale)
    if _is_single_host_image(arr):
        # single host image: the native C++ separable resize (the
        # reference resizeSync's own architecture, resize.cc:367-403)
        # skips a host->device->host round trip for one image
        out = _resize_native(np.asarray(arr), width, height, name, fscale)
        if out is not None:
            return out
    out = _jit_resize(np.dtype(arr.dtype).name, width, height, name, fscale)(arr)
    return np.asarray(out)


def _is_jax_array(arr) -> bool:
    return type(arr).__module__.startswith("jax")


def _is_single_host_image(arr) -> bool:
    """Single host images take the native path; batched inputs and
    jax-resident arrays stay on the device. Forced off with
    PICHA_SYNC_ON_DEVICE=1."""
    return (not _is_jax_array(arr) and arr.ndim == 3
            and os.environ.get("PICHA_SYNC_ON_DEVICE") != "1")


def _host_cheap(arr, dst_w: int, dst_h: int, threshold: int = 20_000_000) -> bool:
    """Small single images run on the host, where a few million numpy
    MACs cost less than a device dispatch and transfer (threshold set
    on the TPU; not measured on the H100). Same float32 math as the
    device graph (identical weight tensors and einsum contraction), so
    results agree within 1 LSB."""
    n = int(np.prod(arr.shape[:-3])) if arr.ndim > 3 else 1
    src_h, src_w, c = arr.shape[-3], arr.shape[-2], arr.shape[-1]
    macs = n * c * (src_h * src_w * dst_w + dst_h * dst_w * src_h)
    return macs < threshold


@functools.lru_cache(maxsize=512)
def resize_windows(dst_size: int, src_size: int, filter_name: str,
                   filter_scale: float):
    """Uniform per-output tap windows: (starts int32 (dst,), taps
    float32 (dst, k)) with the reference's weight values, zero-padded
    to the max window width; starts clamped so every window fits."""
    items = list(_iter_contribs(dst_size, src_size, filter_name,
                                filter_scale))
    k = max(w.size for _, _, w in items)
    k = min(k, src_size)
    starts = np.empty(dst_size, np.int32)
    taps = np.zeros((dst_size, k), np.float32)
    for i, left, w in items:
        s = min(max(left, 0), src_size - k)
        starts[i] = s
        taps[i, left - s : left - s + w.size] = w
    return starts, taps


def _resize_native(arr: np.ndarray, width: int, height: int, name: str,
                   fscale: float):
    """C++ separable resize (native/src/hostresize.cc) — the reference's
    own architecture (resize.cc:66-134): sequential-f32 tap
    accumulation, pinned pack numerics. uint8 + uint16 (deep r16*
    formats, resize.cc:136-149); returns None when not applicable so
    callers fall through."""
    if arr.dtype not in (np.uint8, np.uint16) or arr.ndim != 3:
        return None
    try:
        from ..native import lib as native
    except Exception:  # noqa: BLE001 — native lib unavailable
        return None
    xs, xw = resize_windows(width, arr.shape[1], name, fscale)
    ys, yw = resize_windows(height, arr.shape[0], name, fscale)
    return native.resize_u8(np.ascontiguousarray(arr), width, height,
                            xs, xw, ys, yw)


def _resize_numpy(arr: np.ndarray, width: int, height: int, name: str,
                  fscale: float) -> np.ndarray:
    from ..pixels import pack_f32, unpack_f32

    f = unpack_f32(arr)
    wh = resize_weights(width, arr.shape[-2], name, fscale)
    wv = resize_weights(height, arr.shape[-3], name, fscale)
    tmp = np.einsum("ow,...hwc->...hoc", wh, f)
    out = np.einsum("oh,...hwc->...owc", wv, tmp)
    return pack_f32(out, arr.dtype)


def resize_image(img: Image, opts: dict) -> Image:
    """Image-level resize matching reference resize(Sync) semantics
    (resize.cc:321-403): output keeps the source pixel format."""
    width = int(opts.get("width", 0))
    height = int(opts.get("height", 0))
    if width <= 0 or height <= 0:
        raise InvalidOptionsError("invalid dimensions")
    if img.width <= 0 or img.height <= 0:
        raise InvalidImageError("invalid image")
    name, fscale = parse_resize_options(opts)
    arr = img.to_array()
    out = resize_array(arr, width, height, filter=name, filter_scale=fscale)
    return Image.from_array(out, img.pixel)
