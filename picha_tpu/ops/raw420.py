"""Raw-domain (4:2:0 YCbCr) host resize — the strict-parity fast path.

The reference pipeline for a JPEG->resize->JPEG transcode is a chain of
LINEAR stages between the two entropy codecs:

    IDCT -> fancy chroma upsample -> YCbCr->RGB -> cubic resize
         -> RGB->YCbCr -> 2x2 chroma downsample -> fDCT

In float, the colour transforms are mutually inverse pointwise maps, so
they commute with the (linear) resize and cancel; what remains per
component is

    Y:      resize
    Cb/Cr:  downsample . resize . upsample      (one banded operator)

This module builds those composed per-axis operators with the
reference's exact float32 resize weights (ops/resize.py, reproducing
src/resize.cc:19-50) and libjpeg's fancy-upsample (jdsample.c
h2v2_fancy_upsample: 3/4,1/4 triangle, edge-pinned) and h2v2 box
downsample (jcsample.c: 1/2,1/2) in float, then applies them to the raw
planes from jpeg_read_raw_data with the AVX2 native resizer
(native/src/hostresize.cc). It is the same linear composition the device
fused path uses (ops/jpeg_fused.py) executed on the host: measured
≤~0.5 LSB avg of the staged libjpeg-RGB path, at roughly half its cost
(no upsample, no two colour conversions, chroma resized at quarter
area, raw-mode re-encode skips the encoder's downsample).

Used by JpegBatchPipeline.host_encode_batch (host_raw mode) and raced
by bench.py as the strict-parity configuration.
"""
from __future__ import annotations

import functools

import numpy as np

from .resize import resize_weights, resize_windows


def _ceil16(v: int) -> int:
    return (v + 15) & ~15


def fancy_upsample_matrix(full: int, half: int) -> np.ndarray:
    """(full, half) float32: libjpeg h2v2_fancy_upsample per axis —
    out[2j] = 3/4 in[j] + 1/4 in[j-1], out[2j+1] = 3/4 in[j] +
    1/4 in[j+1], edges pinned to the row (jdsample.c)."""
    U = np.zeros((2 * half, half), np.float32)
    j = np.arange(half)
    U[2 * j, j] += 0.75
    U[2 * j, np.maximum(j - 1, 0)] += 0.25
    U[2 * j + 1, j] += 0.75
    U[2 * j + 1, np.minimum(j + 1, half - 1)] += 0.25
    return U[:full]  # odd full sizes: libjpeg crops the last sample


def box_downsample_matrix(half: int, full: int) -> np.ndarray:
    """(half, full) float32: the encoder's h2v2_downsample per axis —
    mean of each sample pair, right edge duplicated for odd sizes
    (jcsample.c expand_right_edge)."""
    D = np.zeros((half, full), np.float32)
    j = np.arange(half)
    D[j, np.minimum(2 * j, full - 1)] += 0.5
    D[j, np.minimum(2 * j + 1, full - 1)] += 0.5
    return D


def _uniform_windows(M: np.ndarray):
    """Banded matrix -> (starts int32 (rows,), taps float32 (rows, k)):
    the uniform zero-padded window layout picha_resize_u8 takes."""
    rows, cols = M.shape
    nz = M != 0.0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), cols - 1 - nz[:, ::-1].argmax(1), 0)
    k = int((last - first + 1).max())
    starts = np.minimum(first, cols - k).astype(np.int32)
    taps = np.zeros((rows, k), np.float32)
    for i in range(rows):
        taps[i] = M[i, starts[i]:starts[i] + k]
    return starts, taps


def _pad_windows(starts: np.ndarray, taps: np.ndarray, out_pad: int):
    """Extend windows to a padded output size by repeating the last
    window — padding samples become edge replicas, which is what the
    raw-mode encoder wants under its blocks."""
    extra = out_pad - starts.shape[0]
    if extra <= 0:
        return starts, taps
    starts = np.concatenate([starts, np.repeat(starts[-1:], extra)])
    taps = np.concatenate([taps, np.repeat(taps[-1:], extra, axis=0)])
    return np.ascontiguousarray(starts), np.ascontiguousarray(taps)


@functools.lru_cache(maxsize=256)
def luma_windows(dst: int, dst_pad: int, src: int, filter_name: str,
                 fscale: float):
    """Y-plane windows: the reference resize weights, padded outputs."""
    starts, taps = resize_windows(dst, src, filter_name, fscale)
    return _pad_windows(starts, taps, dst_pad)


@functools.lru_cache(maxsize=256)
def chroma_windows(dst_full: int, dst_pad: int, src_full: int,
                   filter_name: str, fscale: float):
    """Composed chroma operator windows for one axis:
    box_down(dst) @ resize(dst_full <- src_full) @ fancy_up(src_full).
    Output length ceil(dst_pad/2), input length ceil(src_full/2)."""
    src_half = -(-src_full // 2)
    dst_half = -(-dst_full // 2)
    # NOTE: composes via dense factors — a transient ~src_full^2/2
    # floats per uncached axis pair (~113 MB at 8K width). Acceptable
    # for the photographic sizes this path serves (cached per
    # geometry); gigapixel axes should use the banded ops/resize path.
    # The three factors are banded, so a window-arithmetic composition
    # is possible if this ever matters.
    U = fancy_upsample_matrix(src_full, src_half)
    R = resize_weights(dst_full, src_full, filter_name, fscale)
    D = box_downsample_matrix(dst_half, dst_full)
    M = D @ R @ U
    starts, taps = _uniform_windows(M)
    return _pad_windows(starts, taps, dst_pad // 2)


def resize_raw420(planes, src_w: int, src_h: int, dst_w: int, dst_h: int,
                  filter_name: str, fscale: float):
    """(y, cb, cr) padded source planes -> (y, cb, cr) padded dest
    planes via three native banded-resize calls."""
    from ..native import lib as native

    y, cb, cr = planes
    wpad_o, hpad_o = _ceil16(dst_w), _ceil16(dst_h)
    yxs, yxw = luma_windows(dst_w, wpad_o, src_w, filter_name, fscale)
    yys, yyw = luma_windows(dst_h, hpad_o, src_h, filter_name, fscale)
    cxs, cxw = chroma_windows(dst_w, wpad_o, src_w, filter_name, fscale)
    cys, cyw = chroma_windows(dst_h, hpad_o, src_h, filter_name, fscale)
    # i16 fixed-point kernel: ~2x the f32 path; its occasional +-1 at
    # pack thresholds fits inside this path's <=1 LSB budget (measured
    # ~0.55 LSB vs the staged reference with f32)
    yo = native.resize_u8(y[..., None], wpad_o, hpad_o, yxs, yxw, yys, yyw,
                          precision="i16")
    cbo = native.resize_u8(cb[..., None], wpad_o // 2, hpad_o // 2,
                           cxs, cxw, cys, cyw, precision="i16")
    cro = native.resize_u8(cr[..., None], wpad_o // 2, hpad_o // 2,
                           cxs, cxw, cys, cyw, precision="i16")
    return yo[..., 0], cbo[..., 0], cro[..., 0]


# Default gamut guard (LSB of mean implied-RGB clip, rawguard.cc): the
# raw path's only SYSTEMATIC divergence from the staged exact path is
# the staged path's mid-pipeline RGB clamp, a nonlinearity bounded by
# the source's clip mass. Calibration (1080p -> 960x544 q85, final-
# output avgChannelDiff vs the staged path, unguarded):
#
#   bench corpus / photographic   mass 0.00       parity 0.52-0.58
#   hostile mosaics / band noise  mass 0.002-0.03 parity 0.74-1.98 (*)
#   saturated gradients           mass 0.34-0.43  parity 0.73-0.84
#   red/blue 2px checkerboard     mass ~3.8       (clamp-dominated)
#
# (*) the >1 entries are NOT clamp divergence: a dust control (the
# same staged image +-1 LSB, re-encoded) measures 1.1-2.2 LSB on that
# content — re-encode quantisation amplification that ANY
# non-bit-identical pipeline pays (bench publishes the floor next to
# the hostile row). The clamp contribution stays <=~0.8 up to mass
# 0.43, so the default guard sits above the measured-safe envelope
# and trips only on content beyond everything tested (e.g. large
# saturated out-of-gamut fields), where it routes to the staged path.
GAMUT_GUARD_LSB = 0.5


# Draft-luma correction taps for the scale_denom=2 raw path: libjpeg
# scales ONLY the luma IDCT (jpeg_idct_4x4); chroma comes out as the
# exact 8x8 IDCT on the same ceil(src/2) grid. So the draft transcode's
# single approximation is Y, and this 5-tap separable filter maps the
# draft-Y grid onto the exact cubic(0.70) resize of the full-res Y
# plane (fit with ops/fastfix.fit_correction over gratings, gradients,
# block mosaics and band-limited noise at 1080p q85; alternating LS,
# unit DC gain). Measured Y-plane residual after correction:
# 0.08-0.48 LSB across those classes (uncorrected 0.12-13.6) — far
# tighter than the RGB-domain fastfix because chroma needs no fix.
DRAFT_YX = np.array([-0.0018, 0.0725, 0.6071, 0.3242, -0.0019], np.float32)
DRAFT_YY = np.array([-0.0015, 0.0724, 0.6068, 0.3240, -0.0017], np.float32)
DRAFT_YX = (DRAFT_YX / DRAFT_YX.sum()).astype(np.float32)
DRAFT_YY = (DRAFT_YY / DRAFT_YY.sum()).astype(np.float32)

# the reference filter the draft taps were fit against (same contract
# as ops/fastfix.FIT_FILTER: correcting toward a different target
# filter would move the output the wrong way)
DRAFT_FIT_FILTER = "cubic"
DRAFT_FIT_SCALE = 0.70


@functools.lru_cache(maxsize=64)
def _draft_luma_windows(dst: int, dst_pad: int, axis: str):
    """Identity-size correction windows for the draft Y plane, padded
    to the encoder's geometry."""
    from .fastfix import windows_from_taps

    taps = DRAFT_YX if axis == "x" else DRAFT_YY
    starts, win = windows_from_taps(dst, tuple(float(v) for v in taps))
    return _pad_windows(starts, win, dst_pad)


@functools.lru_cache(maxsize=1024)
def _draft_composed_luma_windows(dst: int, dst_pad: int, src_full: int,
                                 axis: str, filter_name: str,
                                 fscale: float):
    """General-target draft-Y windows: ONE banded operator mapping the
    scale_denom=2 draft plane (ceil(src/2) grid) directly onto `dst`
    samples of the exact full-resolution resize.

    Construction: the fitted correction K (identity-size, approximates
    C_half = the exact cubic(0.70) resize full->half applied to the
    true Y plane) composed with the least-squares-optimal map T from
    the half grid to the target grid,

        T = argmin_T || T @ C_half - C_full ||_F
          = (C_full @ C_half^T) (C_half @ C_half^T)^{-1},

    so T @ (K @ draft) ~= T @ (C_half @ y) ~= C_full @ y. C_half's rows
    span the half-band subspace; a downscale target's rows (dst <=
    ceil(src/2)) lie almost entirely inside it, so the projection
    residual is tiny — unlike a naive double resize, which composes two
    window families with no optimality claim. T's rows decay like the
    inverse of the banded Gram matrix (exponentially), so after
    trimming sub-1e-3 dust the composed operator W = T @ K stays
    narrow enough for the banded i16 kernel. Rows renormalised to unit
    DC gain. All factors are banded, so the solve is a banded Cholesky
    over sparse factors: ~0.1 s per 1080p axis / ~0.6 s at 4K warm
    (was 0.3 s / 15 s dense), of which the solve itself is 10-30 ms —
    the rest is the reference-parity weight generation that every
    config pays and caches. Cached per geometry (1024 entries), so
    heterogeneous-geometry traffic amortises per source size."""
    half = -(-src_full // 2)
    from scipy import sparse as _sp
    from scipy.linalg import solveh_banded

    from .fastfix import windows_from_taps

    taps = DRAFT_YX if axis == "x" else DRAFT_YY
    ks, kw = windows_from_taps(half, tuple(float(v) for v in taps))
    rows = np.broadcast_to(np.arange(half)[:, None], kw.shape)
    cols = ks[:, None] + np.arange(kw.shape[1])[None, :]
    K = _sp.csr_matrix((kw.ravel().astype(np.float64),
                        (rows.ravel(), cols.ravel())), shape=(half, half))
    def _windows_csr(n, src, fname, fs):
        # sparse (n, src) contribution matrix straight from the window
        # layout — never materialises the dense (n, src) weights
        s, w = resize_windows(n, src, fname, fs)
        r = np.broadcast_to(np.arange(n)[:, None], w.shape).ravel()
        c = (s[:, None] + np.arange(w.shape[1])[None, :]).ravel()
        # fold taps past the true source edge back onto the last true
        # column (duplicate coo entries sum on conversion)
        c = np.where(c >= src_full, src_full - 1, c)
        M = _sp.coo_matrix((w.ravel().astype(np.float64), (r, c)),
                           shape=(n, src_full)).tocsr()
        M.sum_duplicates()
        M.eliminate_zeros()  # the uniform-k layout zero-pads windows
        return M

    # C_half must live on the TRUE draft grid: libjpeg's scaled IDCT
    # emits ceil(src/2) samples centred at full-res positions 2i+0.5
    # (an exact 2:1 grid of the 8x8 blocks, the last sample covering
    # the partial block on odd sources) — NOT the evenly-spread centres
    # resize_weights(half, src_odd) would use, which drift to a half-
    # pixel misalignment at image centre (measured 1.2 LSB). Build the
    # weights against a virtual 2*half-sample source; taps landing on
    # the replicated edge column fold back for odd sizes.
    # Every factor is banded, so the normal equations stay banded:
    # G = C_half C_halfᵀ is SPD with bandwidth ~ the resize window, and
    # the solve runs in O(half·band²+half·band·dst) via a banded
    # Cholesky instead of the dense O(half³) (15 s -> ~0.6 s at 4K,
    # the residue being the reference-parity weight generation itself).
    Ch = _windows_csr(half, 2 * half, DRAFT_FIT_FILTER, DRAFT_FIT_SCALE)
    Cf = _windows_csr(dst, src_full, filter_name, fscale)
    G = (Ch @ Ch.T).tocoo()
    u = int(np.abs(G.row - G.col).max())
    ab = np.zeros((u + 1, half), np.float64)  # upper band form
    up = G.col >= G.row
    ab[u - (G.col[up] - G.row[up]), G.col[up]] = G.data[up]
    ab[u] += 1e-6 * ab[u].sum() / half  # same ridge as the dense form
    rhs = (Ch @ Cf.T).toarray()
    T = solveh_banded(ab, rhs)
    W = (K.T @ T).T.astype(np.float32)
    W[np.abs(W) < 1e-3 * float(np.abs(W).max())] = 0.0
    W /= W.sum(1, keepdims=True)
    starts, win = _uniform_windows(W)
    return _pad_windows(starts, win, dst_pad)


def transcode_raw420_draft(buf: bytes, dst_w: int, dst_h: int,
                           filter_name: str, fscale: float, quality: int,
                           restart: int = 0, gamut_guard: float = None):
    """Draft-mode one-shot transcode for targets <= half size: libjpeg
    scale_denom=2 raw decode (Y via the 4x4 scaled IDCT, chroma exact
    on the same grid) -> fitted 5-tap Y correction + the exact composed
    chroma operator (both banded i16) -> raw re-encode, one native
    call. Only Y is approximate; chroma bytes match transcode_raw420's
    exactly. Applies to any target with dst <= ceil(src/2) on both
    axes: exact 2:1 targets use the identity-size fitted correction
    directly (requires the filter the correction was fit against);
    smaller targets use the composed LS operator
    (_draft_composed_luma_windows), which can target any filter.
    Returns None otherwise (callers fall back)."""
    from ..native import lib as native

    if gamut_guard is None:
        gamut_guard = GAMUT_GUARD_LSB
    st = native.jpeg_stat(buf)
    if st is None:
        return None
    src_w, src_h, _ = st
    half_w, half_h = -(-src_w // 2), -(-src_h // 2)
    # the identity fast path is phase-correct only for EVEN sources:
    # on odd dims the draft grid (2i+0.5 centres) drifts half a pixel
    # from the reference resize's evenly-spread ceil(src/2) grid — the
    # composed operator below absorbs that in T
    exact_half = ((dst_w, dst_h) == (half_w, half_h)
                  and src_w % 2 == 0 and src_h % 2 == 0)
    fit_filter = (filter_name == DRAFT_FIT_FILTER
                  and abs(fscale - DRAFT_FIT_SCALE) <= 1e-6)
    wpad_o, hpad_o = _ceil16(dst_w), _ceil16(dst_h)
    if exact_half and fit_filter:
        yxs, yxw = _draft_luma_windows(dst_w, wpad_o, "x")
        yys, yyw = _draft_luma_windows(dst_h, hpad_o, "y")
    elif (dst_w <= half_w and dst_h <= half_h
          and min(half_w, half_h) >= 48 and min(dst_w, dst_h) >= 8
          # the per-geometry banded LS solve is milliseconds, but its
          # intermediate T is a dense (half, dst) f64 — bound the
          # product (<=2^24 entries = 134 MB) and the axis; beyond
          # that the exact raw path takes over
          and max(half_w, half_h) <= 8192
          and max(half_w * dst_w, half_h * dst_h) <= 1 << 24):
        yxs, yxw = _draft_composed_luma_windows(dst_w, wpad_o, src_w, "x",
                                                filter_name, fscale)
        yys, yyw = _draft_composed_luma_windows(dst_h, hpad_o, src_h, "y",
                                                filter_name, fscale)
    else:
        return None
    # chroma input = the native-resolution chroma plane (ceil(src/2)
    # grid): the SAME composed operator the exact raw path uses
    cxs, cxw = chroma_windows(dst_w, wpad_o, src_w, filter_name, fscale)
    cys, cyw = chroma_windows(dst_h, hpad_o, src_h, filter_name, fscale)
    return native.jpeg_transcode_raw420(
        buf, src_w, src_h, dst_w, dst_h,
        (yxs, yxw), (yys, yyw), (cxs, cxw), (cys, cyw),
        quality, restart=restart, gamut_guard=gamut_guard, scale_denom=2)


def transcode_raw420(buf: bytes, dst_w: int, dst_h: int, filter_name: str,
                     fscale: float, quality: int, restart: int = 0,
                     gamut_guard: float = None):
    """One-shot raw-domain transcode: JPEG bytes -> resized JPEG bytes
    in a single native call (decode raw -> banded i16 resize -> raw
    re-encode, GIL released end to end — pool threads on multi-core
    hosts run whole transcodes concurrently). Returns None when the
    source isn't plain 4:2:0 YCbCr (progressive sources are fine —
    libjpeg's raw mode handles them) or when its gamut-clip mass
    exceeds `gamut_guard` (pass 0 to disable) so callers fall back to
    the RGB path."""
    from ..native import lib as native

    if gamut_guard is None:  # resolve at call time (tunable/patchable)
        gamut_guard = GAMUT_GUARD_LSB
    st = native.jpeg_stat(buf)
    if st is None:
        return None
    src_w, src_h, _ = st
    wpad_o, hpad_o = _ceil16(dst_w), _ceil16(dst_h)
    yxs, yxw = luma_windows(dst_w, wpad_o, src_w, filter_name, fscale)
    yys, yyw = luma_windows(dst_h, hpad_o, src_h, filter_name, fscale)
    cxs, cxw = chroma_windows(dst_w, wpad_o, src_w, filter_name, fscale)
    cys, cyw = chroma_windows(dst_h, hpad_o, src_h, filter_name, fscale)
    return native.jpeg_transcode_raw420(
        buf, src_w, src_h, dst_w, dst_h,
        (yxs, yxw), (yys, yyw), (cxs, cxw), (cys, cyw),
        quality, restart=restart, gamut_guard=gamut_guard)
