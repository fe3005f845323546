"""JPEG pixel stages on the device: dequant + IDCT + chroma upsample +
colour transform, fused under jit.

This is the BASELINE.json north-star fusion: the host does only the
serial entropy decode (libjpeg coefficient I/O, native/jpegshim.cc);
everything from quantised DCT coefficients to RGB bytes is XLA:

  * IDCT as one (64, 64) Kronecker matmul per block (einsum over a
    (..., 64) block tensor);
  * libjpeg-exact integer "fancy" chroma upsampling (jdsample.c
    h2v1/h2v2 semantics) in int32 vector math;
  * libjpeg-exact fixed-point YCbCr->RGB / YCCK->CMYK (jdcolor.c
    semantics, 16-bit fixed point with arithmetic shifts);
  * the reference's CMYK fold rgb = c*k/255 (src/jpegcodec.cc:36-42).

The only divergence from the libjpeg host path is IDCT rounding
(libjpeg uses the integer islow DCT): measured ≤1 LSB per sample.

Encode runs the mirror pipeline (RGB->YCbCr, 2x2 box downsample,
fDCT, quantise); entropy coding runs on the host or on the device
(ops/jpeg_huffman_tpu.py).
"""
from __future__ import annotations

import functools
import math

import numpy as np

# JPEG colour spaces (libjpeg J_COLOR_SPACE numbering)
CS_GRAYSCALE, CS_RGB, CS_YCBCR, CS_CMYK, CS_YCCK = 1, 2, 3, 4, 5

FIX = lambda x: int(x * 65536 + 0.5)
_ONE_HALF = 32768


def idct_matrix() -> np.ndarray:
    """A[u, x] = C(u)/2 * cos((2x+1) u pi / 16); IDCT: P = A^T B A."""
    A = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        cu = math.sqrt(0.5) if u == 0 else 1.0
        for x in range(8):
            A[u, x] = 0.5 * cu * math.cos((2 * x + 1) * u * math.pi / 16)
    return A.astype(np.float32)


_IDCT_A = idct_matrix()

# Matmul precision of the IDCT and fDCT contractions: DEFAULT, which
# lets the GPU run float32 dots in TF32 (10-bit mantissa). Measured on
# the H100 (PERF.md precision table): the staged pixels stay 0.07 LSB
# mean from libjpeg (0.04 at HIGHEST) and the re-encode 0.70 LSB, well
# inside the 1 LSB bound, so the cheapest precision is enough. The
# rounding of quantised coefficients may move by one step; the device
# Huffman encode is held byte-identical to libjpeg's encode of the SAME
# coefficients either way.
DCT_PRECISION = "default"


@functools.lru_cache(maxsize=1)
def _idct_kron() -> np.ndarray:
    """(64, 64) Kronecker IDCT: pixel_flat = coef_flat @ M with
    M[(v,u),(y,x)] = A[v,y] * A[u,x].

    A single K=64 matmul instead of two K=8 matmuls — 4x the FLOPs for
    one large contraction (chosen on the TPU; not measured on the
    H100)."""
    a = _IDCT_A.astype(np.float64)
    m = np.einsum("vy,ux->vuyx", a, a).reshape(64, 64)
    return m.astype(np.float32)


# ---------------------------------------------------------------------------
# jit stages (jnp; work on any leading batch dims)
# ---------------------------------------------------------------------------

def dequant_idct_plane(coefs, qtable, out_h, out_w):
    """(..., bh, bw, 64) int16 + (64,) -> (..., out_h, out_w) int32 samples
    in [0, 255] (level-shifted, clamped)."""
    import jax.numpy as jnp

    bh, bw = coefs.shape[-3], coefs.shape[-2]
    f = coefs.astype(jnp.float32) * qtable.astype(jnp.float32)
    # Kronecker IDCT: one (..., 64) @ (64, 64) contraction
    pix = jnp.einsum("...k,kp->...p", f, jnp.asarray(_idct_kron()),
                     preferred_element_type=jnp.float32,
                     precision=DCT_PRECISION)
    pix = pix.reshape(pix.shape[:-1] + (8, 8))
    # blocks (..., bh, bw, 8, 8) -> plane (..., bh*8, bw*8)
    pix = jnp.moveaxis(pix, -2, -3)  # (..., bh, 8, bw, 8)
    plane = pix.reshape(pix.shape[:-4] + (bh * 8, bw * 8))
    plane = jnp.round(plane + 128.0).astype(jnp.int32)
    plane = jnp.clip(plane, 0, 255)
    return plane[..., :out_h, :out_w]


def fancy_upsample_h(plane):
    """Horizontal 2x fancy upsample, libjpeg h2v1 semantics (int32)."""
    import jax.numpy as jnp

    s = plane
    prev = jnp.concatenate([s[..., :1], s[..., :-1]], axis=-1)
    nxt = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    even = (3 * s + prev + 1) >> 2
    odd = (3 * s + nxt + 2) >> 2
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (s.shape[-1] * 2,))


def fancy_upsample_v(plane):
    """Vertical 2x: colsum stage of libjpeg h2v2 (returns 4x-scaled sums)."""
    import jax.numpy as jnp

    s = plane
    prev = jnp.concatenate([s[..., :1, :], s[..., :-1, :]], axis=-2)
    nxt = jnp.concatenate([s[..., 1:, :], s[..., -1:, :]], axis=-2)
    up = 3 * s + prev     # row 2i
    down = 3 * s + nxt    # row 2i+1
    out = jnp.stack([up, down], axis=-2)  # (..., h, 2, w)
    return out.reshape(out.shape[:-3] + (s.shape[-2] * 2, s.shape[-1]))


def fancy_upsample_h2v2(plane):
    """Full 2x2 fancy upsample (libjpeg h2v2_fancy_upsample, exact)."""
    import jax.numpy as jnp

    colsum = fancy_upsample_v(plane)  # values scaled by 4
    s = colsum
    prev = jnp.concatenate([s[..., :1], s[..., :-1]], axis=-1)
    nxt = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    even = (3 * s + prev + 8) >> 4
    odd = (3 * s + nxt + 7) >> 4
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (s.shape[-1] * 2,))


def check_integer_sampling(comp_sig):
    """Reject fractional upsampling ratios (legal per spec, e.g. hmax=3
    with hs=2) with the same clean error libjpeg's pixel path raises
    ('Fractional sampling not implemented') — libjpeg's COEFFICIENT
    reader accepts such files, so the guard must live here, in front of
    the pixel stages, or the plane shapes silently mismatch."""
    from ..errors import CodecError

    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    for _, _, hs, vs in comp_sig:
        if max_h % hs or max_v % vs:
            raise CodecError("fractional sampling not implemented")


def upsample_to(plane, h_factor, v_factor, out_h, out_w):
    """Upsample a chroma plane by the component's sampling ratio using
    libjpeg's fancy (triangle) kernels for the common 2x cases and
    sample replication (libjpeg int_upsample) otherwise, then crop to
    the luma grid."""
    import jax.numpy as jnp

    if (h_factor, v_factor) == (2, 2):
        plane = fancy_upsample_h2v2(plane)
    elif (h_factor, v_factor) == (2, 1):
        plane = fancy_upsample_h(plane)
    elif (h_factor, v_factor) == (1, 2):
        # libjpeg-TURBO (the host parity oracle this image links,
        # .so.62 = turbo 2.1.5) ships h1v2_fancy_upsample — a vertical
        # triangle IJG libjpeg does not have — with the same per-parity
        # rounding biases as h2v1 (+1 toward the nearer row above, +2
        # toward the one below). Measured on authored 4:4:0 files:
        # per-parity 0.031 LSB avg vs the linked library, uniform +2
        # bias 0.205, replication 20 (tests pin <=1)
        s = plane
        prev = jnp.concatenate([s[..., :1, :], s[..., :-1, :]], axis=-2)
        nxt = jnp.concatenate([s[..., 1:, :], s[..., -1:, :]], axis=-2)
        up = (3 * s + prev + 1) >> 2
        down = (3 * s + nxt + 2) >> 2
        out = jnp.stack([up, down], axis=-2)
        plane = out.reshape(out.shape[:-3] + (s.shape[-2] * 2,
                                              s.shape[-1]))
    else:
        # any other integer expansion (4x, 2h4v, ...) is int_upsample
        # replication in both libjpeg flavours
        if h_factor > 1:
            plane = jnp.repeat(plane, h_factor, axis=-1)
        if v_factor > 1:
            plane = jnp.repeat(plane, v_factor, axis=-2)
    return plane[..., :out_h, :out_w]


def ycbcr_to_rgb_int(y, cb, cr):
    """libjpeg jdcolor.c fixed-point YCbCr->RGB (int32 in, uint8-range out)."""
    import jax.numpy as jnp

    cbs = cb - 128
    crs = cr - 128
    r = y + ((FIX(1.40200) * crs + _ONE_HALF) >> 16)
    b = y + ((FIX(1.77200) * cbs + _ONE_HALF) >> 16)
    g = y + (((-FIX(0.34414)) * cbs + (-FIX(0.71414)) * crs + _ONE_HALF) >> 16)
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0, 255)


def cmyk_fold_to_rgb(c, m, y_, k):
    """The reference's Adobe-inverted-CMYK fold rgb = c*k/255
    (src/jpegcodec.cc:36-42; integer division)."""
    import jax.numpy as jnp

    rgb = jnp.stack([c, m, y_], axis=-1)
    return (rgb * k[..., None]) // 255


def ycck_to_cmyk(y, cb, cr, k):
    """libjpeg ycck_cmyk_convert: invert the YCC->RGB result, K passes."""
    import jax.numpy as jnp

    rgb = ycbcr_to_rgb_int(y, cb, cr)
    cmy = 255 - rgb
    return cmy[..., 0], cmy[..., 1], cmy[..., 2], k


# ---------------------------------------------------------------------------
# whole-image decode graph (per shape signature, jitted)
# ---------------------------------------------------------------------------

def _plane_geometry(width, height, h_samp, v_samp, max_h, max_v):
    import math as m
    dw = m.ceil(width * h_samp / max_h)
    dh = m.ceil(height * v_samp / max_v)
    return dw, dh


def build_decode_stage(comp_sig, color_space, width, height,
                       force_rgb: bool = False):
    """The shared traceable staged-decode: per-component dequant+IDCT,
    chroma upsample, colour transform -> (..., H, W, C) int32 in
    [0, 255]. `comp_sig` entries are (bh, bw, h_samp, v_samp).

    Used by the single-image device path, the batched bucket graphs and
    the training pipeline so the ≤1-LSB-of-host invariant has exactly
    one implementation. force_rgb replicates grayscale to 3 channels."""
    import jax.numpy as jnp

    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    check_integer_sampling(comp_sig)

    def decode_stage(coefs, qtabs):
        planes = []
        for i, (bh, bw, hs, vs) in enumerate(comp_sig):
            dw, dh = _plane_geometry(width, height, hs, vs, max_h, max_v)
            p = dequant_idct_plane(coefs[i], qtabs[i], dh, dw)
            if (hs, vs) != (max_h, max_v):
                p = upsample_to(p, max_h // hs, max_v // vs, height, width)
            else:
                p = p[..., :height, :width]
            planes.append(p)
        if color_space == CS_GRAYSCALE or len(planes) == 1:
            g = planes[0]
            if force_rgb:
                return jnp.stack([g, g, g], axis=-1)
            return g[..., None]
        if color_space == CS_YCBCR:
            return ycbcr_to_rgb_int(*planes[:3])
        if color_space == CS_RGB:
            return jnp.stack(planes[:3], axis=-1)
        if color_space == CS_YCCK:
            c, m_, y_, k = ycck_to_cmyk(planes[0], planes[1], planes[2],
                                        planes[3])
            return cmyk_fold_to_rgb(c, m_, y_, k)
        if color_space == CS_CMYK:
            return cmyk_fold_to_rgb(planes[0], planes[1], planes[2],
                                    planes[3])
        raise ValueError(f"unsupported jpeg colour space {color_space}")

    return decode_stage


@functools.lru_cache(maxsize=256)
def _jit_decode(shape_sig, color_space, width, height):
    """shape_sig: tuple of (bh, bw, h_samp, v_samp) per component."""
    import jax
    import jax.numpy as jnp

    stage = build_decode_stage(shape_sig, color_space, width, height)

    def fn(*args):
        ncomp = len(shape_sig)
        return stage(args[:ncomp], args[ncomp:]).astype(jnp.uint8)

    return jax.jit(fn)


def decode_coefficients(co) -> np.ndarray:
    """native.lib.JpegCoefficients -> (H, W, C) uint8 via the device graph."""
    sig = tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                for c in co.comps)
    fn = _jit_decode(sig, co.color_space, co.width, co.height)
    args = [c["coefs"] for c in co.comps] + [c["qtable"] for c in co.comps]
    return np.asarray(fn(*args))


# ---------------------------------------------------------------------------
# encode: RGB -> quantised coefficients (fDCT on the device)
# ---------------------------------------------------------------------------

# IJG standard base tables (natural order), jcparam.c
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int32)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int32)


def quality_tables(quality: int):
    """jpeg_set_quality / jpeg_quality_scaling semantics (jcparam.c),
    force_baseline (clamp to 255)."""
    quality = min(100, max(1, quality))
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    def scale_tab(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.uint16)
    return scale_tab(_STD_LUMA_Q), scale_tab(_STD_CHROMA_Q)


def rgb_to_ycbcr(rgb):
    """libjpeg jccolor.c forward transform (fixed point)."""
    import jax.numpy as jnp

    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    y = (FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b
         + _ONE_HALF) >> 16
    cb = ((-FIX(0.16874)) * r + (-FIX(0.33126)) * g + FIX(0.50000) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    cr = (FIX(0.50000) * r + (-FIX(0.41869)) * g + (-FIX(0.08131)) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    return y, cb, cr


def box_downsample_2x2(plane):
    """libjpeg-style h2v2 average with rounding (bias approximated by
    +2 round-half-up)."""
    import jax.numpy as jnp

    h, w = plane.shape[-2], plane.shape[-1]
    # pad odd dims by edge replication (libjpeg expand_right_edge)
    if h % 2:
        plane = jnp.concatenate([plane, plane[..., -1:, :]], axis=-2)
        h += 1
    if w % 2:
        plane = jnp.concatenate([plane, plane[..., -1:]], axis=-1)
        w += 1
    p = plane.reshape(plane.shape[:-2] + (h // 2, 2, w // 2, 2))
    return (p.sum(axis=(-3, -1)) + 2) >> 2


def plane_to_blocks(plane, bh, bw):
    """(..., h, w) -> (..., bh, bw, 64), edge-padding to block multiples
    (libjpeg pads with edge replication)."""
    import jax.numpy as jnp

    h, w = plane.shape[-2], plane.shape[-1]
    ph, pw = bh * 8 - h, bw * 8 - w
    if ph or pw:
        plane = jnp.pad(plane, [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)],
                        mode="edge")
    p = plane.reshape(plane.shape[:-2] + (bh, 8, bw, 8))
    p = jnp.moveaxis(p, -3, -2)  # (..., bh, bw, 8, 8)
    return p.reshape(p.shape[:-2] + (64,))


def fdct_quant(blocks, qtable):
    """(..., 64) int samples -> quantised int16 coefficients."""
    import jax.numpy as jnp

    b = blocks.astype(jnp.float32) - 128.0
    # forward DCT = Kronecker transpose: coef_flat = pixel_flat @ M^T
    f = jnp.einsum("...p,kp->...k", b, jnp.asarray(_idct_kron()),
                   preferred_element_type=jnp.float32,
                   precision=DCT_PRECISION)
    q = f / qtable.astype(jnp.float32)
    return jnp.round(q).astype(jnp.int16)


@functools.lru_cache(maxsize=128)
def _jit_encode(height, width, ncomp, subsample):
    import jax
    import jax.numpy as jnp

    def cdiv(a, b):
        return -(-a // b)

    def fn(arr, qluma, qchroma):
        if ncomp == 1:
            y = arr[..., 0].astype(jnp.int32)
            bh, bw = cdiv(height, 8), cdiv(width, 8)
            return (fdct_quant(plane_to_blocks(y, bh, bw), qluma),)
        y, cb, cr = rgb_to_ycbcr(arr)
        if subsample:
            cb = box_downsample_2x2(cb)
            cr = box_downsample_2x2(cr)
            ch, cw = cdiv(height, 2), cdiv(width, 2)
        else:
            ch, cw = height, width
        # true block dims: ceil(comp_size/8); partial MCUs get dummy
        # blocks from libjpeg's jctrans.c on write
        ybh, ybw = cdiv(height, 8), cdiv(width, 8)
        cbh, cbw = cdiv(ch, 8), cdiv(cw, 8)
        out_y = fdct_quant(plane_to_blocks(y, ybh, ybw), qluma)
        out_cb = fdct_quant(plane_to_blocks(cb, cbh, cbw), qchroma)
        out_cr = fdct_quant(plane_to_blocks(cr, cbh, cbw), qchroma)
        return out_y, out_cb, out_cr

    return jax.jit(fn)


def encode_to_coefficients(arr: np.ndarray, quality: int,
                           subsample: bool = True):
    """(H, W, C) uint8 (C=1 grey or 3 rgb) -> list of component dicts for
    native.lib.jpeg_coef_write."""
    h, w, c = arr.shape
    qluma, qchroma = quality_tables(quality)
    fn = _jit_encode(h, w, c, subsample and c == 3)
    outs = fn(arr, qluma, qchroma)
    outs = [np.asarray(o) for o in outs]
    if c == 1:
        return [{"coefs": outs[0], "qtable": qluma, "h_samp": 1, "v_samp": 1}]
    hs = 2 if subsample else 1
    return [
        {"coefs": outs[0], "qtable": qluma, "h_samp": hs, "v_samp": hs},
        {"coefs": outs[1], "qtable": qchroma, "h_samp": 1, "v_samp": 1},
        {"coefs": outs[2], "qtable": qchroma, "h_samp": 1, "v_samp": 1},
    ]
