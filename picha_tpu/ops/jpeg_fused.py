"""Fully-fused JPEG decode+resize: coefficients -> resized YCbCr in two
matmuls per component.

Every pixel stage between entropy decode and the colour transform is
LINEAR: dequantisation (diagonal), IDCT (Kronecker of the 8-point DCT
basis), fancy chroma upsampling (banded triangle operator) and the
separable resize (banded contribution matrices). So they compose into
one pair of per-component weight matrices applied directly to the
coefficient grid:

    tmp[n,bh,v,ox] = sum_{bw,u} coefq[n,bh,bw,v,u] * Th[ox,bw,u]
    out[n,oy,ox]   = sum_{bh,v} tmp[n,bh,v,ox]   * Tv[oy,bh,v]

where Th folds (resizeW ∘ crop ∘ upsampleH ∘ IDCTx) and Tv folds
(resizeV ∘ upsampleV ∘ IDCTy). Compared to the staged graph this
removes the block->plane transposes, the full-resolution intermediate
planes, and runs YCbCr->RGB at the *target* resolution.

Numerics: float32 end to end (the staged path clamps/rounds planes to
uint8 between stages; this path doesn't), held to ~1 LSB of the staged
path by tests. The tiny bias constants of libjpeg's integer fancy
upsampler (+1/+2 >> 2) are dropped — they contribute < 0.5 LSB.
"""
from __future__ import annotations

import functools

import numpy as np

from .jpeg_tpu import _IDCT_A, CS_CMYK, CS_GRAYSCALE, CS_RGB, CS_YCBCR, CS_YCCK
from .resize import resize_weights


def upsample_matrix(factor: int, n_out: int, n_in: int,
                    fancy: bool = True) -> np.ndarray:
    """(n_out, n_in) linear operator of libjpeg's upsampler: triangle
    ("fancy") weights for 2x when `fancy`, replication otherwise;
    edge-replicated. `fancy` mirrors libjpeg-turbo's jinit_upsampler
    routing — h2v1, h1v2 and h2v2 get the triangle; every other
    integer expansion is int_upsample replication (jdsample.c)."""
    U = np.zeros((n_out, n_in), dtype=np.float32)
    if factor == 1:
        for i in range(n_out):
            U[i, min(i, n_in - 1)] = 1.0
        return U
    if factor == 2 and fancy:
        for o in range(n_out):
            i = o // 2
            if o % 2 == 0:
                far = max(i - 1, 0)
            else:
                far = min(i + 1, n_in - 1)
            U[o, min(i, n_in - 1)] += 0.75
            U[o, far] += 0.25
        return U
    for o in range(n_out):
        U[o, min(o // factor, n_in - 1)] = 1.0
    return U


IDENTITY = "__identity__"  # decode-only: no resampling, W = I

# Matmul precision of the two fold contractions: DEFAULT (TF32 on the
# GPU). Measured on the H100 (PERF.md precision table): 0.26 LSB mean
# from the strict host path at both DEFAULT and HIGHEST, while HIGHEST
# takes about three times as long — so the cheapest precision.
FOLD_PRECISION = "default"


@functools.lru_cache(maxsize=64)
def component_weights(dst_size: int, full_size: int, comp_size: int,
                      factor: int, filter_name: str, fscale: float,
                      fancy: bool = True):
    # maxsize: each entry is a dense (dst, blocks*8) f32 fold (~8 MB at
    # identity 1080p); 512 entries could pin GBs in a long-lived
    # service that sees many geometries
    """(dst_size, blocks, 8) float32: resize ∘ upsample ∘ IDCT folded."""
    if filter_name == IDENTITY:
        W = np.eye(dst_size, full_size, dtype=np.float32)
    else:
        W = resize_weights(dst_size, full_size, filter_name, fscale)
    if factor != 1 or comp_size != full_size:
        U = upsample_matrix(factor, full_size, comp_size, fancy)
        W = W @ U  # (dst, comp_size)
    # zero-pad to the block grid; the padded columns hit the encoder's
    # dummy samples in partial blocks, which resize weights never tap
    blocks = -(-comp_size // 8)
    Wp = np.zeros((dst_size, blocks * 8), dtype=np.float32)
    Wp[:, :comp_size] = W[:, :comp_size]
    Wb = Wp.reshape(dst_size, blocks, 8)
    # fold the IDCT basis: T[o, b, u] = sum_x Wb[o, b, x] * A[u, x]
    T = np.einsum("obx,ux->obu", Wb, _IDCT_A).astype(np.float32)
    return T


# Why the DENSE fold is the one fast path: the contribution matrices
# are banded (several times fewer FLOPs at 2x downscale), but every
# banded formulation measured slower on the device — the XLA vmap-gather
# form materialises per-tile windows in device memory, and the banded
# Pallas kernels ran the small tiles at low matrix-unit utilisation.
# Not measured on the H100 (docs/PERFORMANCE.md).


def fused_component(coefs, qtable, comp_geom=None):
    """coefs (N, bh, bw, 64) int16, qtable (N,1,1,64) -> (N, oy, ox) f32
    sample values (level-shifted, unclamped).

    comp_geom: (out_w, out_h, width, height, dw, dh, fw_factor,
    fv_factor, filter_name, fscale)."""
    import jax.numpy as jnp

    (out_w, out_h, width, height, dw, dh, fx, fy, filter_name,
     fscale) = comp_geom
    cq = coefs.astype(jnp.float32) * qtable.astype(jnp.float32)
    n, bh, bw = cq.shape[0], cq.shape[1], cq.shape[2]
    cq = cq.reshape(n, bh, bw, 8, 8)  # [v, u]

    # libjpeg-turbo routing (the linked host oracle): fancy triangle
    # upsamplers exist for h2v1, h1v2 and h2v2; every other integer
    # expansion (4x, 2h4v, ...) is int_upsample replication
    fancy_h = fx == 2 and fy in (1, 2)
    fancy_v = fy == 2 and fx in (1, 2)
    th = component_weights(out_w, width, dw, fx, filter_name, fscale,
                           fancy_h)
    tmp = jnp.einsum("nhwvu,owu->nhvo", cq, jnp.asarray(th),
                     preferred_element_type=jnp.float32,
                     precision=FOLD_PRECISION)
    tv = component_weights(out_h, height, dh, fy, filter_name, fscale,
                           fancy_v)
    out = jnp.einsum("nhvo,yhv->nyo", tmp, jnp.asarray(tv),
                     preferred_element_type=jnp.float32,
                     precision=FOLD_PRECISION)
    return out + 128.0


def fused_decode_resize(comp_sig, color_space, width, height, out_w, out_h,
                        filter_name, fscale, coefs, qtabs):
    """Traceable: per-component fused matmuls -> colour transform at the
    target resolution -> float RGB/grey in [0, 255] (unrounded)."""
    import jax.numpy as jnp

    from .jpeg_tpu import check_integer_sampling

    check_integer_sampling(comp_sig)
    max_h = max(s[2] for s in comp_sig)
    max_v = max(s[3] for s in comp_sig)
    planes = []
    for i, (bh, bw, hs, vs) in enumerate(comp_sig):
        dw = -(-width * hs // max_h)
        dh = -(-height * vs // max_v)
        geom = (out_w, out_h, width, height, dw, dh,
                max_h // hs, max_v // vs, filter_name, fscale)
        planes.append(fused_component(coefs[i], qtabs[i], geom))

    if color_space == CS_GRAYSCALE or len(planes) == 1:
        return planes[0][..., None]
    if color_space == CS_RGB:
        return jnp.stack(planes[:3], axis=-1)

    def ycc_to_rgb(y, cb, cr):
        cbs = cb - 128.0
        crs = cr - 128.0
        r = y + 1.40200 * crs
        g = y - 0.34414 * cbs - 0.71414 * crs
        b = y + 1.77200 * cbs
        return jnp.stack([r, g, b], axis=-1)

    if color_space == CS_YCBCR:
        return ycc_to_rgb(planes[0], planes[1], planes[2])
    # CMYK/YCCK: the reference (and the staged path's
    # cmyk_fold_to_rgb) FLOORS the fold (rgb = c*k // 255,
    # jpegcodec.cc:36-42); the batch graph rounds this float output
    # half-up, so subtract the 0.5 here to net a floor — without it
    # every pixel whose exact c*k/255 has fraction >= .5 lands +1
    # (measured +0.40 mean signed bias on the CMYK fixture)
    if color_space == CS_YCCK:
        cmy = 255.0 - jnp.clip(
            ycc_to_rgb(planes[0], planes[1], planes[2]), 0.0, 255.0)
        k = jnp.clip(planes[3], 0.0, 255.0)
        return cmy * k[..., None] * (1.0 / 255.0) - 0.5
    if color_space == CS_CMYK:
        cmy = jnp.stack(planes[:3], axis=-1)
        k = planes[3]
        return (jnp.clip(cmy, 0.0, 255.0)
                * jnp.clip(k, 0.0, 255.0)[..., None] * (1.0 / 255.0)) - 0.5
    raise ValueError(f"unsupported colour space {color_space}")
