"""Device-side training augmentations (BASELINE config 5 extension).

Pure jit-able functions over (N, H, W, C) float32 batches in [0, 1],
driven by explicit `jax.random` keys so the input pipeline stays a pure
function of (bytes, step) — the same property TrainingInput's on-device
random crop relies on. All ops are shape-static (masks from iota
comparisons, no dynamic slicing beyond what XLA folds), so they fuse
into the decode->resize->normalize graph and shard trivially along the
batch (dp) axis.

The reference library has no training pipeline (SURVEY.md §2 bottom
rows document the absence); this module is part of the device-native
framework's config-5 story. Luma weights match the colour-convert op
(r=.299 g=.587 b=.114, renormalized — reference colorconvert.h:12).

Order note: `color_jitter` applies brightness -> contrast -> saturation
in a fixed order (torchvision randomizes the order per call; a fixed
order keeps one compiled graph and the difference is below training
noise).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy: a module-level jnp.array would run device work at
# IMPORT time (pipeline/__init__ imports this module) and start the
# default backend before the caller could choose its platform
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)
_LUMA = (_LUMA / _LUMA.sum()).astype(np.float32)


def _factors(key, n, strength):
    """Per-image multipliers U[1-s, 1+s], broadcastable to (N,H,W,C)."""
    f = jax.random.uniform(key, (n,), minval=1.0 - strength,
                           maxval=1.0 + strength)
    return f[:, None, None, None]


def brightness(batch, key, strength: float):
    """Per-image scale: x * U[1-s, 1+s], clipped to [0, 1]."""
    return jnp.clip(batch * _factors(key, batch.shape[0], strength), 0.0,
                    1.0)


def contrast(batch, key, strength: float):
    """Blend with the per-image grey mean: (x - m) * f + m."""
    grey = jnp.tensordot(batch, _LUMA, axes=[[-1], [0]])
    m = grey.mean(axis=(1, 2))[:, None, None, None]
    f = _factors(key, batch.shape[0], strength)
    return jnp.clip((batch - m) * f + m, 0.0, 1.0)


def saturation(batch, key, strength: float):
    """Blend each pixel with its luma: grey + (x - grey) * f."""
    grey = jnp.tensordot(batch, _LUMA, axes=[[-1], [0]])[..., None]
    f = _factors(key, batch.shape[0], strength)
    return jnp.clip(grey + (batch - grey) * f, 0.0, 1.0)


def color_jitter(batch, key, brightness_s=0.0, contrast_s=0.0,
                 saturation_s=0.0):
    kb, kc, ks = jax.random.split(key, 3)
    if brightness_s:
        batch = brightness(batch, kb, brightness_s)
    if contrast_s:
        batch = contrast(batch, kc, contrast_s)
    if saturation_s:
        batch = saturation(batch, ks, saturation_s)
    return batch


def cutout(batch, key, size: int, fill: float = 0.0):
    """Zero (or `fill`) one random size x size square per image (mask
    from iota comparisons — static shapes, fuses on the device). The square's
    centre is uniform over the image, so it clips at borders (standard
    cutout semantics: expected masked area shrinks near edges)."""
    n, h, w, _ = batch.shape
    ky, kx = jax.random.split(key)
    ty = jax.random.randint(ky, (n,), 0, h) - size // 2
    tx = jax.random.randint(kx, (n,), 0, w) - size // 2
    yy = jnp.arange(h)[None, :, None]
    xx = jnp.arange(w)[None, None, :]
    dy = yy - ty[:, None, None]
    dx = xx - tx[:, None, None]
    inside = (dy >= 0) & (dy < size) & (dx >= 0) & (dx < size)
    return jnp.where(inside[..., None], jnp.float32(fill), batch)


def mixup(batch, labels, key, alpha: float = 0.2):
    """Batch-level mixup (Zhang et al. 2017): convex-combine each image
    with its neighbour under a batch roll. Returns (mixed_batch,
    mixed_labels, lam). labels may be None (returns None for them)."""
    lam = jax.random.beta(key, alpha, alpha)
    lam = jnp.maximum(lam, 1.0 - lam)  # keep the dominant image first
    mixed = lam * batch + (1.0 - lam) * jnp.roll(batch, 1, axis=0)
    ml = None
    if labels is not None:
        ml = lam * labels + (1.0 - lam) * jnp.roll(labels, 1, axis=0)
    return mixed, ml, lam


def augment(batch, key, *, brightness_s=0.0, contrast_s=0.0,
            saturation_s=0.0, cutout_size=0, cutout_fill=0.0):
    """Compose the per-image augmentations (no mixup — that needs the
    labels, call it separately). jit-able; per-image randomness derives
    from `key` only."""
    kj, kc = jax.random.split(key)
    batch = color_jitter(batch, kj, brightness_s, contrast_s,
                         saturation_s)
    if cutout_size:
        batch = cutout(batch, kc, cutout_size, cutout_fill)
    return batch
