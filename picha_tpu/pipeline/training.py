"""Training-input pipeline (BASELINE.json config 5): batched JPEG decode
+ random crop + resize + normalize feeding a model step.

Deterministic, seedable and resumable (SURVEY.md §5.4): the iterator's
state is (epoch, position, seed) — save `state()`, rebuild with
`TrainingInput(..., state=saved)` and the stream continues identically.

Stage split:
  host pool:   entropy decode -> coefficient tensors (per signature)
               -> DCT-domain ROI pre-crop (default: pack/upload only
               the iMCU-aligned region around each host-drawn crop
               window — ~25x fewer wire bytes on 1080p -> 224 crops)
  device graph:   dequant+IDCT+upsample+YCbCr -> residual-offset crop ->
               resize -> normalize (one jit per signature bucket)
Both the host window draw and the on-device residual/flip derive from
(seed, epoch, pos), so the stream stays a deterministic, resumable
function of (bytes, step); pre_crop=False restores the
upload-everything on-device-window path.
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence

import numpy as np

from ..native import lib as native
from ..ops import jpeg_tpu
from ..ops.resize import resize_f32
from .jpeg_batch import bucket_by_signature, pad_group, signature


@functools.lru_cache(maxsize=128)
def _jit_crop_resize_normalize(sig, crop: int, out: int, filter_name: str,
                               fscale: float, gap4_ks=None,
                               augment_cfg=None, host_offsets=False):
    import jax
    import jax.numpy as jnp

    from .jpeg_batch import unpack_gap4_wire

    width, height = sig[0], sig[1]
    if crop > min(width, height):
        raise ValueError("crop larger than image")
    base = _decode_graph(sig)

    def fn(coef_args, key, xs=None, ys=None):
        if gap4_ks is not None:
            coefs, qtabs = unpack_gap4_wire(coef_args[0], gap4_ks, sig[3])
            coef_args = coefs + qtabs
        rgb = base(*coef_args)  # (N,H,W,C) int32
        n = rgb.shape[0]
        kx, ky, kf = jax.random.split(key, 3)
        if not host_offsets:
            # offsets drawn on-device: pure function of (bytes, step)
            xs = jax.random.randint(kx, (n,), 0, width - crop + 1)
            ys = jax.random.randint(ky, (n,), 0, height - crop + 1)
        # host_offsets: the host drew the window and pre-cropped the
        # coefficient region; xs/ys are the residuals inside it. The
        # flip keeps the device key either way (kf).
        flip = jax.random.bernoulli(kf, 0.5, (n,))

        def crop_one(img, x, y, fl):
            c = jax.lax.dynamic_slice(img, (y, x, 0), (crop, crop, 3))
            return jax.lax.cond(fl, lambda t: t[:, ::-1], lambda t: t, c)

        cropped = jax.vmap(crop_one)(rgb, xs, ys, flip)
        f = cropped.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
        f = jnp.clip(resize_f32(f, out, out, filter_name, fscale), 0.0, 1.0)
        if augment_cfg:
            from .augment import augment as _augment

            f = _augment(f, jax.random.fold_in(key, 0x5eed),
                         **dict(augment_cfg))
        return f

    return jax.jit(fn)


def _region_axis(pos: int, crop: int, dim: int, al: int, margin: int):
    """One axis of the pre-crop region: an `al`-aligned start and a
    region extent covering [pos, pos+crop) with at least `margin`
    pixels of TRUE context on each side — except where the region
    border coincides with a true image border, where cropped and
    full-frame decodes edge-pin identically. Returns (start, extent).

    The nominal extent is the fixed `crop + 2*al` (one sig per source
    geometry); draws near the high edge snap the region to the true
    image border (extent `crop + 2*al + dim%al` — a second sig only
    for unaligned dims, handled by signature bucketing)."""
    span = crop + 2 * al
    if dim <= span:
        return 0, dim
    lo = max(0, (pos - margin) // al * al)
    dim_al = dim // al * al
    if lo + span >= dim_al:  # high border must be the true image edge
        lo = max(0, dim_al - span)
        return lo, dim - lo
    return lo, span


def _crop_region(co, crop: int, x: int, y: int):
    """Slice one image's coefficient grid to the region for a crop
    window at (x, y). Returns (region_co, y_residual, x_residual).

    Invariant (tests/test_pipeline.py): decoding the region and taking
    [y_res:y_res+crop, x_res:x_res+crop] is BIT-IDENTICAL to cropping
    the full-frame decode — the margin keeps >= 1 chroma sample
    (2*samp_ratio px) of true context around the window for the fancy
    upsamplers, so region-border edge-pinning never reaches it."""
    one = co.ncomp == 1  # MCU = 1 block: samp factors don't apply
    hmax = 1 if one else max(c["h_samp"] for c in co.comps)
    vmax = 1 if one else max(c["v_samp"] for c in co.comps)
    ax, ay = 8 * hmax, 8 * vmax
    x0, w_reg = _region_axis(x, crop, co.width, ax, 2 * hmax)
    y0, h_reg = _region_axis(y, crop, co.height, ay, 2 * vmax)
    comps = []
    for c in co.comps:
        hs = 1 if one else c["h_samp"]
        vs = 1 if one else c["v_samp"]
        bx, by = x0 * hs // (hmax * 8), y0 * vs // (vmax * 8)
        dw, dh = -(-w_reg * hs // hmax), -(-h_reg * vs // vmax)
        nbw, nbh = -(-dw // 8), -(-dh // 8)
        take = np.asarray(c["coefs"], np.int16)[by:by + nbh,
                                                bx:bx + nbw]
        if take.shape[:2] != (nbh, nbw):
            take = np.pad(take, ((0, nbh - take.shape[0]),
                                 (0, nbw - take.shape[1]), (0, 0)))
        comps.append({"h_samp": hs, "v_samp": vs,
                      "blocks_w": nbw, "blocks_h": nbh,
                      "width": dw, "height": dh,
                      "qtable": c["qtable"], "coefs": take})
    region = native.JpegCoefficients.from_parts(
        w_reg, h_reg, co.color_space, comps)
    return region, y - y0, x - x0


def _pre_crop_host(cos, crop: int, rng):
    """DCT-domain ROI pre-crop (host side): slice each image's
    coefficient block grid down to an iMCU-aligned region covering a
    host-drawn random crop window, so the sparse pack and the upload
    carry ~(crop+2*iMCU)^2 pixels instead of the full frame — on 1080p
    sources feeding 224-crops that is ~20x fewer wire bytes. The
    residual offset inside the region is applied on-device
    (dynamic_slice), keeping sub-iMCU randomness.

    The region keeps enough true context around the window (see
    _crop_region) that the fine crop decodes bit-identically to a
    full-frame decode on every sampling mode. Returns (region_cos,
    offsets (N, 2) int32 [y, x] residuals)."""
    out, offs = [], []
    for co in cos:
        if co.width < crop or co.height < crop:
            raise ValueError("crop larger than image")
        x = int(rng.integers(0, co.width - crop + 1))
        y = int(rng.integers(0, co.height - crop + 1))
        region, yr, xr = _crop_region(co, crop, x, y)
        out.append(region)
        offs.append((yr, xr))
    return out, np.asarray(offs, np.int32)


def _tuplify(v):
    """Recursively lists -> tuples: state() round-trips through JSON
    (checkpoint meta), which turns the ks_high tuple keys into lists."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuplify(x) for x in v)
    return v


@functools.lru_cache(maxsize=128)
def _decode_graph(sig):
    """coefficients -> (N,H,W,3) int32 RGB decode stage (traceable);
    shares the one staged-decode implementation (jpeg_tpu)."""
    width, height, color_space, comp_sig = sig
    stage = jpeg_tpu.build_decode_stage(comp_sig, color_space, width,
                                        height, force_rgb=True)

    def decode_stage(*args):
        n = len(comp_sig)
        return stage(args[:n], args[n:])

    return decode_stage


class TrainingInput:
    """Deterministic resumable iterator over JPEG bytes.

    >>> ti = TrainingInput(files, batch=256, crop=192, size=224, seed=0)
    >>> batch = next(ti)            # (256, 224, 224, 3) float32 [0,1]
    >>> saved = ti.state()
    >>> ti2 = TrainingInput(files, batch=256, crop=192, size=224,
    ...                     state=saved)   # continues identically
    """

    def __init__(self, items: Sequence[bytes], batch: int, crop: int,
                 size: int, seed: int = 0, filter: str = "cubic",
                 filter_scale: float = 1.0, state: Optional[dict] = None,
                 num_threads: int = 8, augment: Optional[dict] = None,
                 pre_crop: bool = True):
        from concurrent.futures import ThreadPoolExecutor

        self.num_threads = num_threads
        self.items = list(items)
        self.batch = batch
        self.crop = crop
        self.size = size
        self.filter = filter
        self.fscale = filter_scale
        # DCT-domain ROI pre-crop (see _pre_crop_host): host draws the
        # window (seeded by (seed, epoch, pos) — still deterministic
        # and resumable), packs/uploads only the iMCU-aligned region.
        # False restores the upload-everything on-device-window path.
        self.pre_crop = pre_crop
        # device-side augmentations (pipeline/augment.py), applied
        # inside the jit graph after resize — e.g. {"brightness_s": .2,
        # "contrast_s": .2, "saturation_s": .2, "cutout_size": 32}.
        # Hashable tuple form keys the jit cache.
        self.augment = tuple(sorted((augment or {}).items())) or None
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="picha-train")
        # per-(signature, batch-size) high-water gap4 ks (see _run_group);
        # carried through state() so a resumed process starts from the
        # converged jit-key floors instead of re-paying the compiles
        # of every smaller bucket it re-discovers
        self._ks_high: dict = {}
        if state is not None:
            self.seed = state["seed"]
            self.epoch = state["epoch"]
            self.pos = state["pos"]
            self._ks_high = {_tuplify(k): _tuplify(v)
                             for k, v in state.get("ks_high", [])}
        else:
            self.seed = seed
            self.epoch = 0
            self.pos = 0
        self._perm = self._epoch_perm()

    def state(self) -> dict:
        # ks_high as [key, value] pairs: checkpoint meta round-trips
        # through JSON (models/checkpoint.py), which has no tuple type —
        # __init__ re-tuplifies. Values never affect outputs (padding is
        # no-op encoded), only which jit graphs get minted.
        return {"seed": self.seed, "epoch": self.epoch, "pos": self.pos,
                "ks_high": [[k, v] for k, v in self._ks_high.items()]}

    def _epoch_perm(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return rng.permutation(len(self.items))

    def __iter__(self):
        return self

    def __next__(self):
        import jax

        if self.pos + self.batch > len(self.items):
            self.epoch += 1
            self.pos = 0
            self._perm = self._epoch_perm()
        idx = self._perm[self.pos : self.pos + self.batch]
        # fold epoch and pos separately: injective for any dataset size
        step_key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), self.epoch),
            self.pos)
        host_rng = np.random.default_rng((self.seed, self.epoch, self.pos))
        self.pos += self.batch

        bufs = [self.items[i] for i in idx]
        # shared dispatch policy (jpeg_batch.entropy_decode): libjpeg
        # across images for wide batches, restart-segment-parallel
        # native decode when threads outnumber images; serial on the
        # 1-core box where pool threads only convoy on the GIL
        from .jpeg_batch import entropy_decode

        cos = entropy_decode(
            bufs, self._pool if (os.cpu_count() or 1) > 1 else None,
            max_threads=self.num_threads)
        offs = None
        if self.pre_crop:
            cos, offs = _pre_crop_host(cos, self.crop, host_rng)
        groups = bucket_by_signature(cos)
        if len(groups) == 1:
            return self._run_group(groups[0][2], step_key, offs)
        # heterogeneous batch: per-signature sub-batches padded to a
        # size multiple (bounded XLA shape zoo), reassembled in the
        # permutation's order — deterministic across resume because
        # grouping depends only on (dataset, seed, epoch, pos)
        import jax
        import jax.numpy as jnp

        parts, order = [], []
        for gi, (sig, idxs, group) in enumerate(groups):
            padded, n = pad_group(group)
            goffs = None
            if offs is not None:
                goffs = np.zeros((len(padded), 2), np.int32)
                goffs[:n] = offs[np.asarray(idxs)]
            out = self._run_group(padded, jax.random.fold_in(step_key, gi),
                                  goffs)
            parts.append(out[:n])
            order.extend(idxs)
        inv = np.argsort(np.asarray(order))
        return jnp.concatenate(parts, axis=0)[inv]

    def _run_group(self, cos, key, offs=None):
        # gap4 nibble wire: ~4x fewer upload bytes than dense int16
        # coefficients, bit-exact.
        # Monotone per-signature high-water ks: random ROI regions vary
        # in packed size per draw, and every fresh (k1,k2,kc) bucket
        # would mint a new jit graph; growing-only ks converges to a
        # handful of graphs per corpus.
        from .jpeg_batch import signature, stack_gap4_wire

        sig0 = (signature(cos[0]), len(cos))
        # 1.5x headroom on the pack sizes: random ROI draws vary per
        # batch, and a draw that packed slightly larger than the
        # high-water would re-mint the graph (a compile landing
        # mid-training). The wire-byte cost is trivial here (regions are
        # ~crop^2, not full frames).
        sig, ks, wire = stack_gap4_wire(cos, self._ks_high.get(sig0),
                                        headroom=1.5)
        self._ks_high[sig0] = ks
        fn = _jit_crop_resize_normalize(sig, self.crop, self.size,
                                        self.filter, self.fscale,
                                        gap4_ks=ks,
                                        augment_cfg=self.augment,
                                        host_offsets=offs is not None)
        if offs is None:
            return fn((wire,), key)
        return fn((wire,), key, offs[:, 1], offs[:, 0])
