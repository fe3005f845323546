"""Batched JPEG pipeline: the throughput path.

The reference's concurrency story was one libuv thread per request
(SURVEY.md §2 "Async execution"). The device-native equivalent is a
two-stage pipeline (SURVEY.md §5.8):

  host threads:  bytes -> entropy decode -> DCT coefficient tensors
  device (one jit): dequant + IDCT + upsample + YCbCr + resize + pack
                 (optionally + fDCT + quantise for re-encode)

Images are grouped into shape buckets — XLA requires static shapes —
keyed by the coefficient-geometry signature; each bucket compiles once
and is reused (SURVEY.md §7 hard part (c)).

All pixel math runs batched over (N, ...) tensors, so the device sees
large matmuls (IDCT: N*blocks 8x8 contractions; resize: banded weight
matmuls over N*H rows).
"""
from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..native import lib as native
from ..ops import jpeg_tpu
from ..ops.resize import parse_resize_options, resize_f32


def entropy_decode(bufs: Sequence[bytes], pool: Optional[ThreadPoolExecutor] = None,
                   max_threads: Optional[int] = None,
                   force_libjpeg: bool = False
                   ) -> List[native.JpegCoefficients]:
    """Parallel host entropy decode (ctypes releases the GIL).

    Parallelism policy: a batch at least as wide as the thread budget
    fills it with cross-image libjpeg decodes (fastest per core). A
    NARROW batch on a wide budget additionally splits each image's
    restart segments over the idle threads
    (native.jpeg_coefficients -> jpegentropy.cc) — per-image
    parallelism libjpeg cannot offer.

    max_threads caps the TOTAL host threads this call may burst
    (callers with a user-sized pool pass its size so a num_threads=1
    request never fans out to every core); default = core count.
    force_libjpeg pins the libjpeg decoder (pathological-stream
    fallbacks want its warn-and-pad recovery semantics, which the
    clamping native decoder does not reproduce)."""
    cores = os.cpu_count() or 1
    if max_threads is not None:
        cores = max(1, min(cores, max_threads))
    if not force_libjpeg and cores > 1 and 0 < len(bufs) < cores:
        # distribute the cores exactly (ceil for the first cores%len
        # images, floor for the rest) so concurrent decodes never
        # oversubscribe the host
        base, extra = divmod(cores, len(bufs))
        fn = lambda i_b: native.jpeg_coefficients(  # noqa: E731
            i_b[1], nthreads=base + (1 if i_b[0] < extra else 0))
        items = list(enumerate(bufs))
        return list(pool.map(fn, items)) if pool else [fn(x) for x in items]
    if pool is None:
        return [native.JpegCoefficients(b) for b in bufs]
    return list(pool.map(native.JpegCoefficients, bufs))


def signature(co):
    from ..ops.jpeg_scan import ScanInfo

    if isinstance(co, ScanInfo):
        # scan-upload path: geometry from the header parse alone (the
        # comp_sig values equal libjpeg's, tested) — no entropy decode
        return (co.width, co.height, co.color_space, co.comp_sig)
    return (co.width, co.height, co.color_space,
            tuple((c["blocks_h"], c["blocks_w"], c["h_samp"], c["v_samp"])
                  for c in co.comps))


def _resized_comp_sig(h: int, w: int, channels: int):
    """Component geometry of the re-encoded image, matching
    jpeg_tpu._jit_encode's block grids (4:2:0 for colour)."""
    def cdiv(a, b):
        return -(-a // b)

    if channels == 1:
        return ((cdiv(h, 8), cdiv(w, 8), 1, 1),)
    ch, cw = cdiv(h, 2), cdiv(w, 2)
    return ((cdiv(h, 8), cdiv(w, 8), 2, 2),
            (cdiv(ch, 8), cdiv(cw, 8), 1, 1),
            (cdiv(ch, 8), cdiv(cw, 8), 1, 1))


def bucket_by_signature(cos):
    """Group decoded coefficient sets by shape signature (SURVEY.md §7
    hard part (c): XLA needs static shapes, real corpora are ragged).

    Returns a list of (sig, indices, group) with indices into the input
    order; iteration order is deterministic (first appearance)."""
    order = {}
    for i, co in enumerate(cos):
        order.setdefault(signature(co), []).append(i)
    return [(sig, idxs, [cos[i] for i in idxs])
            for sig, idxs in order.items()]


def pad_group(group, multiple: int = 8):
    """Pad a bucket to a size multiple by repeating its last element —
    bounds the number of distinct batch shapes XLA has to compile.
    Returns (padded_group, real_count)."""
    n = len(group)
    target = -(-n // multiple) * multiple
    return list(group) + [group[-1]] * (target - n), n


def gap4_restore_flat(prim, sg, sv, ci, cv, bh, bw):
    """Device side of the gap4 nibble wire for one component: primary
    (gap<<4 | value-code) bytes (7 adds zero, 15 escapes to the gap8
    side stream) + int16 corrections; all three scatters are single
    global image-major sorted ops (vmap lowers scatters poorly on this
    backend)."""
    import jax.numpy as jnp

    m = bh * bw * 64
    n_img = prim.shape[0]
    base = jnp.arange(n_img, dtype=jnp.int32)[:, None] * m
    g = (prim >> 4).astype(jnp.int32)
    idx = jnp.cumsum(g, axis=1) - 1
    nib = (prim & 15).astype(jnp.int32)
    v = jnp.where(nib == 15, 0, nib - 7)
    gi = (jnp.maximum(idx, 0) + base).reshape(-1)
    flat = jnp.zeros((n_img * m,), jnp.int32).at[gi].add(
        v.reshape(-1), indices_are_sorted=True)
    idx2 = jnp.cumsum(sg.astype(jnp.int32), axis=1) - 1
    gi2 = (jnp.maximum(idx2, 0) + base).reshape(-1)
    flat = flat.at[gi2].add(sv.astype(jnp.int32).reshape(-1),
                            indices_are_sorted=True)
    flat = flat.at[ci].add(cv.astype(jnp.int32), indices_are_sorted=True)
    return flat.reshape((-1, bh, bw, 64))


def unpack_gap4_wire(buf, gap4_ks, comp_sig):
    """Coalesced gap4 wire buffer -> (per-component dense coefficient
    tensors, qtables) on device (single upload; this link pays a large
    fixed latency per transfer)."""
    import jax.numpy as jnp
    from jax import lax

    nb, ks = gap4_ks
    n = len(comp_sig)
    off = 0

    def take(count, dtype):
        nonlocal off
        width = jnp.dtype(dtype).itemsize
        raw = buf[off:off + count * width]
        off += count * width
        if width == 1:
            return lax.bitcast_convert_type(raw, dtype)
        return lax.bitcast_convert_type(raw.reshape(count, width), dtype)

    parts = []
    for i in range(n):
        k1, k2, kc = ks[i]
        prim = take(nb * k1, jnp.uint8).reshape(nb, k1)
        sg = take(nb * k2, jnp.uint8).reshape(nb, k2)
        sv = take(nb * k2, jnp.int8).reshape(nb, k2)
        ci = take(kc, jnp.int32)
        cv = take(kc, jnp.int16)
        parts.append((prim, sg, sv, ci, cv))
    qtabs = tuple(
        take(nb * 64, jnp.uint16).reshape(nb, 1, 1, 64) for _ in range(n))
    coefs = tuple(
        gap4_restore_flat(p_, sg, sv, ci, cv,
                          comp_sig[i][0], comp_sig[i][1])
        for i, (p_, sg, sv, ci, cv) in enumerate(parts))
    return coefs, qtabs


def stack_gap4_wire(cos, ks_floor=None, headroom: float = 1.0):
    """Host side: same-signature coefficient sets -> (gap4_ks, wire
    uint8 buffer) via the single-scan native batch packer.

    ks_floor: a previously returned gap4_ks to use as a per-component
    size floor — callers whose batch content varies per step (e.g.
    TrainingInput's random ROI regions) keep a monotone high-water ks
    per signature so the jit static key converges instead of flipping
    between buckets (each flip is a fresh compile).

    headroom: over-size factor on this batch's measured pack sizes
    (see native.gap4_pack_batch) so the FIRST minted graph already
    covers later, slightly-larger draws."""
    sig = signature(cos[0])
    n = len(cos[0].comps)
    nb = len(cos)
    ks, sections = [], []
    for i in range(n):
        k1, k2, kc, prim, sgaps, svals, ci, cv = native.gap4_pack_batch(
            [co.comps[i]["coefs"] for co in cos],
            k_floor=None if ks_floor is None else ks_floor[1][i],
            headroom=headroom)
        sections += [prim.reshape(-1), sgaps.reshape(-1),
                     svals.view(np.uint8).reshape(-1),
                     ci.view(np.uint8).reshape(-1),
                     cv.view(np.uint8).reshape(-1)]
        ks.append((k1, k2, kc))
    for i in range(n):
        q = np.stack([co.comps[i]["qtable"] for co in cos])
        sections.append(np.ascontiguousarray(
            q.astype(np.uint16)).view(np.uint8).reshape(-1))
    return sig, (nb, tuple(ks)), np.concatenate(sections)


@functools.lru_cache(maxsize=256)
def _jit_batch_graph(sig, out_w: Optional[int], out_h: Optional[int],
                     filter_name: str, filter_scale: float,
                     normalize: bool, encode_quality: Optional[int],
                     sparse_ks: Optional[tuple] = None,
                     yuv420_out: bool = False,
                     fused: bool = False,
                     int8_ks: Optional[tuple] = None,
                     gap8_ks: Optional[tuple] = None,
                     device_scan_cap: Optional[int] = None,
                     gap4_ks: Optional[tuple] = None,
                     scan_ks: Optional[tuple] = None):
    """Build the fused batched graph for one signature bucket.

    Stages: coefficients -> RGB/grey (N,H,W,C int32) -> optional resize
    (u8 semantics preserved: unpack/pack round-half-up) -> one of
      * uint8 image batch
      * normalized float32 (training input)
      * re-encoded quantised coefficients (encode_quality set)
    """
    import jax
    import jax.numpy as jnp

    width, height, color_space, comp_sig = sig
    decode_stage = jpeg_tpu.build_decode_stage(comp_sig, color_space,
                                               width, height)

    def densify(idx, val, bh, bw):
        # scatter-add the (index, value) pairs into dense blocks.
        # Indices are sorted (np.flatnonzero order) with tail padding at
        # m-1 carrying value 0, so the scatter can take the sorted
        # hint
        m = bh * bw * 64

        def one(i, v):
            return jnp.zeros((m,), jnp.int32).at[i].add(
                v.astype(jnp.int32), indices_are_sorted=True)

        dense = jax.vmap(one)(idx, val)
        return dense.reshape((-1, bh, bw, 64))

    def gap8_restore(g, v, ci, cv, bh, bw):
        # gap-delta wire format (native/src/sparsepack.cc): per-image
        # (gap u8, val i8) pairs with cumulative 1-based indexing, plus
        # a batch-flat int16 correction list for |v| > 127. One global
        # image-major scatter (batched/vmapped scatters lower poorly on
        # this backend), indices sorted end to end.
        m = bh * bw * 64
        n_img = g.shape[0]
        idx = jnp.cumsum(g.astype(jnp.int32), axis=1) - 1  # (N, K) sorted
        gi = (jnp.maximum(idx, 0)
              + jnp.arange(n_img, dtype=jnp.int32)[:, None] * m).reshape(-1)
        flat = jnp.zeros((n_img * m,), jnp.int32).at[gi].add(
            v.astype(jnp.int32).reshape(-1), indices_are_sorted=True)
        flat = flat.at[ci].add(cv.astype(jnp.int32), indices_are_sorted=True)
        return flat.reshape((-1, bh, bw, 64))

    def int8_restore(c8, idx, val):
        # int8 body + batch-flat sorted corrections for |v| > 127
        # (padding at the last index adds zero)
        dense = c8.astype(jnp.int32)
        shape = dense.shape
        flat = dense.reshape(-1)
        flat = flat.at[idx].add(val.astype(jnp.int32),
                                indices_are_sorted=True)
        return flat.reshape(shape)

    def unpack_gap8(buf):
        # single coalesced uint8 upload buffer -> per-component arrays.
        # One transfer instead of ~15 (each host->device copy pays a
        # fixed latency), so the wire layout is one buffer with
        # 4-byte-aligned sections, bitcast on device.
        from jax import lax

        nb, n = gap8_ks[0], len(comp_sig)
        off = 0
        parts = []

        def take(count, dtype):
            nonlocal off
            width = jnp.dtype(dtype).itemsize
            raw = buf[off:off + count * width]
            off += count * width
            if width == 1:
                return lax.bitcast_convert_type(raw, dtype)
            return lax.bitcast_convert_type(raw.reshape(count, width), dtype)

        for i in range(n):
            k, kc = gap8_ks[1][i]
            g = take(nb * k, jnp.uint8).reshape(nb, k)
            v = take(nb * k, jnp.int8).reshape(nb, k)
            ci = take(kc, jnp.int32)
            cv = take(kc, jnp.int16)
            parts.append((g, v, ci, cv))
        qtabs = tuple(
            take(nb * 64, jnp.uint16).reshape(nb, 1, 1, 64)
            for _ in range(n))
        return parts, qtabs

    def fn(*args):
        n = len(comp_sig)
        ok_flag = None
        if scan_ks is not None:
            # raw-scan upload: the ENTIRE entropy decode runs on the
            # chip (ops/jpeg_huffman_decode_tpu.py — chunked
            # speculative Huffman decode), fused into this graph. The
            # host's only work was the header parse + wire layout.
            from ..ops.jpeg_huffman_decode_tpu import (
                build_decoder_core, build_wire_unpack, split_planes)

            unpack = build_wire_unpack(scan_ks, n)
            dec_args, qtabs = unpack(args[0])
            core = build_decoder_core(*scan_ks[:-1])
            scan_out, ok_flag = core(*dec_args)
            coefs = split_planes(scan_out, comp_sig)
        elif gap4_ks is not None:
            coefs, qtabs = unpack_gap4_wire(args[0], gap4_ks, comp_sig)
        elif gap8_ks is not None:
            parts, qtabs = unpack_gap8(args[0])
            coefs = tuple(
                gap8_restore(g, v, ci, cv, comp_sig[i][0], comp_sig[i][1])
                for i, (g, v, ci, cv) in enumerate(parts))
        elif sparse_ks is not None:
            coefs = tuple(
                densify(args[2 * i], args[2 * i + 1],
                        comp_sig[i][0], comp_sig[i][1])
                for i in range(n))
            qtabs = args[2 * n:3 * n]
        elif int8_ks is not None:
            coefs = tuple(
                int8_restore(args[3 * i], args[3 * i + 1], args[3 * i + 2])
                for i in range(n))
            qtabs = args[3 * n:4 * n]
        else:
            coefs, qtabs = args[:n], args[n:2 * n]
        def pixel_stages(coefs, qtabs):
            if fused:
                # single-shot path: dequant+IDCT+upsample(+resize) folded
                # into two matmuls per component (ops/jpeg_fused.py);
                # decode-only uses identity resampling matrices
                from ..ops.jpeg_fused import IDENTITY, fused_decode_resize

                if out_w is not None:
                    fw, fh, fname = out_w, out_h, filter_name
                else:
                    fw, fh, fname = width, height, IDENTITY
                f255 = fused_decode_resize(comp_sig, color_space, width,
                                           height, fw, fh, fname,
                                           filter_scale, coefs, qtabs)
                if normalize:
                    return jnp.clip(f255, 0.0, 255.0) * jnp.float32(1.0 / 255.0)
                img = jnp.floor(jnp.clip(f255 + 0.5, 0.0, 255.0)).astype(jnp.int32)
            elif out_w is not None:
                rgb = decode_stage(coefs, qtabs)  # (N,H,W,C) int32
                f = rgb.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
                f = resize_f32(f, out_w, out_h, filter_name, filter_scale)
                if normalize:
                    # clip resize overshoot so staged and fused agree
                    return jnp.clip(f, 0.0, 1.0)  # (N,out_h,out_w,C) f32
                img = jnp.floor(jnp.clip(f * 255.0 + 0.5, 0.0, 255.0))
                img = img.astype(jnp.int32)
            else:
                rgb = decode_stage(coefs, qtabs)  # (N,H,W,C) int32
                if normalize:
                    return rgb.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
                img = rgb
            if yuv420_out:
                # padded 4:2:0 planes for the host raw-data encoder — halves
                # the device->host bytes vs RGB (1.5 B/px vs 3 B/px)
                eh = out_h if out_h is not None else height
                ew = out_w if out_w is not None else width
                hpad, wpad = (eh + 15) & ~15, (ew + 15) & ~15
                if img.shape[-1] == 1:
                    yp = img[..., 0]
                    cbp = jnp.full(
                        (yp.shape[0], hpad // 2, wpad // 2), 128, jnp.int32)
                    crp = cbp
                    yp = jnp.pad(yp, ((0, 0), (0, hpad - eh), (0, wpad - ew)),
                                 mode="edge")
                else:
                    yp, cbp, crp = jpeg_tpu.rgb_to_ycbcr(img)
                    yp = jnp.pad(yp, ((0, 0), (0, hpad - eh), (0, wpad - ew)),
                                 mode="edge")
                    cbp = jpeg_tpu.box_downsample_2x2(
                        jnp.pad(cbp, ((0, 0), (0, hpad - eh), (0, wpad - ew)),
                                mode="edge"))
                    crp = jpeg_tpu.box_downsample_2x2(
                        jnp.pad(crp, ((0, 0), (0, hpad - eh), (0, wpad - ew)),
                                mode="edge"))
                # one (N, bytes) uint8 buffer per batch: a single readback
                # instead of three (per-transfer link latency dominates)
                nimg = yp.shape[0]
                return jnp.concatenate(
                    [yp.astype(jnp.uint8).reshape(nimg, -1),
                     cbp.astype(jnp.uint8).reshape(nimg, -1),
                     crp.astype(jnp.uint8).reshape(nimg, -1)], axis=1)
            if encode_quality is not None:
                qluma, qchroma = jpeg_tpu.quality_tables(encode_quality)
                eh = out_h if out_h is not None else height
                ew = out_w if out_w is not None else width
                enc = jpeg_tpu._jit_encode.__wrapped__(eh, ew, img.shape[-1],
                                                       img.shape[-1] == 3)
                out_coefs = enc(img.astype(jnp.uint8), qluma, qchroma)
                if device_scan_cap is None:
                    return out_coefs
                # full on-device entropy encode: the readback is finished
                # scan bytes (~0.1-0.2 B/px) instead of 4:2:0 planes
                from .jpeg_batch import _resized_comp_sig
                from ..ops.jpeg_huffman_tpu import build_scan_encoder

                rsig = _resized_comp_sig(eh, ew, img.shape[-1])
                scan_enc = build_scan_encoder(rsig, device_scan_cap)
                return scan_enc(out_coefs)
            return img.astype(jnp.uint8)

        result = pixel_stages(coefs, qtabs)
        if ok_flag is not None:
            return result, ok_flag
        return result

    return jax.jit(fn)


class JpegBatchPipeline:
    """decode -> (resize) -> {uint8 | normalized | re-encoded} over
    homogeneous-signature batches.

    Parameters mirror the single-image ops: resize target + filter
    options (resize.cc semantics), ``normalize`` for training input,
    ``encode_quality`` to run the full decode->resize->encode loop with
    host Huffman writing.
    """

    def __init__(self, width: Optional[int] = None,
                 height: Optional[int] = None, filter: Optional[str] = None,
                 filter_scale: Optional[float] = None,
                 normalize: bool = False,
                 encode_quality: Optional[int] = None,
                 encode_backend: str = "tpu",
                 upload: str = "dense",
                 fused: bool = False,
                 num_threads: Optional[int] = None,
                 scan_byte_cap: Optional[int] = None,
                 host_fast_scale: bool = False,
                 host_raw: bool = False,
                 host_draft: bool = False,
                 fast_guard: Optional[float] = None):
        """encode_backend: 'device' runs the ENTIRE encode on the chip —
        fDCT, quantisation and baseline Huffman coding incl. byte
        stuffing (ops/jpeg_huffman_tpu.py; scan bytes are byte-identical
        to libjpeg's) — so the readback is finished scan bytes
        (~0.1-0.2 B/px) and the host only prepends a cached header.
        'tpu' runs fDCT+quantise on device and Huffman on the host;
        'raw420' reads back 4:2:0 planes for jpeg_write_raw_data;
        'host' reads back the resized uint8 pixels and runs the whole
        encode through libjpeg. 'device' minimises both link directions
        and host CPU; scan_byte_cap bounds its per-image output buffer
        (default ~0.5 B/sample; overflow raises).

        upload: 'dense' ships full (N, bh, bw, 64) int16 coefficient
        tensors; 'sparse' ships (index, value) pairs of the nonzero
        coefficients (typically ~10% at q85 — ~4x fewer host->device
        bytes) and scatter-adds them into dense blocks on device
        (sorted-index scatter; host-side packing costs CPU — profile);
        'int8' ships int8 coefficient bodies plus a tiny sorted
        correction list for |v| > 127 — exactly half the dense bytes,
        bit-exact, near-zero host cost.

        fused: fold dequant+IDCT+upsample+resize into two matmuls per
        component (ops/jpeg_fused.py) — the fastest decode+resize path;
        float-linear numerics within ~1 LSB of the staged path."""
        opts = {}
        if filter is not None:
            opts["filter"] = filter
        if filter_scale is not None:
            opts["filterScale"] = filter_scale
        self._filter, self._fscale = parse_resize_options(opts)
        self._width, self._height = width, height
        self._normalize = normalize
        self._encode_quality = encode_quality
        self._encode_backend = encode_backend
        self._upload = upload
        self._fused = fused
        self._scan_byte_cap = scan_byte_cap
        self._overflow_clone = None  # lazy raw420 fallback pipeline
        # doubled once on the first on-chip encode overflow (dense
        # content): one retry through a larger-budget graph keeps the
        # batch on the device path instead of cliff-dropping to the
        # host fallback (advisor r4). Applies only to the
        # quality-derived default cap, never to an explicit
        # scan_byte_cap.
        self._cap_boost = 1
        # draft-mode host decode: when the resize target is EXACTLY the
        # source/2 (or /4, /8), decode at 1/N via the reduced IDCT and
        # skip the resize — a different resampling than the cubic path
        # (measured ~1.3 LSB avg apart at 1/2, inside the reference's
        # own <2 golden tolerance), opt-in like every thumbnailer's
        # draft path
        self._host_fast_scale = host_fast_scale
        # host-fast divergence tripwire (ops/fastfix.py draft_hf_probe):
        # images whose draft output exceeds this second-difference
        # statistic route to the staged strict path; 0 disables. Trips
        # are counted in fast_guard_trips (observability, like the raw
        # path's gamut-guard fallbacks).
        if fast_guard is None:
            from ..ops.fastfix import GUARD_D2_LSB

            fast_guard = GUARD_D2_LSB if host_fast_scale else 0.0
        self._fast_guard = float(fast_guard)
        self.fast_guard_trips = 0
        # images the device path handed to the host, by reason:
        #   scan_parse      — upload="scan" batch the device decoder
        #                     cannot take (progressive/arithmetic/
        #                     multi-scan, table-id or bit-address limits)
        #   decode_not_ok   — the device decoder did not converge
        #   encode_overflow — the device encode overflowed its budget
        #                     even after the doubled-cap retry
        self.host_fallbacks = {"scan_parse": 0, "decode_not_ok": 0,
                               "encode_overflow": 0}
        self._fallback_lock = threading.Lock()
        # raw-domain host transcode (ops/raw420.py): resize the 4:2:0
        # planes directly with the composed downsample.resize.upsample
        # operator — strict parity (~0.6 LSB of the staged cubic path)
        # at ~0.7x its cost; falls back per image on non-420 layouts
        self._host_raw = host_raw
        # draft-raw transcode (ops/raw420.py transcode_raw420_draft):
        # for targets <= source/2, scale_denom=2 raw decode (chroma
        # comes out EXACT on the half grid; only Y is the 4x4-IDCT
        # draft, pulled onto the cubic grid by a fitted 5-tap
        # correction at exact 2:1, or its LS composition with the
        # remaining resize at smaller targets) — ~0.6-0.9 LSB of the
        # staged path at the lowest host cost of any config; falls
        # back to host_raw then staged per image
        self._host_draft = host_draft
        if host_draft:
            self._host_raw = True
        self._num_threads = num_threads or 8
        self._pool = ThreadPoolExecutor(max_workers=self._num_threads,
                                        thread_name_prefix="picha-entropy")

    def _count_fallback(self, reason: str, n: int) -> None:
        with self._fallback_lock:
            self.host_fallbacks[reason] += n

    def close(self):
        """Release the entropy thread pool (losing configs in
        stream_best, shutdown paths). Idempotent; the pipeline must not
        be used afterwards."""
        self._pool.shutdown(wait=False)

    # -- host stage --------------------------------------------------------

    def _map(self, fn, seq):
        """Pool map on multi-core hosts; serial on one core, where pool
        threads only convoy on the GIL (measured 15% slower)."""
        if (os.cpu_count() or 1) <= 1:
            return [fn(x) for x in seq]
        return list(self._pool.map(fn, seq))

    def entropy_decode(self, bufs):
        if self._upload == "scan":
            # no host entropy decode at all: parse the headers, ship
            # the raw scan, Huffman-decode on the chip. Files the
            # device decoder can't take (progressive, arithmetic,
            # multi-scan) fall back to the host path transparently.
            from ..ops.jpeg_scan import parse_baseline

            infos = [parse_baseline(bytes(b)) for b in bufs]
            if all(i is not None for i in infos):
                # the device decoder's per-lane table ids are uint8; a
                # batch with >255 unique Huffman table rows (per-image
                # optimized tables at scale) must take the host path
                # rather than silently wrap ids onto wrong tables
                from ..ops.jpeg_huffman_decode_tpu import prep_tables

                uniq = set()
                for i in infos:
                    limit, delta, hv = prep_tables(i)  # memoized on i;
                    # ScanBatch.__init__ reuses the cached result
                    for t in range(6):
                        uniq.add((limit[t].tobytes(), delta[t].tobytes(),
                                  hv[t].tobytes()))
                # the decoder addresses bits as int32: gate the batch's
                # scan volume well under 2^31 bits (the kernel also
                # hard-raises; this pre-check routes to host instead)
                scan_bytes = sum(
                    sum(len(s) for s in i.segments) for i in infos)
                if len(uniq) <= 256 and scan_bytes <= 2**27:
                    for i, b in zip(infos, bufs):
                        i.src = b
                    return infos
            self._count_fallback("scan_parse", len(bufs))
        if (os.cpu_count() or 1) <= 1:
            return entropy_decode(bufs, None, max_threads=self._num_threads)
        return entropy_decode(bufs, self._pool,
                              max_threads=self._num_threads)

    def stack_bucket(self, cos):
        """Stack same-signature coefficient sets into batch tensors.

        Returns (sig, args) for dense upload, or (sig, ks, args) for
        sparse upload (ks = static padded-nnz per component)."""
        from ..ops.jpeg_scan import ScanInfo

        sig = signature(cos[0])
        if isinstance(cos[0], ScanInfo):
            from ..ops.jpeg_huffman_decode_tpu import ScanBatch

            ks, wire = ScanBatch(cos).wire()
            return sig, ks, [wire]
        n = len(cos[0].comps)
        args = []
        if self._upload == "sparse":
            ks = []
            for i in range(n):
                flats = [co.comps[i]["coefs"].reshape(-1) for co in cos]
                nzs = [np.flatnonzero(f) for f in flats]
                k = max(1, max(nz.size for nz in nzs))
                k = -(-k // 16384) * 16384  # bucket to limit recompiles
                m = flats[0].size
                # pad with (m-1, 0): keeps indices sorted (fast device
                # scatter) and adds zero
                idx = np.full((len(cos), k), m - 1, np.int32)
                val = np.zeros((len(cos), k), np.int16)
                for j, (f, nz) in enumerate(zip(flats, nzs)):
                    idx[j, : nz.size] = nz
                    val[j, : nz.size] = f[nz]
                args.append(idx)
                args.append(val)
                ks.append(k)
            for i in range(n):
                q = np.stack([co.comps[i]["qtable"] for co in cos])
                args.append(q[:, None, None, :])
            return sig, tuple(ks), args
        if self._upload == "gap4":
            # nibble wire assembled in C++ (native gap4 batch packer);
            # one coalesced upload buffer (shared helper, also used by
            # the training-input graph)
            sig, ks, wire = stack_gap4_wire(cos)
            return sig, ks, [wire]
        if self._upload == "gap8":
            # one coalesced uint8 wire buffer (unpack_gap8 is the device
            # side): [per comp: gaps | vals | corr_idx | corr_val] then
            # the uint16 qtables; every section is 4-byte aligned by the
            # 8192/1024 padding granularity
            nb = len(cos)
            ks = []
            sections = []
            for i in range(n):
                m = cos[0].comps[i]["coefs"].size
                packed = [native.gap8_pack(co.comps[i]["coefs"]) for co in cos]
                k = max(g.size for g, _, _, _ in packed)
                k = -(-k // 8192) * 8192  # bucket to limit recompiles
                gaps = np.zeros((nb, k), np.uint8)
                vals = np.zeros((nb, k), np.int8)
                ci_parts, cv_parts = [], []
                for j, (g, v, ci, cv) in enumerate(packed):
                    gaps[j, : g.size] = g
                    vals[j, : v.size] = v
                    if ci.size:
                        ci_parts.append(ci.astype(np.int64) + j * m)
                        cv_parts.append(cv)
                nc = sum(p.size for p in ci_parts)
                kc = -(-max(1, nc) // 1024) * 1024
                # pad corrections at the last flat index with zero value —
                # keeps the scatter sorted and is a no-op add
                corr_idx = np.full((kc,), nb * m - 1, np.int32)
                corr_val = np.zeros((kc,), np.int16)
                if nc:
                    corr_idx[:nc] = np.concatenate(ci_parts)
                    corr_val[:nc] = np.concatenate(cv_parts)
                sections += [gaps.reshape(-1), vals.view(np.uint8).reshape(-1),
                             corr_idx.view(np.uint8).reshape(-1),
                             corr_val.view(np.uint8).reshape(-1)]
                ks.append((k, kc))
            for i in range(n):
                q = np.stack([co.comps[i]["qtable"] for co in cos])
                sections.append(np.ascontiguousarray(
                    q.astype(np.uint16)).view(np.uint8).reshape(-1))
            wire = np.concatenate(sections)
            return sig, (nb, tuple(ks)), [wire]
        if self._upload == "int8":
            ks = []
            for i in range(n):
                c16 = np.stack([co.comps[i]["coefs"] for co in cos])
                c8 = np.clip(c16, -128, 127).astype(np.int8)
                resid = c16.astype(np.int32) - c8
                flat_idx = np.flatnonzero(resid)
                vals = resid.reshape(-1)[flat_idx].astype(np.int16)
                k = max(1, flat_idx.size)
                k = -(-k // 4096) * 4096
                m = resid.size
                idx = np.full((k,), m - 1, np.int32)
                val = np.zeros((k,), np.int16)
                idx[: flat_idx.size] = flat_idx
                val[: flat_idx.size] = vals
                args.extend([c8, idx, val])
                ks.append(k)
            for i in range(n):
                q = np.stack([co.comps[i]["qtable"] for co in cos])
                args.append(q[:, None, None, :])
            return sig, tuple(ks), args
        for i in range(n):
            args.append(np.stack([co.comps[i]["coefs"] for co in cos]))
        for i in range(n):
            q = np.stack([co.comps[i]["qtable"] for co in cos])
            # (N, 1, 1, 64) so dequant broadcasts against (N, bh, bw, 64)
            args.append(q[:, None, None, :])
        return sig, args

    # -- device stage ------------------------------------------------------

    def run_bucket(self, sig, args, sparse_ks=None, int8_ks=None,
                   gap8_ks=None, gap4_ks=None, scan_ks=None):
        device_quality = (self._encode_quality
                          if self._encode_backend in ("tpu", "device")
                          else None)
        yuv = (self._encode_backend == "raw420"
               and self._encode_quality is not None)
        cap = None
        if self._encode_backend == "device" and device_quality is not None:
            cap = self._scan_cap_for(sig)
        fn = _jit_batch_graph(sig, self._width, self._height, self._filter,
                              self._fscale, self._normalize, device_quality,
                              sparse_ks, yuv, self._fused, int8_ks, gap8_ks,
                              cap, gap4_ks, scan_ks)
        return fn(*args)

    def _scan_cap_for(self, sig) -> int:
        ew = self._width if self._width is not None else sig[0]
        eh = self._height if self._height is not None else sig[1]
        if self._scan_byte_cap is not None:
            return self._scan_byte_cap
        # natural-image baseline scans measure ~0.10-0.20 B/px at q85
        # (bench corpus 0.13; pure noise 0.76 overflows ANY sane cap and
        # takes the loud host fallback, as it did at the old 0.5 B/px
        # cap). The device byte-stage cost (prefix-sum word assembly +
        # stuffing) is LINEAR in this cap, so budget by encode quality
        # with ~1.4x headroom over the dense end of natural content:
        # q<=88 -> 0.1875 B/px, q<=95 -> 0.3125, above -> 0.625. A
        # too-small cap is no longer a cliff: _run_with_retry re-mints
        # the graph once at a DOUBLED budget before any host fallback,
        # so dense batches pay one retry instead of everyone paying a
        # 2x-headroom cap every batch.
        q = self._encode_quality
        px = ew * eh
        frac = 3 if q is None or q <= 88 else (5 if q <= 95 else 10)
        frac *= self._cap_boost
        return max(1 << 16, -(-(px * frac // 16) // 4096) * 4096)

    def _stage_device(self, cos):
        """Host pack + async upload + graph dispatch for one homogeneous
        batch; returns (sig, device outputs) without blocking on the
        device."""
        import jax

        from ..ops.jpeg_scan import ScanInfo

        sig = signature(cos[0])
        if isinstance(cos[0], ScanInfo):
            sig, ks, args = self.stack_bucket(cos)
            dargs = [jax.device_put(a) for a in args]
            out = self.run_bucket(sig, dargs, scan_ks=ks)
            return sig, ("scan", out, [i.src for i in cos])
        if self._upload in ("sparse", "int8", "gap8", "gap4"):
            sig, ks, args = self.stack_bucket(cos)
            dargs = [jax.device_put(a) for a in args]
            kw = {self._upload + "_ks": ks}
            return sig, self.run_bucket(sig, dargs, **kw)
        sig, args = self.stack_bucket(cos)
        dargs = [jax.device_put(a) for a in args]
        return sig, self.run_bucket(sig, dargs)

    def __call__(self, bufs: Sequence[bytes]):
        """Full pipeline for a homogeneous batch; returns device array(s)
        (or encoded JPEG bytes list when encode_quality is set)."""
        cos = self.entropy_decode(bufs)
        sigs = {signature(co) for co in cos}
        if len(sigs) != 1:
            return self._call_mixed(cos)
        return self._run_with_retry(cos)

    def _run_with_retry(self, cos):
        """Run one homogeneous batch; on a device-encode overflow of the
        quality-DERIVED cap, double the budget and retry once (a fresh,
        larger graph — dense content stays on the device path instead
        of cliff-dropping to host, advisor r4) before taking the raw420
        fallback. An explicit scan_byte_cap is the caller's contract
        and is never boosted."""
        try:
            return self._finish(*self._process(cos))
        except OverflowError:
            if self._scan_byte_cap is None and self._cap_boost == 1:
                self._cap_boost = 2
                try:
                    return self._finish(*self._process(cos))
                except OverflowError:
                    pass
            # device scan encode hit its compaction/byte budget (dense
            # content) — redo this batch with the raw420 backend: same
            # device decode+resize, host entropy encode, no budget
            return self._overflow_fallback(cos)

    def _overflow_fallback(self, cos):
        """Re-run a batch whose on-chip encode overflowed its packet or
        byte budget through a raw420-backend clone (device pixel
        stages, host entropy coding — no compaction cap). Rare by
        construction (the cap covers natural content at the configured
        quality; tests pin the overflow signalling), so paying one
        extra jit compile here beats capping everyone for the worst
        case."""
        self._count_fallback("encode_overflow", len(cos))
        clone = self._overflow_clone
        if clone is None:
            clone = JpegBatchPipeline(
                width=self._width, height=self._height,
                filter=self._filter, filter_scale=self._fscale,
                encode_quality=self._encode_quality,
                encode_backend="raw420", fused=self._fused,
                upload=self._upload if self._upload != "scan" else "gap4",
                normalize=self._normalize)
            self._overflow_clone = clone
        from ..ops.jpeg_scan import ScanInfo

        if isinstance(cos[0], ScanInfo):  # scan infos carry the bytes
            cos = entropy_decode([i.src for i in cos], None,
                                 max_threads=self._num_threads)
        return clone._finish(*clone._process(cos))

    def _process(self, cos):
        """Homogeneous batch -> (sig, device output)."""
        from ..ops.jpeg_scan import ScanInfo

        if isinstance(cos[0], ScanInfo):
            try:
                sig, ks, args = self.stack_bucket(cos)
            except ValueError:
                # ScanBatch's own capacity gates (unique-table id space,
                # int32 bit-address space) are the single source of
                # truth; the entropy_decode pre-check is only a fast
                # approximate filter — anything it let through that the
                # kernel rejects degrades to the host path here
                self._count_fallback("scan_parse", len(cos))
                return self._process(
                    entropy_decode([i.src for i in cos], self._pool,
                                   max_threads=self._num_threads))
            out = self.run_bucket(sig, args, scan_ks=ks)
            return sig, ("scan", out, [i.src for i in cos])
        if self._upload in ("sparse", "int8", "gap8", "gap4"):
            sig, ks, args = self.stack_bucket(cos)
            return sig, self.run_bucket(sig, args,
                                        **{self._upload + "_ks": ks})
        sig, args = self.stack_bucket(cos)
        return sig, self.run_bucket(sig, args)

    def _finish(self, sig, out):
        """Device output -> arrays or encoded bytes."""
        if isinstance(out, tuple) and len(out) == 3 and out[0] == "scan":
            _, (res, okf), srcs = out
            if not bool(np.asarray(okf)):
                # the chunked decoder did not converge (pathological
                # stream) — redo the batch through host entropy decode
                # + dense upload; same device pixel stages, identical
                # results
                self._count_fallback("decode_not_ok", len(srcs))
                return self._scan_fallback(srcs)
            out = res
        if self._encode_quality is None:
            return out
        if self._encode_backend == "host":
            batch = np.asarray(out)  # (N, h, w, C) uint8
            q = self._encode_quality
            return self._map(lambda img: native.jpeg_encode(img, q),
                             batch)
        if self._encode_backend == "raw420":
            return self.raw420_encode(out, sig)
        if self._encode_backend == "device":
            return self.scan_finish(out, sig)
        return self.huffman_encode(out, sig)

    def _scan_fallback(self, bufs):
        # force_libjpeg: these streams already defeated the device
        # decoder; the fallback must be the warn-and-pad reference
        # decoder, not the clamping native one (whose output on
        # pathological streams would vary with host core count)
        cos = entropy_decode(list(bufs), None, force_libjpeg=True)
        sig, args = self.stack_bucket(cos)
        return self._finish(sig, self.run_bucket(sig, args))

    def scan_finish(self, out, sig):
        """Host stage for the 'device' encode backend: read back the
        per-image byte counts, then only the longest used prefix of the
        scan buffer (length bucketed to 64 KiB so the slice program
        compiles a handful of times), and prepend the cached header."""
        from ..ops.jpeg_huffman_tpu import assemble, jpeg_header

        scan, nbytes = out
        nb = np.asarray(nbytes)
        cap = scan.shape[1]
        if int(nb.max()) > cap:
            raise OverflowError(
                f"device scan encode overflow ({int(nb.max())} > {cap}): "
                "the scan bytes or packet count exceeded the budget for "
                "this quality (incompressible content?) — raise "
                "scan_byte_cap, lower the quality, or use "
                "encode_backend='raw420'/'host'")
        m = min(cap, -(-int(nb.max()) // 65536) * 65536)
        host = np.asarray(scan[:, :m])
        ew = self._width if self._width is not None else sig[0]
        eh = self._height if self._height is not None else sig[1]
        # channel count of the encode comes from the decode colour space
        channels = 1 if len(sig[3]) == 1 else 3
        rsig = _resized_comp_sig(eh, ew, channels)
        header = jpeg_header(ew, eh, rsig, self._encode_quality)
        return [assemble(header, host[i], int(nb[i]))
                for i in range(host.shape[0])]

    def _call_mixed(self, cos):
        """Heterogeneous batch: bucket by signature, pad each bucket to
        a size multiple (bounding XLA recompiles), run per-bucket
        sub-batches, reassemble in input order (SURVEY.md §7 hard part
        (c); index.js:210-221's any-input contract lifted to batches)."""
        if self._encode_quality is None and (self._width is None
                                             or self._height is None):
            raise ValueError(
                "mixed-signature batch without a resize target has no "
                "common output shape; set width/height or encode_quality")
        results = [None] * len(cos)
        for sig, idxs, group in bucket_by_signature(cos):
            padded, n = pad_group(group)
            out = self._run_with_retry(padded)
            if isinstance(out, list):
                for j, i in enumerate(idxs):
                    results[i] = out[j]
            else:
                arr = np.asarray(out)
                for j, i in enumerate(idxs):
                    results[i] = arr[j]
        if self._encode_quality is None:
            # grey buckets produce C=1; replicate to the batch's widest
            # channel count so the stack has one shape
            cmax = max(r.shape[-1] for r in results)
            results = [np.repeat(r, cmax, axis=-1)
                       if r.shape[-1] != cmax else r for r in results]
            return np.stack(results)
        return results

    def host_encode_batch(self, bufs):
        """Pure-host reference path for one batch: libjpeg decode ->
        resize (XLA:CPU, same weights as the device graph, one batched
        call when dims agree) -> libjpeg encode. Used by the hybrid
        scheduler to soak up host cycles the device chain leaves
        idle."""
        q = self._encode_quality
        stats = [native.jpeg_stat(b) for b in bufs]
        if any(st is None for st in stats):
            raise CodecError("invalid JPEG in batch")
        if self._host_fast_scale and self._width is not None:
            for denom in (2, 4, 8):
                if all(-(-st[0] // denom) == self._width
                       and -(-st[1] // denom) == self._height
                       for st in stats):
                    # denom=2 gets the draft-decode correction filter
                    # (ops/fastfix.py): ~1 ms/img to pull the draft
                    # output 3-4x closer to the strict cubic path —
                    # ONLY when the pipeline actually targets the
                    # filter the taps were fit against (correcting
                    # toward cubic-0.70 under e.g. a triangle target
                    # would move the output the wrong way)
                    fix = None
                    if denom == 2:
                        from ..ops.fastfix import (FIT_FILTER, FIT_SCALE,
                                                   apply_correction)
                        if self._filter == FIT_FILTER \
                                and abs(self._fscale - FIT_SCALE) < 1e-6:
                            fix = apply_correction
                    from ..ops.fastfix import draft_hf_probe

                    outs = []
                    for b, st in zip(bufs, stats):
                        a = native.jpeg_decode(
                            b, 3 if st[2] >= 3 else 1, self._width,
                            self._height, scale_denom=denom)
                        # divergence tripwire (ops/fastfix.py): content
                        # with energy in the bands the scaled IDCT
                        # discards routes to the staged strict path —
                        # the draft analog of the raw path's gamut guard
                        if self._fast_guard and \
                                draft_hf_probe(a) > self._fast_guard:
                            self.fast_guard_trips += 1
                            outs.append(None)
                            continue
                        if fix is not None:
                            a = fix(a)
                        outs.append(native.jpeg_encode(
                            np.ascontiguousarray(a), q))
                    if all(o is not None for o in outs):
                        return outs
                    # guard-tripped stragglers continue into the
                    # staged strict path below
                    keep = [o is None for o in outs]
                    fast_outs = outs
                    bufs = [b for b, k in zip(bufs, keep) if k]
                    stats = [st for st, k in zip(stats, keep) if k]
                    strict = self.host_encode_batch_staged(bufs, stats, q)
                    it = iter(strict)
                    return [o if o is not None else next(it)
                            for o in fast_outs]
        if self._host_raw and self._width is not None:
            from ..ops.raw420 import transcode_raw420, transcode_raw420_draft

            def one_raw(b):
                if self._host_draft:
                    o = transcode_raw420_draft(b, self._width, self._height,
                                               self._filter, self._fscale,
                                               85 if q is None else q)
                    if o is not None:
                        return o
                return transcode_raw420(b, self._width, self._height,
                                        self._filter, self._fscale,
                                        85 if q is None else q)

            outs = [one_raw(b) for b in bufs]
            if all(o is not None for o in outs):
                return outs
            # mixed batch: finish only the non-420 stragglers below
            bufs = [b for b, o in zip(bufs, outs) if o is None]
            stats = [st for st, o in zip(stats, outs) if o is None]
        else:
            outs = None
        enc = self.host_encode_batch_staged(bufs, stats, q)
        if outs is None:
            return enc
        it = iter(enc)
        return [o if o is not None else next(it) for o in outs]

    def host_encode_batch_staged(self, bufs, stats, q):
        """The strict staged host path (full libjpeg decode -> native
        C++ resize -> libjpeg encode) for an already-stat'ed batch — the
        tail every faster host config falls back to per image. Touches
        no JAX backend."""
        from ..ops.resize import _resize_native

        outs = []
        for b, st in zip(bufs, stats):
            a = native.jpeg_decode(b, 3 if st[2] >= 3 else 1, st[0], st[1])
            r = _resize_native(a, self._width, self._height,
                               self._filter, self._fscale)
            outs.append(native.jpeg_encode(np.ascontiguousarray(r), q))
        return outs

    @staticmethod
    def _put(q, item, stop):
        """Bounded put that gives up when the consumer is gone."""
        import queue as _queue

        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def stream_hybrid(self, batches, depth: int = 2):
        """Hybrid host+device scheduler: the device chain is kept up to
        `depth` batches deep with asynchronous dispatch and readback
        (dispatch, device_put and copy_to_host_async all return
        immediately and is_ready() is truthful), and
        every moment the device pipeline is full the SAME thread runs
        the pure-host path (libjpeg + AVX2 resize) on the next batch.

        Single-threaded by design: on a 1-core host, a thread-per-stage
        scheduler convoys on the GIL — measured ~5x inflation of every
        stage (host batch 274 -> 1353 ms) and half the throughput of
        just running the host path serially. Cooperative scheduling
        with async device I/O gets host-path throughput PLUS the device
        chain's contribution.

        Results yield in input order; hybrid (host-path) batches are
        valid JPEGs of the same quality but not bit-equal to
        device-encoded ones (different fDCT path)."""
        import collections

        import jax

        it = iter(batches)
        backlog = collections.deque()   # (idx, bufs) read ahead
        inflight = collections.deque()  # (idx, sig, device out, bufs)
        pending = {}                    # idx -> finished result
        next_yield = 0
        n_read = 0
        done_feeding = False

        def leaves(out):
            return [x for x in jax.tree_util.tree_leaves(out)
                    if hasattr(x, "is_ready")]

        def pump():
            nonlocal n_read, done_feeding
            while not done_feeding and len(backlog) < depth + 2:
                try:
                    bufs = next(it)
                except StopIteration:
                    done_feeding = True
                    return
                backlog.append((n_read, bufs))
                n_read += 1

        def harvest():
            # finish device batches whose readback has landed (head of
            # the deque first — the device stream is in-order)
            while inflight:
                if not all(x.is_ready() for x in leaves(inflight[0][2])):
                    return
                idx, sig, out, _bufs = inflight.popleft()
                try:
                    pending[idx] = self._finish(sig, out)
                except OverflowError:  # on-chip encode budget exceeded
                    self._count_fallback("encode_overflow", len(_bufs))
                    pending[idx] = self.host_encode_batch(_bufs)

        pump()
        while backlog or inflight or pending:
            while next_yield in pending:
                yield pending.pop(next_yield)
                next_yield += 1
            pump()
            harvest()
            # feed the device while it has capacity AND a spare batch
            # remains for the host path
            if len(backlog) >= 2 and len(inflight) < depth:
                idx, bufs = backlog.popleft()
                sig, out = self._stage_device(self.entropy_decode(bufs))
                for x in leaves(out):
                    x.copy_to_host_async()
                inflight.append((idx, sig, out, bufs))
                continue
            if backlog:
                idx, bufs = backlog.popleft()
                pending[idx] = self.host_encode_batch(bufs)
                continue
            if inflight:
                # no backlog left: instead of idling behind a slow
                # device batch, the host re-runs the OLDEST in-flight
                # one on its own path and the stream takes whichever
                # finished (the device result is simply dropped). This
                # caps the stream tail at one host batch even when the
                # device chain's per-batch latency is many times the
                # host's.
                idx, sig, out, bufs = inflight.popleft()
                if all(x.is_ready() for x in leaves(out)):
                    try:
                        pending[idx] = self._finish(sig, out)
                    except OverflowError:
                        self._count_fallback("encode_overflow", len(bufs))
                        pending[idx] = self.host_encode_batch(bufs)
                else:
                    pending[idx] = self.host_encode_batch(bufs)
        while next_yield in pending:
            yield pending.pop(next_yield)
            next_yield += 1

    def stream_host(self, batches):
        """Pure-host streaming: libjpeg decode -> AVX2 native resize ->
        libjpeg encode, batch after batch: the throughput baseline the
        hybrid must beat; bench.py races it against the hybrids."""
        for bufs in batches:
            yield self.host_encode_batch(bufs)

    def stream(self, batches, depth: int = 2):
        """Stage-overlapped pipeline over an iterable of homogeneous
        batches (lists of JPEG bytes). Keeps `depth` batches in flight:

          thread E: entropy decode (libjpeg, GIL released)
          thread D: sparse pack + async upload + graph dispatch
          caller:   device readback + host re-encode

        The upload and readback directions of the host<->device link are
        independent (full duplex), so batch n's result downloads while
        batch n+1's coefficients upload and n+2 entropy-decodes — the
        libuv-overlap story of the reference (resize.cc:364) rebuilt as
        a device pipeline. Yields per-batch results in order."""
        import queue as _queue

        q_cos: _queue.Queue = _queue.Queue(maxsize=depth)
        q_dev: _queue.Queue = _queue.Queue(maxsize=depth)
        _END = object()
        stop = threading.Event()
        put = self._put

        def entropy_worker():
            try:
                for bufs in batches:
                    if not put(q_cos, ("ok", self.entropy_decode(bufs)),
                               stop):
                        return
            except BaseException as e:  # noqa: BLE001 — relay to consumer
                put(q_cos, ("err", e), stop)
            put(q_cos, (_END, None), stop)

        def device_worker():
            while not stop.is_set():
                kind, item = q_cos.get()
                if kind is _END:
                    break
                if kind == "err":
                    put(q_dev, ("err", item), stop)
                    break
                try:
                    if not put(q_dev, ("ok", self._stage_device(item)),
                               stop):
                        return
                except BaseException as e:  # noqa: BLE001
                    put(q_dev, ("err", e), stop)
                    break
            put(q_dev, (_END, None), stop)

        te = threading.Thread(target=entropy_worker, daemon=True)
        td = threading.Thread(target=device_worker, daemon=True)
        te.start()
        td.start()
        try:
            while True:
                kind, item = q_dev.get()
                if kind is _END:
                    return
                if kind == "err":
                    raise item
                sig, out = item
                yield self._finish(sig, out)
        finally:
            stop.set()
            for q in (q_cos, q_dev):
                try:
                    while True:
                        q.get_nowait()
                except _queue.Empty:
                    pass
            te.join(timeout=1.0)
            td.join(timeout=1.0)

    def raw420_encode(self, planes, sig):
        """Host stage for the yuv420 output mode: coalesced (N, bytes)
        plane buffer -> JPEG via jpeg_write_raw_data (fDCT+quant+Huffman
        only on host)."""
        width, height = sig[0], sig[1]
        ew = self._width if self._width is not None else width
        eh = self._height if self._height is not None else height
        hpad, wpad = (eh + 15) & ~15, (ew + 15) & ~15
        q = self._encode_quality
        buf = np.asarray(planes)  # (N, ybytes + 2*cbytes) single readback
        ysz = hpad * wpad
        csz = (hpad // 2) * (wpad // 2)

        def enc(i):
            y = buf[i, :ysz].reshape(hpad, wpad)
            cb = buf[i, ysz : ysz + csz].reshape(hpad // 2, wpad // 2)
            cr = buf[i, ysz + csz :].reshape(hpad // 2, wpad // 2)
            return native.jpeg_encode_raw420(y, cb, cr, ew, eh, q)

        return self._map(enc, range(buf.shape[0]))

    def huffman_encode(self, coef_out, sig):
        """Host stage: quantised coefficient batches -> JPEG bytes."""
        width, height, _, _ = sig
        ew = self._width if self._width is not None else width
        eh = self._height if self._height is not None else height
        qluma, qchroma = jpeg_tpu.quality_tables(self._encode_quality)
        outs = [np.asarray(o) for o in coef_out]
        n = outs[0].shape[0]
        results = []
        if len(outs) == 1:
            def enc1(i):
                comps = [{"coefs": outs[0][i], "qtable": qluma,
                          "h_samp": 1, "v_samp": 1}]
                return native.jpeg_coef_write(ew, eh, comps)
            return self._map(enc1, range(n))
        def enc3(i):
            comps = [
                {"coefs": outs[0][i], "qtable": qluma, "h_samp": 2, "v_samp": 2},
                {"coefs": outs[1][i], "qtable": qchroma, "h_samp": 1, "v_samp": 1},
                {"coefs": outs[2][i], "qtable": qchroma, "h_samp": 1, "v_samp": 1},
            ]
            return native.jpeg_coef_write(ew, eh, comps)
        return self._map(enc3, range(n))
