#!/usr/bin/env python
"""Smoke run of picha_tpu's main paths on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(c) on one card
    python chip_smoke.py --four-cards  # phase (d) only, on four cards

One process drives the card through the entry points a user calls:

  (a) batch transcode — seeded 1920x1088 q85 4:2:0 corpora, one without
      and one with restart markers, through JpegBatchPipeline (device
      entropy decode, fused decode+resize, device fDCT and Huffman
      encode) with stream(depth=2); every host-fallback counter must
      stay 0. Parity: device entropy decode bit-exact vs libjpeg (plus
      a |DC diff| ~2040 batch), device Huffman encode byte-identical to
      the host encode of the same coefficients, fused and staged pixels
      <= 1 LSB mean per image vs the strict host path, device resize
      <= 1 LSB max vs a float64 numpy resize;
  (b) training ingest — TrainingInput at batch 256, crop 192 -> 224 on
      mixed-size sources; resume from state() must be bit-equal, and a
      batch is checked against a libjpeg + float64 reference;
  (c) serving — 64 requests through DynamicBatcher, all answered and
      equal to the batch pipeline at the same size;
  (d) four cards — row-sharded resize of a 16384x16384 image and the
      fused batch graph on a 4-way data-parallel mesh, each against
      one card.

Each phase prints one line with its set-up/compile and steady seconds,
peak device memory and parity figures. The card's name and power
limit come first; the last line is the JSON verdict. Exits non-zero,
with no verdict, when JAX finds no GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 42
SRC_W, SRC_H = 1920, 1088
OUT_W, OUT_H = 960, 544


def log(*a):
    print(*a, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def require(r: dict, cond, what: str) -> None:
    """Record a failed gate in the phase's result line."""
    if not cond:
        r.setdefault("failed", []).append(what)


# ---------------------------------------------------------------------------
# device and card
# ---------------------------------------------------------------------------

def require_gpu(count: int = 1):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"'{devs[0].platform}'); refusing to fall back")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}")
    return devs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def peak_gib(devices=None) -> float:
    import jax

    devs = devices or jax.devices()[:1]
    return max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
               for d in devs) / 2**30


def timed(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# seeded corpora
# ---------------------------------------------------------------------------

def grating_corpus(n: int, w: int, h: int, seed: int = SEED,
                   quality: int = 85, restart: int = 0) -> list:
    """Smooth colour gratings plus noise, JPEG-encoded 4:2:0 by
    libjpeg (the synthetic corpus the repo has always benchmarked)."""
    from picha_tpu.native import lib as native

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    noise = rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    out = []
    for i in range(n):
        fx, fy = rng.uniform(1, 6, 2)
        base = (127 + 60 * np.sin(2 * np.pi * fx * xx / w + i)
                + 50 * np.cos(2 * np.pi * fy * yy / h))
        img = np.stack([base, np.roll(base, 37, axis=1),
                        np.roll(base, 71, axis=0)], axis=-1)
        arr = np.clip(img + np.roll(noise, i * 13, axis=1), 0,
                      255).astype(np.uint8)
        out.append(native.jpeg_encode(arr, quality, restart=restart))
    return out


def extreme_dc_corpus(n: int, w: int, h: int, seed: int = SEED) -> list:
    """Black/white 8x8-block checkerboards at q100 (DC quantiser 1):
    luma DC differences of about +-2040, the largest a baseline 8-bit
    stream carries."""
    from picha_tpu.native import lib as native

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        by, bx = np.mgrid[0:h, 0:w] // 8
        board = ((by + bx + i) % 2).astype(np.float32) * 255
        flip = rng.random((h // 8 + 1, w // 8 + 1)) < 0.1
        board = np.where(flip[by, bx], 255 - board, board)
        arr = np.repeat(board[..., None], 3, axis=2).astype(np.uint8)
        out.append(native.jpeg_encode(arr, 100))
    return out


def mixed_size_corpus(n: int, sizes, seed: int = SEED) -> list:
    rng = np.random.default_rng(seed + 1)
    picks = rng.integers(0, len(sizes), n)
    out = []
    for i, k in enumerate(picks):
        w, h = sizes[k]
        out += grating_corpus(1, w, h, seed=seed + 7 * i)
    return out


# ---------------------------------------------------------------------------
# plain references
# ---------------------------------------------------------------------------

def scan_of(jpeg: bytes) -> bytes:
    """Entropy-coded bytes between the SOS header and EOI."""
    i = 2
    while i + 4 <= len(jpeg):
        if jpeg[i] != 0xFF:
            break
        ln = (jpeg[i + 2] << 8) | jpeg[i + 3]
        if jpeg[i + 1] == 0xDA:
            return jpeg[i + 2 + ln:-2]
        i += 2 + ln
    raise SmokeFailure("no SOS marker in encoded JPEG")


def resize_f64(arr: np.ndarray, w: int, h: int, filter_name: str,
               fscale: float) -> np.ndarray:
    """Separable resize in float64 numpy with the reference's weights:
    the plain reference for the device resize graph."""
    from picha_tpu.ops.resize import _iter_contribs

    def weights(dst, src):
        m = np.zeros((dst, src), np.float64)
        for i, left, wt in _iter_contribs(dst, src, filter_name, fscale):
            m[i, left:left + wt.size] = wt
        return m

    f = arr.astype(np.float64) / 255.0
    tmp = np.einsum("ow,...hwc->...hoc", weights(w, arr.shape[-2]), f)
    out = np.einsum("oh,...hwc->...owc", weights(h, arr.shape[-3]), tmp)
    return np.floor(np.clip(out * 255.0 + 0.5, 0, 255)).astype(np.uint8)


def host_pixels(pipe, bufs) -> np.ndarray:
    """The strict host path's pixels (libjpeg decode -> native resize),
    i.e. JpegBatchPipeline.host_encode_batch_staged before its encode."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops.resize import _resize_native

    out = []
    for b in bufs:
        w, h, c = native.jpeg_stat(b)
        a = native.jpeg_decode(b, 3 if c >= 3 else 1, w, h)
        out.append(_resize_native(a, pipe._width, pipe._height,
                                  pipe._filter, pipe._fscale))
    return np.stack(out)


def mean_lsb(a, b) -> np.ndarray:
    """Per-image mean |a - b| in LSB."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.reshape(d.shape[0], -1).mean(axis=1)


# ---------------------------------------------------------------------------
# phase (a): batch transcode
# ---------------------------------------------------------------------------

def decode_exact(bufs) -> tuple:
    """Device entropy decode (the pipeline's decoder core, run alone)
    vs libjpeg's coefficients. Returns (all equal, max |DC diff| seen,
    device seconds of one steady decode)."""
    import jax

    from picha_tpu.native import lib as native
    from picha_tpu.ops.jpeg_huffman_decode_tpu import (ScanBatch,
                                                       build_decoder,
                                                       decode_planes)
    from picha_tpu.ops.jpeg_scan import parse_baseline

    batch = ScanBatch([parse_baseline(b) for b in bufs])
    planes = decode_planes(batch)
    check(planes is not None, "device decoder did not converge")
    equal, dcmax = True, 0
    for i, b in enumerate(bufs):
        co = native.JpegCoefficients(b)
        for ci, comp in enumerate(co.comps):
            ref = comp["coefs"]
            equal &= bool(np.array_equal(planes[ci][i], ref))
            dc = ref[..., 0].astype(np.int64).reshape(-1)
            dcmax = max(dcmax, int(np.abs(np.diff(dc)).max(initial=0)))
    fn = build_decoder(*batch.static_key())
    args = [jax.device_put(a) for a in batch.args()]
    jax.block_until_ready(fn(*args))
    _, dt = timed(lambda: jax.block_until_ready(fn(*args)))
    return equal, dcmax, dt


def encode_identical(bufs, width, height, quality) -> bool:
    """Device Huffman encode vs the host (libjpeg) Huffman encode of the
    SAME device-quantised coefficients: scan bytes must be identical."""
    import jax

    from picha_tpu.ops.jpeg_huffman_tpu import build_scan_encoder
    from picha_tpu.pipeline import JpegBatchPipeline
    from picha_tpu.pipeline.jpeg_batch import _resized_comp_sig

    coef_pipe = JpegBatchPipeline(width=width, height=height,
                                  encode_quality=quality, fused=True,
                                  upload="scan", encode_backend="tpu")
    dev_pipe = JpegBatchPipeline(width=width, height=height,
                                 encode_quality=quality, fused=True,
                                 upload="scan", encode_backend="device")
    try:
        sig, out = coef_pipe._process(coef_pipe.entropy_decode(bufs))
        _, (coefs, ok), _ = out
        check(bool(np.asarray(ok)), "device decoder did not converge")
        host = coef_pipe.huffman_encode(coefs, sig)
        enc = jax.jit(build_scan_encoder(
            _resized_comp_sig(height, width, 3), dev_pipe._scan_cap_for(sig)))
        dev = dev_pipe.scan_finish(enc(coefs), sig)
        return all(scan_of(a) == scan_of(b) for a, b in zip(dev, host))
    finally:
        coef_pipe.close()
        dev_pipe.close()


def pixel_parity(bufs, width, height) -> dict:
    """Fused and staged device pixel stages vs the strict host path
    (max over images of the per-image mean LSB), and the device resize
    graph vs float64 numpy (max LSB). The pixel stages take libjpeg's
    coefficients (dense upload): the device entropy decode is checked
    bit-exact on its own, so it need not be compiled again here."""
    import jax

    from picha_tpu.native import lib as native
    from picha_tpu.ops.resize import _jit_resize
    from picha_tpu.pipeline import JpegBatchPipeline

    res = {}
    for name, fused in (("fused", True), ("staged", False)):
        p = JpegBatchPipeline(width=width, height=height, fused=fused)
        try:
            dev = np.asarray(p(bufs))
            res[name + "_lsb_mean"] = float(mean_lsb(
                dev, host_pixels(p, bufs)).max())
        finally:
            p.close()
    w, h, _ = native.jpeg_stat(bufs[0])
    src = np.stack([native.jpeg_decode(b, 3, w, h) for b in bufs[:4]])
    flt, fsc = p._filter, p._fscale
    dev = np.asarray(_jit_resize("uint8", width, height, flt, fsc)(
        jax.device_put(src)))
    ref = resize_f64(src, width, height, flt, fsc)
    res["resize_lsb_max"] = int(np.abs(dev.astype(int) - ref).max())
    return res


def phase_transcode(n_img=64, batch=16, src=(SRC_W, SRC_H),
                    out=(OUT_W, OUT_H), quality=85, restart=0,
                    dc_src=(512, 512), name="", stage_parity=True) -> dict:
    """Phase (a) on one corpus. `stage_parity` adds the checks that do
    not depend on the entropy decoder (the extreme-DC decode, the
    encoder and the pixel stages), which one corpus suffices for."""
    import jax

    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline
    from picha_tpu.pipeline.jpeg_batch import _jit_batch_graph

    t0 = time.perf_counter()
    bufs = grating_corpus(n_img, *src, restart=restart)
    batches = [bufs[i:i + batch] for i in range(0, n_img, batch)]
    pipe = JpegBatchPipeline(width=out[0], height=out[1],
                             encode_quality=quality, fused=True,
                             upload="scan", encode_backend="device")
    r = {"phase": f"a/{name}", "images": n_img, "batch": batch,
         "corpus_s": time.perf_counter() - t0}
    try:
        # compile the main graph once at its real widths
        infos = pipe.entropy_decode(batches[0])
        sig, ks, args = pipe.stack_bucket(infos)
        graph = _jit_batch_graph(
            sig, out[0], out[1], pipe._filter, pipe._fscale, False,
            quality, None, False, True, None, None, pipe._scan_cap_for(sig),
            None, ks)
        dargs = [jax.device_put(a) for a in args]
        compiled, r["compile_s"] = timed(
            lambda: graph.lower(*dargs).compile())
        ma = compiled.memory_analysis()
        if ma is not None:
            r["graph_temp_gib"] = ma.temp_size_in_bytes / 2**30
        _, r["first_batch_s"] = timed(lambda: pipe(batches[0]))
        jax.block_until_ready(graph(*dargs))
        _, r["device_batch_s"] = timed(
            lambda: jax.block_until_ready(graph(*dargs)))

        outs, r["steady_s"] = timed(
            lambda: [j for res in pipe.stream(batches, depth=2)
                     for j in res])
        r["img_s"] = n_img / r["steady_s"]
        r["src_mpix_s"] = r["img_s"] * src[0] * src[1] / 1e6
        r["fallbacks"] = dict(pipe.host_fallbacks)
        require(r, len(outs) == n_img, "stream lost images")
        require(r, all(v == 0 for v in pipe.host_fallbacks.values()),
                "host fallbacks")

        stats = [native.jpeg_stat(b) for b in bufs[:batch]]
        ref = pipe.host_encode_batch_staged(bufs[:batch], stats, quality)
        dec = [native.jpeg_decode(j, 3, out[0], out[1])
               for j in outs[:batch]]
        ref_dec = [native.jpeg_decode(j, 3, out[0], out[1]) for j in ref]
        r["e2e_lsb_mean"] = float(mean_lsb(dec, ref_dec).max())
    finally:
        pipe.close()

    r["decode_exact"], r["dc_diff_max"], r["decoder_s"] = decode_exact(
        batches[0])
    if stage_parity:
        exact_dc, dc_ext, _ = decode_exact(extreme_dc_corpus(4, *dc_src))
        r["decode_exact"] &= exact_dc
        r["dc_diff_max"] = max(r["dc_diff_max"], dc_ext)
        r["encode_identical"] = encode_identical(batches[0], out[0],
                                                 out[1], quality)
        r.update(pixel_parity(batches[0], out[0], out[1]))
        require(r, r["encode_identical"],
                "device encode differs from libjpeg")
        require(r, r["fused_lsb_mean"] <= 1.0
                and r["staged_lsb_mean"] <= 1.0,
                "pixel parity above 1 LSB mean")
        require(r, r["resize_lsb_max"] <= 1, "resize above 1 LSB max")
    r["peak_gib"] = peak_gib()
    require(r, r["decode_exact"], "device decode differs from libjpeg")
    return r


# ---------------------------------------------------------------------------
# phase (b): training ingest
# ---------------------------------------------------------------------------

TRAIN_SIZES = ((500, 375), (375, 500), (500, 333), (480, 360))


def training_reference(ti, bufs, pos, epoch) -> np.ndarray:
    """libjpeg decode -> the host-drawn crop -> float64 resize, for the
    batch TrainingInput yields at (epoch, pos). Offsets come from the
    iterator's documented seeding; flips are matched per image."""
    from picha_tpu.native import lib as native

    perm = np.random.default_rng((ti.seed, epoch)).permutation(len(bufs))
    rng = np.random.default_rng((ti.seed, epoch, pos))
    out = []
    for i in perm[pos:pos + ti.batch]:
        w, h, _ = native.jpeg_stat(bufs[i])
        x = int(rng.integers(0, w - ti.crop + 1))
        y = int(rng.integers(0, h - ti.crop + 1))
        a = native.jpeg_decode(bufs[i], 3, w, h)[y:y + ti.crop,
                                                  x:x + ti.crop]
        out.append(a)
    return np.stack(out)


def phase_training(n_src=512, batch=256, crop=192, size=224,
                   sizes=TRAIN_SIZES) -> dict:
    import jax

    from picha_tpu.pipeline import TrainingInput
    from picha_tpu.pipeline.training import _jit_crop_resize_normalize

    def graphs():
        return _jit_crop_resize_normalize.cache_info().misses

    t0 = time.perf_counter()
    bufs = mixed_size_corpus(n_src, sizes)
    r = {"phase": "b/training", "sources": n_src, "batch": batch,
         "corpus_s": time.perf_counter() - t0}
    ti = TrainingInput(bufs, batch=batch, crop=crop, size=size, seed=0)
    first, r["first_step_s"] = timed(
        lambda: jax.block_until_ready(next(ti)))
    epoch, pos = ti.epoch, ti.pos
    if pos + batch > n_src:
        epoch, pos = epoch + 1, 0
    n_graphs = graphs()
    second, r["steady_step_s"] = timed(
        lambda: jax.block_until_ready(next(ti)))
    # a step that meets a new (signature, group size, pack size) bucket
    # compiles a graph inside the timed step
    r["steady_step_new_graphs"] = graphs() - n_graphs
    r["img_s"] = batch / r["steady_step_s"]
    check(second.shape == (batch, size, size, 3), "bad batch shape")
    require(r, bool(np.isfinite(np.asarray(second)).all()),
            "non-finite batch")
    saved = ti.state()
    third = np.asarray(next(ti))
    resumed = TrainingInput(bufs, batch=batch, crop=crop, size=size,
                            state=saved)
    r["resume_bit_equal"] = bool(np.array_equal(np.asarray(next(resumed)),
                                                third))
    crops = training_reference(ti, bufs, pos, epoch)
    got = np.asarray(second) * 255.0
    lsb = np.minimum(*(mean_lsb(got, resize_f64(c, size, size, ti.filter,
                                                ti.fscale))
                       for c in (crops, crops[:, :, ::-1])))
    r["ref_lsb_mean"] = float(lsb.max())
    r["peak_gib"] = peak_gib()
    require(r, r["resume_bit_equal"], "resumed batch differs")
    require(r, r["ref_lsb_mean"] <= 1.0, "training batch above 1 LSB mean")
    return r


# ---------------------------------------------------------------------------
# phase (c): serving
# ---------------------------------------------------------------------------

def phase_serving(n_req=64, src=(SRC_W, SRC_H), size=224, max_batch=32,
                  max_delay_ms=5.0) -> dict:
    from picha_tpu.pipeline import DynamicBatcher, JpegBatchPipeline

    bufs = grating_corpus(n_req, *src, seed=SEED + 3)
    r = {"phase": "c/serving", "requests": n_req}
    srv = DynamicBatcher(width=size, height=size, max_batch=max_batch,
                         max_delay_ms=max_delay_ms)
    try:
        warm = [srv.submit(b) for b in bufs[:max_batch]]
        _, r["first_s"] = timed(lambda: [f.result(900) for f in warm])
        t0 = time.perf_counter()
        futs = [srv.submit(b) for b in bufs]
        got = np.stack([f.result(900) for f in futs])
        r["steady_s"] = time.perf_counter() - t0
    finally:
        srv.close(timeout=60)
    r["req_s"] = n_req / r["steady_s"]
    pipe = JpegBatchPipeline(width=size, height=size, fused=True,
                             upload="scan")
    try:
        want = np.asarray(pipe(bufs))
    finally:
        pipe.close()
    r["answered"] = len(got)
    r["lsb_max_vs_batch"] = int(np.abs(got.astype(int) - want).max())
    r["peak_gib"] = peak_gib()
    require(r, r["answered"] == n_req, "requests unanswered")
    require(r, r["lsb_max_vs_batch"] <= 1, "server differs from batch pipeline")
    return r


# ---------------------------------------------------------------------------
# phase (d): four cards
# ---------------------------------------------------------------------------

def phase_four_cards(n_dev=4, side=16384, out_side=8192, n_img=64,
                     src=(SRC_W, SRC_H), out=(OUT_W, OUT_H)) -> dict:
    import jax

    from picha_tpu.ops.resize import _jit_resize, parse_resize_options
    from picha_tpu.parallel.mesh import make_mesh, shard_batch
    from picha_tpu.parallel.spatial import resize_sharded
    from picha_tpu.pipeline import JpegBatchPipeline
    from picha_tpu.pipeline.jpeg_batch import _jit_batch_graph

    devs = jax.devices()[:n_dev]
    r = {"phase": "d/four-cards", "devices": len(devs)}
    rng = np.random.default_rng(SEED)
    tile = rng.integers(0, 256, (side // 64, side // 64, 3), np.uint8)
    img = np.kron(tile, np.ones((64, 64, 1), np.uint8))
    img = (img + rng.integers(0, 8, img.shape, np.uint8)).astype(np.uint8)

    mesh = make_mesh((("sp", n_dev),), devices=devs)
    sp_in = jax.device_put(img, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("sp", None, None)))
    jax.block_until_ready(resize_sharded(sp_in, out_side, out_side, mesh))
    sharded, r["spatial_s"] = timed(lambda: jax.block_until_ready(
        resize_sharded(sp_in, out_side, out_side, mesh)))
    name, fscale = parse_resize_options({})
    one_fn = _jit_resize("uint8", out_side, out_side, name, fscale)
    one_in = jax.device_put(img, devs[0])
    jax.block_until_ready(one_fn(one_in))
    one, r["spatial_one_card_s"] = timed(
        lambda: jax.block_until_ready(one_fn(one_in)))
    r["spatial_lsb_max"] = int(np.abs(np.asarray(sharded).astype(int)
                                      - np.asarray(one)).max())

    bufs = grating_corpus(n_img, *src, seed=SEED + 5)
    pipe = JpegBatchPipeline(width=out[0], height=out[1], fused=True)
    try:
        sig, args = pipe.stack_bucket(pipe.entropy_decode(bufs))
    finally:
        pipe.close()
    graph = _jit_batch_graph(sig, out[0], out[1], pipe._filter,
                             pipe._fscale, False, None, None, False, True)
    dp = make_mesh((("dp", n_dev),), devices=devs)
    dp_args = [shard_batch(a, dp) for a in args]
    jax.block_until_ready(graph(*dp_args))
    dp_out, r["dp_s"] = timed(lambda: jax.block_until_ready(
        graph(*dp_args)))
    one_args = [jax.device_put(a, devs[0]) for a in args]
    jax.block_until_ready(graph(*one_args))
    one_out, r["dp_one_card_s"] = timed(lambda: jax.block_until_ready(
        graph(*one_args)))
    r["dp_lsb_max"] = int(np.abs(np.asarray(dp_out).astype(int)
                                 - np.asarray(one_out)).max())
    r["peak_gib"] = peak_gib(devs)
    require(r, r["spatial_lsb_max"] <= 1, "sharded resize differs from one card")
    require(r, r["dp_lsb_max"] <= 1, "dp batch graph differs from one card")
    return r


# ---------------------------------------------------------------------------

def report(r: dict) -> None:
    def fmt(v):
        return f"{v:.4f}" if isinstance(v, float) else v

    log(" ".join(f"{k}={fmt(v)}" for k, v in r.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    opts = ap.parse_args(argv)
    t_start = time.perf_counter()
    n_cards = 4 if opts.four_cards else 1
    devs = require_gpu(n_cards)
    log(f"card: {card_line()}")
    log(f"jax: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")

    t0 = time.perf_counter()
    # importing the package loads the native library, building it first
    # when its stamp does not match these sources on this host
    from picha_tpu.native import build

    build.build()
    log(f"setup: native_build_s={time.perf_counter() - t0:.4f}")
    if opts.four_cards:
        phases = [phase_four_cards]
    else:
        phases = [lambda: phase_transcode(restart=0, name="no-restart"),
                  lambda: phase_transcode(restart=8, name="restart",
                                          stage_parity=False),
                  phase_training, phase_serving]
    failed = False
    for ph in phases:
        try:
            r, r["wall_s"] = timed(ph)
            report(r)
            failed |= bool(r.get("failed"))
        except SmokeFailure as e:
            log(f"FAILED: {e}")
            failed = True
        except Exception:  # noqa: BLE001 — report every phase, then fail
            import traceback

            traceback.print_exc()
            failed = True
    log(f"total_wall_s={time.perf_counter() - t_start:.4f}")
    if failed:
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
