#!/usr/bin/env python
"""picha_tpu benchmark — runs on one NVIDIA GPU, in one process.

Measures megapixels/sec for the batched JPEG decode -> resize -> encode
pipeline (1080p inputs), plus p50 latency for a single 1080p image,
the device-only pixel-stage throughput, host<->device copy bandwidth
and the host codec rows (PNG, WebP, TIFF, CMYK, deep PNG).

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, ...}
vs_baseline = ratio over a single-threaded CPU stand-in doing the same
work through PIL/libjpeg (the reference is a single-threaded C path per
request and publishes no numbers of its own — BASELINE.md). Exits
non-zero, without a result, when JAX finds no GPU.

Supplementary logs and the full detail go to stderr.
"""
from __future__ import annotations

import io
import json
import os
import statistics
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---- global wall-clock budget -------------------------------------------
# Every stage is gated on a hard deadline, and the compact JSON line is
# emitted by atexit/SIGTERM handlers from whatever completed — a kill
# under a timeout still yields a parseable result.
BENCH_T0 = time.monotonic()
BENCH_DEADLINE_S = float(os.environ.get("PICHA_BENCH_DEADLINE_S", "1350"))
EMIT_RESERVE_S = 25.0  # kept back for the final emit + detail write

# emission state shared with the atexit/SIGTERM handlers; main() fills
# these in place as stages complete
_RESULT = {"detail": {}, "violations": [], "cpu_ips": None,
           "e2e_ips": None, "emitted": False, "device": None}


def budget_left() -> float:
    return BENCH_DEADLINE_S - (time.monotonic() - BENCH_T0)


def emit_compact(reason: str = "") -> None:
    """Print the ONE compact JSON line the driver parses, exactly once,
    from whatever has been measured so far. Safe to call from atexit
    and from a SIGTERM handler."""
    if _RESULT["emitted"]:
        return
    _RESULT["emitted"] = True
    detail = _RESULT["detail"]
    violations = _RESULT["violations"]
    e2e_ips = _RESULT["e2e_ips"] or 0.0
    cpu_ips = _RESULT["cpu_ips"] or 0.0
    mpix = BENCH_W * BENCH_H / 1e6
    detail["strict_parity_mpix_s"] = round(e2e_ips * mpix, 1)
    detail["bench_wall_s"] = round(time.monotonic() - BENCH_T0, 1)
    if reason:
        detail["emit_reason"] = reason
    if violations:
        detail["violations"] = violations
        log(f"PARITY VIOLATIONS — poisoning result: {violations}")
        e2e_ips = 0.0
    full = {
        "metric": "batched 1080p JPEG decode->resize(960x544 cubic)->encode "
                  "q85, end-to-end per chip, strict <=1 LSB parity",
        "value": round(e2e_ips * mpix, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(e2e_ips / cpu_ips, 2) if cpu_ips else 0.0,
        "detail": detail,
    }
    log("detail " + json.dumps(full))
    # the one stdout line stays small; the full detail went to stderr
    compact = {
        "metric": "jpeg e2e decode->resize->encode, strict <=1 LSB",
        "value": full["value"],
        "unit": "Mpix/s",
        "vs_baseline": full["vs_baseline"],
        "p50_ms_1080p": detail.get("p50_ms_1080p"),
        "device_only_mpix_s": detail.get("device_only_mpix_s"),
        "device_only_norestart_mpix_s":
            detail.get("device_only_norestart_mpix_s"),
        "png_e2e_mpix_s": detail.get("png_e2e_mpix_s"),
        "webp_e2e_mpix_s": detail.get("webp_e2e_mpix_s"),
        "tiff_e2e_mpix_s": detail.get("tiff_e2e_mpix_s"),
        "violations": len(violations),
        "device": _RESULT["device"],
    }
    print(json.dumps(compact), flush=True)


def make_test_images(n: int, w: int, h: int, seed: int = 42) -> list:
    from picha_tpu.native import lib as native

    rng = np.random.default_rng(seed)
    bufs = []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    noise = rng.normal(0, 6, (h, w, 3)).astype(np.float32)
    for i in range(n):
        fx, fy = rng.uniform(1, 6, 2)
        base = (127 + 60 * np.sin(2 * np.pi * fx * xx / w + i)
                + 50 * np.cos(2 * np.pi * fy * yy / h))
        img = np.stack([base, np.roll(base, 37, axis=1),
                        np.roll(base, 71, axis=0)], axis=-1)
        arr = np.clip(img + np.roll(noise, i * 13, axis=1), 0, 255).astype(np.uint8)
        bufs.append(native.jpeg_encode(arr, 85))
    return bufs


def best_window(fn, windows=3):
    """Run the timed window `fn() -> (work, seconds)` `windows` times
    and return the best rate; every window is logged."""
    rates = []
    for _ in range(windows):
        work, dt = fn()
        rates.append(work / dt)
    log(f"  windows: {[round(r, 1) for r in rates]} img/s")
    return max(rates)


def _hostile_images(n: int, w: int = 1920, h: int = 1088) -> list:
    """Adversarial 4:2:0 corpus: 32px block mosaics and 4px band-limited
    noise — heavy spectral energy at the half-grid Nyquist, the worst
    case for any draft-decode path."""
    from picha_tpu.native import lib as native

    r = np.random.default_rng(1234)
    out = []
    for i in range(n):
        if i % 2 == 0:
            t = r.integers(0, 256, (h // 32, w // 32, 3)).astype(np.float32)
            img = np.kron(t, np.ones((32, 32, 1), np.float32))
        else:
            g = r.normal(0, 1, (h // 4, w // 4, 3)).astype(np.float32)
            img = 127 + 45 * np.kron(g, np.ones((4, 4, 1), np.float32))
        out.append(native.jpeg_encode(
            np.clip(img, 0, 255).astype(np.uint8), 85))
    return out


def measure_link():
    """Host->device and device->host copy rates (MB/s) of 64 MB of
    random bytes."""
    import jax

    data = np.random.default_rng(0).integers(0, 256, 64 << 20, np.uint8)
    jax.block_until_ready(jax.device_put(data))  # warm both directions
    t0 = time.perf_counter()
    d = jax.block_until_ready(jax.device_put(data))
    up = data.nbytes / 1e6 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    np.asarray(d)
    down = data.nbytes / 1e6 / (time.perf_counter() - t0)
    return up, down


def bench_device_stage(p, sig, dargs, batch, iters=10, fused=False):
    """Device-only throughput (img/s) of the pixel graph on resident
    coefficients."""
    import jax

    from picha_tpu.pipeline.jpeg_batch import _jit_batch_graph

    fn = _jit_batch_graph(sig, p._width, p._height, p._filter, p._fscale,
                          False, None, None, False, fused)
    jax.block_until_ready(fn(*dargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*dargs)
    jax.block_until_ready(out)
    return batch * iters / (time.perf_counter() - t0)


def bench_e2e(bufs, batch, out_w, out_h, rounds=12, config="host",
              windows=3):
    """End-to-end decode -> resize -> encode in one of three
    configurations an operator could deploy:

      host         pure-host streaming: libjpeg decode, AVX2 native
                   resize, libjpeg encode — no device in the loop
      gap4+device  hybrid: host path fills the core while the device
                   chain (gap4 coefficient upload -> fused decode+
                   resize -> full on-chip Huffman encode) runs `depth`
                   batches deep with async dispatch/readback
      scan+device  hybrid where even the entropy DECODE is on-chip —
                   the upload is the raw JPEG scan; the host keeps only
                   the header parse

    Returns (img/s, detail). bench_e2e_best probes all three and runs
    the final measurement on the winner. The timed measurement runs
    `windows` times and keeps the best; one untimed warm batch precedes
    timing so compiles, weight caches and zlib state never land inside
    the window."""
    from picha_tpu.pipeline import JpegBatchPipeline

    if config in ("host", "host-fast", "host-raw", "host-draft"):
        p = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                              encode_backend="host", upload="gap4",
                              host_fast_scale=(config == "host-fast"),
                              host_raw=(config == "host-raw"),
                              host_draft=(config == "host-draft"))
        runner = p.stream_host
        up_b = down_b = 0.0
    else:
        upload, backend = config.split("+")
        # the hybrid's host worker runs the raw-domain path too — faster
        # than the RGB path, ≤1 LSB parity (measured by config_parity
        # every run, not assumed)
        p = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                              encode_backend=backend, fused=True,
                              upload=upload, host_raw=True)
        warm = p(bufs[:batch])
        cos = p.entropy_decode(bufs[:batch])
        _, _, args = p.stack_bucket(cos)
        up_b = sum(a.nbytes for a in args) / 1e6
        down_b = (sum(len(e) for e in warm) / 1e6 if backend == "device"
                  else batch * (((out_h + 15) & ~15)
                                * (((out_w + 15) & ~15)) * 3) / 2 / 1e6)
        runner = p.stream_hybrid
    for _ in runner([bufs]):  # untimed warmup
        pass

    P = len(bufs)

    def window():
        t0 = time.perf_counter()
        n = 0
        for encoded in runner(
                [bufs[(r + i) % P] for i in range(batch)]
                for r in range(rounds)):
            n += len(encoded)
        return n, time.perf_counter() - t0

    ips = best_window(window, windows=windows)
    return ips, {"up_MB_per_batch": round(up_b, 1),
                 "down_MB_per_batch": round(down_b, 1),
                 "e2e_config": config}


def config_parity(bufs, out_w, out_h, config, refs):
    """Average LSB diff of a host config's decoded outputs vs the
    strict cubic path, measured over the WHOLE corpus (the north-star
    gate is ≤1 LSB, BASELINE.json — a one-image gate on friendly
    content is not a gate)."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                          encode_backend="host",
                          host_fast_scale=(config == "host-fast"),
                          host_raw=(config == "host-raw"),
                          host_draft=(config == "host-draft"))
    diffs = []
    for b, ref in zip(p.host_encode_batch(bufs), refs):
        got = native.jpeg_decode(bytes(b), 3, out_w, out_h)
        diffs.append(np.abs(got.astype(int) - ref.astype(int)).mean())
    return float(np.mean(diffs)), p.fast_guard_trips


def bench_e2e_best(bufs, batch, out_w, out_h):
    """Probe each deployable configuration briefly, then measure the
    winner properly — what an operator would run. The HEADLINE winner
    is drawn only from configs whose full-corpus output parity is
    ≤1 LSB vs the strict cubic path (the north-star clause); faster
    non-strict configs (host-fast's DCT-domain draft decode) are
    reported in detail but cannot carry the headline. Returns (ips,
    detail, violations)."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    violations = []
    probes = {}
    for hc in ("host", "host-raw", "host-draft", "host-fast"):
        ips, _ = bench_e2e(bufs, batch, out_w, out_h, rounds=6, config=hc,
                           windows=2)
        probes[hc] = round(ips, 1)

    # full-corpus parity gates vs the strict cubic path
    pn = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                           encode_backend="host")
    refs = [native.jpeg_decode(bytes(b), 3, out_w, out_h)
            for b in pn.host_encode_batch(bufs)]
    diffs = {"host": 0.0}
    fast_trips = {}
    for hc in ("host-raw", "host-draft", "host-fast"):
        try:
            diffs[hc], trips = config_parity(bufs, out_w, out_h, hc, refs)
            if hc == "host-fast":
                fast_trips["corpus"] = trips
                if trips:
                    # the divergence guard exists for hostile content;
                    # tripping on the HEADLINE corpus means the fast
                    # path quietly became the staged path
                    violations.append(
                        f"host-fast divergence guard tripped on {trips} "
                        f"bench-corpus images")
            log(f"{hc} vs cubic avg diff (full corpus, n={len(bufs)}): "
                f"{diffs[hc]:.3f} LSB ({'strict' if diffs[hc] <= 1.0 else 'NOT strict'}"
                f" of the <=1 LSB north-star clause)")
        except Exception as e:  # noqa: BLE001
            log(f"{hc} parity check failed: {e}")
            probes.pop(hc, None)
    # host-raw is SUPPOSED to be strict — if it ever isn't, that's a
    # correctness regression, not a race outcome
    if "host-raw" in diffs and diffs["host-raw"] > 1.0:
        violations.append(
            f"host-raw parity {diffs['host-raw']:.3f} LSB > 1.0")

    # hostile-content parity, WITH ATTRIBUTION: block mosaics + 4px
    # noise put heavy spectral energy at the half-grid Nyquist and many
    # out-of-gamut colours. host-fast formerly measured ~2.7 LSB there
    # (the 4x4 draft IDCT truncates what no filter can recover); its
    # divergence guard (ops/fastfix.py draft_hf_probe, round 4) now
    # routes such content to the staged strict path, so the number
    # below measures the GUARDED config and must sit at/below the
    # re-encode floor. host-raw measures ~1.4 — which is AT/BELOW
    # the dust-control floor published next to it: the SAME staged
    # pre-encode image perturbed by sub-LSB dust and re-encoded at q85
    # lands 1.1-2.2 LSB from the un-dusted encode on this content
    # (quantisation amplification any non-bit-identical pipeline pays;
    # the raw path tracks the pure linear composition to <=0.25 LSB in
    # the plane domain — tests/test_raw420.py pins both). The gamut
    # guard (rawguard.cc) separately bounds the one mechanism that
    # grows without bound (out-of-gamut clamp divergence); it must
    # never trip on the headline corpus.
    hostile_parity = {}
    guard_fallbacks = {}
    hostile_floor = None
    try:
        from picha_tpu.ops.resize import (_resize_native,
                                          parse_resize_options)
        fname, fscale = parse_resize_options({})
        hb = _hostile_images(6)
        hrefs = [native.jpeg_decode(bytes(b), 3, out_w, out_h)
                 for b in pn.host_encode_batch(hb)]
        for hc in ("host-raw", "host-draft", "host-fast"):
            par, trips = config_parity(hb, out_w, out_h, hc, hrefs)
            hostile_parity[hc] = round(par, 3)
            if hc == "host-fast":
                fast_trips["hostile"] = trips
        rng = np.random.default_rng(0)
        floors = []
        for b, ref in zip(hb, hrefs):
            st = native.jpeg_stat(bytes(b))
            src = native.jpeg_decode(bytes(b), 3, st[0], st[1])
            pre = _resize_native(src, out_w, out_h, fname, fscale)
            dust = np.clip(pre.astype(np.int16)
                           + rng.integers(0, 2, pre.shape),
                           0, 255).astype(np.uint8)
            got = native.jpeg_decode(native.jpeg_encode(
                np.ascontiguousarray(dust), 85), 3, out_w, out_h)
            floors.append(np.abs(got.astype(int) - ref.astype(int)).mean())
        hostile_floor = round(float(np.mean(floors)), 3)
        log(f"hostile-content parity (LSB): {hostile_parity}; "
            f"sub-LSB-dust re-encode floor {hostile_floor}; "
            f"host-fast guard trips {fast_trips}")
        if hostile_parity.get("host-fast", 0.0) > hostile_floor:
            violations.append(
                f"guarded host-fast hostile parity "
                f"{hostile_parity['host-fast']} LSB exceeds the "
                f"re-encode floor {hostile_floor}")
    except Exception as e:  # noqa: BLE001
        log(f"hostile parity check failed: {e}")
    # the guard-count tripwire runs in its OWN try: an incidental
    # failure above must not silently skip the corpus check, and a
    # failure here is recorded in the JSON rather than swallowed
    try:
        from picha_tpu.ops.raw420 import transcode_raw420
        from picha_tpu.ops.resize import parse_resize_options
        fname, fscale = parse_resize_options({})
        for name, corpus in (("hostile", _hostile_images(6)),
                             ("corpus", bufs)):
            # None means EITHER unsupported layout (rc=1) or the gamut
            # guard (rc=2) — count a guard trip only when the same
            # source succeeds with the guard disabled
            n = 0
            for b in corpus:
                if transcode_raw420(bytes(b), out_w, out_h, fname,
                                    fscale, 85) is None and \
                   transcode_raw420(bytes(b), out_w, out_h, fname,
                                    fscale, 85, gamut_guard=0.0) \
                   is not None:
                    n += 1
            guard_fallbacks[name] = n
        log(f"gamut-guard fallbacks: {guard_fallbacks['hostile']}/6 "
            f"hostile, {guard_fallbacks['corpus']}/{len(bufs)} corpus")
    except Exception as e:  # noqa: BLE001
        log(f"gamut-guard tripwire failed: {e}")
        guard_fallbacks = {"error": f"{type(e).__name__}: {e}"}
    if diffs.get("host-fast", 99.0) >= 2.0:
        probes.pop("host-fast", None)  # outside even the golden tolerance

    for config in ("gap4+device", "scan+device"):
        ips, _ = bench_e2e(bufs, batch, out_w, out_h, rounds=6,
                           config=config, windows=2)
        probes[config] = round(ips, 1)
    log(f"e2e config probes (img/s): {probes}")

    # strict pool: everything except configs that measured >1 LSB
    # (device chains run the fused composed operator + byte-exact
    # entropy coding — held ≤1 LSB by bench_device_parity and tests)
    strict = {c: v for c, v in probes.items() if diffs.get(c, 0.0) <= 1.0}
    # hostile admission gate (VERDICT r4 #6), for EVERY candidate, not
    # just host-fast: a config whose hostile-content parity exceeds the
    # sub-LSB-dust re-encode floor is doing something worse than
    # quantisation amplification and cannot carry the headline, however
    # fast its probe. Enforced by exclusion so a future draft-path
    # change that drifts past the floor demotes the config instead of
    # silently publishing it.
    hostile_excluded = []
    if hostile_floor is not None:
        for hc, par in sorted(hostile_parity.items()):
            if hc in strict and par > hostile_floor:
                log(f"{hc} EXCLUDED from the strict pool: hostile "
                    f"parity {par} LSB > re-encode floor {hostile_floor}")
                strict.pop(hc)
                hostile_excluded.append(hc)
    if not strict:
        violations.append("no strict-parity config available")
        return 0.0, {"config_probes_img_s": probes}, violations
    # among configs within probe noise (2%) of the fastest, prefer the
    # one with the tighter MEASURED parity — a 0.1% probe-speed edge is
    # not worth publishing the config with more corpus divergence.
    # Configs without a parity measurement this run (device chains,
    # whose ≤1 LSB is held by tests) rank at the admissibility bound
    # 1.0, so the absence of a measurement never wins a tie-break.
    best_ips = max(strict.values())
    near = [c for c in strict if strict[c] >= 0.98 * best_ips]
    winner = min(near, key=lambda c: (diffs.get(c, 1.0), -strict[c]))
    # budget-tight path: the probes above already raced every config —
    # reuse the winner's probe instead of re-racing when time is short
    if budget_left() < 180 + EMIT_RESERVE_S:
        log(f"final race SKIPPED ({budget_left():.0f}s left) — "
            f"publishing {winner}'s probe result")
        ips, d = strict[winner], {"e2e_config": winner,
                                  "e2e_from_probe": True}
    elif "+" in winner:
        ips, d = bench_e2e(bufs, batch, out_w, out_h, rounds=20,
                           config=winner, windows=3)
    else:
        ips, d = bench_e2e(bufs, batch, out_w, out_h, rounds=8,
                           config=winner, windows=8)
    d["config_probes_img_s"] = probes
    d["config_parity_lsb"] = {k: round(v, 3) for k, v in diffs.items()}
    if hostile_parity:
        d["hostile_parity_lsb"] = hostile_parity
    if hostile_floor is not None:
        d["hostile_reencode_floor_lsb"] = hostile_floor
        d["hostile_gate_excluded"] = hostile_excluded
    if fast_trips:
        d["fast_guard_trips"] = fast_trips
    if guard_fallbacks:
        d["raw_guard_fallbacks"] = guard_fallbacks
        if guard_fallbacks.get("corpus", 0) > 0:
            violations.append(
                f"gamut guard tripped on {guard_fallbacks['corpus']} "
                f"bench-corpus images — host-raw would quietly run the "
                f"staged path")
    fastest_any = max(probes, key=probes.get)
    d["fastest_any_config"] = fastest_any
    d["fastest_any_img_s"] = probes[fastest_any]
    return ips, d, violations


def bench_device_roofline(bufs, batch, out_w, out_h, mpix, iters=6,
                          restart=8):
    """Chip-bound roofline (the number production hosts would see):
    the ENTIRE decode->resize->encode loop on device — scan bytes
    resident -> device Huffman decode (ops/jpeg_huffman_decode_tpu.py,
    restart corpora take the Jacobi-free single-pass kernel) -> fused
    dequant+IDCT+upsample+resize -> device Huffman encode -> scan bytes
    resident. No host work inside the measured window. Parity of the
    produced JPEGs vs the strict host path is enforced (<=1 LSB).

    Returns (mpix_per_s, parity_lsb, used_single_pass)."""
    import jax

    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    # corpus prep: restart markers make entropy decode exactly
    # parallel-decodable (the standard prep for accelerator decoding;
    # ~1-2% file size). restart=0 measures the speculative decoder.
    if restart:
        corpus = [native.jpeg_encode(
            native.jpeg_decode(b, 3, 1920, 1088), 85, restart=restart)
            for b in bufs[:batch]]
    else:
        corpus = [bytes(b) for b in bufs[:batch]]
    p = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                          encode_backend="device", fused=True,
                          upload="scan")
    from picha_tpu.ops.jpeg_scan import ScanInfo

    cos = p.entropy_decode(corpus)
    if not isinstance(cos[0], ScanInfo):
        raise RuntimeError("scan path unavailable for corpus")
    sig0, ks0, args = p.stack_bucket(cos)
    wire = [jax.device_put(a) for a in args]
    single = bool(ks0[-2])  # ScanBatch.static_key()'s single_pass flag
    # warm + parity: run once, assemble JPEGs, compare vs strict host
    res, okf = p.run_bucket(sig0, wire, scan_ks=ks0)
    if not bool(np.asarray(okf)):
        raise RuntimeError("device decoder did not converge")
    jpegs = p.scan_finish(res, sig0)
    pn = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                           encode_backend="host")
    diffs = []
    for got_b, ref_b in zip(jpegs, pn.host_encode_batch(corpus)):
        got = native.jpeg_decode(bytes(got_b), 3, out_w, out_h)
        ref = native.jpeg_decode(bytes(ref_b), 3, out_w, out_h)
        diffs.append(np.abs(got.astype(int) - ref.astype(int)).mean())
    parity = float(np.mean(diffs))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = p.run_bucket(sig0, wire, scan_ks=ks0)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return batch / dt * mpix, parity, single


def bench_train_ingest(bufs, batch, rounds=10):
    """Training-input ingest (BASELINE config 5): JPEG bytes ->
    normalized 224x224 float batches resident on device — no readback."""
    import jax

    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(width=224, height=224, normalize=True, fused=True,
                          upload="gap4")
    jax.block_until_ready(p(bufs[:batch]))
    t0 = time.perf_counter()
    for _ in range(rounds):
        _, dev = p._stage_device(p.entropy_decode(bufs[:batch]))
    jax.block_until_ready(dev)
    dt = time.perf_counter() - t0
    return batch * rounds / dt


def bench_train_crop_ingest(bufs, batch, rounds=8):
    """The TRUE config-5 shape: JPEG bytes -> random 224-crop -> resize
    224 -> normalized device-resident batches via TrainingInput, whose
    DCT-domain ROI pre-crop packs/uploads only the iMCU region around
    each window (~25x fewer wire bytes on 1080p sources than the
    decode-everything path)."""
    import jax

    from picha_tpu.pipeline.training import TrainingInput

    ti = TrainingInput(list(bufs), batch=batch, crop=224, size=224, seed=0)
    jax.block_until_ready(next(ti))
    t0 = time.perf_counter()
    outs = [next(ti) for _ in range(rounds)]
    jax.block_until_ready(outs)
    return batch * rounds / (time.perf_counter() - t0)


def bench_host_stage(bufs, batch, out_w, out_h, iters=3):
    """All host-side CPU work per batch (entropy decode + gap4 sparse
    pack + raw420 re-encode) — the serial-core roofline term."""
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(width=out_w, height=out_h, encode_quality=85,
                          encode_backend="raw420", fused=True,
                          upload="gap4")
    hp, wp = (out_h + 15) & ~15, (out_w + 15) & ~15
    planes = np.full((batch, hp * wp + 2 * (hp // 2) * (wp // 2)), 128,
                     np.uint8)

    def window():
        t0 = time.perf_counter()
        for _ in range(iters):
            cos = p.entropy_decode(bufs[:batch])
            sig, ks, args = p.stack_bucket(cos)
            p.raw420_encode(planes, sig)
        return batch * iters, time.perf_counter() - t0

    window()  # warm
    return best_window(window, windows=2)


def bench_device_parity(bufs):
    """Smoke parity: fused gap8 device decode vs host libjpeg,
    must stay within 1 LSB average (CLAUDE.md invariant)."""
    from picha_tpu.native import lib as native
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline(fused=True, upload="gap8")
    got = np.asarray(p(bufs[:2]))
    w, h, _ = native.jpeg_stat(bufs[0])
    diffs = []
    for i in range(2):
        want = native.jpeg_decode(bufs[i], 3, w, h)
        diffs.append(np.abs(got[i].astype(int) - want.astype(int)).mean())
    return max(diffs)


def bench_entropy(bufs, batch, iters=4):
    from picha_tpu.pipeline import JpegBatchPipeline

    p = JpegBatchPipeline()
    p.entropy_decode(bufs[:2])  # warm

    def window():
        t0 = time.perf_counter()
        for _ in range(iters):
            p.entropy_decode(bufs[:batch])
        return batch * iters, time.perf_counter() - t0

    return best_window(window, windows=2)


def bench_entropy_native(bufs, iters=4):
    """Segment-parallel native decoder (jpegentropy.cc) single-thread
    img/s on the bench corpus — the per-thread rate production hosts
    multiply by their core count for narrow batches. Returns None
    when the corpus has no restart segments (the decoder then defers to
    libjpeg by design)."""
    from picha_tpu.native import lib as native
    from picha_tpu.ops.jpeg_scan import parse_baseline

    # the main corpus is restart-free; author restart variants the way
    # the device-only roofline does (same pixels, DRI=8)
    def reencode(b):
        w, h, _ = native.jpeg_stat(bytes(b))
        return native.jpeg_encode(native.jpeg_decode(bytes(b), 3, w, h),
                                  85, restart=8)

    rbufs = [reencode(b) for b in bufs[:4]]
    infos = [parse_baseline(bytes(b)) for b in rbufs]
    infos = [i for i in infos if i is not None and len(i.segments) > 1]
    if not infos:
        return None
    native.jpeg_entropy_decode(infos[0], nthreads=1)  # warm

    def window():
        t0 = time.perf_counter()
        for _ in range(iters):
            for i in infos:
                native.jpeg_entropy_decode(i, nthreads=1)
        return len(infos) * iters, time.perf_counter() - t0

    return best_window(window, windows=2)


def bench_png_e2e(bufs, out_w, out_h, n=10):
    """BASELINE config 1: PNG decode -> resize -> PNG encode.

    Lossless both ways, so unlike JPEG's host-fast there is no quality
    axis — every deflate level / filter strategy produces a bit-exact
    round-trip PNG. The bench races the libpng-default settings
    (level 6, adaptive 5-filter search — what the reference's
    pngcodec.cc:361-399 did) against a throughput config (level 1,
    fixed Paeth filter, both surfaced as encode options) and reports
    the winner, plus a stage decomposition and the size cost.

    Returns (img/s winner, detail dict)."""
    import zlib

    import picha_tpu as picha
    from picha_tpu.codecs import png as png_codec
    from picha_tpu.native import lib as native
    from picha_tpu.ops.resize import _resize_native, parse_resize_options

    pngs = []
    for b in bufs[: max(2, n // 3)]:
        img = picha.decodeJpegSync(b)
        pngs.append(picha.encodePngSync(img))

    # ---- stage decomposition (one representative image) -------------
    buf = pngs[0]
    h = png_codec._parse_header(buf)
    idat = b"".join(d for t, d in png_codec._parse_chunks(buf)
                    if t == b"IDAT")
    fname, fscale = parse_resize_options({})
    stages = {}
    # time the shipped inflate path (libdeflate when built in, zlib
    # fallback otherwise) so the decomposition matches the codec
    expected = h.height * (h.width * 3 + 1)
    t0 = time.perf_counter()
    raw = native.zlib_inflate(idat, expected)
    stages["inflate_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plane = png_codec._unfilter_to_plane(raw, h.width, h.height, 3,
                                         h.bit_depth)
    stages["unfilter_ms"] = (time.perf_counter() - t0) * 1e3
    arr = plane.reshape(h.height, h.width, 3)
    _resize_native(arr, out_w, out_h, fname, fscale)  # warm weight cache
    t0 = time.perf_counter()
    small = _resize_native(arr, out_w, out_h, fname, fscale)
    stages["resize_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    filt_adapt = native.png_filter(np.ascontiguousarray(small), out_h,
                                   out_w * 3, 3, -1)
    stages["filter_adaptive_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    filt_fixed = native.png_filter(np.ascontiguousarray(small), out_h,
                                   out_w * 3, 3, 4)
    stages["filter_paeth_ms"] = (time.perf_counter() - t0) * 1e3
    _deflate = native.zlib_deflate

    t0 = time.perf_counter()
    z6 = _deflate(filt_adapt, 6)
    stages["deflate_l6_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    z1 = _deflate(filt_fixed, 1)
    stages["deflate_l1_ms"] = (time.perf_counter() - t0) * 1e3
    stages = {k: round(v, 2) for k, v in stages.items()}
    size_cost = len(z1) / max(1, len(z6))

    # ---- config race ------------------------------------------------
    # default (round 5): deflate-probed filter selection + libdeflate
    # level 4 — measured 0.98-1.01x the libpng-default size (the probe
    # picks the filter deflate actually prefers; the MSD heuristic's
    # paeth/avg mix ran 1-5% LARGER) while encoding ~2.3x faster and
    # producing streams that also DECODE faster (UP-heavy filters
    # unfilter at SIMD speed). `quality` is the libpng-parity point
    # (exact reference defaults: MSD-adaptive + level 6) and serves as
    # the honest SIZE BASELINE for the ≤+2% admission below. Multi-core
    # hosts additionally get the pigz-style parallel deflate; on one
    # core deflateThreads=1 is the serial libdeflate path.
    import os as _os

    nthr = _os.cpu_count() or 1
    configs = {
        "default": ({"deflateThreads": nthr} if nthr > 1 else {}),
        "quality": {"compressionLevel": 6, "filterStrategy": -1},
        "fast": {"compressionLevel": 1, "filter_strategy": 4},
    }
    rates, sizes = {}, {}
    for name, opts in configs.items():
        szs = []
        for p in pngs:
            sm0 = picha.resizeSync(picha.decodePngSync(p),
                                   {"width": out_w, "height": out_h})
            szs.append(len(picha.encodePngSync(sm0, opts)))
        sizes[name] = float(np.mean(szs))

        def window():
            t0 = time.perf_counter()
            for i in range(n):
                img = picha.decodePngSync(pngs[i % len(pngs)])
                sm = picha.resizeSync(img, {"width": out_w, "height": out_h})
                picha.encodePngSync(sm, opts)
            return n, time.perf_counter() - t0

        rates[name] = round(best_window(window, windows=2), 2)

    # PIL stand-in doing the same work (decode->resize->save level 6)
    import io as _io

    from PIL import Image as PILImage

    def pil_window():
        t0 = time.perf_counter()
        for i in range(max(2, n // 2)):
            im = PILImage.open(_io.BytesIO(pngs[i % len(pngs)]))
            im = im.resize((out_w, out_h), PILImage.BICUBIC)
            o = _io.BytesIO()
            im.save(o, format="PNG")
        return max(2, n // 2), time.perf_counter() - t0

    pil_ips = best_window(pil_window, windows=2)

    # headline policy (same as webp): the fastest config whose output
    # stays within 2% of the libpng-parity (`quality`) size;
    # byte-costlier configs ride alongside in png_configs_img_s, never
    # on top
    size_ok = {c for c in rates
               if sizes[c] <= sizes["quality"] * 1.02}
    win = max(size_ok, key=rates.get)
    detail = {"png_configs_img_s": rates, "png_e2e_config": win,
              "png_config_size_ratio": {
                  c: round(sizes[c] / sizes["quality"], 3) for c in rates},
              "png_stage_ms": stages,
              "png_zlib_backend": ("libdeflate" if native.have_libdeflate()
                                   else "zlib"),
              "png_fast_size_ratio": round(size_cost, 3),
              "png_pil_standin_img_s": round(pil_ips, 2)}
    return rates[win], detail


def bench_config4(n=256):
    """BASELINE config 4: 256-image batched decode -> subView crop ->
    resize -> encodeWebP (alpha, preset) / encodeTiff lzw, through
    ImageBatchPipeline with the host backend (crop view + native
    resize per image). PIL stand-ins do the same work.

    Returns dict of {webp,tiff}_e2e_mpix_s + stand-ins."""
    import io as _io

    from PIL import Image as PILImage

    import picha_tpu as picha
    from picha_tpu.pipeline import ImageBatchPipeline

    W, H = 384, 256
    rng = np.random.default_rng(9)
    srcs = []
    for i in range(8):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        base = 127 + 70 * np.sin(xx / (11 + i)) + 40 * np.cos(yy / (7 + i))
        a = np.clip(np.stack(
            [base, 255 - base, base * 0.5 + 60,
             np.full_like(base, 255) - (xx + yy) % 17], -1)
            + rng.normal(0, 4, (H, W, 4)), 0, 255).astype(np.uint8)
        srcs.append(picha.Image.from_array(a, "rgba"))
    webps = [picha.encodeWebPSync(im, {"preset": "picture", "quality": 90})
             for im in srcs]
    tiffs = [picha.encodeTiffSync(im, {"compression": "lzw"})
             for im in srcs]
    mpix_total = n * W * H / 1e6

    out = {}
    for name, corpus, encs in (
            # webp default (round 5): method 3 — measured ~1.1x the
            # libwebp-default e2e at +3.7% bytes, identical round-trip
            # diff, bit-exact alpha (the alpha coder's effort follows
            # `method` and is ~64% of the RGBA encode cost;
            # codecs/webp.py docstring). `reference` is the exact
            # libwebp-default point (method 4, the PIL stand-in's
            # settings) and anchors the ≤+5% size gate; fast (method 0)
            # rides alongside at ~+27% bytes. All gated on the
            # reference's own lossy oracle (test/webp_codec.js: <8 LSB).
            ("webp", webps, {
                "default": ("image/webp", {"quality": 85}),
                "reference": ("image/webp", {"quality": 85, "method": 4}),
                "fast": ("image/webp", {"quality": 85, "method": 0})}),
            ("tiff", tiffs, {
                "default": ("image/tiff", {"compression": "lzw"})})):
        bufs = [corpus[i % len(corpus)] for i in range(n)]
        mt = "image/webp" if name == "webp" else "image/tiff"
        # quality gate ground truth: the exact crop+resize pixels via
        # the single-image API (what the pipeline computes pre-encode).
        # Only the webp race consumes these — skip the work otherwise.
        refs = []
        if len(encs) > 1:
            for b in bufs[:4]:
                im = picha.decodeSync(bytes(b))
                v = im.sub_view(16, 16, W - 32, H - 32)
                refs.append(picha.resizeSync(v, {"width": 176,
                                                 "height": 112}))
        configs, sizes, diffs = {}, {}, {}
        for cname, enc in encs.items():
            # backend='host': crop view + native AVX2 resize per image
            p = ImageBatchPipeline(crop=(16, 16, W - 32, H - 32),
                                   resize=(176, 112), encode=enc,
                                   backend="host")
            outs8 = p(bufs[:8], mimetype=mt)  # warm caches
            sizes[cname] = sum(len(o) for o in outs8)
            if name == "webp":
                d = [picha.decodeSync(o).avg_channel_diff(refs[i])
                     for i, o in enumerate(outs8[:4])]
                diffs[cname] = round(sum(d) / len(d), 2)

            def window(p=p):
                t0 = time.perf_counter()
                outs = p(bufs, mimetype=mt)
                assert len(outs) == n
                return mpix_total, time.perf_counter() - t0

            configs[cname] = round(best_window(window, windows=2), 1)
        admissible = {c: v for c, v in configs.items()
                      if diffs.get(c, 0.0) < 8.0}  # reference oracle
        if not admissible:
            # even the default config failed the reference's own lossy
            # oracle — report its rate anyway (this row isn't the
            # parity-gated headline) but flag the failure loudly so the
            # regression is visible in the JSON, not a crash
            out[f"{name}_quality_oracle_failed"] = diffs
            admissible = {"default": configs["default"]}
        winner = max(admissible, key=admissible.get)
        if len(configs) > 1:
            # honest headline: a faster config that pays >5% bytes over
            # the libwebp-default (`reference`) size is not the same
            # job — it rides alongside, never on top
            base = sizes.get("reference", sizes["default"])
            ratios = {c: round(sizes[c] / base, 3) for c in configs}
            size_ok = [c for c in admissible if ratios[c] <= 1.05]
            if size_ok:
                winner = max(size_ok, key=admissible.get)
            out[f"{name}_configs_mpix_s"] = configs
            out[f"{name}_e2e_config"] = winner
            out[f"{name}_config_diff_lsb"] = diffs
            out[f"{name}_config_size_ratio"] = ratios
        out[f"{name}_e2e_mpix_s"] = admissible[winner]

        # PIL stand-in: same decode->crop->resize->encode, same formats
        def pil_window():
            t0 = time.perf_counter()
            for i in range(n // 4):
                im = PILImage.open(_io.BytesIO(bufs[i]))
                im = im.crop((16, 16, W - 16, H - 16)).resize(
                    (176, 112), PILImage.BICUBIC)
                o = _io.BytesIO()
                if name == "webp":
                    im.save(o, format="WEBP", quality=85)
                else:
                    im.save(o, format="TIFF", compression="tiff_lzw")
            return mpix_total / 4, time.perf_counter() - t0

        out[f"{name}_pil_standin_mpix_s"] = round(
            best_window(pil_window, windows=2), 1)
    return out


def bench_config23(out_w, out_h, n=12):
    """BASELINE configs 2 and 3: the CMYK JPEG round-trip with colour
    convert (decode -> rgb fold -> lanczos downscale -> encode q85) and
    the 16-bit deep path (deep PNG decode -> catmulrom resize -> grey16
    convert). Both host-side; PIL stand-in for the CMYK leg."""
    import io as _io

    from PIL import Image as PILImage

    import picha_tpu as picha

    W, H = BENCH_W, BENCH_H
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 127 + 70 * np.sin(xx / 23) + 50 * np.cos(yy / 17)
    rgbish = np.clip(np.stack(
        [base, 255 - base, base * 0.6 + 50], -1)
        + rng.normal(0, 5, (H, W, 3)), 0, 255).astype(np.uint8)
    pim = PILImage.fromarray(rgbish, "RGB").convert("CMYK")
    o = _io.BytesIO()
    pim.save(o, format="JPEG", quality=90)
    cmyk = o.getvalue()

    deep = (rng.integers(0, 65536, (H // 2, W // 2, 4))
            .astype(np.uint16))
    deep_png = picha.encodePngSync(
        picha.Image.from_array(deep, "r16g16b16a16"))

    out = {}

    def window2():
        t0 = time.perf_counter()
        for _ in range(n):
            img = picha.decodeJpegSync(cmyk)  # CMYK folds to rgb
            sm = picha.resizeSync(img, {"width": out_w, "height": out_h,
                                        "filter": "lanczos"})
            picha.encodeJpegSync(sm, {"quality": 85})
        return n * W * H / 1e6, time.perf_counter() - t0

    picha.decodeJpegSync(cmyk)
    out["cmyk_e2e_mpix_s"] = round(best_window(window2, windows=2), 1)

    def window2_pil():
        t0 = time.perf_counter()
        for _ in range(max(2, n // 2)):
            im = PILImage.open(_io.BytesIO(cmyk)).convert("RGB")
            im = im.resize((out_w, out_h), PILImage.LANCZOS)
            oo = _io.BytesIO()
            im.save(oo, format="JPEG", quality=85)
        return max(2, n // 2) * W * H / 1e6, time.perf_counter() - t0

    out["cmyk_pil_standin_mpix_s"] = round(
        best_window(window2_pil, windows=2), 1)

    def window3():
        t0 = time.perf_counter()
        for _ in range(n):
            img = picha.decodePngSync(deep_png, {"deep": True})
            sm = picha.resizeSync(img, {"width": out_w // 2,
                                        "height": out_h // 2,
                                        "filter": "catmulrom"})
            picha.colorConvertSync(sm, {"pixel": "r16"})
        return n * (W // 2) * (H // 2) / 1e6, time.perf_counter() - t0

    picha.decodePngSync(deep_png, {"deep": True})
    out["deep16_mpix_s"] = round(best_window(window3, windows=2), 1)

    # stand-in denominator for config 3: the same decode->resize->grey
    # job through PIL. PIL cannot do this at 16 bits — it silently
    # truncates a 16-bit RGBA PNG to uint8 on open (mode 'RGBA') — so
    # the stand-in runs at HALF the fidelity of the measured path;
    # the ratio is therefore a floor on the real advantage.
    def window3_pil():
        t0 = time.perf_counter()
        for _ in range(n):
            im = PILImage.open(_io.BytesIO(bytes(deep_png)))
            im = im.resize((out_w // 2, out_h // 2), PILImage.BICUBIC)
            im.convert("L")
        return n * (W // 2) * (H // 2) / 1e6, time.perf_counter() - t0

    out["deep16_pil_standin_mpix_s"] = round(
        best_window(window3_pil, windows=2), 1)
    out["deep16_standin_fidelity"] = "8-bit (PIL truncates 16-bit PNG)"
    if out["deep16_pil_standin_mpix_s"]:
        out["deep16_vs_standin"] = round(
            out["deep16_mpix_s"] / out["deep16_pil_standin_mpix_s"], 2)
    return out


def bench_single_latency(buf, out_w, out_h, reps=15):
    # Returns (staged p50, one-call transcode p50) — the latter is the
    # public transcodeJpegSync fast path.
    import picha_tpu as picha

    picha.encodeJpegSync(
        picha.resizeSync(picha.decodeJpegSync(buf),
                         {"width": out_w, "height": out_h}), {"quality": 85})
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        img = picha.decodeJpegSync(buf)
        small = picha.resizeSync(img, {"width": out_w, "height": out_h})
        picha.encodeJpegSync(small, {"quality": 85})
        lat.append((time.perf_counter() - t0) * 1e3)
    # separate failure fate: a transcode-path error must not discard
    # the independently measured staged p50
    try:
        topts = {"width": out_w, "height": out_h, "quality": 85}
        picha.transcodeJpegSync(buf, topts)
        tlat = []
        for _ in range(reps):
            t0 = time.perf_counter()
            picha.transcodeJpegSync(buf, topts)
            tlat.append((time.perf_counter() - t0) * 1e3)
        t50 = statistics.median(tlat)
    except Exception as e:  # noqa: BLE001
        log(f"transcode p50 FAILED: {type(e).__name__}: {e}")
        t50 = None
    return statistics.median(lat), t50


def bench_cpu_standin(bufs, out_w, out_h, n=24):
    """The vs_baseline denominator: PIL decode -> bicubic -> encode,
    best of windows like the headline."""
    from PIL import Image as PILImage

    def window():
        t0 = time.perf_counter()
        for i in range(n):
            im = PILImage.open(io.BytesIO(bufs[i % len(bufs)]))
            im = im.resize((out_w, out_h), PILImage.BICUBIC)
            out = io.BytesIO()
            im.save(out, format="JPEG", quality=85)
        return n, time.perf_counter() - t0

    return best_window(window, windows=3)


# one corpus for every stage: the decomposition in `detail` is only
# comparable because every row measures the same batch
BENCH_W, BENCH_H = 1920, 1088
BENCH_BATCH = 16
BENCH_OUT_W, BENCH_OUT_H = 960, 544


def run_stage(name, fn, *a):
    try:
        return fn(*a)
    except Exception as e:  # noqa: BLE001 — report the row, keep going
        log(f"{name} FAILED: {type(e).__name__}: {e}")
        return None


def device_stages(stage, bufs, batch, out_w, out_h, mpix, detail,
                  violations):
    """The device-only rows: copy bandwidth, the all-device transcode
    loop on both corpora, training ingest, parity and the pixel
    stages."""
    import jax

    from picha_tpu.pipeline import JpegBatchPipeline

    link = stage("link", 10, measure_link)
    if link:
        detail["link_up_MBps"] = round(link[0], 1)
        detail["link_down_MBps"] = round(link[1], 1)
        log(f"copy bandwidth: up {link[0]:.0f} MB/s, down {link[1]:.0f} MB/s")

    for key, restart in (("device_only", 8), ("device_only_norestart", 0)):
        roof = stage(f"device-only loop (restart={restart})", 60,
                     bench_device_roofline, bufs, batch, out_w, out_h, mpix,
                     6, restart)
        if roof:
            roof_mpix, roof_parity, roof_single = roof
            detail[key + "_mpix_s"] = round(roof_mpix, 1)
            detail[key + "_parity_lsb"] = round(roof_parity, 3)
            log(f"device-only loop (scan -> device Huffman decode -> fused "
                f"-> device Huffman encode, restart={restart}, "
                f"{'single-pass' if roof_single else 'chunked'}): "
                f"{roof_mpix:.0f} Mpix/s, parity {roof_parity:.3f} LSB")
            if roof_parity > 1.0:
                violations.append(
                    f"{key} parity {roof_parity:.3f} LSB > 1.0")

    train_ips = stage("train ingest", 30, bench_train_ingest, bufs, batch)
    if train_ips:
        detail["train_ingest_mpix_s"] = round(train_ips * mpix, 1)
        log(f"training-input ingest (decode+resize 224+normalize, on-device): "
            f"{train_ips:.1f} img/s ({train_ips * mpix:.0f} Mpix/s)")

    crop_ips = stage("train crop ingest", 30, bench_train_crop_ingest, bufs,
                     batch)
    if crop_ips:
        detail["train_crop_ingest_mpix_s"] = round(crop_ips * mpix, 1)
        log(f"training-input RANDOM-CROP ingest (TrainingInput, DCT-ROI "
            f"pre-crop): {crop_ips:.1f} img/s "
            f"({crop_ips * mpix:.0f} source Mpix/s)")

    parity = stage("device parity", 20, bench_device_parity, bufs)
    if parity is not None:
        detail["device_host_avg_diff_lsb"] = round(float(parity), 3)
        log(f"fused device decode vs host libjpeg: avg diff {parity:.3f} LSB")
        if parity > 1.0:
            violations.append(
                f"fused device decode parity {parity:.3f} LSB > 1.0")

    def pixel_stage(fused):
        p = JpegBatchPipeline(width=out_w, height=out_h)
        cos = p.entropy_decode(bufs[:batch])
        sig, args = p.stack_bucket(cos)
        dargs = [jax.device_put(a) for a in args]
        return bench_device_stage(p, sig, dargs, batch, fused=fused)

    for name, fused in (("fused", True), ("staged", False)):
        ips = stage(f"device pixel stage ({name})", 30, pixel_stage, fused)
        if ips:
            detail[f"device_{name}_stage_mpix_s"] = round(ips * mpix, 1)
            log(f"device {name} pixel stage: {ips:.1f} img/s "
                f"({ips * mpix:.0f} Mpix/s)")


def stage_budgeted(detail, name, est_s, fn, *a):
    """run_stage gated on the global deadline: a stage whose estimated
    cost doesn't fit in the remaining budget is skipped and recorded."""
    left = budget_left()
    if left < est_s + EMIT_RESERVE_S:
        log(f"{name} SKIPPED: {left:.0f}s left < ~{est_s}s estimated")
        detail.setdefault("skipped", []).append(name)
        return None
    return run_stage(name, fn, *a)


def require_gpu():
    """The device, or exit non-zero: this benchmark never falls back."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform '{devs[0].platform}')")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card[0] if card else None}


def main():
    import atexit
    import signal

    _RESULT["device"] = require_gpu()
    log(f"device: {_RESULT['device']}")
    W, H = BENCH_W, BENCH_H
    mpix = W * H / 1e6
    batch = BENCH_BATCH
    bufs = make_test_images(batch, W, H)
    log(f"generated {len(bufs)} jpegs, ~{len(bufs[0])//1024} KiB each; "
        f"deadline {BENCH_DEADLINE_S:.0f}s")

    out_w, out_h = BENCH_OUT_W, BENCH_OUT_H
    detail = _RESULT["detail"]
    violations = _RESULT["violations"]
    detail["host_cores"] = os.cpu_count() or 1

    # even a kill must yield the one parseable line: atexit for
    # normal/exception exits, SIGTERM for the `timeout` utility's kill
    atexit.register(emit_compact)

    def _on_term(signum, frame):  # noqa: ARG001
        emit_compact(reason=f"signal {signum}")
        os._exit(1)

    signal.signal(signal.SIGTERM, _on_term)

    def stage(name, est_s, fn, *a):
        return stage_budgeted(detail, name, est_s, fn, *a)

    # ---- 1. the strict-parity e2e headline ---------------------------
    # runs FIRST: whatever else the deadline eats, the value lands
    e2e = stage("e2e", 90, bench_e2e_best, bufs, batch, out_w, out_h)
    if e2e:
        e2e_ips, ebytes, e2e_violations = e2e
        violations.extend(e2e_violations)
        detail.update(ebytes)
        _RESULT["e2e_ips"] = e2e_ips
        log(f"e2e decode->resize->encode (pipelined): {e2e_ips:.1f} img/s "
            f"({e2e_ips * mpix:.0f} Mpix/s)")

    # ---- 2. the vs_baseline denominator (cheap, PIL-only) -----------
    cpu_ips = stage("cpu standin", 30, bench_cpu_standin, bufs, out_w, out_h)
    if cpu_ips:
        detail["cpu_standin_mpix_s"] = round(cpu_ips * mpix, 1)
        _RESULT["cpu_ips"] = cpu_ips
        log(f"CPU stand-in (PIL single-thread): {cpu_ips:.1f} img/s "
            f"({cpu_ips * mpix:.0f} Mpix/s)")

    # ---- 3. device-only rows ------------------------------------------
    device_stages(stage, bufs, batch, out_w, out_h, mpix, detail,
                  violations)

    # ---- 4. host-side stage decompositions ---------------------------
    host_ips = stage("host stage", 40, bench_host_stage, bufs, batch,
                     out_w, out_h)
    if host_ips:
        detail["host_stage_mpix_s"] = round(host_ips * mpix, 1)
        log(f"host stage (entropy + gap4 pack + raw420 encode): "
            f"{host_ips:.1f} img/s ({host_ips * mpix:.0f} Mpix/s)")

    entropy_ips = stage("entropy", 30, bench_entropy, bufs, batch)
    if entropy_ips:
        detail["host_entropy_mpix_s"] = round(entropy_ips * mpix, 1)
        log(f"host entropy decode: {entropy_ips:.1f} img/s "
            f"({entropy_ips * mpix:.0f} Mpix/s)")

    nat_ips = stage("entropy-native", 25, bench_entropy_native, bufs)
    if nat_ips:
        detail["host_entropy_native_1t_mpix_s"] = round(nat_ips * mpix, 1)
        log(f"native segment decoder (1 thread, restart corpus): "
            f"{nat_ips:.1f} img/s ({nat_ips * mpix:.0f} Mpix/s)")

    # ---- 5. format rows (configs 1-4) --------------------------------
    png = stage("png e2e", 75, bench_png_e2e, bufs, out_w, out_h)
    if png:
        png_ips, png_detail = png
        detail["png_e2e_mpix_s"] = round(png_ips * mpix, 1)
        detail.update(png_detail)
        log(f"PNG decode->resize->encode (config 1): {png_ips:.1f} img/s "
            f"({png_ips * mpix:.0f} Mpix/s) "
            f"[winner {png_detail['png_e2e_config']}, "
            f"configs {png_detail['png_configs_img_s']}, "
            f"stages {png_detail['png_stage_ms']}]")

    c4 = stage("config4 webp/tiff", 110, bench_config4)
    if c4:
        detail.update(c4)
        log(f"config 4 (256-img batched decode->crop->resize->encode): "
            f"webp {c4.get('webp_e2e_mpix_s')} Mpix/s "
            f"(PIL {c4.get('webp_pil_standin_mpix_s')}), "
            f"tiff {c4.get('tiff_e2e_mpix_s')} Mpix/s "
            f"(PIL {c4.get('tiff_pil_standin_mpix_s')})")

    c23 = stage("config2/3 cmyk+deep16", 60, bench_config23, out_w, out_h)
    if c23:
        detail.update(c23)
        log(f"config 2 (CMYK decode->rgb->lanczos->q85): "
            f"{c23.get('cmyk_e2e_mpix_s')} Mpix/s "
            f"(PIL {c23.get('cmyk_pil_standin_mpix_s')}); "
            f"config 3 (deep16 PNG->catmulrom->grey16): "
            f"{c23.get('deep16_mpix_s')} Mpix/s")

    # ---- 6. stand-in latency row --------------------------------------
    p50 = stage("latency", 20, bench_single_latency, bufs[0], out_w, out_h)
    if p50:
        detail["p50_ms_1080p"] = round(p50[0], 1)
        log(f"p50 single-image 1080p decode->resize->encode: {p50[0]:.1f} ms")
        if p50[1] is not None:
            detail["p50_transcode_ms_1080p"] = round(p50[1], 1)
            log(f"one-call transcodeJpegSync p50: {p50[1]:.1f} ms")

    emit_compact()
    if violations:
        sys.exit(1)


if __name__ == "__main__":
    main()
