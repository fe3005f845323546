"""Dynamic batching for serving.

The reference's serving story was one libuv worker per request
(SURVEY.md §2 "Async execution"); the device equivalent needs batching to
keep the chip fed. `DynamicBatcher` accepts single-image requests,
groups them by coefficient signature into shape buckets, and flushes a
bucket when it reaches `max_batch` or its oldest request exceeds
`max_delay_ms` — the standard latency/throughput knob of production
inference servers. Results are delivered through per-request Futures,
so the call surface stays the reference's async one-image-in,
one-image-out shape.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from ..native import lib as native
from .jpeg_batch import JpegBatchPipeline, signature


class DynamicBatcher:
    """JPEG decode(+resize) server: submit(bytes) -> Future[np.ndarray].

    >>> b = DynamicBatcher(width=224, height=224, max_batch=32)
    >>> fut = b.submit(jpeg_bytes)
    >>> img = fut.result()            # (224, 224, C) uint8
    """

    def __init__(self, width: Optional[int] = None,
                 height: Optional[int] = None,
                 filter: Optional[str] = None,
                 normalize: bool = False,
                 fused: bool = True,
                 max_batch: int = 32, max_delay_ms: float = 5.0):
        self._pipe = JpegBatchPipeline(width=width, height=height,
                                       filter=filter, normalize=normalize,
                                       fused=fused and width is not None)
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._lock = threading.Condition()
        self._queues: dict = {}  # sig -> list of (deadline, co, future)
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="picha-batcher")
        self._worker.start()

    def submit(self, buf: bytes) -> Future:
        """O(1): entropy decode runs on the pipeline's pool, not the
        caller's thread; the result Future resolves after batching."""
        fut: Future = Future()
        data = bytes(buf)

        def decode_and_enqueue():
            try:
                co = native.JpegCoefficients(data)
            except Exception as e:  # noqa: BLE001 — deliver via future
                _safe_set_exception(fut, e)
                return
            sig = signature(co)
            with self._lock:
                if self._closed:
                    _safe_set_exception(fut, RuntimeError("batcher closed"))
                    return
                self._queues.setdefault(sig, []).append(
                    (time.monotonic() + self.max_delay, co, fut))
                self._lock.notify()

        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("batcher closed"))
                return fut
            # submit INSIDE the lock: a close() racing between the
            # check and the submit would shut the executor down and
            # raise a raw RuntimeError at the call site instead of
            # delivering the error through the Future
            try:
                self._pipe._pool.submit(decode_and_enqueue)
            except RuntimeError as e:
                fut.set_exception(e)
        return fut

    def _take_ready(self):
        now = time.monotonic()
        for sig, items in self._queues.items():
            if len(items) >= self.max_batch or (items and items[0][0] <= now):
                batch = items[: self.max_batch]
                rest = items[self.max_batch:]
                if rest:
                    self._queues[sig] = rest
                else:
                    del self._queues[sig]
                return sig, batch
        return None

    def _next_deadline(self):
        ds = [items[0][0] for items in self._queues.values() if items]
        return min(ds) if ds else None

    def _run(self):
        while True:
            with self._lock:
                ready = self._take_ready()
                if ready is None:
                    if self._closed and not self._queues:
                        return
                    deadline = self._next_deadline()
                    timeout = (max(0.0, deadline - time.monotonic())
                               if deadline is not None else 0.1)
                    self._lock.wait(timeout=timeout)
                    continue
            sig, batch = ready
            cos = [b[1] for b in batch]
            futs = [b[2] for b in batch]
            try:
                # pad to a size multiple (jpeg_batch.pad_group): raw
                # flush sizes (1, 3, 7, ...) would each retrace and pay
                # a cold compile — seconds of request latency per
                # distinct size
                from .jpeg_batch import pad_group

                padded, nreal = pad_group(cos)
                _, args = self._pipe.stack_bucket(padded)
                out = np.asarray(self._pipe.run_bucket(sig, args))[:nreal]
                for i, fut in enumerate(futs):
                    # .copy(): don't pin the whole batch buffer through
                    # one client's retained view
                    _safe_set_result(fut, out[i].copy())
            except BaseException as e:  # noqa: BLE001
                for fut in futs:
                    _safe_set_exception(fut, e)
                if not isinstance(e, Exception):
                    # SystemExit/KeyboardInterrupt/... would silently
                    # kill this worker and hang every later submit();
                    # fail everything queued and die loudly instead
                    with self._lock:
                        self._closed = True
                        pending = [f for items in self._queues.values()
                                   for (_, _, f) in items]
                        self._queues.clear()
                    for f in pending:
                        _safe_set_exception(
                            f, RuntimeError("batcher worker died"))
                    raise

    def close(self, wait: bool = True, timeout: float | None = None):
        """Drain and stop. With wait=True joins until the queue drains
        (bounded by `timeout` if given); if the worker is still busy at
        timeout, pending futures are failed rather than left hanging."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        if wait:
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                with self._lock:
                    pending = [f for items in self._queues.values()
                               for (_, _, f) in items]
                    self._queues.clear()
                for f in pending:
                    _safe_set_exception(
                        f, RuntimeError("batcher closed before completion"))
        if self._worker.is_alive():
            # the pipe must be released even when the worker outlives
            # the join timeout (or wait=False): reap it in the
            # background once the worker actually exits, else its
            # 8-thread entropy pool leaks for the process lifetime
            def _reap():
                self._worker.join()
                self._pipe.close()

            threading.Thread(target=_reap, daemon=True,
                             name="picha-batcher-reaper").start()
        else:
            self._pipe.close()  # worker drained — release its pool


def _safe_set_result(fut: Future, value) -> None:
    """set_result tolerant of client-side cancellation races."""
    try:
        if not fut.done():
            fut.set_result(value)
    except Exception:  # noqa: BLE001 — InvalidStateError from a lost race
        pass


def _safe_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        if not fut.done():
            fut.set_exception(exc)
    except Exception:  # noqa: BLE001
        pass


def _race_cache_path():
    """The winning-config cache lives in the XLA compile cache's
    directory — the same "one-time cost per deployment" story."""
    from ..runtime import compile_cache

    return compile_cache.enable() / "stream_best.json"


def _race_cache_load(key: str):
    import json

    try:
        with open(_race_cache_path()) as f:
            return json.load(f).get(key)
    except Exception:  # noqa: BLE001 — cache is an optimisation only
        return None


def _race_cache_store(key: str, entry) -> None:
    import json
    import os

    path = _race_cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        # exclusive file lock around the read-modify-replace: two
        # processes finishing races concurrently must not lose each
        # other's entries (each would re-pay its probe forever)
        import fcntl

        with open(str(path) + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                with open(path) as f:
                    data = json.load(f)
            except Exception:  # noqa: BLE001
                data = {}
            if entry is None:
                data.pop(key, None)
            else:
                data[key] = entry
            tmp = str(path) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, path)
    except Exception:  # noqa: BLE001
        pass


def _parity_vs_host(host_pipe, in_batches, out_batches, width, height):
    """Mean per-image avg-channel diff (LSB) of a config's encoded
    outputs vs the strict host path run on the SAME inputs. Both sides
    are decoded with libjpeg; q-noise is common-mode between two
    encodes of near-identical pixels, so the measure tracks the
    pre-encode parity bench.py gates on."""
    diffs = []
    for bufs, outs in zip(in_batches, out_batches):
        refs = host_pipe.host_encode_batch(list(bufs))
        for got, ref in zip(outs, refs):
            a = native.jpeg_decode(bytes(got), 3, width, height)
            b = native.jpeg_decode(bytes(ref), 3, width, height)
            diffs.append(float(np.abs(a.astype(np.int16)
                                      - b.astype(np.int16)).mean()))
    return float(np.mean(diffs)) if diffs else 0.0


def _race_cache_key(width, height, quality, configs, depth, strict_lsb):
    import os

    # the library build is part of the deployment signature: a kernel
    # speedup in a new version must re-race, not inherit a stale winner
    from .. import __version__ as _ver

    return "|".join(map(str, (width, height, quality,
                              ",".join(sorted(configs)),
                              os.cpu_count() or 1, depth, strict_lsb,
                              _ver)))


def stream_best(batches, *, width, height, quality=85,
                configs=("host", "host-raw", "gap4+device", "scan+device"),
                probe_batches=2, depth=2, use_cache=True,
                strict_lsb=None):
    """Self-tuning transcode stream: probe each deployable
    configuration on live traffic, then run the rest of the stream
    through the fastest.

    The right split between the host path (libjpeg + AVX2 resize) and
    the device chains depends on the deployment — host cores, link
    bandwidth, and even how much CPU the transfers themselves steal
    (docs/PERFORMANCE.md "Round 2b") — so it is measured, not assumed:
    exactly the race bench.py runs, packaged for production.

    Probing: each config first consumes one untimed warm batch (jit
    compiles, caches), then a probe chunk timed from dispatch to full
    drain with results buffered so consumer time never pollutes the
    race. A config whose probe raises (a device error) scores as
    losing and its chunk is replayed through the
    host path — nothing is ever dropped.

    configs: subset of "host", "host-raw", "host-draft", "host-fast",
    "<upload>+<backend>" (e.g. "gap4+device", "scan+device",
    "gap4+raw420"). "host-raw" transcodes in the 4:2:0 raw domain
    (ops/raw420.py) — ≤1 LSB of the cubic path on photographic content
    (bench.py measures 0.55 LSB on its corpus and gates on it; on
    adversarial out-of-gamut synthetics the YCbCr-domain resize and the
    staged path's intermediate RGB clipping diverge to ~1.4 LSB).
    "host-fast" uses the draft-mode DCT-scaled decode when the target
    is exactly source/2^k — a different resampling than the cubic
    filter (close on natural content, not on noise), so it is opt-in
    here; bench.py shows how to gate it on a measured quality check.
    "host-draft" is the raw-domain draft (ops/raw420.py
    transcode_raw420_draft): exact chroma + fitted-correction draft Y
    for any target <= source/2, the cheapest host config; like every
    non-host config it is subject to the strict_lsb gate and falls
    back per image to host-raw/staged off its applicability window.

    strict_lsb: when set (e.g. 1.0 — the BASELINE north-star clause),
    every non-host config's probe outputs are additionally compared to
    the strict host path run on the same inputs, and configs whose
    measured parity exceeds the bound are disqualified from winning
    regardless of speed — the bench.py quality gate enforced on LIVE
    traffic, where it belongs (parity is content-dependent: host-raw
    measures ~0.6 LSB on photographic corpora but ~1.4 on adversarial
    out-of-gamut synthetics). A cached winner is spot-checked on its
    first batch and demoted to a fresh race if the bound no longer
    holds on current traffic.

    The probe's winner persists next to the XLA compile cache keyed by
    the deployment signature (geometry, quality, configs, host cores,
    strict bound), so a process restart goes straight to the winning
    config instead of re-paying the probe batches; the entry is
    invalidated if the cached config later fails. Set use_cache=False
    (or delete .jax_cache/stream_best.json) to force a fresh race."""
    from itertools import islice

    probe_batches = max(1, probe_batches)

    def make(config):
        if config in ("host", "host-fast", "host-raw", "host-draft"):
            p = JpegBatchPipeline(width=width, height=height,
                                  encode_quality=quality,
                                  encode_backend="host",
                                  host_fast_scale=(config == "host-fast"),
                                  host_raw=(config == "host-raw"),
                                  host_draft=(config == "host-draft"))
            return p, p.stream_host
        upload, backend = config.split("+")
        p = JpegBatchPipeline(width=width, height=height,
                              encode_quality=quality,
                              encode_backend=backend, fused=True,
                              upload=upload, host_raw=True)
        return p, (lambda bs: p.stream_hybrid(bs, depth=depth))

    cache_key = _race_cache_key(width, height, quality, configs, depth,
                                strict_lsb)
    cached = _race_cache_load(cache_key) if use_cache else None
    it = iter(batches)
    if cached and cached.get("best") in set(configs) | {"host"}:
        best = cached["best"]
        if strict_lsb is not None and best != "host":
            # spot-check the cached winner's parity on CURRENT traffic
            # before trusting it for the whole stream: peek one batch,
            # run it through both the winner and the strict host path,
            # and demote to a fresh race on violation (the host outputs
            # for the peeked batch are yielded — they are strict by
            # definition, so nothing non-compliant ever leaves).
            first = next(it, None)
            if first is not None:
                first = list(first)
                wp, _wr = make(best)
                hp, _hr = make("host")
                try:
                    try:
                        wouts = next(iter(wp.stream_host([first]))) \
                            if "+" not in best else wp(first)
                        houts = hp.host_encode_batch(first)
                        lsb = _parity_vs_host(hp, [first], [wouts],
                                              width, height)
                    except Exception:  # noqa: BLE001 — winner broken
                        lsb = float("inf")
                        houts = hp.host_encode_batch(first)
                finally:
                    wp.close()
                    hp.close()
                yield houts
                if lsb > strict_lsb:
                    _race_cache_store(cache_key, None)
                    cached = None
        if cached:
            pipe, runner = make(best)
            # replay tap: remember batches handed to the runner but not
            # yet yielded as results (all runners yield in input
            # order), so a cached-winner failure replays its in-flight
            # batches through the host path instead of dropping them —
            # the same nothing-is-ever-dropped guarantee the race path
            # gives
            import collections

            tap = collections.deque()

            def tapped():
                for b in it:
                    tap.append(b)
                    yield b

            try:
                try:
                    for out in runner(tapped()):
                        if tap:
                            tap.popleft()
                        yield out
                    return
                except GeneratorExit:
                    # abandoned generator: the outer finally still
                    # closes the pipe (it used to leak its 8-thread
                    # pool here)
                    raise
                except Exception:
                    # the cached winner no longer works in this
                    # deployment — forget it, replay its in-flight
                    # batches on the host path, and finish the rest of
                    # the stream there too
                    _race_cache_store(cache_key, None)
                    hp, host_run = make("host")
                    from itertools import chain

                    try:
                        for out in host_run(chain(list(tap), it)):
                            yield out
                    finally:
                        hp.close()
                    return
            finally:
                pipe.close()

    host_pipe, host_runner = make("host")
    rates = {}
    winners = {"host": (host_pipe, host_runner)}
    try:
        yield from _race_and_run(it, configs, winners, rates, make,
                                 host_runner, cache_key, use_cache,
                                 probe_batches, depth, strict_lsb,
                                 width, height)
    finally:
        # idempotent closes: losers were already closed after the race;
        # this covers abandonment at ANY yield (the probe-phase yields
        # used to leak every pipe's thread pool on GeneratorExit)
        for p, _r in winners.values():
            p.close()


def _race_and_run(it, configs, winners, rates, make, host_runner,
                  cache_key, use_cache, probe_batches, depth,
                  strict_lsb=None, width=None, height=None):
    import time
    from itertools import islice

    parities = {}
    for config in configs:
        if config == "host":
            pipe, runner = winners["host"]
        else:
            pipe, runner = make(config)
            winners[config] = (pipe, runner)
        # device configs need TWO warm batches: stream_hybrid only
        # dispatches to the device once its backlog holds >= 2 batches,
        # so a one-batch warm would leave the device graph uncompiled
        # and the timed probe would pay the first compile
        warm = list(islice(it, 2 if "+" in config else 1))
        if not warm:
            break
        if "+" in config and len(warm) == 1:
            # stream nearly dry — compile the device graph with a
            # direct (non-streamed) call; its outputs are discarded,
            # the warm batch still flows through the runner below
            try:
                pipe(warm[0])
            except Exception:  # noqa: BLE001 — probe will score the loss
                pass
        chunk = list(islice(it, probe_batches))
        try:
            warm_outs = list(runner(iter(warm)))
            t0 = time.perf_counter()
            outs = list(runner(iter(chunk)))  # timed to full drain
            if chunk:
                # images/sec, not batches/sec: signature-bucketed
                # streams can hand different-sized batches to different
                # configs' probe chunks
                rates[config] = sum(len(o) for o in outs) / max(
                    time.perf_counter() - t0, 1e-9)
                if strict_lsb is not None and config != "host":
                    # quality gate on LIVE traffic: measured outside
                    # the timed window (one-time probe cost), a config
                    # over the bound cannot win no matter how fast
                    lsb = _parity_vs_host(winners["host"][0], chunk,
                                          outs, width, height)
                    parities[config] = round(lsb, 3)
                    if lsb > strict_lsb:
                        del rates[config]
        except Exception:  # noqa: BLE001 — config loses; replay on host
            if config == "host":
                raise
            warm_outs = []
            outs = list(host_runner(iter(warm + chunk)))
        for out in warm_outs:
            yield out
        for out in outs:
            yield out
        if not chunk:
            break
    best = max(rates, key=rates.get) if rates else "host"
    if use_cache and rates:
        entry = {"best": best,
                 "rates": {k: round(v, 3) for k, v in rates.items()},
                 "saved_at": time.time()}
        if parities:
            entry["parity_lsb"] = parities
        _race_cache_store(cache_key, entry)
    for config, (pipe, _r) in winners.items():
        if config != best:
            pipe.close()
    pipe, runner = winners[best]
    try:
        for out in runner(it):
            yield out
    finally:
        pipe.close()
