"""Double-buffered host->device prefetch.

The replacement for the reference's libuv overlap (SURVEY.md
§5.8): while the device crunches batch N, host threads entropy-decode
batch N+1 and its transfer is already in flight. JAX dispatch is
asynchronous, so the recipe is simply to keep `depth` batches in
flight and only block on the oldest.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator


def prefetch(producer: Iterable, depth: int = 2) -> Iterator:
    """Run `producer` (host work -> device arrays) ahead of the consumer
    by `depth` items on a DAEMON background thread.

    A daemon thread (not a ThreadPoolExecutor, whose non-daemon workers
    are joined at interpreter exit) so a consumer that abandons this
    generator while the producer is blocked — e.g. a device readback
    through a stalled link, documented to hang for minutes here —
    never wedges process shutdown; the worker notices the stop flag at
    its next queue hand-off and exits. The producer generator is
    consumed only by the worker thread, so generator-GC close() races
    cannot hit 'generator already executing'."""
    import queue as _queue
    import threading

    depth = max(1, depth)  # depth<1 would deadlock the queue below
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()

    def work():
        try:
            for item in producer:
                while not stop.is_set():
                    try:
                        q.put(("ok", item), timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(("end", None))
        except BaseException as e:  # noqa: BLE001 — delivered to consumer
            try:
                q.put(("err", e), timeout=1.0)
            except _queue.Full:
                pass

    threading.Thread(target=work, daemon=True,
                     name="picha-prefetch").start()
    try:
        while True:
            kind, val = q.get()
            if kind == "end":
                return
            if kind == "err":
                raise val
            yield val
    finally:
        stop.set()


def map_prefetch(fn: Callable, items, depth: int = 2) -> Iterator:
    """prefetch(map(fn, items)) with a clean generator."""
    return prefetch((fn(x) for x in items), depth)
