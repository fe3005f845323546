"""Chunk-size sweep for the speculative (no-restart) device Huffman
decoder: times the decode at several CHUNK_BITS values on the GPU and
verifies exact parity vs libjpeg at each.

Total Jacobi work scales like passes x steps x lane-cost; larger
chunks mean fewer lanes to converge (sync distance ~12-15 kbit is
C-independent) at the price of longer serial step chains per pass —
this sweep finds the empirical knee.

Run from the repository root:  python tools/time_chunked.py [C ...]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

from chip_smoke import grating_corpus  # noqa: E402
from picha_tpu.native import lib as native  # noqa: E402
from picha_tpu.ops.jpeg_huffman_decode_tpu import (  # noqa: E402
    ScanBatch, build_decoder, decode_planes)
from picha_tpu.ops.jpeg_scan import parse_baseline  # noqa: E402

BATCH = 16
W, H = 1920, 1088
MPIX = W * H / 1e6
CS = [int(a) for a in sys.argv[1:]] or [1024, 2048, 4096]


def log(*a):
    print(*a, flush=True)


def main():
    log("devices:", jax.devices())
    bufs = grating_corpus(BATCH, W, H)
    infos = [parse_baseline(bytes(b)) for b in bufs]
    want = [native.JpegCoefficients(bytes(b)) for b in bufs[:2]]

    for C in CS:
        sb = ScanBatch(infos, chunk_bits=C)
        ks = sb.static_key()
        log(f"C={C}: lanes {sb.n_lanes} steps {sb.steps} "
            f"nblkmax {sb.nblkmax} single_pass {sb.single_pass}")
        fn = build_decoder(*ks)
        args = [jax.device_put(np.asarray(a)) for a in sb.args()]
        t0 = time.perf_counter()
        out, ok = jax.block_until_ready(fn(*args))
        log(f"  first run (incl. compile): "
            f"{time.perf_counter() - t0:.1f} s, ok={bool(np.asarray(ok))}")
        iters = 4
        t0 = time.perf_counter()
        for _ in range(iters):
            res = fn(*args)
        jax.block_until_ready(res)
        dt = (time.perf_counter() - t0) / iters
        log(f"  decode: {dt * 1e3:.1f} ms/iter "
            f"({BATCH * MPIX / dt:.1f} Mpix/s)")
        # parity on 2 images
        planes = decode_planes(ScanBatch(infos[:2], chunk_bits=C))
        okp = planes is not None
        if okp:
            for i, co in enumerate(want):
                for ci in range(co.ncomp):
                    w = co.comps[ci]["coefs"]
                    got = planes[ci][i]
                    if not np.array_equal(got[: w.shape[0], : w.shape[1]],
                                          w):
                        okp = False
        log(f"  parity vs libjpeg: {'exact' if okp else 'MISMATCH'}")


if __name__ == "__main__":
    main()
