"""Host-fallback counters of JpegBatchPipeline.

Every image the device path hands to the host is counted by reason, so
a run that silently fell back cannot pass for a device run
(chip_smoke.py requires all three counters to stay 0)."""

import numpy as np
import pytest

from picha_tpu.native import lib as native
from picha_tpu.pipeline import JpegBatchPipeline

ZERO = {"scan_parse": 0, "decode_not_ok": 0, "encode_overflow": 0}


def _corpus(n=2, w=48, h=32, **kw):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = 128 + 60 * np.sin(xx / (3.0 + i)) + 40 * np.cos(yy / 5.0)
        arr = np.clip(base[..., None] + rng.normal(0, 4, (h, w, 3)), 0,
                      255).astype(np.uint8)
        out.append(native.jpeg_encode(arr, 85, **kw))
    return out


def _device_pipe(**kw):
    return JpegBatchPipeline(width=24, height=16, encode_quality=85,
                             fused=True, upload="scan",
                             encode_backend="device", **kw)


def test_counters_stay_zero_on_device_batch():
    p = _device_pipe()
    try:
        out = p(_corpus())
        assert len(out) == 2 and all(o[:2] == b"\xff\xd8" for o in out)
        assert p.host_fallbacks == ZERO
    finally:
        p.close()


def test_progressive_batch_counts_scan_parse():
    p = _device_pipe()
    try:
        out = p(_corpus(progressive=True))
        assert len(out) == 2
        assert p.host_fallbacks == dict(ZERO, scan_parse=2)
    finally:
        p.close()


def test_unconverged_decode_counts_decode_not_ok():
    import jax.numpy as jnp

    p = JpegBatchPipeline(width=24, height=16, fused=True, upload="scan")
    run = p.run_bucket

    def not_ok(sig, args, **kw):
        res = run(sig, args, **kw)
        if kw.get("scan_ks") is None:
            return res
        return res[0], jnp.bool_(False)

    p.run_bucket = not_ok
    try:
        got = np.asarray(p(_corpus()))
        assert got.shape == (2, 16, 24, 3)
        assert p.host_fallbacks == dict(ZERO, decode_not_ok=2)
    finally:
        p.close()


def test_encode_overflow_counts_encode_overflow():
    # a 1-byte budget overflows on any content; an explicit cap is never
    # boosted, so the batch goes straight to the raw420 host encode
    p = _device_pipe(scan_byte_cap=1)
    try:
        out = p(_corpus())
        assert len(out) == 2
        assert p.host_fallbacks == dict(ZERO, encode_overflow=2)
    finally:
        p.close()


@pytest.mark.parametrize("reason", sorted(ZERO))
def test_count_fallback_is_per_reason(reason):
    p = JpegBatchPipeline()
    try:
        p._count_fallback(reason, 3)
        assert p.host_fallbacks == dict(ZERO, **{reason: 3})
    finally:
        p.close()
