"""Example: a dynamic-batching thumbnail service.

Single-image requests arrive one at a time; the DynamicBatcher groups
them into device-sized batches transparently (the picha-style surface —
one image in, one image out — is preserved via Futures).

    python examples/thumbnail_server.py tests/fixtures/*.jpg
"""
import sys

from picha_tpu.native import lib as native
from picha_tpu.pipeline import DynamicBatcher


def main(paths):
    batcher = DynamicBatcher(width=128, height=128, max_batch=32,
                             max_delay_ms=10)
    try:
        futures = {p: batcher.submit(open(p, "rb").read()) for p in paths}
        for p, fut in futures.items():
            thumb = fut.result(timeout=300)  # (128, 128, C) uint8
            out = p.rsplit("/", 1)[-1] + ".thumb.jpg"
            data = native.jpeg_encode(thumb, 85)
            with open(out, "wb") as f:
                f.write(data)
            print(f"{p} -> {out} ({len(data)} bytes)")
    finally:
        batcher.close()


if __name__ == "__main__":
    main([p for p in sys.argv[1:] if p.lower().endswith((".jpg", ".jpeg"))])
