"""Example: bulk JPEG transcode at full-silicon utilisation.

Streams batches through the stage-overlapped hybrid scheduler: host
entropy decode -> gap-delta sparse upload (one coalesced buffer) ->
fused dequant+IDCT+upsample+resize on the device -> either coalesced
4:2:0 planes + host raw encode (default) or the full on-chip encode
(--device-encode: fDCT+quantise+device Huffman, scan bytes byte-identical
to libjpeg), while a host worker steals whole batches for the pure
host path whenever the device chain is busy.

    python examples/batch_transcode.py out_dir *.jpg
    python examples/batch_transcode.py --device-encode out_dir *.jpg
"""
import os
import sys
import time

from picha_tpu.pipeline import JpegBatchPipeline
from picha_tpu.pipeline.jpeg_batch import bucket_by_signature, signature  # noqa: F401


def main(argv):
    device_encode = "--device-encode" in argv
    argv = [a for a in argv if not a.startswith("--")]
    if len(argv) < 2:
        print(__doc__.strip().splitlines()[-2].strip())
        print(__doc__.strip().splitlines()[-1].strip())
        return
    out_dir, paths = argv[0], argv[1:]
    os.makedirs(out_dir, exist_ok=True)
    bufs = [open(p, "rb").read() for p in paths]

    pipe = JpegBatchPipeline(
        width=960, height=544, encode_quality=85, fused=True,
        upload="gap4",
        encode_backend="device" if device_encode else "raw420")

    batch = 16
    batches = [bufs[i : i + batch] for i in range(0, len(bufs), batch)]
    t0 = time.perf_counter()
    n = 0
    for bi, encoded in enumerate(pipe.stream_hybrid(iter(batches), depth=3)):
        for j, data in enumerate(encoded):
            name = os.path.basename(paths[bi * batch + j])
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(bytes(data))
            n += 1
    dt = time.perf_counter() - t0
    print(f"transcoded {n} images in {dt:.2f}s ({n / dt:.1f} img/s)")


if __name__ == "__main__":
    main(sys.argv[1:])
