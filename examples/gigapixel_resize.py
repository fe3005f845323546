"""Example: resize an image too large for one device by sharding its
rows across a device mesh (halo exchange between neighbours).

`parallel.spatial.resize_sharded` splits the H axis over the mesh,
computes each shard's output rows from its own rows plus a halo of
neighbour rows fetched with `ppermute`, and returns the output sharded
the same way — bit-equal to the single-device resize (the spatial
analog of sequence parallelism; SURVEY.md §5.7). The weights are the
reference's float32 cubic construction, so parity semantics match the
single-image API exactly.

Runs on the GPUs present (one or more); where JAX finds only the CPU
it splits it into 8 virtual devices:

    python examples/gigapixel_resize.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from a checkout without install

if "XLA_FLAGS" not in os.environ:  # 8 virtual devices if only a CPU
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from picha_tpu.parallel.mesh import make_mesh  # noqa: E402
from picha_tpu.parallel.spatial import resize_sharded  # noqa: E402


def main():
    n = jax.local_device_count()
    mesh = make_mesh((("sp", n),))
    # a tall synthetic "gigapixel" strip (keep the demo quick; scale
    # H/W up freely — per-device memory is what bounds it, not total)
    H, W = 4096, 3072
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 97),
                    127 + 100 * np.cos(yy / 61),
                    (xx + yy) % 256], axis=-1).astype(np.uint8)
    img += rng.integers(0, 8, img.shape, np.uint8)

    out = resize_sharded(img, 768, 1024, mesh)
    out = np.asarray(out)
    print(f"{H}x{W} -> {out.shape} over {n} devices "
          f"(row-sharded, ppermute halos)")

    # parity vs the single-device XLA path (same float ops; the AVX2
    # host path differs by up to 1 LSB by documented design)
    from picha_tpu.ops.resize import resize_array

    ref = np.asarray(resize_array(img, 768, 1024))
    print("bit-equal to single-device resize:",
          bool(np.array_equal(out, ref)))


if __name__ == "__main__":
    main()
