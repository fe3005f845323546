"""Device-mesh helpers.

The reference had no multi-device story (SURVEY.md §2 bottom rows);
the device-native scale-out plan (SURVEY.md §5.8) is jax.sharding over a
Mesh: batch axis = pure data parallelism (every op in the library is
image-wise independent), spatial axis for oversize single images
(parallel/spatial.py), and model axes (dp×tp) for the training-input
consumer (models/vit.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def make_mesh(axes: Sequence[tuple] = (("dp", -1),), devices=None):
    """Build a Mesh from (name, size) axes; size -1 absorbs the rest.

    make_mesh()                      -> 1-D 'dp' mesh over all devices
    make_mesh((("dp", 2), ("tp", 4)))-> 2x4 dp×tp mesh
    """
    import jax
    from jax.sharding import Mesh

    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    sizes = []
    wild = None
    prod = 1
    for i, (name, size) in enumerate(axes):
        if size == -1:
            if wild is not None:
                # two wildcards are ambiguous — the old behaviour
                # silently pinned the first to 1 (disabling that axis)
                raise ValueError("only one mesh axis may have size -1")
            wild = i
            sizes.append(1)
        else:
            sizes.append(int(size))
            prod *= int(size)
    if wild is not None:
        if n % prod:
            raise ValueError(f"{n} devices not divisible by {prod}")
        sizes[wild] = n // prod
        prod *= sizes[wild]
    if prod > n:
        raise ValueError(
            f"mesh axes {dict(axes)} need {prod} devices, have {n}")
    if prod < n:
        # explicit axes smaller than the device count use a prefix of
        # the devices (deliberate: sub-meshes for testing/partitioning)
        devs = devs[:prod]
    arr = np.array(devs).reshape(sizes)
    return Mesh(arr, tuple(name for name, _ in axes))


def batch_sharding(mesh, axis: str = "dp"):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(axis))


def replicated(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P())


def shard_batch(arr, mesh, axis: str = "dp"):
    """Place a host batch onto the mesh, split over its leading axis."""
    import jax

    return jax.device_put(arr, batch_sharding(mesh, axis))
