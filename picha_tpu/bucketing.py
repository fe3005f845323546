"""Geometric size bucketing shared by the wire packers and the device
entropy coders.

Content-dependent sizes (wire bytes, segment bits, packet counts) feed
jit static keys; rounding them to 16 mantissa steps per octave (with a
floor granule) makes real corpora land on a handful of values, so the
graphs recompile a bounded number of times — the large graphs take
tens of seconds each — at <= ~6% padding cost.
"""
from __future__ import annotations


def bucket_geometric(k: int, granule: int) -> int:
    k = max(int(k), granule)
    step = max(granule, 1 << max(0, k.bit_length() - 4))
    return -(-k // step) * step
