"""Spatially-sharded resize with halo exchange — the CP/SP analog.

The reference's "large image with bounded memory" story was a
row-streaming ring buffer (resize.cc:52-64,83-132) plus O(1) subView
crops. On the device the equivalent is sharding the image's H axis across the
mesh and exchanging a filter-support halo of rows between neighbouring
devices (SURVEY.md §5.7): each device resizes its output-row slab
using only its local rows plus the halo, so gigapixel inputs never
need to be resident on one chip.

Implementation: shard_map over the 'sp' axis. The horizontal pass is
embarrassingly local; the vertical pass needs input rows within
``fsupport`` of the slab boundary, fetched with two ppermute shifts
(up + down). Boundary wrap-around rows carry zero weight in the
per-device vertical weight block (built from the zero-padded global
contribution matrix), so the ring permutation needs no edge casing.
"""
from __future__ import annotations

import functools

import numpy as np

from ..ops.resize import parse_resize_options


def _required_halo(src_h: int, dst_h: int, filter_name: str, fscale: float,
                   n: int, local_in: int, local_out: int) -> int:
    """Halo bound: how far any shard's output windows reach outside its
    input slab. Uses the UNTRIMMED analytic window bounds of each
    shard's extreme rows: those are monotone in the row index, so they
    bound every interior row — the trimmed extents are NOT monotone
    (kernels hit exact zeros), and sizing from trimmed extremes could
    under-halo an interior row (a spurious coverage failure at build
    time). The over-allocation is at most a couple of zero-weight
    rows."""
    from ..ops.resize import window_bounds

    rows = []
    for k in range(n):
        r0 = k * local_out
        if r0 >= dst_h:
            break
        rows += [r0, min((k + 1) * local_out, dst_h) - 1]
    bounds = window_bounds(dst_h, src_h, filter_name, fscale, rows)
    halo = 0
    for k in range(n):
        r0 = k * local_out
        if r0 >= dst_h:
            break
        r1 = min((k + 1) * local_out, dst_h) - 1
        for r in {r0, r1}:
            left, right = bounds[r]
            halo = max(halo, k * local_in - left,
                       (right - 1) - ((k + 1) * local_in - 1))
    return max(halo, 0)


@functools.lru_cache(maxsize=8)
def _build(src_h: int, src_w: int, channels: int, dst_h: int, dst_w: int,
           filter_name: str, fscale: float, n_shards: int, axis: str,
           mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jax import shard_map

    from ..ops import resize as _resize
    from ..ops.resize import _apply_axis, resize_weight_rows

    # non-divisible sizes pad the tail and crop after (weights embed in
    # a zero-extended grid, so the numerics stay those of the true
    # src_h -> dst_h mapping)
    src_pad_h = -(-src_h // n_shards) * n_shards
    dst_pad_h = -(-dst_h // n_shards) * n_shards
    local_in = src_pad_h // n_shards
    local_out = dst_pad_h // n_shards
    halo = _required_halo(src_h, dst_h, filter_name, fscale, n_shards,
                          local_in, local_out)
    if halo > local_in:
        # a single ppermute hop reaches only the adjacent shard; wider
        # reach (filter support + pad-induced slab skew) would silently
        # drop taps
        raise ValueError(
            f"vertical window reach ({halo} rows) exceeds the per-shard row "
            f"count ({local_in}); use fewer shards, a narrower filter, or "
            f"shard-divisible sizes")

    ext_len = local_in + 2 * halo
    # per-shard vertical weights: dense (local_out, ext_len) blocks for
    # small slabs; BANDED (T, tile, in_len) blocks + window starts for
    # large ones — the dense form is still ~dst_h*src_h/n floats in
    # total, which defeats the gigapixel goal (at 1e6->5e5 rows over 8
    # shards it would be ~30 GB/shard; banded is ~50 MB). Column j of a
    # shard's extended slab maps to global row k*local_in - halo + j.
    # Output rows >= dst_h are padding: zero weight rows, cropped after.
    from ..ops.resize import BAND_TILE, BANDED_THRESHOLD, _iter_contribs

    banded = ext_len > BANDED_THRESHOLD
    if not banded:
        def block(k):
            b = np.zeros((local_out, ext_len), dtype=np.float32)
            real = min(local_out, max(0, dst_h - k * local_out))
            if real > 0:
                b[:real] = resize_weight_rows(
                    dst_h, src_h, filter_name, fscale,
                    row_start=k * local_out, row_count=real,
                    col_start=k * local_in - halo,
                    col_count=ext_len)
            return b

        blocks = np.stack([block(k) for k in range(n_shards)])
        starts = np.zeros((n_shards, 1), np.int32)  # unused placeholder
        tiles = in_len = 0
    else:
        tile = BAND_TILE
        tiles = -(-local_out // tile)
        shard_rows = []
        los = np.zeros((n_shards, tiles), np.int64)
        his = np.ones((n_shards, tiles), np.int64)
        for k in range(n_shards):
            e0 = k * local_in - halo
            real = min(local_out, max(0, dst_h - k * local_out))
            rows = list(_iter_contribs(dst_h, src_h, filter_name, fscale,
                                       k * local_out, real))
            shard_rows.append(rows)
            for t in range(tiles):
                seg = rows[t * tile:(t + 1) * tile]
                if seg:
                    los[k, t] = min(left for _, left, _ in seg) - e0
                    his[k, t] = max(left + w.size for _, left, w in seg) - e0
        in_len = int(min(ext_len, (his - los).max()))
        starts = np.minimum(los, max(0, ext_len - in_len)).astype(np.int32)
        blocks = np.zeros((n_shards, tiles, tile, in_len), np.float32)
        for k, rows in enumerate(shard_rows):
            e0 = k * local_in - halo
            for i, left, w in rows:
                r = i - k * local_out
                t, rr = divmod(r, tile)
                off = (left - e0) - int(starts[k, t])
                blocks[k, t, rr, off:off + w.size] = w

    def local_fn(img, wv_block, starts_blk):
        # img: (local_in, W, C) float32; wv_block/starts_blk carry the
        # leading 1-sized shard axis from shard_map
        if halo == 0:
            # every window fits inside the slab (e.g. box filter at
            # shard-aligned scales) — and img[-0:] would be the WHOLE
            # slab, not an empty slice
            ext = img
        else:
            up_perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
            dn_perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            prev_tail = jax.lax.ppermute(img[-halo:], axis, up_perm)
            next_head = jax.lax.ppermute(img[:halo], axis, dn_perm)
            ext = jnp.concatenate([prev_tail, img, next_head], axis=0)
        # horizontal pass: dense or banded per source width (ops.resize)
        tmp = _apply_axis(ext, dst_w, src_w, filter_name, fscale, axis=-2)
        if not banded:
            return jnp.einsum("oh,hwc->owc", wv_block[0], tmp,
                              preferred_element_type=jnp.float32,
                              precision=_resize.RESIZE_PRECISION)

        def slice_one(s):
            return jax.lax.dynamic_slice_in_dim(tmp, s, in_len, axis=0)

        g = jax.vmap(slice_one)(starts_blk[0])      # (T, in_len, W, C)
        out = jnp.einsum("tik,tkwc->tiwc", wv_block[0], g,
                         preferred_element_type=jnp.float32,
                         precision=_resize.RESIZE_PRECISION)
        return out.reshape(tiles * BAND_TILE, *out.shape[2:])[:local_out]

    smapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis, None, None),
                  P(axis) if banded else P(axis, None, None),
                  P(axis, None)),
        out_specs=P(axis, None, None))

    def fn(img_u8):
        f = img_u8.astype(jnp.float32) / jnp.float32(255.0)
        out = smapped(f, jnp.asarray(blocks), jnp.asarray(starts))
        return jnp.floor(jnp.clip(out * 255.0 + 0.5, 0, 255)).astype(jnp.uint8)

    sharding = NamedSharding(mesh, P(axis, None, None))
    jitted = jax.jit(fn, in_shardings=sharding, out_shardings=sharding)

    def wrapper(img_u8):
        # pad-and-crop happens outside the pjit boundary: pjit rejects a
        # P(axis) sharding on a non-divisible dimension
        if src_pad_h != src_h:
            img_u8 = jnp.pad(
                img_u8, ((0, src_pad_h - src_h), (0, 0), (0, 0)))
        out = jitted(img_u8)
        if dst_pad_h != dst_h:
            out = out[:dst_h]
        return out

    return wrapper


def resize_sharded(img, dst_w: int, dst_h: int, mesh, axis: str = "sp",
                   filter: str | None = None, filter_scale: float | None = None):
    """Resize an (H, W, C) uint8 image sharded over rows on `mesh[axis]`.

    Returns a (dst_h, dst_w, C) uint8 array sharded the same way. Same
    numerics as ops.resize (reference resize.cc semantics)."""
    opts = {}
    if filter is not None:
        opts["filter"] = filter
    if filter_scale is not None:
        opts["filterScale"] = filter_scale
    name, fscale = parse_resize_options(opts)
    n = mesh.shape[axis]
    h, w, c = img.shape
    fn = _build(h, w, c, dst_h, dst_w, name, fscale, n, axis, mesh)
    return fn(img)
