"""Pipeline parallelism (GPipe-style) over a 'pp' mesh axis.

The reference has no multi-device story at all (SURVEY.md §2 bottom
rows); this module completes the rebuild's parallelism alphabet
(dp / tp / sp / ep / pp). A stack of identical stages is sharded one
stage per 'pp' device; microbatches stream through the pipe with
activations hopping stage->stage between devices via `ppermute` inside a
`shard_map`. The schedule is the classic GPipe ramp: with S stages and
M microbatches the loop runs S+M-1 ticks, every device computing on
every tick once the pipe fills (bubble fraction (S-1)/(S+M-1)).

All shapes are static, the time loop is a `lax.scan` (compiler-visible,
no Python unrolling), and the only collectives are the ppermute hops —
exactly the "pick a mesh, annotate, let XLA do the rest" recipe, except
pipelining genuinely needs the explicit permute.
"""
from __future__ import annotations

import functools
from typing import Callable


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   n_micro: int, axis: str = "pp"):
    """Run x through S pipelined stages.

    stage_fn(params_slice, act) -> act : one stage's computation; the
        params_slice is one element of each stacked leaf (leading axis
        removed).
    stacked_params: pytree whose leaves have leading axis S (== mesh
        size along `axis`); sharded/shardable as P('pp', ...).
    x: (batch, ...) input, batch divisible by n_micro.
    Returns stage_fn applied S times in sequence to every microbatch,
    bit-identical to the unpipelined loop.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    shard_map = functools.partial(jax.shard_map, check_vma=False)

    S = mesh.shape[axis]
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError("batch must divide into n_micro microbatches")
    mb = batch // n_micro
    micro = x.reshape((n_micro, mb) + x.shape[1:])

    pspec = jax.tree.map(lambda _: P(axis), stacked_params)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(pspec, P()), out_specs=P())
    def run(params, micro_in):
        # params leaves arrive as (1, ...) local slices
        local = jax.tree.map(lambda a: a[0], params)
        idx = jax.lax.axis_index(axis)
        state = jnp.zeros_like(micro_in[0])
        out = jnp.zeros_like(micro_in)

        def tick(carry, t):
            state, out = carry
            # stage 0 injects microbatch t (clamped; masked later)
            inj = micro_in[jnp.clip(t, 0, n_micro - 1)]
            act = jnp.where(idx == 0, inj, state)
            act = stage_fn(local, act)
            # the LAST stage's result for microbatch t-(S-1) is final
            done = t - (S - 1)
            take = (idx == S - 1) & (done >= 0)
            out = jax.lax.cond(
                take,
                lambda o: jax.lax.dynamic_update_index_in_dim(
                    o, act, jnp.clip(done, 0, n_micro - 1), 0),
                lambda o: o, out)
            # activations hop to the next stage
            nxt = jax.lax.ppermute(
                act, axis, [(i, (i + 1) % S) for i in range(S)])
            return (nxt, out), None

        (state, out), _ = jax.lax.scan(
            tick, (state, out), jnp.arange(n_micro + S - 1))
        # every device returns the full output: broadcast from the last
        # stage (psum of a one-stage-nonzero buffer)
        out = jax.lax.psum(
            jnp.where(idx == S - 1, out, jnp.zeros_like(out)), axis)
        return out

    out = run(stacked_params, micro)
    return out.reshape((batch,) + x.shape[1:])
