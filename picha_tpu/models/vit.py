"""A minimal-but-real Vision Transformer: the consumer for the
training-input pipeline (BASELINE.json config 5 — "1024-image batched
JPEG decode + random-crop + resize 224x224 + normalize feeding a ViT
step on the device").

Pure-jax pytree params (no framework dep), bfloat16 matmul path with
float32 accumulations, dp×tp sharding rules for mesh execution:

  batch             -> P('dp')
  qkv / mlp-in      -> shard output features on 'tp'
  proj / mlp-out    -> shard input features on 'tp'
  norms, biases     -> replicated

GSPMD inserts the tp collectives (all-reduce on proj/mlp-out) and the
dp grad psum — no hand-written comm (scaling-book recipe).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    classes: int = 1000
    # switch-MoE: every `moe_every`-th block swaps its MLP for
    # `moe_experts` expert FFNs with top-1 routing (0 = dense model).
    # Experts shard over the mesh's 'ep' axis (expert parallelism).
    moe_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.5
    dtype: Any = None  # computed lazily (jnp.bfloat16)

    def is_moe_block(self, i: int) -> bool:
        # every moe_every-th block, counting from the moe_every-th
        # (moe_every=1 means EVERY block is MoE)
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_every - 1)

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


TINY = ViTConfig(image_size=32, patch=8, dim=128, depth=2, heads=4,
                 mlp_ratio=4, classes=16)
TINY_MOE = ViTConfig(image_size=32, patch=8, dim=128, depth=2, heads=4,
                     mlp_ratio=4, classes=16, moe_experts=4)


def init_params(key, cfg: ViTConfig) -> Dict:
    import jax

    ks = jax.random.split(key, 6 + cfg.depth)
    dim, hd = cfg.dim, cfg.head_dim

    def dense(k, fan_in, shape):
        return (jax.random.normal(k, shape, dtype=np.float32)
                / np.float32(math.sqrt(fan_in)))

    params = {
        "patch_embed": dense(ks[0], cfg.patch * cfg.patch * 3,
                             (cfg.patch * cfg.patch * 3, dim)),
        "pos_embed": 0.02 * jax.random.normal(
            ks[1], (cfg.seq_len, dim), dtype=np.float32),
        "head": dense(ks[2], dim, (dim, cfg.classes)),
        "final_ln": {"scale": np.ones(dim, np.float32),
                     "bias": np.zeros(dim, np.float32)},
        "blocks": [],
    }
    for i in range(cfg.depth):
        bk = jax.random.split(ks[6 + i], 5)
        blk = {
            "ln1": {"scale": np.ones(dim, np.float32),
                    "bias": np.zeros(dim, np.float32)},
            "qkv": dense(bk[0], dim, (dim, 3 * cfg.heads * hd)),
            "proj": dense(bk[1], cfg.heads * hd, (cfg.heads * hd, dim)),
            "ln2": {"scale": np.ones(dim, np.float32),
                    "bias": np.zeros(dim, np.float32)},
        }
        if cfg.is_moe_block(i):
            E, f = cfg.moe_experts, cfg.mlp_ratio * dim
            blk["router"] = dense(bk[4], dim, (dim, E))
            blk["w_in"] = np.stack(
                [dense(jax.random.fold_in(bk[2], e), dim, (dim, f))
                 for e in range(E)])
            blk["w_out"] = np.stack(
                [dense(jax.random.fold_in(bk[3], e), f, (f, dim))
                 for e in range(E)])
        else:
            blk["mlp_in"] = dense(bk[2], dim, (dim, cfg.mlp_ratio * dim))
            blk["mlp_out"] = dense(bk[3], cfg.mlp_ratio * dim,
                                   (cfg.mlp_ratio * dim, dim))
        params["blocks"].append(blk)
    return params


def param_specs(cfg: ViTConfig):
    """PartitionSpec pytree matching init_params (dp×tp mesh)."""
    from jax.sharding import PartitionSpec as P

    rep = P()

    def block(i):
        b = {
            "ln1": {"scale": rep, "bias": rep},
            "qkv": P(None, "tp"),
            "proj": P("tp", None),
            "ln2": {"scale": rep, "bias": rep},
        }
        if cfg.is_moe_block(i):
            # expert axis shards over 'ep'; each expert's FFN keeps the
            # tp feature split — GSPMD handles both collectives
            b["router"] = rep
            b["w_in"] = P("ep", None, "tp")
            b["w_out"] = P("ep", "tp", None)
        else:
            b["mlp_in"] = P(None, "tp")
            b["mlp_out"] = P("tp", None)
        return b

    return {
        "patch_embed": P(None, "tp"),
        "pos_embed": rep,
        "head": P(None, "tp"),
        "final_ln": {"scale": rep, "bias": rep},
        "blocks": [block(i) for i in range(cfg.depth)],
    }


def _ln(x, p):
    import jax.numpy as jnp

    x32 = x.astype(jnp.float32)
    mu = x32.mean(-1, keepdims=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdims=True)
    out = (x32 - mu) / jnp.sqrt(var + 1e-6)
    return (out * p["scale"] + p["bias"]).astype(x.dtype)


def forward(params, images, cfg: ViTConfig):
    """images: (N, H, W, 3) float in [0,1] (pipeline `normalize` output).
    Returns (N, classes) float32 logits."""
    import jax
    import jax.numpy as jnp

    bf16 = jnp.bfloat16
    n, h, w, _ = images.shape
    p = cfg.patch
    x = images.reshape(n, h // p, p, w // p, p, 3)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(n, cfg.seq_len, p * p * 3)
    x = x.astype(bf16) @ params["patch_embed"].astype(bf16)
    x = x + params["pos_embed"].astype(bf16)

    scale = 1.0 / math.sqrt(cfg.head_dim)
    for blk in params["blocks"]:
        y = _ln(x, blk["ln1"])
        qkv = y @ blk["qkv"].astype(bf16)
        qkv = qkv.reshape(n, cfg.seq_len, 3, cfg.heads, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = jnp.einsum("nqhd,nkhd->nhqk", q, k,
                         preferred_element_type=jnp.float32) * scale
        att = jax.nn.softmax(att, axis=-1).astype(bf16)
        o = jnp.einsum("nhqk,nkhd->nqhd", att, v,
                       preferred_element_type=jnp.float32).astype(bf16)
        o = o.reshape(n, cfg.seq_len, cfg.heads * cfg.head_dim)
        x = x + o @ blk["proj"].astype(bf16)
        y = _ln(x, blk["ln2"])
        if "router" in blk:
            x = x + _switch_moe(y, blk, cfg)
        else:
            y = jax.nn.gelu(y @ blk["mlp_in"].astype(bf16))
            x = x + y @ blk["mlp_out"].astype(bf16)

    x = _ln(x, params["final_ln"])
    pooled = x.mean(axis=1)
    return (pooled @ params["head"].astype(bf16)).astype(jnp.float32)


def _switch_moe(y, blk, cfg: ViTConfig):
    """Top-1 switch routing with static capacity (all shapes static,
    dropped tokens pass through the residual). Dispatch is a SCATTER
    into the (E, cap, d) expert buffers and combine is a GATHER — the
    classic dense (t, E, cap) one-hot einsum dispatch is quadratic in
    token count (t*cap ~ 1.5*t^2/E floats: ~240 TB at the 1024x224
    config-5 scale) where scatter/gather stay linear. Slots are unique
    per (expert, slot) by construction, so the scatter-add never
    collides. Experts run expert-parallel under an 'ep' mesh axis via
    the param sharding — no hand-written collectives."""
    import jax
    import jax.numpy as jnp

    bf16 = jnp.bfloat16
    n, s, d = y.shape
    t = n * s
    E = cfg.moe_experts
    cap = max(1, int(math.ceil(t / E * cfg.capacity_factor)))
    yt = y.reshape(t, d)
    logits = yt.astype(jnp.float32) @ blk["router"]        # (t, E)
    gates = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(gates, axis=-1)                    # (t,)
    gate = jnp.max(gates, axis=-1)                         # (t,)
    oh = jax.nn.one_hot(expert, E, dtype=jnp.float32)      # (t, E)
    pos = (jnp.cumsum(oh, axis=0) - 1.0) * oh              # slot per token
    slot = jnp.sum(pos, axis=-1).astype(jnp.int32)
    keep = slot < cap
    eidx = jnp.where(keep, expert, E)      # dropped tokens -> trash row
    sidx = jnp.where(keep, slot, 0)
    xe = jnp.zeros((E + 1, cap, d), bf16).at[eidx, sidx].add(
        yt.astype(bf16))[:E]
    he = jax.nn.gelu(jnp.einsum("ecd,edf->ecf", xe,
                                blk["w_in"].astype(bf16)))
    ye = jnp.einsum("ecf,efd->ecd", he, blk["w_out"].astype(bf16))
    yep = jnp.concatenate([ye, jnp.zeros((1, cap, d), ye.dtype)], axis=0)
    out = yep[eidx, sidx] * (gate * keep)[:, None].astype(bf16)
    return out.reshape(n, s, d).astype(y.dtype)


def loss_fn(params, images, labels, cfg: ViTConfig):
    import jax
    import jax.numpy as jnp

    logits = forward(params, images, cfg)
    logp = jax.nn.log_softmax(logits)
    ll = jnp.take_along_axis(logp, labels[:, None], axis=-1)
    return -ll.mean()


def make_train_step(cfg: ViTConfig, learning_rate: float = 3e-4):
    """Returns (init_opt_state, train_step). train_step is jittable and
    sharding-agnostic: under a dp×tp mesh GSPMD handles the comms."""
    import jax
    import optax

    tx = optax.adamw(learning_rate)

    def init_opt(params):
        return tx.init(params)

    def train_step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, labels, cfg)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return init_opt, train_step
