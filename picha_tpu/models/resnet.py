"""A compact pre-activation ResNet: the convolutional consumer for the
image pipeline (models come in two families — patch-transformer
(vit.py) and convolutional — both pure-jax pytrees with dp×tp sharding
rules; GSPMD inserts the collectives).

Convs lower to matmuls via XLA's implicit im2col; channels are the
sharded ('tp') axis: conv kernels shard on output channels, the
block's second conv on input channels (mirroring the qkv/proj split in
the ViT).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    image_size: int = 224
    stem_channels: int = 64
    stage_channels: tuple = (64, 128, 256)
    blocks_per_stage: int = 2
    classes: int = 1000


TINY = ResNetConfig(image_size=32, stem_channels=32,
                    stage_channels=(32, 64), blocks_per_stage=1, classes=16)


def _conv_init(key, kh, kw, cin, cout):
    import jax

    fan_in = kh * kw * cin
    return (jax.random.normal(key, (kh, kw, cin, cout), dtype=np.float32)
            / np.float32(math.sqrt(fan_in)))


def init_params(key, cfg: ResNetConfig) -> Dict:
    import jax

    n_blocks = len(cfg.stage_channels) * cfg.blocks_per_stage
    ks = iter(jax.random.split(key, 3 + 3 * n_blocks))
    params: Dict[str, Any] = {
        "stem": _conv_init(next(ks), 3, 3, 3, cfg.stem_channels),
        "head": (jax.random.normal(next(ks),
                                   (cfg.stage_channels[-1], cfg.classes),
                                   dtype=np.float32)
                 / np.float32(math.sqrt(cfg.stage_channels[-1]))),
        "stages": [],
    }
    cin = cfg.stem_channels
    for cout in cfg.stage_channels:
        stage = []
        for b in range(cfg.blocks_per_stage):
            stage.append({
                "conv1": _conv_init(next(ks), 3, 3, cin, cout),
                "conv2": _conv_init(next(ks), 3, 3, cout, cout),
                "proj": (_conv_init(next(ks), 1, 1, cin, cout)
                         if cin != cout else None),
                "scale1": np.ones(cin, np.float32),
                "scale2": np.ones(cout, np.float32),
            })
            cin = cout
        params["stages"].append(stage)
    return params


def param_specs(cfg: ResNetConfig):
    from jax.sharding import PartitionSpec as P

    rep = P()

    def block(cin_eq_cout):
        return {
            "conv1": P(None, None, None, "tp"),
            "conv2": P(None, None, "tp", None),
            "proj": None if cin_eq_cout else P(None, None, None, "tp"),
            "scale1": rep,
            "scale2": rep,
        }

    stages = []
    cin = cfg.stem_channels
    for cout in cfg.stage_channels:
        stage = []
        for b in range(cfg.blocks_per_stage):
            stage.append(block(cin == cout))
            cin = cout
        stages.append(stage)
    return {
        "stem": P(None, None, None, "tp"),
        "head": P(None, "tp"),
        "stages": stages,
    }


def _norm(x, scale):
    import jax.numpy as jnp

    x32 = x.astype(jnp.float32)
    mu = x32.mean(axis=(1, 2), keepdims=True)
    var = ((x32 - mu) ** 2).mean(axis=(1, 2), keepdims=True)
    return ((x32 - mu) / jnp.sqrt(var + 1e-5) * scale).astype(x.dtype)


def _conv(x, w, stride=1):
    import jax

    # plain same-dtype conv: the matmul unit accumulates in f32, and
    # keeping operand/result dtypes uniform keeps the VJP well-typed
    return jax.lax.conv_general_dilated(
        x, w.astype(x.dtype), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def forward(params, images, cfg: ResNetConfig):
    """images (N, H, W, 3) float in [0,1] -> (N, classes) f32 logits."""
    import jax
    import jax.numpy as jnp

    x = images.astype(jnp.bfloat16)
    x = _conv(x, params["stem"])
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 else 1
            h = jax.nn.relu(_norm(x, blk["scale1"]))
            h = _conv(h, blk["conv1"], stride)
            h = jax.nn.relu(_norm(h, blk["scale2"]))
            h = _conv(h, blk["conv2"])
            shortcut = x
            if blk["proj"] is not None:
                shortcut = _conv(shortcut, blk["proj"], stride)
            elif stride != 1:
                # identity downsample = the stride-2 SAME sample points;
                # a strided slice is free vs a CxC eye convolution
                shortcut = shortcut[:, ::stride, ::stride, :]
            x = h + shortcut
    pooled = x.astype(jnp.float32).mean(axis=(1, 2))
    return pooled @ params["head"]


def make_train_step(cfg: ResNetConfig, learning_rate: float = 3e-4):
    import jax
    import jax.numpy as jnp
    import optax

    tx = optax.adamw(learning_rate)

    def loss_fn(params, images, labels):
        logits = forward(params, images, cfg)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean()

    def init_opt(params):
        return tx.init(params)

    def train_step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return init_opt, train_step
