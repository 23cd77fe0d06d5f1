"""Operations of the SSG ViT, counted from a configuration's shapes.

The rule of ``frozen/flops.py`` (two operations a multiply-add), applied to
the ViT: the patch convolution (``patch_size`` at ``patch_stride``, no
padding, over 3 channels), each block's four linears (qkv, the output
projection, the MLP's two) over every token, and attention's two products,
QK^T and PV, 2 T^2 D operations each (``frozen/vitwork.py``); where
``num_features`` > 0, one linear a part. LayerNorm, GELU, the softmax, the
adds and the heads' BatchNorm are not counted. A train step counts three
forwards (the forward, and the backward's two products a layer) and no
recomputation. ViT-B/16 at stride 12 on 256x128 (211 tokens): 37.73 GFLOP
a forward, 7.244 TFLOP a step of 64.
"""

from __future__ import annotations

from benchmark.frozen.vitwork import attention_flops


def grid(config: dict) -> tuple[int, int]:
    k, s = config["patch_size"], config["patch_stride"]
    return (config["height"] - k) // s + 1, (config["width"] - k) // s + 1


def forward_flops(config: dict) -> float:
    """Operations of one image's forward at the configuration's size."""
    gh, gw = grid(config)
    c, inner, k = config["hidden_size"], config["intermediate_size"], config["patch_size"]
    t = 1 + gh * gw
    total = 2.0 * gh * gw * c * 3 * k * k
    per_layer = 2.0 * t * c * (3 * c + c + 2 * inner)
    total += config["num_hidden_layers"] * per_layer + attention_flops(config, 1)
    if config.get("num_features", 0) > 0:
        total += 2.0 * c * config["num_features"] * config["num_parts"]
    return total


def train_step_flops(config: dict, batch: int) -> float:
    """Operations of one train step of ``batch`` images: three forwards."""
    return 3.0 * batch * forward_flops(config)
