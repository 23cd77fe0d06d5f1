"""Weights of an SSG ViT configuration, made on the device from a seed.

``layout(config)`` lists every tensor of the model's state dict by name
(timm's names under ``backbone.``: ``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.norm1``, ``attn.qkv``, ``attn.proj``,
``norm2``, ``mlp.fc1``, ``mlp.fc2``, ``norm``; the heads' ``feat_bn_whole``
...), built from the configuration file alone. ``make_state`` fills it with
ViT's initialisation: every linear weight, the class token and the position
table truncated normal with std ``init_std`` cut at two standard
deviations, from one draw on a generator on the device; the patch
convolution normal with variance 2 / (k^2 out), TransReID's; biases 0;
LayerNorms and BatchNorms at identity (running mean 0, running variance
1). A pre-norm transformer keeps such weights stable in train mode: no
batch statistic sits inside the backbone. The program loads it with
``load_state_dict(strict=True)`` (BatchNorm's step counters aside), so a
name or shape the program does not have fails loudly, and the reference
reads the same dictionary.
"""

from __future__ import annotations

import math

import torch

PART_NAMES = ("whole", "up", "down")


def layout(config: dict) -> list[tuple[str, str, tuple]]:
    """(name, kind, shape) of every state tensor; kind is ``trunc`` (a
    truncated normal draw), ``patch``, ``bias``, ``ones`` or one of
    ``bn_mean``, ``bn_var``."""
    c, inner = config["hidden_size"], config["intermediate_size"]
    k = config["patch_size"]
    out = [("backbone.cls_token", "trunc", (1, 1, c)),
           ("backbone.pos_embed", "trunc", (1, config["num_tokens"], c)),
           ("backbone.patch_embed.proj.weight", "patch", (c, 3, k, k)),
           ("backbone.patch_embed.proj.bias", "bias", (c,))]

    def linear(name, cin, cout):
        out.extend([(f"{name}.weight", "trunc", (cout, cin)), (f"{name}.bias", "bias", (cout,))])

    def norm(name):
        out.extend([(f"{name}.weight", "ones", (c,)), (f"{name}.bias", "bias", (c,))])

    for i in range(config["num_hidden_layers"]):
        q = f"backbone.blocks.{i}"
        norm(f"{q}.norm1")
        linear(f"{q}.attn.qkv", c, 3 * c)
        linear(f"{q}.attn.proj", c, c)
        norm(f"{q}.norm2")
        linear(f"{q}.mlp.fc1", c, inner)
        linear(f"{q}.mlp.fc2", inner, c)
    norm("backbone.norm")
    width = config.get("num_features", 0) or c
    for part in PART_NAMES[:config["num_parts"]]:
        if config.get("num_features", 0) > 0:
            linear(f"feat_{part}", c, width)
        out.extend([(f"feat_bn_{part}.weight", "ones", (width,)),
                    (f"feat_bn_{part}.bias", "bias", (width,)),
                    (f"feat_bn_{part}.running_mean", "bn_mean", (width,)),
                    (f"feat_bn_{part}.running_var", "bn_var", (width,))])
    return out


def make_state(config: dict, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """fp32 state dict on ``gen``'s device, drawn from ``gen``."""
    dev, std = gen.device, float(config["init_std"])
    items = layout(config)
    total = sum(torch.Size(s).numel() for _, kind, s in items if kind == "trunc")
    flat = torch.nn.init.trunc_normal_(torch.empty(total, device=dev), std=std, a=-2 * std,
                                       b=2 * std, generator=gen)
    state, off = {}, 0
    for name, kind, shape in items:
        numel = torch.Size(shape).numel()
        if kind == "trunc":
            state[name] = flat[off:off + numel].view(shape)
            off += numel
        elif kind == "patch":
            fan_out = shape[0] * shape[2] * shape[3]
            state[name] = torch.randn(shape, generator=gen, device=dev).mul_(
                math.sqrt(2.0 / fan_out))
        elif kind in ("ones", "bn_var"):
            state[name] = torch.ones(shape, device=dev)
        else:
            state[name] = torch.zeros(shape, device=dev)
    return state
