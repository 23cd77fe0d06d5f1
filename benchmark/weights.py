"""Weights of an SSG ResNet configuration, made on the device from a seed.

``layout(config)`` lists every tensor of the model's state dict by name
(torchvision's names: ``backbone.layer1.0.conv1.weight``, ``downsample.0``
/ ``downsample.1``, ``feat_bn_whole``), built from the configuration file
alone. ``make_state`` fills it: every convolution and linear weight normal
with variance 1 / fan_in (LeCun, as Flax initialises), from one draw on a
generator on the device; biases 0; BatchNorms at identity (weight 1, bias
0, running mean 0, running variance 1), except the last of each residual
branch (``bn3``), whose weight is the configuration's
``residual_bn_gamma``. At 1, a random ResNet in train mode is chaotic:
batch statistics amplify any rounding block after block, so the port's
own bf16 and fp32 forwards of the same weights differ by ~27 % in the
pooled features and ~49 % at layer4 (ResNet-50, CPU); trained ResNets hold
that weight small, and zero-init-residual schemes start it at 0. The program loads it with
``load_state_dict(strict=True)``, so a name or shape the program does not
have fails loudly, and the reference reads the same dictionary.
"""

from __future__ import annotations

import torch

PART_NAMES = ("whole", "up", "down")


def layout(config: dict) -> list[tuple[str, str, tuple]]:
    """(name, kind, shape) of every state tensor; kind is ``conv``, ``linear``,
    ``bias`` or one of ``bn_weight``, ``bn_weight_last`` (a residual
    branch's last), ``bn_bias``, ``bn_mean``, ``bn_var``."""
    out = []

    def conv(name, cin, cout, k):
        out.append((f"{name}.weight", "conv", (cout, cin, k, k)))

    def bn(name, c, weight="bn_weight"):
        for field, kind in (("weight", weight), ("bias", "bn_bias"),
                            ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out.append((f"{name}.{field}", kind, (c,)))

    conv("backbone.conv1", 3, 64, 7)
    bn("backbone.bn1", 64)
    cin = 64
    stages = config["stage_sizes"]
    for s, blocks in enumerate(stages):
        f = 64 * 2 ** s
        stride = 1 if s == 0 else (config["last_stride"] if s == len(stages) - 1 else 2)
        for b in range(blocks):
            p = f"backbone.layer{s + 1}.{b}"
            conv(f"{p}.conv1", cin, f, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", f, 4 * f, 1)
            bn(f"{p}.bn3", 4 * f, weight="bn_weight_last")
            if (stride if b == 0 else 1) != 1 or cin != 4 * f:
                conv(f"{p}.downsample.0", cin, 4 * f, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    width = config.get("num_features", 0) or cin
    for part in PART_NAMES[:config["num_parts"]]:
        if config.get("num_features", 0) > 0:
            out.append((f"feat_{part}.weight", "linear", (width, cin)))
            out.append((f"feat_{part}.bias", "bias", (width,)))
        bn(f"feat_bn_{part}", width)
    return out


def make_state(config: dict, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """fp32 state dict on ``gen``'s device, drawn from ``gen``."""
    dev = gen.device
    items = layout(config)
    drawn = [(n, s) for n, k, s in items if k in ("conv", "linear")]
    total = sum(torch.Size(s).numel() for _, s in drawn)
    flat = torch.randn(total, generator=gen, device=dev)
    state, off = {}, 0
    for name, kind, shape in items:
        if kind in ("conv", "linear"):
            numel = torch.Size(shape).numel()
            fan_in = numel // shape[0]
            state[name] = flat[off:off + numel].view(shape).mul_(fan_in ** -0.5)
            off += numel
        elif kind in ("bn_weight", "bn_var"):
            state[name] = torch.ones(shape, device=dev)
        elif kind == "bn_weight_last":
            state[name] = torch.full(shape, float(config["residual_bn_gamma"]), device=dev)
        else:
            state[name] = torch.zeros(shape, device=dev)
    return state
