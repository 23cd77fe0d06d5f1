"""Operations of the SSG ResNet, counted from a configuration's shapes.

The counting rule is ``chip_smoke.forward_flops``'s at commit 78531ab (two
operations a multiply-add of every convolution and linear layer), applied
here to the shapes a configuration file states rather than to the
program's modules: a 7x7/2 stem, a 3x3/2 max-pool, then Bottleneck stages
of widths 64 x 2^s (x 4 out), strides 1, 2, 2, ``last_stride``, a
downsample 1x1 where a block's input and output differ, and, where
``num_features`` > 0, one linear a part. BatchNorm, ReLU, adds, pooling
and the losses are not counted. A train step counts three forwards (the
forward, and the backward's two products a layer) and no recomputation.
"""

from __future__ import annotations


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def forward_flops(config: dict, height: int | None = None, width: int | None = None) -> float:
    """Operations of one image's forward at ``height`` x ``width`` (the
    configuration's input size by default)."""
    h = config["height"] if height is None else height
    w = config["width"] if width is None else width
    total = 0.0

    def conv(cin, cout, k, stride, h, w):
        nonlocal total
        oh, ow = _out(h, k, stride), _out(w, k, stride)
        total += 2.0 * oh * ow * cout * cin * k * k
        return oh, ow

    h, w = conv(3, 64, 7, 2, h, w)
    h, w = _out(h, 3, 2), _out(w, 3, 2)  # max-pool
    cin = 64
    stages = config["stage_sizes"]
    for s, blocks in enumerate(stages):
        f = 64 * 2 ** s
        stride = 1 if s == 0 else (config["last_stride"] if s == len(stages) - 1 else 2)
        for b in range(blocks):
            st = stride if b == 0 else 1
            conv(cin, f, 1, 1, h, w)
            oh, ow = conv(f, f, 3, st, h, w)
            conv(f, 4 * f, 1, 1, oh, ow)
            if st != 1 or cin != 4 * f:
                conv(cin, 4 * f, 1, st, h, w)
            h, w, cin = oh, ow, 4 * f
    if config.get("num_features", 0) > 0:
        total += 2.0 * cin * config["num_features"] * config["num_parts"]
    return total


def train_step_flops(config: dict, batch: int) -> float:
    """Operations of one train step of ``batch`` images: three forwards."""
    return 3.0 * batch * forward_flops(config)
