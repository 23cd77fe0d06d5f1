"""ResNet with SSG part pooling, in PyTorch.

Counterpart of ``ssg_tpu/models/resnet.py`` (eval forward): a
torchvision-layout ResNet backbone whose conv5 feature map is pooled three
ways — whole map, upper half, lower half — each with its own head.

* Public input is NHWC float, as in the JAX package; inside, the network
  runs NCHW, channels-last on the GPU (an NHWC tensor permuted to NCHW
  already has channels-last strides).
* Convolutions pad ``k // 2`` explicitly; BN eps 1e-5; 3x3/2 max-pool with
  pad 1; stage strides ``1, 2, 2, last_stride``.
* ``dtype``: the backbone's convolutions compute in ``dtype`` (bf16 runs
  with fp32 accumulation); BatchNorm parameters stay fp32 and normalise
  the narrower activation in fp32 (PyTorch's mixed-type batch norm), as
  Flax does before casting back. The heads run in fp32.
* Module names follow torchvision (``backbone.layer1.0.conv1``,
  ``downsample.0/1``, ``feat_whole``, ``feat_bn_whole``), so
  ``models/convert.py`` maps the JAX variables one to one.

The JAX package's space-to-depth stem is an exact TPU rewrite of the 7x7
conv and is not ported; nor are its fused Pallas eval blocks (off by
default there).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

PART_NAMES = ("whole", "up", "down")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        cout = features * self.expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv3 = _conv(features, cout, 1)
        self.bn3 = nn.BatchNorm2d(cout, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNetBackbone(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], last_stride: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else (
                last_stride if stage == len(stage_sizes) - 1 else 2)
            blocks = []
            for blk in range(num_blocks):
                blocks.append(Bottleneck(cin, 64 * 2**stage, stride if blk == 0 else 1))
                cin = 64 * 2**stage * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.out_channels = cin

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x  # (B, C, h, w) conv5 feature map


class SSGResNet(nn.Module):
    """ResNet backbone + SSG multi-part pooling heads (eval forward).

    ``forward(x)`` takes NHWC float images and returns the embeddings
    (num_parts, B, F): L2-normalised in eval mode when ``norm`` is set,
    raw otherwise. ``F`` is ``num_features`` or, when that is 0, the
    backbone's channel count.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_features: int = 0,
                 num_parts: int = 3, norm: bool = True, last_stride: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNetBackbone(stage_sizes, last_stride)
        self.num_parts = num_parts
        self.norm = norm
        self.dtype = dtype
        width = self.backbone.out_channels
        for part in PART_NAMES[:num_parts]:
            if num_features > 0:
                self.add_module(f"feat_{part}", nn.Linear(width, num_features))
            self.add_module(f"feat_bn_{part}",
                            nn.BatchNorm1d(num_features or width, eps=1e-5))
        self.num_features = num_features
        # Convolution weights carry the compute type; BN and heads stay fp32.
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "SSGResNet":
        """Random weights from ``generator``: convs and linears normal with
        variance 1/fan_in (LeCun, as Flax's default), biases 0, BN identity."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                std = (w[0].numel()) ** -0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
        return self

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        fmap = self.backbone(x)
        h = fmap.shape[2]
        # max(h // 2, 1): a height-1 map would leave the upper slice empty.
        pools = [
            fmap.mean((2, 3)),
            fmap[:, :, :max(h // 2, 1)].mean((2, 3)),
            fmap[:, :, h // 2:].mean((2, 3)),
        ][:self.num_parts]
        embeddings = []
        for part, pooled in zip(PART_NAMES, pools):
            y = pooled.float()
            if self.num_features > 0:
                y = getattr(self, f"feat_{part}")(y)
            y = getattr(self, f"feat_bn_{part}")(y)
            if not self.training and self.norm:
                y = y / y.norm(dim=1, keepdim=True).clamp_min(1e-12)
            embeddings.append(y)
        return torch.stack(embeddings)


def resnet50(**kwargs) -> SSGResNet:
    kwargs.setdefault("stage_sizes", (3, 4, 6, 3))
    return SSGResNet(**kwargs)
