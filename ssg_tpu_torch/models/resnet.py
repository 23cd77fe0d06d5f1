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

* ``fused_eval`` (off by default, as in JAX): in eval mode each identity
  bottleneck (stride 1, ``cin == 4 * features``) folds its BatchNorms into
  the conv weights and runs ``ops.bottleneck.fused_bottleneck`` (the CUDA
  kernels on the card, bf16 or fp32). Those blocks keep their conv weights
  in fp32, as Flax keeps its parameters, and fold from them: folding a
  bf16-stored weight would round twice. Other convs are stored in
  ``dtype``; train mode casts the fp32 masters to ``dtype`` at each conv.

The JAX package's space-to-depth stem is an exact TPU rewrite of the 7x7
conv and is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssg_tpu_torch.ops.bottleneck import fold_bn, fused_bottleneck

PART_NAMES = ("whole", "up", "down")


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, fused_eval: bool = False):
        super().__init__()
        cout = features * self.expansion
        self.fused_eval = fused_eval
        self._fold_cache = None
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

    @torch.no_grad()
    def folded(self, dtype: torch.dtype) -> tuple:
        """The block with its BNs folded (``fold_bn``, fp32), in the JAX
        layout ``ops.bottleneck`` takes: ``(w1, b1, w2, b2, w3, b3)``, plus
        ``(wd, bd)`` for a downsample block. Weights are cast to ``dtype``
        and contiguous, biases fp32. Cached until a source tensor is
        replaced or changed in place (its ``_version``)."""
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        srcs = [t for conv, bn in pairs
                for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        key = (dtype, *((t.data_ptr(), t._version) for t in srcs))
        if self._fold_cache is None or self._fold_cache[0] != key:
            out = []
            for conv, bn in pairs:
                w, b = fold_bn(conv.weight.permute(2, 3, 1, 0), bn.weight, bn.bias,
                               bn.running_mean, bn.running_var, bn.eps)
                w = w[0, 0] if conv.kernel_size == (1, 1) else w
                out += [w.to(dtype).contiguous(), b.contiguous()]
            self._fold_cache = (key, tuple(out))
        return self._fold_cache[1]

    @staticmethod
    def _conv(conv: nn.Conv2d, x):
        if conv.weight.dtype == x.dtype:
            return conv(x)
        return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)

    def forward(self, x):
        if self.fused_eval and not self.training and self.downsample is None:
            # NCHW with channels-last strides is NHWC-contiguous once permuted:
            # the kernel reads and writes it with no layout copy (other
            # strides are copied once).
            out = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(), *self.folded(x.dtype))
            return out.permute(0, 3, 1, 2)
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self._conv(self.conv1, x)))
        y = self.relu(self.bn2(self._conv(self.conv2, y)))
        y = self.bn3(self._conv(self.conv3, y))
        return self.relu(y + residual)


class ResNetBackbone(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], last_stride: int = 2,
                 fused_eval: bool = False):
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
                blocks.append(Bottleneck(cin, 64 * 2**stage, stride if blk == 0 else 1,
                                         fused_eval))
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
                 dtype: torch.dtype = torch.float32, fused_eval: bool = False):
        super().__init__()
        self.backbone = ResNetBackbone(stage_sizes, last_stride, fused_eval)
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
        # Convolution weights carry the compute type; BN and heads stay fp32,
        # and so do the fp32 masters of the blocks that fused_eval folds.
        masters = set()
        for blk in self.backbone.modules():
            if isinstance(blk, Bottleneck) and blk.fused_eval and blk.downsample is None:
                masters.update((blk.conv1, blk.conv2, blk.conv3))
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d) and m not in masters:
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
