"""ResNet with SSG part pooling, in PyTorch.

Counterpart of ``ssg_tpu/models/resnet.py``: a torchvision-layout ResNet
backbone whose conv5 feature map is pooled three ways — whole map, upper
half, lower half — each with its own head.

* Public input is NHWC float, as in the JAX package; inside, the network
  runs NCHW, channels-last on the GPU (an NHWC tensor permuted to NCHW
  already has channels-last strides).
* Convolutions pad ``k // 2`` explicitly; BN eps 1e-5, momentum 0.1 (Flax's
  0.9 from the other side); 3x3/2 max-pool with pad 1; stage strides
  ``1, 2, 2, last_stride``.
* ``dtype``: the backbone's convolutions compute in ``dtype`` (bf16 runs
  with fp32 accumulation) on fp32 masters, and its BatchNorms keep Flax's
  running variance (``models.layers``); the heads run in fp32
  (``models.heads``).
* Module names follow torchvision (``backbone.layer1.0.conv1``,
  ``downsample.0/1``, ``feat_whole``, ``feat_bn_whole``,
  ``classifier_whole``), so ``models/convert.py`` maps the JAX variables
  one to one.
* ``block``: ``Bottleneck`` (resnet50/101/152, expansion 4) or
  ``BasicBlock`` (resnet18/34, expansion 1); a block builds its downsample
  only where the residual's shape differs, as JAX's do.
* ``remat`` (``forward(x, remat=True)``, the train step's option): each
  residual block runs under ``models.layers.remat_block``, which recomputes
  the block's inner activations in the backward pass.
* ``fused_eval`` (off by default, as in JAX): in eval mode each identity
  bottleneck (stride 1, ``cin == 4 * features``) folds its BatchNorms into
  the conv weights and runs ``ops.bottleneck.fused_bottleneck`` (the CUDA
  kernels on the card, bf16 or fp32). The fold reads the fp32 masters, so
  each folded weight is rounded once, and is redone whenever a master or a
  statistic changes (an optimizer step, a train-mode forward).

* ``stem_s2d`` is accepted for interface parity with the JAX package and
  changes nothing: its space-to-depth stem is an exact TPU rewrite of the
  7x7/2 conv (JAX's ``None`` turns it on only on a TPU), so the canonical
  conv computes the same function.
* ``act_store`` is accepted only as ``None``: the JAX package's
  block-boundary storage experiment (``docs/train_profile.md``) is not
  ported, and any other value raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ssg_tpu_torch.models.heads import SSGHeads
from ssg_tpu_torch.models.layers import BatchNorm2d, Conv2d, remat_block
from ssg_tpu_torch.ops.bottleneck import fold_bn, fused_bottleneck


class BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet18/34): 3x3(stride) -> 3x3 + residual.
    ``fused_eval`` is accepted and unused, as in JAX."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, fused_eval: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv2d(features, features, 3)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(Conv2d(cin, features, 1, stride),
                                            BatchNorm2d(features, eps=1e-5))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3(stride) -> 1x1(x4) + residual."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, fused_eval: bool = False):
        super().__init__()
        cout = features * self.expansion
        self.fused_eval = fused_eval
        self._fold_cache = None
        self.conv1 = Conv2d(cin, features, 1)
        self.bn1 = BatchNorm2d(features, eps=1e-5)
        self.conv2 = Conv2d(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features, eps=1e-5)
        self.conv3 = Conv2d(features, cout, 1)
        self.bn3 = BatchNorm2d(cout, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Conv2d(cin, cout, 1, stride),
                                            BatchNorm2d(cout, eps=1e-5))

    @torch.no_grad()
    def folded(self, dtype: torch.dtype) -> tuple:
        """The block with its BNs folded (``fold_bn``, fp32), in the JAX
        layout ``ops.bottleneck`` takes: ``(w1, b1, w2, b2, w3, b3)``, plus
        ``(wd, bd)`` for a downsample block. Weights are cast to ``dtype``
        and contiguous, biases fp32. Cached until a source tensor is
        replaced or changed in place (its ``_version``: an optimizer's
        in-place update, ``load_state_dict``), or the block runs a
        train-mode forward (the BN statistics' update)."""
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

    def forward(self, x):
        if self.training:
            # A train-mode forward updates the BN statistics without bumping
            # their versions, so the fold cache cannot see it: drop it.
            self._fold_cache = None
        elif self.fused_eval and self.downsample is None:
            # NCHW with channels-last strides is NHWC-contiguous once permuted:
            # the kernel reads and writes it with no layout copy (other
            # strides are copied once).
            out = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(), *self.folded(x.dtype))
            return out.permute(0, 3, 1, 2)
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNetBackbone(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], last_stride: int = 2,
                 fused_eval: bool = False, block: type = Bottleneck):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else (
                last_stride if stage == len(stage_sizes) - 1 else 2)
            blocks = []
            for blk in range(num_blocks):
                blocks.append(block(cin, 64 * 2**stage, stride if blk == 0 else 1, fused_eval))
                cin = 64 * 2**stage * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.out_channels = cin

    def forward(self, x, remat: bool = False):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = remat_block(blk, x, remat)
        return x  # (B, C, h, w) conv5 feature map


class SSGResNet(SSGHeads):
    """ResNet backbone + SSG multi-part pooling heads (``SSGHeads``).

    ``forward(x, remat=False)`` takes NHWC float images and returns the
    heads' dict.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_features: int = 0,
                 dropout: float = 0.0, num_classes: int = 0, num_parts: int = 3,
                 norm: bool = True, last_stride: int = 2, dtype: torch.dtype = torch.float32,
                 fused_eval: bool = False, block: type = Bottleneck,
                 stem_s2d: bool | None = None, act_store: torch.dtype | None = None):
        super().__init__()
        if act_store is not None:
            raise NotImplementedError(
                f"act_store={act_store} is not ported: the JAX package's block-boundary "
                "storage experiment (docs/train_profile.md) is rejected there and unused")
        self.backbone = ResNetBackbone(stage_sizes, last_stride, fused_eval, block)
        self._add_heads(self.backbone.out_channels, num_features, dropout, num_classes,
                        num_parts, norm, dtype)

    def forward(self, x, remat: bool = False) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        return self._heads(self.backbone(x, remat))


def _make(stage_sizes, block):
    def ctor(**kwargs) -> SSGResNet:
        kwargs.setdefault("stage_sizes", stage_sizes)
        return SSGResNet(block=block, **kwargs)

    return ctor


resnet18 = _make((2, 2, 2, 2), BasicBlock)
resnet34 = _make((3, 4, 6, 3), BasicBlock)
resnet50 = _make((3, 4, 6, 3), Bottleneck)
resnet101 = _make((3, 4, 23, 3), Bottleneck)
resnet152 = _make((3, 8, 36, 3), Bottleneck)
