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
  with fp32 accumulation). Every weight is an fp32 master, as Flax keeps
  its parameters: ``Conv2d`` casts it to the activation type at each call,
  so the optimizer updates fp32 values. BatchNorm normalises the narrower
  activation in fp32 (PyTorch's mixed-type batch norm), as Flax does before
  casting back. The heads run in fp32 (in fp64 for an fp64 model, which
  serves as an exact reference).
* ``BatchNorm2d`` / ``BatchNorm1d`` update their running variance with the
  biased batch variance, as Flax does; PyTorch's own use the unbiased one.
* Module names follow torchvision (``backbone.layer1.0.conv1``,
  ``downsample.0/1``, ``feat_whole``, ``feat_bn_whole``,
  ``classifier_whole``), so ``models/convert.py`` maps the JAX variables
  one to one.
* ``fused_eval`` (off by default, as in JAX): in eval mode each identity
  bottleneck (stride 1, ``cin == 4 * features``) folds its BatchNorms into
  the conv weights and runs ``ops.bottleneck.fused_bottleneck`` (the CUDA
  kernels on the card, bf16 or fp32). The fold reads the fp32 masters, so
  each folded weight is rounded once, and is redone whenever a master or a
  statistic changes (an optimizer step, a train-mode forward).

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


class Conv2d(nn.Conv2d):
    """Bias-free convolution, ``k // 2`` padding, with an fp32 master weight
    cast to the input's type at each call (Flax's ``nn.Conv`` with its
    default fp32 ``param_dtype``). The cast is differentiable, so gradients
    reach the master. Without autograd (an eval extract) the cast copy is
    cached until the weight is replaced or changed in place."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=k // 2, bias=False)
        self._cast_cache = None

    def cast_weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        if w.dtype == dtype:
            return w
        if torch.is_grad_enabled():
            return w.to(dtype)
        c = self._cast_cache
        if c is None or c[0] != w.data_ptr() or c[1] != w._version or c[2].dtype != dtype:
            c = self._cast_cache = (w.data_ptr(), w._version, w.to(dtype))
        return c[2]

    def forward(self, x):
        return F.conv2d(x, self.cast_weight(x.dtype), None, self.stride, self.padding)


class _FlaxRunningVariance:
    """Batch norm with momentum 0.1 and Flax's running statistics.

    Train mode normalises with the batch statistics, as PyTorch's batch
    norm does, but leaves the biased batch variance in the running variance
    (Flax's update), where PyTorch leaves the unbiased one: n / (n - 1)
    larger, 6.7 % at a batch of 16 rows. With r the running variance
    before, m the momentum and u the unbiased variance that PyTorch wrote,
    the biased update is ``(1 - m) r + m u (n - 1) / n``, which is
    ``r' (n - 1) / n + (1 - m) r / n`` of PyTorch's result r'. The
    correction goes through ``.data``, as PyTorch's own update does not
    bump the running variance's version either: its backward saved it.
    ``num_batches_tracked`` (PyTorch's counter for a cumulative average)
    is not kept: the momentum is fixed. Eval mode normalises with the
    running statistics. Both call ``F.batch_norm`` directly."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        rv = self.running_var.data
        before = rv * ((1.0 - self.momentum) / n)
        out = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        torch.add(before, rv, alpha=(n - 1) / n, out=rv)
        return out


class BatchNorm2d(_FlaxRunningVariance, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxRunningVariance, nn.BatchNorm1d):
    pass


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
                 fused_eval: bool = False):
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
    """ResNet backbone + SSG multi-part pooling heads.

    ``forward(x)`` takes NHWC float images and returns a dict:
    ``"embeddings"`` (num_parts, B, F), raw in train mode (the triplet
    loss's input) and L2-normalised in eval mode when ``norm`` is set; and
    ``"logits"`` (num_parts, B, num_classes) when ``num_classes > 0``.
    ``F`` is ``num_features`` or, when that is 0, the backbone's channel
    count. Dropout (``dropout > 0``, train mode) applies after each part's
    BatchNorm and feeds only the classifier; the embedding is taken before
    it.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_features: int = 0,
                 dropout: float = 0.0, num_classes: int = 0, num_parts: int = 3,
                 norm: bool = True, last_stride: int = 2, dtype: torch.dtype = torch.float32,
                 fused_eval: bool = False):
        super().__init__()
        self.backbone = ResNetBackbone(stage_sizes, last_stride, fused_eval)
        self.num_parts = num_parts
        self.norm = norm
        self.dtype = dtype
        self.num_features = num_features
        self.num_classes = num_classes
        self.drop = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        width = self.backbone.out_channels
        for part in PART_NAMES[:num_parts]:
            if num_features > 0:
                self.add_module(f"feat_{part}", nn.Linear(width, num_features))
            self.add_module(f"feat_bn_{part}", BatchNorm1d(num_features or width, eps=1e-5))
            if num_classes > 0:
                self.add_module(f"classifier_{part}",
                                nn.Linear(num_features or width, num_classes))

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

    def forward(self, x) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        fmap = self.backbone(x)
        h = fmap.shape[2]
        # max(h // 2, 1): a height-1 map would leave the upper slice empty.
        pools = [
            fmap.mean((2, 3)),
            fmap[:, :, :max(h // 2, 1)].mean((2, 3)),
            fmap[:, :, h // 2:].mean((2, 3)),
        ][:self.num_parts]
        embeddings, logits = [], []
        head_dtype = torch.promote_types(self.dtype, torch.float32)  # fp32, or fp64
        for part, pooled in zip(PART_NAMES, pools):
            y = pooled.to(head_dtype)
            if self.num_features > 0:
                y = getattr(self, f"feat_{part}")(y)
            y = getattr(self, f"feat_bn_{part}")(y)
            emb = y
            if not self.training and self.norm:
                emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-12)
            if self.num_classes > 0:
                logits.append(getattr(self, f"classifier_{part}")(self.drop(y)))
            embeddings.append(emb)
        out = {"embeddings": torch.stack(embeddings)}
        if logits:
            out["logits"] = torch.stack(logits)
        return out


def resnet50(**kwargs) -> SSGResNet:
    kwargs.setdefault("stage_sizes", (3, 4, 6, 3))
    return SSGResNet(**kwargs)
