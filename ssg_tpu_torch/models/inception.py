"""InceptionNet with SSG part pooling, in PyTorch.

Counterpart of ``ssg_tpu/models/inception.py``: a conv stem (/4) followed by
inception blocks that mix 1x1 / 3x3 / double-3x3 / pooled branches, ending
in the SSG multi-part heads (``models.resnet.SSGHeads``: whole / upper /
lower pooled embeddings, the same output contract as ``SSGResNet``).

* Public input is NHWC float; inside, the network runs NCHW (channels-last
  on the card), as ``SSGResNet`` does.
* Every conv is ``models.resnet.Conv2d`` (an fp32 master cast to the
  activation type at each call, ``k // 2`` padding) and every BatchNorm
  ``models.resnet.BatchNorm2d`` (Flax's biased running variance), both in
  the model's ``dtype``, as Flax runs its branch convs and BNs in the
  module dtype; the heads run in fp32.
* Pooling: a stride-1 block's pool branch is a 3x3/1 average pool with pad
  1 that counts the padding (Flax's ``avg_pool`` with explicit padding,
  ``nn.AvgPool2d``'s default); a stride-2 block's is a 3x3/2 max pool with
  pad 1 (-inf padding in both), which passes its input channels through.
  At the default depth 8 / width 64 the block widths run 64 -> 256 -> 512
  -> 1024, so the embedding is 1024-d.
* Module names are Flax's (``stem1.conv``, ``block3.bdbl_2.bn``,
  ``feat_bn_whole``), so ``models.convert.from_jax_variables`` maps the
  JAX variables one to one.
* ``remat`` (``forward(x, remat=True)``): each inception block runs under
  ``torch.utils.checkpoint``, with the same recomputation rule for its
  BatchNorms as the ResNet's residual blocks (``models.resnet.recomputing``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssg_tpu_torch.models.resnet import BatchNorm2d, Conv2d, SSGHeads, _checkpoint_contexts


class _ConvBN(nn.Module):
    """conv (no bias, ``k // 2`` padding) -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel, stride)
        self.bn = BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class InceptionBlock(nn.Module):
    """Four branches concatenated: 1x1, 3x3, double 3x3, avg-pool + 1x1.
    ``stride=2`` downsamples: no 1x1 branch, and the pool branch is a
    max-pool of the input. ``out_channels`` is ``4 * features``, or
    ``2 * features + cin`` when downsampling."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        f, s = features, stride
        self.stride = s
        if s == 1:
            self.b1x1 = _ConvBN(cin, f, 1)
        self.b3x3_reduce = _ConvBN(cin, f, 1)
        self.b3x3 = _ConvBN(f, f, 3, s)
        self.bdbl_reduce = _ConvBN(cin, f, 1)
        self.bdbl_1 = _ConvBN(f, f, 3)
        self.bdbl_2 = _ConvBN(f, f, 3, s)
        if s == 1:
            self.pool = nn.AvgPool2d(3, 1, padding=1)
            self.bpool = _ConvBN(cin, f, 1)
            self.out_channels = 4 * f
        else:
            self.pool = nn.MaxPool2d(3, 2, padding=1)
            self.out_channels = 2 * f + cin

    def forward(self, x):
        branches = [self.b1x1(x)] if self.stride == 1 else []
        branches.append(self.b3x3(self.b3x3_reduce(x)))
        branches.append(self.bdbl_2(self.bdbl_1(self.bdbl_reduce(x))))
        p = self.pool(x)
        branches.append(self.bpool(p) if self.stride == 1 else p)
        return torch.cat(branches, dim=1)


class SSGInception(SSGHeads):
    """Inception backbone + SSG multi-part heads. ``depth`` inception blocks
    after the stem; the blocks at ``depth // 3`` and ``2 * depth // 3``
    double the per-branch ``width`` and downsample."""

    def __init__(self, depth: int = 8, width: int = 64, num_features: int = 0,
                 dropout: float = 0.0, num_classes: int = 0, num_parts: int = 3,
                 norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem1 = _ConvBN(3, 32, 3, 2)
        self.stem2 = _ConvBN(32, 32, 3)
        self.stem3 = _ConvBN(32, 64, 3)
        self.stem_pool = nn.MaxPool2d(3, 2, padding=1)
        self.depth = depth
        cin = 64
        for i in range(depth):
            downsample = i in (depth // 3, 2 * depth // 3)
            if downsample:
                width *= 2
            block = InceptionBlock(cin, width, 2 if downsample else 1)
            self.add_module(f"block{i}", block)
            cin = block.out_channels
        self.out_channels = cin
        self._add_heads(cin, num_features, dropout, num_classes, num_parts, norm, dtype)

    def forward(self, x, remat: bool = False) -> dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        x = self.stem_pool(self.stem3(self.stem2(self.stem1(x))))
        remat = remat and torch.is_grad_enabled()
        for i in range(self.depth):
            blk = getattr(self, f"block{i}")
            x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=True,
                            context_fn=_checkpoint_contexts) if remat else blk(x))
        return self._heads(x)


def inception(**kwargs) -> SSGInception:
    kwargs.pop("last_stride", None)  # a ResNet knob, accepted as the JAX factory does
    return SSGInception(**kwargs)
