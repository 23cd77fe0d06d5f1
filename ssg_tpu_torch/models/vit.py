"""ViT-Base/16 with overlapping patches and the SSG part heads, in PyTorch.

The transformer backbone that person re-ID adapts (TransReID, He et al.
2021, arXiv:2102.04378; TransReID-SSL, Luo et al. 2021, arXiv:2111.12084,
runs it through the same cluster-then-fine-tune loop as SSG), ending in the
heads every backbone of the port shares (``models.heads.SSGHeads``). The
JAX package has no counterpart.

* ViT-Base (Dosovitskiy et al. 2020, arXiv:2010.11929, Table 1): 12
  pre-norm blocks of width 768, 12 heads of 64, an MLP of 3,072 with
  exact-erf GELU, qkv bias, LayerNorm eps 1e-6, a class token, learned
  position embeddings and a final LayerNorm.
* TransReID's input stage: 16x16 patches at stride 12 with no padding, so a
  256x128 image gives 21 x 10 overlapping patches and 211 tokens. The
  position table is built for ``img_size``; an image of another size is
  refused (nothing interpolates the table: the port trains and extracts at
  one size).
* Heads: the "whole" part is the final class token, as in TransReID; the
  upper and lower parts are the means of the upper and lower halves of the
  patch grid, by the ``h // 2`` rule ``SSGHeads`` applies to a feature map.
  All three go through ``SSGHeads._project`` (each part's BatchNorm1d,
  L2-normalised in eval mode). TransReID's camera embedding (SIE) and
  jigsaw branch (JPM) belong to its heads, not its backbone, and are not
  built; drop-path is 0.
* Parameter names are timm's ``vit_base_patch16_224`` under ``backbone.``
  (``patch_embed.proj``, ``cls_token``, ``pos_embed``, ``blocks.{i}.norm1``,
  ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``,
  ``norm``), so a TransReID checkpoint maps key for key.
* Precision, for ``dtype=torch.bfloat16``: the patch convolution, every
  linear and attention's two products run on bf16 operands with fp32
  accumulation, from fp32 masters cast at each call (cached without
  autograd until a master changes: ``models.layers.cast_masters``);
  LayerNorm's statistics and the softmax are fp32; the residual stream is
  fp32, as ``torch.autocast(bfloat16)`` keeps it; the heads are fp32. With
  ``dtype=torch.float32`` everything runs in fp32.
* Attention is ``F.scaled_dot_product_attention`` restricted to one route
  (``attention_route``): FlashAttention on the card in bf16 or fp16, the
  math route otherwise. There is no fallback: a shape the route cannot take
  raises.
* ``remat`` (``forward(x, remat=True)``): each block runs under
  ``models.layers.remat_block``, the rule every backbone's blocks share.
* Spans (``utils.profiling``): ``vit.embed``, ``vit.block`` (keyed by the
  block's index) and ``vit.heads`` in ``forward``, and the counter
  ``vit.attention.<route>`` once a forward. They record where the forward
  runs in Python: an extract, a train step's eager calls and its capture;
  a replayed CUDA graph runs none of them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ssg_tpu_torch.models.heads import SSGHeads
from ssg_tpu_torch.models.layers import cast_masters, remat_block
from ssg_tpu_torch.utils.profiling import count, span

_ROUTES = {"flash": SDPBackend.FLASH_ATTENTION, "math": SDPBackend.MATH}


def attention_route(device: torch.device, dtype: torch.dtype) -> str:
    """The one SDPA backend the model uses: ``"flash"`` on the card in a
    16-bit type, ``"math"`` elsewhere (fp32 stays true fp32 on the card)."""
    half = dtype in (torch.bfloat16, torch.float16)
    return "flash" if device.type == "cuda" and half else "math"


class Linear(nn.Linear):
    """A linear layer on an fp32 master weight and bias, cast to the input's
    type (``models.layers.cast_masters``)."""

    _cast_cache = None

    def forward(self, x):
        return F.linear(x, *cast_masters(self, x.dtype))


class PatchConv(nn.Conv2d):
    """The patch embedding's convolution: ``k`` x ``k`` at ``stride``, no
    padding, with a bias, on fp32 masters cast to the input's type."""

    _cast_cache = None

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__(cin, cout, k, stride, padding=0, bias=True)

    def forward(self, x):
        return F.conv2d(x, *cast_masters(self, x.dtype), self.stride)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, stride: int, dim: int):
        super().__init__()
        self.proj = PatchConv(3, dim, patch_size, stride)

    def forward(self, x):
        return self.proj(x)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, t, c = x.shape
        q, k, v = self.qkv(x).view(b, t, 3, self.num_heads, c // self.num_heads).permute(
            2, 0, 3, 1, 4)  # each (B, heads, T, head_dim)
        # The route is restricted here, not once a forward, so that remat's
        # recomputation on autograd's thread takes it too.
        with sdpa_kernel(_ROUTES[attention_route(x.device, x.dtype)]):
            y = F.scaled_dot_product_attention(q, k, v)
        return self.proj(y.transpose(1, 2).reshape(b, t, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block on the residual stream: each branch's
    LayerNorm output is cast to the compute type, its result added back in
    the stream's type."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x).to(self.dtype))
        return x + self.mlp(self.norm2(x).to(self.dtype))


class VisionTransformer(nn.Module):
    """The backbone's modules; ``SSGViT.forward`` runs them."""

    def __init__(self, img_size: Sequence[int], patch_size: int, stride: int, embed_dim: int,
                 depth: int, num_heads: int, mlp_dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.grid = tuple((s - patch_size) // stride + 1 for s in img_size)
        self.num_tokens = 1 + self.grid[0] * self.grid[1]
        self.patch_embed = PatchEmbed(patch_size, stride, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_tokens, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_dim, eps, dtype)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=eps)

    def embed(self, x):
        """NCHW images in the compute type -> (B, T, C) fp32 tokens."""
        x = self.patch_embed(x)
        if tuple(x.shape[2:]) != self.grid:
            raise ValueError(f"a {tuple(x.shape[2:])} patch grid; the position table is "
                             f"for {self.grid} (img_size)")
        x = x.flatten(2).transpose(1, 2).float()
        return torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1) + self.pos_embed


class SSGViT(SSGHeads):
    """ViT backbone + SSG multi-part heads (``SSGHeads``), defaults ViT-B/16
    at stride 12 on 256x128 images.

    ``forward(x, remat=False)`` takes NHWC float images and returns the
    heads' dict, as ``SSGResNet`` does.
    """

    def __init__(self, img_size: Sequence[int] = (256, 128), patch_size: int = 16,
                 stride: int = 12, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, eps: float = 1e-6, num_features: int = 0,
                 dropout: float = 0.0, num_classes: int = 0, num_parts: int = 3,
                 norm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = VisionTransformer(img_size, patch_size, stride, embed_dim, depth,
                                          num_heads, mlp_dim, eps, dtype)
        self._add_heads(embed_dim, num_features, dropout, num_classes, num_parts, norm, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random weights from ``generator``, ViT's initialisation: linears,
        the class token and the positions truncated normal with std 0.02
        (cut at two), biases 0, LayerNorms and BatchNorms at identity; the
        patch convolution normal with variance 2 / (k^2 out), TransReID's."""
        def trunc(t):
            t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), std=0.02, a=-0.04, b=0.04,
                                          generator=generator))

        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                n = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / n))
                m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
                m.reset_parameters()
        trunc(self.backbone.cls_token)
        trunc(self.backbone.pos_embed)
        return self

    def forward(self, x, remat: bool = False) -> dict[str, torch.Tensor]:
        vit = self.backbone
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        count(f"vit.attention.{attention_route(x.device, self.dtype)}")
        with span("vit.embed"):
            x = vit.embed(x)
        for i, blk in enumerate(vit.blocks):
            with span("vit.block", key=i):
                x = remat_block(blk, x, remat)
        with span("vit.heads"):
            x = vit.norm(x)
            gh, gw = vit.grid
            grid = x[:, 1:].unflatten(1, (gh, gw))  # (B, gh, gw, C)
            pools = [x[:, 0], grid[:, :max(gh // 2, 1)].mean((1, 2)),
                     grid[:, gh // 2:].mean((1, 2))][:self.num_parts]
            return self._project(pools)


def vit_base_patch16_s12(**kwargs) -> SSGViT:
    """ViT-B/16 at stride 12 (``SSGViT``'s defaults); keyword arguments
    override them."""
    kwargs.pop("last_stride", None)  # a ResNet knob, accepted as ``inception`` does
    return SSGViT(**kwargs)
