"""The SSG multi-part heads every backbone of the port ends in.

``SSGResNet`` (``models/resnet.py``), ``SSGInception``
(``models/inception.py``) and ``SSGViT`` (``models/vit.py``) subclass
``SSGHeads``: a backbone builds its modules, calls ``_add_heads`` with its
width and returns ``_heads(fmap)`` (or ``_project(parts)``, where it pools
its own way) from ``forward``. Module names (``feat_whole``,
``feat_bn_whole``, ``classifier_whole``) are the JAX package's, so
``models/convert.py`` maps the JAX variables one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from ssg_tpu_torch.models.layers import BatchNorm1d

PART_NAMES = ("whole", "up", "down")


class SSGHeads(nn.Module):
    """The SSG multi-part heads that every backbone ends in (``SSGResNet``,
    ``models.inception.SSGInception``, ``models.vit.SSGViT``), and their
    random initialisation.

    ``_heads(fmap)`` pools the (B, C, h, w) feature map three ways
    (``_pool``: whole map, upper half, lower half) and projects each part
    (``_project``, which a backbone that pools its own way calls with its
    (B, C) parts, as ``models.vit.SSGViT`` does). The result is a dict:
    ``"embeddings"`` (num_parts, B, F), raw in train mode (the triplet
    loss's input) and L2-normalised in eval mode when ``norm`` is set; and
    ``"logits"`` (num_parts, B, num_classes) when ``num_classes > 0``. ``F``
    (``embedding_dim``) is ``num_features`` or, when that is 0, the
    backbone's channel count. Dropout (``dropout > 0``, train mode) applies
    after each part's BatchNorm and feeds only the classifier; the
    embedding is taken before it. The heads run in fp32 (in fp64 for an
    fp64 model, which serves as an exact reference).
    """

    def _add_heads(self, width: int, num_features: int, dropout: float, num_classes: int,
                   num_parts: int, norm: bool, dtype: torch.dtype) -> None:
        self.num_parts = num_parts
        self.norm = norm
        self.dtype = dtype
        self.num_features = num_features
        self.num_classes = num_classes
        self.embedding_dim = num_features or width
        self.drop = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        for part in PART_NAMES[:num_parts]:
            if num_features > 0:
                self.add_module(f"feat_{part}", nn.Linear(width, num_features))
            self.add_module(f"feat_bn_{part}", BatchNorm1d(self.embedding_dim, eps=1e-5))
            if num_classes > 0:
                self.add_module(f"classifier_{part}", nn.Linear(self.embedding_dim, num_classes))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
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

    def _heads(self, fmap: torch.Tensor) -> dict[str, torch.Tensor]:
        return self._project(self._pool(fmap))

    def _pool(self, fmap: torch.Tensor) -> list[torch.Tensor]:
        """The (B, C, h, w) map's parts, each (B, C): whole, upper, lower."""
        h = fmap.shape[2]
        # max(h // 2, 1): a height-1 map would leave the upper slice empty.
        return [
            fmap.mean((2, 3)),
            fmap[:, :, :max(h // 2, 1)].mean((2, 3)),
            fmap[:, :, h // 2:].mean((2, 3)),
        ][:self.num_parts]

    def _project(self, pools: list[torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each part's (B, C) pooled features through its heads."""
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
