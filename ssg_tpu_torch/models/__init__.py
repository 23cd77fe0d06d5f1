"""Model factory (counterpart of ``ssg_tpu.models``): the SSG ResNets, the
SSG Inception and the SSG ViT-B/16 at patch stride 12 (the port's own; the
JAX package has no transformer), each ending in the same multi-part heads
(``SSGHeads``)."""

from ssg_tpu_torch.models.heads import SSGHeads
from ssg_tpu_torch.models.inception import SSGInception, inception
from ssg_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    SSGResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from ssg_tpu_torch.models.vit import SSGViT, vit_base_patch16_s12

_FACTORY = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "inception": inception,
    "vit_base_patch16_s12": vit_base_patch16_s12,
}


def names() -> list[str]:
    return sorted(_FACTORY)


def create(name: str, **kwargs) -> SSGHeads:
    """``create('resnet50', num_features=0, num_parts=3, dtype=torch.bfloat16)``."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name!r}; known: {names()}")
    return _FACTORY[name](**kwargs)


__all__ = ["BasicBlock", "Bottleneck", "SSGHeads", "SSGInception", "SSGResNet", "SSGViT",
           "create", "inception", "names", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "vit_base_patch16_s12"]
