"""Model factory (counterpart of ``ssg_tpu.models``): the SSG ResNets and
the SSG Inception, each ending in the same multi-part heads (``SSGHeads``)."""

from ssg_tpu_torch.models.inception import SSGInception, inception
from ssg_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    SSGHeads,
    SSGResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)

_FACTORY = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "inception": inception,
}


def names() -> list[str]:
    return sorted(_FACTORY)


def create(name: str, **kwargs) -> SSGHeads:
    """``create('resnet50', num_features=0, num_parts=3, dtype=torch.bfloat16)``."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name!r}; known: {names()}")
    return _FACTORY[name](**kwargs)


__all__ = ["BasicBlock", "Bottleneck", "SSGHeads", "SSGInception", "SSGResNet", "create",
           "inception", "names", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]
