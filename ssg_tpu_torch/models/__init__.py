"""Model factory (counterpart of ``ssg_tpu.models``). ``inception`` is not
ported yet (ROADMAP A10)."""

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

_FACTORY = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
}


def names() -> list[str]:
    return sorted(_FACTORY)


def create(name: str, **kwargs) -> SSGResNet:
    """``create('resnet50', num_features=0, num_parts=3, dtype=torch.bfloat16)``."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name!r}; known: {names()}")
    return _FACTORY[name](**kwargs)


__all__ = ["BasicBlock", "Bottleneck", "SSGResNet", "create", "names", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
