"""Model factory (counterpart of ``ssg_tpu.models``)."""

from ssg_tpu_torch.models.resnet import SSGResNet, resnet50

_FACTORY = {"resnet50": resnet50}


def names() -> list[str]:
    return sorted(_FACTORY)


def create(name: str, **kwargs) -> SSGResNet:
    """``create('resnet50', num_features=0, num_parts=3, dtype=torch.bfloat16)``."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name!r}; known: {names()}")
    return _FACTORY[name](**kwargs)


__all__ = ["SSGResNet", "create", "names", "resnet50"]
