"""The system under test, as the cells build it: an SSG ResNet of the
program (``ssg_tpu_torch``) holding the benchmark's weights."""

from __future__ import annotations

import torch

from ssg_tpu_torch.models.resnet import SSGResNet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(config: dict, state: dict, device) -> SSGResNet:
    """The configuration's model on ``device`` (channels-last on the card),
    loaded with ``state``; only BatchNorm's step counters may be absent."""
    model = SSGResNet(stage_sizes=tuple(config["stage_sizes"]),
                      num_features=config.get("num_features", 0), num_parts=config["num_parts"],
                      last_stride=config["last_stride"], dtype=DTYPES[config["dtype"]])
    missing, unexpected = model.load_state_dict(state, strict=False)
    stray = [k for k in missing if not k.endswith("num_batches_tracked")]
    if stray or unexpected:
        raise KeyError(f"state does not fit the model: missing {stray}, unexpected {unexpected}")
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model
