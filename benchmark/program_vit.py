"""The system under test for the ViT cells: the program's (``ssg_tpu_torch``)
SSG ViT holding the benchmark's weights."""

from __future__ import annotations

import torch

from ssg_tpu_torch.models.vit import SSGViT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(config: dict, state: dict, device) -> SSGViT:
    """The configuration's model on ``device`` (channels-last on the card, as
    the port's loop moves every model), loaded with ``state``; only
    BatchNorm's step counters may be absent."""
    model = SSGViT(img_size=(config["height"], config["width"]),
                   patch_size=config["patch_size"], stride=config["patch_stride"],
                   embed_dim=config["hidden_size"], depth=config["num_hidden_layers"],
                   num_heads=config["num_attention_heads"], mlp_dim=config["intermediate_size"],
                   eps=config["layer_norm_eps"], num_features=config.get("num_features", 0),
                   num_parts=config["num_parts"], dtype=DTYPES[config["dtype"]])
    missing, unexpected = model.load_state_dict(state, strict=False)
    stray = [k for k in missing if not k.endswith("num_batches_tracked")]
    if stray or unexpected:
        raise KeyError(f"state does not fit the model: missing {stray}, unexpected {unexpected}")
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model
