"""JAX (Flax) variables -> the port's ``state_dict``.

The port's own copy of the mapping in ``ssg_tpu/models/convert.py``
(``flax_to_torch``): it turns the JAX package's ``{'params', 'batch_stats'}``
numpy tree of an ``SSGResNet`` into tensors that
``ssg_tpu_torch.models.resnet.SSGResNet.load_state_dict`` takes:

  conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw)
  dense ``kernel`` (I, O)        -> ``weight`` (O, I)
  bn ``scale`` / ``bias``        -> ``weight`` / ``bias``
  bn ``mean`` / ``var``          -> ``running_mean`` / ``running_var``
  ``layer1_0``                   -> ``layer1.0``
  ``downsample_conv`` / ``_bn``  -> ``downsample.0`` / ``downsample.1``
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _torch_key(prefix: str, leaf: str) -> str:
    key = f"{prefix}.{leaf}" if prefix else leaf
    key = key.replace("downsample_conv", "downsample.0")
    key = key.replace("downsample_bn", "downsample.1")
    return re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", key)


def from_jax_variables(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Convert Flax ``{'params': ..., 'batch_stats': ...}`` to a state_dict."""
    out: dict[str, torch.Tensor] = {}

    def emit(prefix: str, leaf: str, arr: np.ndarray):
        out[_torch_key(prefix, leaf)] = torch.from_numpy(np.array(arr))

    def walk(node: Mapping[str, Any], prefix: str):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}.{name}" if prefix else name)
                continue
            arr = np.asarray(value)
            if name == "kernel":
                emit(prefix, "weight", arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
            elif name == "scale":
                emit(prefix, "weight", arr)
            elif name == "bias":
                emit(prefix, "bias", arr)
            elif name == "mean":
                emit(prefix, "running_mean", arr)
                # PyTorch BN keeps a step counter that Flax has no use for.
                emit(prefix, "num_batches_tracked", np.zeros((), np.int64))
            elif name == "var":
                emit(prefix, "running_var", arr)
            else:
                raise KeyError(f"Unhandled flax leaf: {prefix}.{name}")

    walk(variables.get("params", {}), "")
    walk(variables.get("batch_stats", {}), "")
    return out
