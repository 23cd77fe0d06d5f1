"""Checkpoints of other layouts -> the port's ``state_dict``.

``load_torch_checkpoint`` reads a reference or torchvision ``.pth`` /
``.tar`` file (the port's own copy of ``ssg_tpu/models/convert.py``'s
reader, without the conversion to Flax); ``torch_state_dict`` converts a
file already loaded. ``from_jax_variables`` maps JAX
variables: the port's own copy of the mapping in
``ssg_tpu/models/convert.py`` (``flax_to_torch``), which turns the JAX
package's ``{'params', 'batch_stats'}`` numpy tree of an ``SSGResNet`` or
an ``SSGInception`` into tensors that the port's model of the same name
(``models.resnet.SSGResNet``, ``models.inception.SSGInception``) takes in
``load_state_dict``. ``to_jax_variables`` is its inverse (the JAX
package's ``torch_to_flax``), so a model trained here goes back to the JAX
package. The Inception's module names are Flax's, so only the leaves are
renamed:

  conv ``kernel`` (kh, kw, I, O) -> ``weight`` (O, I, kh, kw)
  dense ``kernel`` (I, O)        -> ``weight`` (O, I)
  bn ``scale`` / ``bias``        -> ``weight`` / ``bias``
  bn ``mean`` / ``var``          -> ``running_mean`` / ``running_var``
  ``layer1_0``                   -> ``layer1.0``
  ``downsample_conv`` / ``_bn``  -> ``downsample.0`` / ``downsample.1``
"""

from __future__ import annotations

import os
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
    """Convert Flax ``{'params': ..., 'batch_stats': ...}`` of an
    ``SSGResNet`` or ``SSGInception`` to a state_dict."""
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


def to_jax_variables(state_dict: Mapping[str, Any]) -> dict:
    """Convert a state_dict of an ``SSGResNet`` or ``SSGInception`` to Flax
    ``{'params': ..., 'batch_stats': ...}`` numpy trees, the inverse of
    ``from_jax_variables``. ``num_batches_tracked`` has no Flax leaf and is
    dropped."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: list[str], value: np.ndarray):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        # "layer1.0.conv2" -> "layer1_0/conv2"; "downsample.0" / ".1" ->
        # "downsample_conv" / "downsample_bn".
        key = re.sub(r"layer(\d+)\.(\d+)", r"layer\1_\2", key)
        key = key.replace("downsample.0", "downsample_conv").replace("downsample.1", "downsample_bn")
        *path, leaf = key.split(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight" and arr.ndim == 4:  # conv (O, I, kh, kw) -> (kh, kw, I, O)
            put(params, path + ["kernel"], arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:  # dense (O, I) -> (I, O)
            put(params, path + ["kernel"], arr.T)
        elif leaf == "weight":  # batch norm
            put(params, path + ["scale"], arr)
        elif leaf == "bias":
            put(params, path + ["bias"], arr)
        elif leaf == "running_mean":
            put(stats, path + ["mean"], arr)
        elif leaf == "running_var":
            put(stats, path + ["var"], arr)
        else:
            raise KeyError(f"Unhandled torch key: {key}")
    return {"params": params, "batch_stats": stats}


def torch_state_dict(blob: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A loaded reference checkpoint (``{"state_dict": ..., "epoch": ...}``,
    the reference's ``save_checkpoint`` format, SURVEY.md §2 #13) or bare
    state_dict, as a state_dict that ``SSGResNet`` loads.

    DataParallel's ``module.`` prefix is stripped. A plain torchvision
    ResNet (``conv1.weight``, no ``backbone.`` keys: the ImageNet start the
    reference trains from) gets the ``backbone.`` prefix and loses its
    ``fc.*`` classifier; such a file holds no SSG heads. Every BatchNorm
    gets a ``num_batches_tracked`` entry where the file has none, as the
    port's BatchNorm keeps one.
    """
    sd = blob.get("state_dict", blob)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if "conv1.weight" in sd and "backbone.conv1.weight" not in sd:
        sd = {f"backbone.{k}": v for k, v in sd.items() if not k.startswith("fc.")}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd.setdefault(key.removesuffix("running_mean") + "num_batches_tracked",
                      torch.zeros((), dtype=torch.int64))
    return sd


def load_torch_checkpoint(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read a reference or torchvision ``.pth`` / ``.tar`` file, unpickling
    tensors and plain containers only (``weights_only``), into a state_dict
    that ``SSGResNet`` loads (``torch_state_dict``)."""
    return torch_state_dict(torch.load(path, map_location="cpu", weights_only=True))
