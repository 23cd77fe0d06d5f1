"""Checkpoint/resume helpers.

Counterpart of ``ssg_tpu/utils/serialization.py``, mirroring the
reference's [reid/utils/serialization.py] surface (SURVEY.md §2 #13, §5
checkpoint row): ``save_checkpoint(state, is_best, fpath)`` writes one
checkpoint file plus a ``model_best.pth`` copy beside it, and
``load_checkpoint`` reads it back; ``read_json`` / ``write_json`` keep
the prepared datasets' ``splits.json`` and ``meta.json``. Where the JAX package stores Orbax
directories, the port stores ``torch.save`` files of plain state: the
loop's checkpoint is ``{"model": state_dict, "optimizer": state_dict,
"iteration": int}``. ``load_checkpoint`` unpickles only tensors and plain
containers (``weights_only``).
"""

from __future__ import annotations

import json
import os
import shutil

import torch


def mkdir_if_missing(path: str):
    os.makedirs(path, exist_ok=True)


def read_json(fpath: str):
    with open(fpath) as f:
        return json.load(f)


def write_json(obj, fpath: str):
    mkdir_if_missing(os.path.dirname(fpath) or ".")
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=2)


def save_checkpoint(state: dict, is_best: bool, fpath: str = "checkpoint.pth"):
    """Save ``state`` to ``fpath``; keep a ``model_best.pth`` copy beside it
    when ``is_best``. The file is written under a temporary name and
    renamed, so an interrupted save leaves the previous checkpoint whole."""
    fpath = os.path.abspath(fpath)
    mkdir_if_missing(os.path.dirname(fpath))
    tmp = f"{fpath}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, fpath)
    if is_best:
        shutil.copyfile(fpath, os.path.join(os.path.dirname(fpath), "model_best.pth"))


def load_checkpoint(fpath: str, device=None) -> dict:
    """Read a checkpoint written by ``save_checkpoint``, its tensors placed
    on ``device`` (where they were saved when None)."""
    fpath = os.path.abspath(fpath)
    if not os.path.isfile(fpath):
        raise FileNotFoundError(fpath)
    return torch.load(fpath, map_location=device, weights_only=True)


def copy_state_dict(src: dict, dst: dict, strip: str = "") -> dict:
    """Copy the entries of ``src`` over ``dst`` whose key and shape match
    (the reference's ``copy_state_dict``: a partial restore that skips keys
    the target lacks and shape-mismatched heads, e.g. classifiers sized to
    another identity count). ``strip`` removes a prefix from source keys
    first (``"module."``). Returns a new dict; raises ``KeyError`` when
    nothing matched."""
    out = dict(dst)
    copied = 0
    for key, value in src.items():
        k = key[len(strip):] if strip and key.startswith(strip) else key
        if k not in out or tuple(out[k].shape) != tuple(value.shape):
            continue
        out[k] = value
        copied += 1
    if copied == 0:
        raise KeyError("copy_state_dict matched no entries")
    return out
