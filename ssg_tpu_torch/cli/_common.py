"""What the three entry points share: the stdout log, the flags that are
not ported yet, the dataset, the model and its weights."""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from ssg_tpu_torch import models
from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.models.convert import torch_state_dict
from ssg_tpu_torch.utils.logging import Logger
from ssg_tpu_torch.utils.serialization import load_checkpoint


@contextlib.contextmanager
def logged_stdout(logs_dir: str, argv: list[str]):
    """Tee stdout to ``logs_dir/log.txt`` (metrics to ``log.txt.jsonl``) as
    the reference's scripts do, for the ``with`` block; stdout is restored
    and the log closed on the way out, so in-process callers keep theirs."""
    os.makedirs(logs_dir, exist_ok=True)
    logger = Logger(os.path.join(logs_dir, "log.txt"))
    console = sys.stdout
    sys.stdout = logger
    try:
        print(" ".join(sys.argv[:1] + argv))
        yield logger
    finally:
        sys.stdout = console
        logger.close()


def refuse_unported(args) -> None:
    """Raise for a flag whose path the port does not have yet."""
    if getattr(args, "data_parallel", False) or getattr(args, "multihost", False) or any(
            getattr(args, f"dist_{k}", None) is not None
            for k in ("coordinator", "num_processes", "process_id")):
        raise NotImplementedError("--data_parallel, --multihost and --dist_*: multi-GPU "
                                  "training is not ported yet (ROADMAP A9)")


def dataset(args, name: str):
    """``name`` from ``args.data_dir/<name>`` when that holds a prepared
    tree (``cli.prepare``), else its synthetic stand-in at ``args.scale``."""
    root = os.path.join(args.data_dir, name) if args.data_dir else None
    return datasets.create(name, root=root, scale=args.scale, seed=args.seed)


def new_model(args, **kwargs):
    """``args.arch`` with the flags' widths, random weights from ``args.seed``."""
    model = models.create(args.arch, num_features=args.num_features, dropout=args.dropout,
                          num_parts=args.num_parts,
                          dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
                          **kwargs)
    return model.reset_parameters(torch.Generator().manual_seed(args.seed))


def checkpoint_state(path: str) -> dict[str, torch.Tensor]:
    """The model weights of a checkpoint: a port checkpoint (a dict with
    ``"model"``) as it is, a reference or torchvision file through
    ``models.convert.torch_state_dict``. The file is read once."""
    blob = load_checkpoint(path, device="cpu")
    return blob["model"] if "model" in blob else torch_state_dict(blob)
