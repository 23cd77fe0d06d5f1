"""SSG self-training: the reference's [selftraining.py] entry point
(SURVEY.md §3.1).

The port's counterpart of the root ``selftraining.py``, with its flags and
defaults plus ``--device``. Example (synthetic data):

  python -m ssg_tpu_torch.cli.selftraining --src_dataset market1501 \\
      --tgt_dataset dukemtmc --scale 0.2 --iteration 2 --epochs 2 \\
      --resume logs/pretrain/source_checkpoint.pth

``--resume`` takes a port checkpoint (``source_checkpoint.pth``,
``checkpoint.pth``) or a reference / torchvision ``.pth`` / ``.tar`` file;
``--resume_loop`` continues an interrupted run from its
``logs_dir/checkpoint.pth``. ``--data_dir`` reads ``<data_dir>/<tgt_dataset>``
as ``cli.prepare`` writes it.

``--data_parallel`` runs the loop over the ranks of the process group
(``parallel.make_mesh``): launch one process a card with ``torchrun
--nproc_per_node=P -m ssg_tpu_torch.cli.selftraining --data_parallel ...``;
without a group it is a mesh of one. ``--multihost`` joins the group
explicitly first, from ``--dist_coordinator host:port
--dist_num_processes P --dist_process_id i`` (one command a rank), or from
torchrun's environment without them. NCCL takes one rank a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ssg_tpu_torch import api
from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cli._common import (checkpoint_state, dataset, logged_stdout,
                                       maybe_init_multihost, new_model)
from ssg_tpu_torch.train.ssg_loop import SSGConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Self-Similarity Grouping on the GPU")
    p.add_argument("--src_dataset", type=str, default="market1501")
    p.add_argument("--tgt_dataset", type=str, default="dukemtmc")
    p.add_argument("--data_dir", type=str, default=None,
                   help="root with <dataset>/images; synthetic if absent")
    p.add_argument("--scale", type=str, default="small",
                   help="synthetic dataset scale: tiny|small|full|<fraction>")
    p.add_argument("--logs_dir", type=str, default="logs/ssg")
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--num_features", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--last_stride", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_instances", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--lr", type=float, default=6e-5)
    p.add_argument("--lr_schedule", type=str, default="constant", choices=["constant", "step"],
                   help="epoch-indexed lr schedule within each iteration")
    p.add_argument("--lr_step_size", type=int, default=40,
                   help="StepLR period in epochs (lr_schedule=step)")
    p.add_argument("--lr_gamma", type=float, default=0.1)
    p.add_argument("--warmup_epochs", type=int, default=0,
                   help="linear lr warmup epochs (0 disables)")
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--margin", type=float, default=0.3)
    p.add_argument("--epochs", type=int, default=70)
    p.add_argument("--iteration", type=int, default=30)
    p.add_argument("--k1", type=int, default=20)
    p.add_argument("--k2", type=int, default=6)
    p.add_argument("--lambda_value", type=float, default=0.1)
    p.add_argument("--rho", type=float, default=1.6e-3)
    p.add_argument("--rho_growth", type=float, default=0.0,
                   help="per-iteration eps-quantile growth: rho_it = rho*(1+g)^it "
                        "(0 = the reference's fixed rho)")
    p.add_argument("--min_samples", type=int, default=4)
    p.add_argument("--num_parts", type=int, default=3)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint: the port's .pth, or a reference/torchvision .pth(.tar)")
    p.add_argument("--resume_loop", type=str, default="",
                   help="loop checkpoint (logs_dir/checkpoint.pth: model, optimizer, "
                        "iteration) to continue an interrupted SSG run")
    p.add_argument("--evaluate", action="store_true",
                   help="eval only (reference --evaluate short-circuit)")
    p.add_argument("--rerank", action="store_true",
                   help="k-reciprocal re-ranking at test time")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--data_parallel", action="store_true",
                   help="over the ranks of the process group (torchrun or --multihost): "
                        "sharded extraction, streaming clustering over the ranks, "
                        "data-parallel fine-tuning")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group before touching the card, from --dist_* "
                        "or torchrun's environment")
    p.add_argument("--dist_coordinator", type=str, default=None,
                   help="host:port of rank 0's store for explicit clusters")
    p.add_argument("--dist_num_processes", type=int, default=None)
    p.add_argument("--dist_process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels), or cpu (their plain versions)")
    return p


def load_model(args):
    """The model of the flags, with the ``--resume`` checkpoint's weights
    (entries the model lacks, such as source classifier heads, are left
    out; every entry it has must be there)."""
    model = new_model(args, last_stride=args.last_stride)
    if args.resume:
        missing, _ = model.load_state_dict(checkpoint_state(args.resume), strict=False)
        if missing:
            raise KeyError(f"{args.resume} lacks {len(missing)} of the model's entries, "
                           f"e.g. {missing[:3]}")
    return model


def ssg_config(args) -> SSGConfig:
    return SSGConfig(
        iterations=args.iteration, epochs=args.epochs, batch_size=args.batch_size,
        num_instances=args.num_instances, k1=args.k1, k2=args.k2,
        lambda_value=args.lambda_value, rho=args.rho, rho_growth=args.rho_growth,
        min_samples=args.min_samples, margin=args.margin, lr=args.lr,
        lr_schedule=args.lr_schedule, lr_step_size=args.lr_step_size, lr_gamma=args.lr_gamma,
        warmup_epochs=args.warmup_epochs, weight_decay=args.weight_decay,
        num_parts=args.num_parts, height=args.height, width=args.width,
        print_freq=args.print_freq, seed=args.seed, eval_rerank=args.rerank,
        logs_dir=args.logs_dir, data_parallel=args.data_parallel)


def run(args, model, tgt, dev, logger, **ssg_kwargs) -> int:
    """``--evaluate``, or the SSG loop; shared with ``semitraining``."""
    if args.evaluate:
        model.to(dev, memory_format=torch.channels_last)
        api.Evaluator(model, batch_size=args.batch_size, device=dev).evaluate(
            tgt, rerank=args.rerank, logger=logger)
        return 0
    _, history = api.train(model, tgt, ssg_config(args), logger=logger,
                           resume_from=args.resume_loop or None, device=dev, **ssg_kwargs)
    for entry in history:
        logger.metric(kind="iteration", **entry)
    if history and "mAP" in history[-1]:
        print(f"final mAP {history[-1]['mAP']:.1%}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    maybe_init_multihost(args)
    dev = resolve_device(args.device)
    with logged_stdout(args.logs_dir, argv) as logger:
        print(f"device: {dev}")
        tgt = dataset(args, args.tgt_dataset)
        print(f"target {args.tgt_dataset}: train={len(tgt.train)} query={len(tgt.query)} "
              f"gallery={len(tgt.gallery)}")
        return run(args, load_model(args), tgt, dev, logger)


if __name__ == "__main__":
    raise SystemExit(main())
