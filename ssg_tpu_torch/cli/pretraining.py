"""Supervised source pretraining: produces the source-trained checkpoint
that self-training resumes from (SURVEY.md §0 step 1).

The port's counterpart of the root ``pretraining.py``, with its flags and
defaults plus ``--device``. Example (synthetic data):

  python -m ssg_tpu_torch.cli.pretraining --dataset market1501 --scale 0.1 \\
      --epochs 2 --logs_dir logs/pretrain
  python -m ssg_tpu_torch.cli.selftraining \\
      --resume logs/pretrain/source_checkpoint.pth ...

``--device cpu`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

from ssg_tpu_torch import api
from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cli._common import dataset, logged_stdout, new_model, refuse_unported
from ssg_tpu_torch.data import datasets
from ssg_tpu_torch.train.pretrain import PretrainConfig, run_pretrain


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Supervised source pretraining")
    p.add_argument("--dataset", type=str, default="market1501")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--scale", type=str, default="small")
    p.add_argument("--logs_dir", type=str, default="logs/pretrain")
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--num_features", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_instances", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--lr", type=float, default=3.5e-4)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--margin", type=float, default=0.3)
    p.add_argument("--ce_weight", type=float, default=1.0)
    p.add_argument("--loss", type=str, default="softmax", choices=["softmax", "oim"],
                   help="identity loss: per-branch softmax CE (classifier heads) or OIM "
                        "on the whole-body embedding (loss/oim.py)")
    p.add_argument("--oim_temperature", type=float, default=0.1)
    p.add_argument("--oim_momentum", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=70)
    p.add_argument("--num_parts", type=int, default=3)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--evaluate_on", type=str, default="",
                   help="optional dataset to evaluate on after training")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels), or cpu (their plain versions)")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)
    with logged_stdout(args.logs_dir, argv) as logger:
        src = dataset(args, args.dataset)
        num_ids = len({p for _, p, _ in src.train})
        print(f"source {args.dataset}: train={len(src.train)} ids={num_ids}")
        # OIM replaces the softmax classifier: no logits heads.
        model = new_model(args, num_classes=num_ids if args.loss == "softmax" else 0)
        cfg = PretrainConfig(
            epochs=args.epochs, batch_size=args.batch_size, num_instances=args.num_instances,
            margin=args.margin, ce_weight=args.ce_weight, lr=args.lr,
            weight_decay=args.weight_decay, num_parts=args.num_parts, height=args.height,
            width=args.width, print_freq=args.print_freq, seed=args.seed,
            logs_dir=args.logs_dir, loss=args.loss, oim_temperature=args.oim_temperature,
            oim_momentum=args.oim_momentum)
        t0 = time.time()
        run_pretrain(model, src, cfg, logger=logger, device=dev)
        train_s = time.time() - t0
        print(f"saved {args.logs_dir}/source_checkpoint.pth")
        eval_s = 0.0
        if args.evaluate_on:
            t0 = time.time()
            tgt = datasets.create(args.evaluate_on, scale=args.scale, seed=args.seed)
            api.Evaluator(model, batch_size=args.batch_size, device=dev).evaluate(
                tgt, logger=logger)
            eval_s = time.time() - t0
        logger.metric(kind="seconds", train=train_s, eval=eval_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
