"""SSG++ semi-supervised adaptation: the reference's [semitraining.py]
entry point (SURVEY.md §2 #2). SSG plus a one-shot labelled target subset
(one labelled image per identity) that affiliates clusters with
identities and adds a supervised cross-entropy term.

The port's counterpart of the root ``semitraining.py``: the port's
``selftraining`` flags plus ``--ce_weight`` and ``--one_shot_seed``.
Example:

  python -m ssg_tpu_torch.cli.semitraining --tgt_dataset dukemtmc \\
      --scale 0.2 --iteration 1 --epochs 1 \\
      --resume logs/pretrain/source_checkpoint.pth

A resumed checkpoint keeps the model's fresh classifier heads, sized to the
target identities, where its own are missing or sized to another count
(a source-pretrained checkpoint's).
"""

from __future__ import annotations

import sys

from ssg_tpu_torch._device import resolve_device
from ssg_tpu_torch.cli._common import (checkpoint_state, dataset, logged_stdout, new_model,
                                       refuse_unported)
from ssg_tpu_torch.cli.selftraining import build_parser as selftraining_parser
from ssg_tpu_torch.cli.selftraining import run
from ssg_tpu_torch.train.semi import one_shot_subset
from ssg_tpu_torch.utils.serialization import copy_state_dict


def build_parser():
    p = selftraining_parser()
    p.description = "SSG++: Self-Similarity Grouping with one-shot labels"
    p.add_argument("--ce_weight", type=float, default=0.5,
                   help="weight of the one-shot supervised CE term")
    p.add_argument("--one_shot_seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    dev = resolve_device(args.device)
    with logged_stdout(args.logs_dir, argv) as logger:
        tgt = dataset(args, args.tgt_dataset)
        one_shot = one_shot_subset(tgt.train, seed=args.one_shot_seed)
        # CE class indices must be dense 0..K-1; benchmark pids are sparse.
        dense = {p: i for i, p in enumerate(sorted({pid for _, pid, _ in tgt.train}))}
        one_shot = {idx: dense[pid] for idx, pid in one_shot.items()}
        print(f"target {args.tgt_dataset}: train={len(tgt.train)} one-shot={len(one_shot)} "
              f"ids={len(dense)}")
        model = new_model(args, num_classes=len(dense), last_stride=args.last_stride)
        if args.resume:
            model.load_state_dict(copy_state_dict(checkpoint_state(args.resume),
                                                  model.state_dict()))
        return run(args, model, tgt, dev, logger, one_shot=one_shot, ce_weight=args.ce_weight)


if __name__ == "__main__":
    raise SystemExit(main())
