"""Dataset preparation: a raw benchmark distribution -> the open-reid layout
that ``--data_dir`` reads.

The port's counterpart of the root ``prepare.py``, with its flags:

  python -m ssg_tpu_torch.cli.prepare --dataset market1501 \\
      --raw_dir /data/raw/Market-1501 --out_dir /data/market1501
  python -m ssg_tpu_torch.cli.selftraining --tgt_dataset market1501 \\
      --data_dir /data ...
"""

from __future__ import annotations

import argparse

from ssg_tpu_torch.data.prepare import prepare


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Prepare a raw re-ID benchmark")
    p.add_argument("--dataset", type=str, required=True,
                   help="market1501 | dukemtmc | msmt17")
    p.add_argument("--raw_dir", type=str, required=True,
                   help="unpacked raw distribution directory")
    p.add_argument("--out_dir", type=str, required=True,
                   help="output root (becomes --data_dir/<dataset>)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    splits = prepare(args.dataset, args.raw_dir, args.out_dir)
    print(f"{args.dataset}: train={len(splits['train'])} query={len(splits['query'])} "
          f"gallery={len(splits['gallery'])} -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
