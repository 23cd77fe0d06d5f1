#!/usr/bin/env python3
"""Time the port's bf16 extract in two or more checkouts of it, in turns.

Each tree's ``ssg_tpu_torch`` runs in its own process (the packages share a
name), on config-1's shapes without rendering: N = 3368 random uint8
256x128 images made on the card from seed 0, in 27 batches of 128 (the
last one padded), through ``api.extract_features`` of the bf16 SSG
ResNet-50 with random weights from seed 0. A process warms up with one
extract, then times ``--reps`` extracts on the host clock, each ending in a
device synchronise, and prints its median. The trees run in turns (A, B,
B, A for two) ``--rounds`` times, since host times spread between calls.

    python3 scripts/torch_extract_ab.py --tree . --tree .archive/parent

where ``.archive/parent`` holds another version of ``ssg_tpu_torch/`` (for
example ``git archive <rev> ssg_tpu_torch | tar -x -C .archive/parent``,
made before the call: the chip machine's copy has no ``.git``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, BATCH = 3368, 128


def child(tree: str, reps: int) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from ssg_tpu_torch import api, models, resolve_device

    dev = resolve_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = []
    for start in range(0, N, BATCH):
        real = min(BATCH, N - start)
        images = torch.randint(0, 256, (BATCH, 256, 128, 3), generator=gen, device=dev,
                               dtype=torch.uint8)
        mask = [i < real for i in range(BATCH)]
        batches.append((images, [0] * BATCH, [0] * BATCH, mask))
    model = models.create("resnet50", num_features=0, num_parts=3, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.eval().to(dev, memory_format=torch.channels_last)
    api.extract_features(model, batches)  # warm-up: cuDNN plans, cached casts
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.extract_features(model, batches)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({"tree": tree, "extract_seconds": times,
                      "median": statistics.median(times)}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", help="a directory holding ssg_tpu_torch/")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps)
        return 0
    trees = args.tree or ["."]
    runs = {t: [] for t in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            res = subprocess.run([sys.executable, __file__, "--child", tree, "--reps",
                                  str(args.reps)], capture_output=True, text=True, check=True,
                                 timeout=600)
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps(line))
            runs[tree].append(line["median"])
    print(json.dumps({"extract_ab": {t: {"process_medians": v, "median": statistics.median(v)}
                                     for t, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
