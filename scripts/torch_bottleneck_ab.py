#!/usr/bin/env python3
"""The bottleneck kernel against another version of its source, in turns on
one CUDA card.

Run from the repository root on a machine with a card and ``nvcc``:

    git show <rev>:ssg_tpu_torch/csrc/bottleneck.cu > .archive/bottleneck_old.cu
    python3 scripts/torch_bottleneck_ab.py --baseline .archive/bottleneck_old.cu

It builds ``ssg_tpu_torch/csrc/bottleneck.cu`` and the baseline (same C
interface) with the port's ``nvcc`` flags (``ops._build``), checks both
against the plain version, and times one identity block at each ResNet-50
path shape (batch 128, 256x128 input; random bf16 activations and folded
weights from seed 0) in turns: current, baseline, baseline, current, for
``--rounds`` rounds. Per layer it prints the median device ms of each; then
the 12 identity blocks of a batch (2, 3, 5 and 2 in layers 1-4) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ssg_tpu_torch.ops import _build, bottleneck  # noqa: E402
from ssg_tpu_torch.ops.bottleneck import bf16_ulp_error, bottleneck_ref  # noqa: E402

# (name, H, W, C, Cm, identity blocks a batch) at batch 128.
LAYERS = (("layer1", 64, 32, 256, 64, 2), ("layer2", 32, 16, 512, 128, 3),
          ("layer3", 16, 8, 1024, 256, 5), ("layer4", 8, 4, 2048, 512, 2))
BATCH = 128
BF16_ULPS = 4  # kernel against the plain version, as in chip_smoke.py


def block(gen: np.random.Generator, c: int, cm: int, dev):
    shapes = [(c, cm), (cm,), (3, 3, cm, cm), (cm,), (cm, c), (c,)]
    out = []
    for shape in shapes:
        a = gen.normal(size=shape).astype(np.float32)
        if len(shape) > 1:
            out.append(torch.from_numpy(a * np.prod(shape[:-1]) ** -0.5).to(dev, torch.bfloat16))
        else:
            out.append(torch.from_numpy(a * 0.1).to(dev))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True, help="another bottleneck.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20, help="launches a timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bottleneck_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _build.build(["bottleneck", args.baseline.resolve()])  # one nvcc each, together
    libs = {"current": bottleneck.bind(_build.load("bottleneck")),
            "baseline": bottleneck.bind(_build.load(args.baseline.resolve()))}
    stream = torch.cuda.current_stream().cuda_stream
    gen = np.random.default_rng(0)
    totals = dict.fromkeys(libs, 0.0)
    for name, h, w, c, cm, count in LAYERS:
        x = torch.from_numpy(np.abs(gen.normal(size=(BATCH, h, w, c))).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        ws = block(gen, c, cm, dev)
        ref = bottleneck_ref(x, *ws)
        out = torch.empty_like(x)

        def timed(lib):
            def go():
                err = lib.ssg_bottleneck(x.data_ptr(), *(t.data_ptr() for t in ws), None, None,
                                         out.data_ptr(), BATCH, h, w, c, cm, c, 1, stream)
                if err:
                    raise RuntimeError(f"ssg_bottleneck: CUDA error {err}")

            go()
            torch.cuda.synchronize()
            ulps = bf16_ulp_error(out, ref)
            if ulps > BF16_ULPS:
                raise RuntimeError(f"{name}: {ulps:.0f} ulps from the plain version")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                go()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / args.reps

        times = {k: [] for k in libs}
        for _ in range(args.rounds):
            for k in ("current", "baseline", "baseline", "current"):
                times[k].append(timed(libs[k]))
        med = {k: statistics.median(v) for k, v in times.items()}
        for k in totals:
            totals[k] += count * med[k]
        print(f"{name} identity block ({BATCH},{h},{w},{c})/Cm {cm}: " +
              ", ".join(f"{k} {v:.4f} ms" for k, v in med.items()) +
              f"; current / baseline {med['current'] / med['baseline']:.3f}")
    print("12 identity blocks a batch: " + ", ".join(f"{k} {v:.4f} ms" for k, v in totals.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
