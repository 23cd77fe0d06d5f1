"""A whole ResNet bottleneck stage, BatchNorm folded: the strided/downsample
first block, then the identity blocks.

Counterpart of ``ssg_tpu/ops/bottleneck_stage.py``, which runs a stage as
one Pallas span with every activation in VMEM. On Hopper a stage is not one
kernel: one image's layer1 activation (64 x 32 x 256 bf16, 1 MiB) is far over
the 227 KB of shared memory a block can use, so nothing can keep a whole
stage on chip. The stage is one launch of ``csrc/bottleneck.cu``'s
downsample instance followed by one identity launch per further block; the
block outputs pass through device memory (a layer3 activation at batch 128
is 33.5 MB, inside the 50 MB L2). ``stage_ref`` is the plain version.
"""

from __future__ import annotations

import torch

from ssg_tpu_torch.ops.bottleneck import block_ref, launch_block

# Kernel launches made by fused_bottleneck_stage, one per block.
launches = 0


def stage_ref(x, blocks, stride: int):
    """Plain version, block by block (mirrors ``ssg_tpu.ops.bottleneck_stage.stage_ref``)."""
    for i, blk in enumerate(blocks):
        x = block_ref(x, *blk, stride=stride if i == 0 and len(blk) == 8 else 1)
    return x


def fused_bottleneck_stage(x: torch.Tensor, blocks, stride: int = 1) -> torch.Tensor:
    """Run a bottleneck stage on NHWC ``x``.

    blocks: weight tuples, ``(w1, b1, w2, b2, w3, b3, wd, bd)`` for a
    downsample block (first only) and ``(w1, b1, w2, b2, w3, b3)`` for an
    identity block, BN folded; w1/w3/wd as ``(Cin, Cout)``, w2 as
    ``(3, 3, Cm, Cm)``. ``stride`` applies to a downsample first block.
    CUDA tensors (bf16 or fp32) run ``launch_block`` once per block; CPU
    tensors take the plain version.
    """
    global launches
    if x.device.type == "cpu":
        return stage_ref(x, blocks, stride)
    for i, blk in enumerate(blocks):
        if len(blk) == 8:
            if i:
                raise ValueError("fused_bottleneck_stage: a downsample block must come first")
            x = launch_block(x, *blk, stride=stride)
        else:
            x = launch_block(x, *blk)
        launches += 1
    return x
