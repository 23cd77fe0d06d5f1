"""The attention work of the SSG ViT and the rule that finds its kernels in
a device trace.

Operations: attention's two products, QK^T and PV, are 2 T^2 d
multiply-adds a head, so 4 B h T^2 d operations a layer forward over B
images; the backward computes five such products (FlashAttention-2's
count: QK^T and PV again, dV, dP and dQ, dK), 2.5 times the forward's. The
softmax, its backward and the scaling are not counted. A train step is the
forward and the backward: 3.5 times the forward's count.

Bytes, each input read once and each output written once, in the
configuration's ``dtype``: the forward reads Q, K and V and writes the
output, the backward reads Q, K, V, the output and its gradient and writes
dQ, dK and dV, each B T D elements; the softmax's log-sum-exp (B h T, fp32)
is written by the one and read by the other. The least time of each pass
is the larger of its operations over the bf16 peak and its bytes over the
card's bandwidth (at T = 211 and d = 64 the bytes bound both).

The rule: a device event is attention's when its name holds ``flash``,
``fmha``, ``attention`` or ``sdpa`` in any case (FlashAttention's
``flash_fwd_kernel`` and ``flash_bwd_*`` kernels, cuDNN's and the
memory-efficient route's ``fmha`` kernels, a kernel of the repository's
own named for attention).
"""

from __future__ import annotations

from benchmark.frozen.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S

ATTENTION_NAMES = ("flash", "fmha", "attention", "sdpa")
BACKWARD_FACTOR = 2.5


def _tokens(config: dict) -> int:
    k, s = config["patch_size"], config["patch_stride"]
    return 1 + ((config["height"] - k) // s + 1) * ((config["width"] - k) // s + 1)


def attention_flops(config: dict, batch: int) -> float:
    """Forward operations of attention's two products over ``batch`` images,
    every layer."""
    t = _tokens(config)
    return 4.0 * batch * config["num_hidden_layers"] * t * t * config["hidden_size"]


def train_step_bound_s(config: dict, batch: int) -> float:
    """Least seconds attention's forward and backward of one train step
    could take on the card, every layer (the module docstring)."""
    t, c, layers = _tokens(config), config["hidden_size"], config["num_hidden_layers"]
    size = {"bfloat16": 2, "float16": 2, "float32": 4}[config["dtype"]]
    ops = attention_flops(config, batch) / layers
    lse = 4.0 * batch * config["num_attention_heads"] * t
    fwd_bytes = 4 * batch * t * c * size + lse
    bwd_bytes = 8 * batch * t * c * size + lse
    fwd = max(ops / BF16_FLOP_PER_S, fwd_bytes / HBM_BYTES_PER_S)
    bwd = max(BACKWARD_FACTOR * ops / BF16_FLOP_PER_S, bwd_bytes / HBM_BYTES_PER_S)
    return layers * (fwd + bwd)


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(word in low for word in ATTENTION_NAMES)


def attention_seconds(by_name: dict) -> float:
    """Seconds of the trace's device events that the rule classes as attention."""
    return sum(v for k, v in by_name.items() if is_attention(k))
