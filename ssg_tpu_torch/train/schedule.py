"""Optimizer and learning-rate schedule of the SSG fine-tune loop.

Counterpart of ``ssg_tpu/train/schedule.py``. The JAX package injects the
learning rate into optax's ``adamw`` state so the host can set it once per
epoch; here the learning rate lives in the optimizer's param groups, which
``set_learning_rate`` sets. ``lr_at`` is a copy of JAX's.

``make_optimizer`` is ``torch.optim.AdamW`` with optax ``adamw``'s defaults
(betas 0.9 / 0.999, eps 1e-8, eps inside the root's denominator): both apply
``p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps)`` to every parameter, BN
included (``tests/test_torch_train.py`` holds the two to each other).
It runs the multi-tensor (``foreach``) update: its in-place updates bump
each parameter's version, which the model's cached casts and BN folds key
on (the ``fused`` update does not).

On the card the optimizer is ``capturable``: its step counters live on the
device and the bias corrections are computed there, in fp32, so the update
can be captured into a CUDA graph and replayed with the right step count
(``train/trainer.py``). Eager and replayed steps then run the same update.
A replay writes the parameters without bumping their versions, so the
graphed step bumps them itself after each replay. On the CPU nothing
changes: the corrections are Python floats, as without the flag.
"""

from __future__ import annotations

import torch


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 5e-4) -> torch.optim.AdamW:
    """AdamW over ``params`` (tensors or param-group dicts) with the
    learning rate settable per epoch; ``capturable`` where every parameter
    is on the card."""
    params = list(params)
    tensors = [p for g in params for p in (g["params"] if isinstance(g, dict) else (g,))]
    capturable = bool(tensors) and all(p.is_cuda for p in tensors)
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, foreach=True, capturable=capturable)


def load_optimizer_state(optimizer: torch.optim.AdamW, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, keeping each group's
    ``capturable`` as ``make_optimizer`` chose it for these parameters (a
    checkpoint written on another device carries its own), with the step
    counters where that needs them: on the parameter's device when
    capturable, else on the host."""
    capturable = [g["capturable"] for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, cap in zip(optimizer.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(p.device if cap else "cpu")


def lr_at(
    epoch: int,
    base_lr: float,
    schedule: str = "constant",
    step_size: int = 40,
    gamma: float = 0.1,
    warmup_epochs: int = 0,
) -> float:
    """Epoch-indexed learning rate.

    - linear warmup over ``warmup_epochs`` (0 disables),
    - then ``constant`` or ``step`` (torch StepLR: x ``gamma`` every
      ``step_size`` epochs, counted from epoch 0).
    """
    if warmup_epochs > 0 and epoch < warmup_epochs:
        return base_lr * (epoch + 1) / warmup_epochs
    if schedule == "constant":
        return base_lr
    if schedule == "step":
        return base_lr * gamma ** (epoch // step_size)
    raise ValueError(f"unknown lr schedule {schedule!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group of ``optimizer``."""
    for group in optimizer.param_groups:
        group["lr"] = lr
