"""The layers and training modes that the port's backbones share.

``models/resnet.py``, ``models/inception.py`` and ``models/vit.py`` build on
these; the train step switches ``data_parallel`` around its forward and
backward.

* Every weight is an fp32 master, as Flax keeps its parameters:
  ``Conv2d`` (and the ViT's linears, through ``cast_masters``) casts it to
  the activation type at each call, so the optimizer updates fp32 values.
  BatchNorm normalises a narrower activation in fp32 (PyTorch's mixed-type
  batch norm), as Flax does before casting back.
* ``BatchNorm2d`` / ``BatchNorm1d`` update their running variance with the
  biased batch variance, as Flax does; PyTorch's own use the unbiased one.
  Inside ``data_parallel(mesh)`` (the data-parallel train step) a
  train-mode BatchNorm takes its statistics over the global batch, the
  ranks' slices together, as JAX's SPMD step does on the whole batch: one
  all-reduce of the sums for the mean, one of the squared deviations for
  the variance, both differentiable, and the global row count in the
  biased running update.
* ``remat_block`` (a backbone's ``forward(x, remat=True)``, the train
  step's option): the block runs under ``torch.utils.checkpoint``, so the
  backward pass recomputes its inner activations from its saved input. The
  recomputation re-runs train-mode BatchNorm; ``recomputing`` makes each BN
  normalise with the batch statistics there and leave its running
  statistics (and Flax's correction) alone, so the statistics move once a
  step, as without remat.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules import module as nn_module
from torch.utils.checkpoint import checkpoint

_state = threading.local()  # .recomputing: inside a checkpoint's recomputation
# The data-parallel step's mesh, while it runs. A process-wide value, not a
# thread's: on the card the backward pass (and with it remat's
# recomputation) runs on autograd's device thread.
_dp = {"mesh": None}


@contextlib.contextmanager
def data_parallel(mesh):
    """BatchNorms take global-batch statistics over ``mesh`` (a mesh of more
    than one rank) for the ``with`` block: the train step's forward and
    backward."""
    _dp["mesh"] = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _dp["mesh"] = None


def _global_batch_norm(x, weight, bias, eps: float, mesh):
    """Train-mode batch norm over the global batch of equal rank slices:
    (output in ``x``'s type, the global mean, the biased variance), in fp32
    and differentiable through the two all-reduces."""
    from ssg_tpu_torch.parallel.ring import all_reduce_sum_autograd

    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    shape = [1, c] + [1] * (x.dim() - 2)
    xf = x.float()
    n = x.numel() // c * mesh.size
    mean = all_reduce_sum_autograd(mesh, xf.sum(dims)) / n
    xc = xf - mean.view(shape)
    var = all_reduce_sum_autograd(mesh, (xc * xc).sum(dims)) / n
    y = xc * torch.rsqrt(var + eps).view(shape) * weight.view(shape) + bias.view(shape)
    return y.to(x.dtype), mean.detach(), var.detach()


@contextlib.contextmanager
def recomputing():
    """Marks a checkpoint's recomputation (the backward pass may run it on
    another thread than the forward, hence the thread-local flag)."""
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = False


def _checkpoint_contexts():
    return contextlib.nullcontext(), recomputing()


def remat_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``, under a non-reentrant checkpoint with the recomputation
    context (``recomputing``) when ``remat`` is set and autograd is on. A
    block is the granularity that saves memory: one checkpoint around the
    whole model would keep its recomputation's activations alive as long."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=True,
                          context_fn=_checkpoint_contexts)
    return block(x)


def cast_masters(module: nn.Module, dtype: torch.dtype) -> tuple:
    """``module``'s fp32 master ``weight`` and ``bias`` (None or a tensor)
    cast to ``dtype``. The cast is differentiable, so gradients reach the
    masters. Without autograd (an eval extract) the copies are cached on the
    module until a master is replaced or changed in place (its
    ``_version``)."""
    params = module._parameters  # dict reads, not Module.__getattr__: once a layer a call
    w, b = params["weight"], params["bias"]
    if w.dtype == dtype:
        return w, b
    if torch.is_grad_enabled():
        return w.to(dtype), None if b is None else b.to(dtype)
    key = (dtype, w.data_ptr(), w._version, None if b is None else (b.data_ptr(), b._version))
    c = module._cast_cache
    if c is None or c[0] != key:
        c = module._cast_cache = (key, w.to(dtype), None if b is None else b.to(dtype))
    return c[1], c[2]


# The attributes in which a module caches weights derived from its
# parameters and buffers for a no-grad forward: ``cast_masters``' casts and
# ``resnet.Bottleneck.folded``'s BatchNorm folds. A captured CUDA graph reads
# them by address (``api.extract_features``), so every such cache is named
# here.
DERIVED_CACHES = ("_cast_cache", "_fold_cache")


def derived_caches(model: nn.Module) -> list:
    """The caches of derived weights (``DERIVED_CACHES``) that the modules
    of ``model`` hold now, each a tuple that is replaced when rebuilt."""
    return [c for m in model.modules() for c in map(vars(m).get, DERIVED_CACHES)
            if c is not None]


def no_hooks(modules, backward: bool = False) -> bool:
    """Whether no module hook would run in a forward of ``modules`` (e.g.
    ``model.modules()``), nor with ``backward`` in its backward: no global
    module hook, and no forward hook or pre-hook (backward hook or pre-hook)
    on any of them. A CUDA graph's replay runs no hook, so a graph replays
    only where this holds."""
    if (nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks
            or nn_module._global_backward_hooks or nn_module._global_backward_pre_hooks):
        return False
    return not any(m._forward_hooks or m._forward_pre_hooks
                   or (backward and (m._backward_hooks or m._backward_pre_hooks))
                   for m in modules)


class Conv2d(nn.Conv2d):
    """Bias-free convolution, ``k // 2`` padding, with an fp32 master weight
    cast to the input's type at each call (Flax's ``nn.Conv`` with its
    default fp32 ``param_dtype``; ``cast_masters``)."""

    _cast_cache = None

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, padding=k // 2, bias=False)

    def forward(self, x):
        return F.conv2d(x, cast_masters(self, x.dtype)[0], None, self.stride, self.padding)


class _FlaxRunningVariance:
    """Batch norm with momentum 0.1 and Flax's running statistics.

    Train mode normalises with the batch statistics, as PyTorch's batch
    norm does, but leaves the biased batch variance in the running variance
    (Flax's update), where PyTorch leaves the unbiased one: n / (n - 1)
    larger, 6.7 % at a batch of 16 rows. With r the running variance
    before, m the momentum and u the unbiased variance that PyTorch wrote,
    the biased update is ``(1 - m) r + m u (n - 1) / n``, which is
    ``r' (n - 1) / n + (1 - m) r / n`` of PyTorch's result r'. The
    correction goes through ``.data``, as PyTorch's own update does not
    bump the running variance's version either: its backward saved it.
    ``num_batches_tracked`` (PyTorch's counter for a cumulative average)
    is not kept: the momentum is fixed. Eval mode normalises with the
    running statistics. Both call ``F.batch_norm`` directly. Inside a
    checkpoint's recomputation (``recomputing``) it normalises with the
    batch statistics and updates none of the module's. Inside
    ``data_parallel`` the batch statistics are the global batch's
    (``_global_batch_norm``), in the recomputation too."""

    _recompute_stats = None  # (mean, var) scratch for the recomputation

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mesh = _dp["mesh"]
        if mesh is not None:
            out, mean, var = _global_batch_norm(x, self.weight, self.bias, self.eps, mesh)
            if not getattr(_state, "recomputing", False):
                with torch.no_grad():
                    self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
                    self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            return out
        if getattr(_state, "recomputing", False):
            # The saved tensors must match the forward's, so the call keeps
            # its running statistics, as scratch ones that momentum 0 leaves
            # as they are: the same kernel, the same outputs.
            scratch = self._recompute_stats
            if scratch is None or scratch[0].device != x.device:
                scratch = self._recompute_stats = (torch.zeros_like(self.running_mean),
                                                   torch.ones_like(self.running_var))
            return F.batch_norm(x, *scratch, self.weight, self.bias, True, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        rv = self.running_var.data
        before = rv * ((1.0 - self.momentum) / n)
        out = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        torch.add(before, rv, alpha=(n - 1) / n, out=rv)
        return out


class BatchNorm2d(_FlaxRunningVariance, nn.BatchNorm2d):
    pass


class BatchNorm1d(_FlaxRunningVariance, nn.BatchNorm1d):
    pass
