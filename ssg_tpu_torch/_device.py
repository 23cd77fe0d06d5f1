"""Device and precision policy of the port.

* ``device=None`` means ``cuda``. Without a card that raises, unless the
  caller asked for ``"cpu"`` explicitly (the CPU tests do).
* fp32 products run in true fp32, matching the JAX package's
  ``Precision.HIGHEST`` distances, query-expansion product, triplet Gram
  and fp32 parity model: ``allow_tf32`` is switched off for cuBLAS and
  cuDNN when ``ssg_tpu_torch`` is imported (``set_precision_policy``), so
  code that builds the model and calls it without an entry point of the
  port gets true fp32 as well. ``resolve_device`` applies it again, in case
  the caller switched it back on after the import.
* The bf16 model keeps fp32 master weights and runs bf16 convolutions with
  fp32 accumulation (cuDNN's behaviour for bf16), as XLA does for Flax's
  ``dtype=bfloat16`` with its default fp32 ``param_dtype``.
"""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """True fp32 products and convolutions: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ssg_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        set_precision_policy()
    return dev
