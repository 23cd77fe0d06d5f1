"""Device and precision policy of the port.

* ``device=None`` means ``cuda``. Without a card that raises, unless the
  caller asked for ``"cpu"`` explicitly (the CPU tests do).
* fp32 products run in true fp32 (``allow_tf32 = False`` for cuBLAS and
  cuDNN), matching the JAX package's ``Precision.HIGHEST`` distances,
  query-expansion product and fp32 parity model.
* The bf16 model runs bf16 convolutions with fp32 accumulation (cuDNN's
  behaviour for bf16), as XLA does for ``dtype=bfloat16``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ssg_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
