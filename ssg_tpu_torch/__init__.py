"""PyTorch/CUDA port of ``ssg_tpu`` for NVIDIA Hopper (H100).

The module layout mirrors ``ssg_tpu`` so each counterpart is easy to find.
This package imports torch and numpy only — never jax, flax or ``ssg_tpu``
(``tests/test_torch_isolation.py`` enforces it). Entry points run on the
card unless the caller passes ``device="cpu"``; see ``_device.py`` for the
device and precision policy.
"""

from ssg_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
