"""gofr_tpu_torch — the PyTorch/CUDA port of gofr_tpu's serving and
training paths.

The JAX package ``gofr_tpu`` beside it is the reference this package is
held against. This package imports ``torch``, numpy and the standard
library only: never ``jax`` and nothing of ``gofr_tpu`` (what it needs
from there it keeps as its own copy).

Layout mirrors the reference so each module's counterpart is easy to
find (``gofr_tpu_torch/ops/attention.py`` ↔ ``gofr_tpu/ops/attention.py``).
The attention kernels (decode, chunked prefill, and full-sequence
``flash_attention`` for training and padded prefill) are hand-written
CUDA C++ for Hopper (``csrc/``), bound with ctypes (``ops/cuda/``);
``parallel/sharding.py`` holds the one-device training step.
"""

from gofr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
