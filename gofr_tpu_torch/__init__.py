"""gofr_tpu_torch — the PyTorch/CUDA port of gofr_tpu: the framework
(``App``, ``ctx.infer``, HTTP, config, logging, metrics) and the serving
and training paths.

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

Public surface, as the reference's::

    from gofr_tpu_torch import App

    app = App()

    @app.get("/hello")
    def hello(ctx):
        return f"Hello {ctx.param('name') or 'World'}!"

    app.run()
"""

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.version import FRAMEWORK_VERSION

__version__ = FRAMEWORK_VERSION

# Lazy, as in the reference: `import gofr_tpu_torch` does not pull in the
# framework half until it is used.
_LAZY = {
    "App": ("gofr_tpu_torch.app", "App"),
    "Context": ("gofr_tpu_torch.context", "Context"),
    "new_cmd": ("gofr_tpu_torch.app", "new_cmd"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gofr_tpu_torch' has no attribute {name!r}")


__all__ = ["App", "Context", "FRAMEWORK_VERSION", "new_cmd", "resolve_device"]
