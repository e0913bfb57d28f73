"""Where the port's native builds land: the nvcc kernel library
(``ops/cuda/_build.py``) and the byte-level BPE core
(``serving/native_tokenizer.py``).

The default is ``gofr_tpu_torch/_build/`` (listed in ``.gitignore``).
``TPU_COMPILE_CACHE_DIR`` points it at an operator's directory through
:func:`use_dir`: both libraries are named by a hash of their sources and
flags, so a later process on the same tree loads them from there instead
of compiling. The directory is fixed once a build or a load has read it
in this process (the reference's rule for jax's compilation cache, which
jax reads at the first compile): a later :func:`use_dir` with another
directory is refused and says why.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

DEFAULT_DIR = Path(__file__).resolve().parent / "_build"

_lock = threading.Lock()
_dir = DEFAULT_DIR
_used = False


def build_dir() -> Path:
    """The build directory, fixed from now on in this process (callers
    are about to build into it or load from it)."""
    global _used
    with _lock:
        _used = True
        return _dir


def use_dir(path: str) -> dict[str, Any]:
    """Point the builds at ``path``; returns the provenance record the
    compile tracker keeps (``dir``, ``enabled``, and ``error`` when
    refused). Refused once another directory was read by a build or a
    load in this process, and when ``path`` cannot be created."""
    global _dir
    info: dict[str, Any] = {"dir": str(path), "enabled": False}
    target = Path(path).expanduser().resolve()
    with _lock:
        if target == _dir:
            info["enabled"] = True
            return info
        if _used:
            info["error"] = (
                f"the native builds already read {_dir} in this process; "
                "TPU_COMPILE_CACHE_DIR takes effect only when set before "
                "the first build"
            )
            return info
        try:
            os.makedirs(target, exist_ok=True)
        except OSError as exc:
            info["error"] = f"{type(exc).__name__}: {exc}"
            return info
        _dir = target
        info["enabled"] = True
        return info
