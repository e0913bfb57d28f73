"""Model checkpoint save and restore — the port of
``gofr_tpu/serving/checkpoint.py``, in torch's format.

A checkpoint is one file written by ``torch.save`` and read by
``torch.load(weights_only=True)``: only tensors, dicts, lists and strings,
so loading one runs no code. A Q8/Q4 leaf is saved as
``{"quant": "int8" | "int4", "q": ..., "s": ...}`` and restored as the
port's Q8/Q4. The reference's checkpoints are orbax directories, which
the port does not read (ROADMAP Queue 3, deliberate differences).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from gofr_tpu_torch.ops.quant import Q4, Q8, is_quantized

_KINDS = {"int8": Q8, "int4": Q4}


def _to_plain(state: Any) -> Any:
    if is_quantized(state):
        return {"quant": state.mode, "q": state.q, "s": state.s}
    if isinstance(state, dict):
        return {k: _to_plain(v) for k, v in state.items()}
    return state


def _from_plain(state: Any) -> Any:
    if isinstance(state, dict):
        if set(state) == {"quant", "q", "s"} and state["quant"] in _KINDS:
            return _KINDS[state["quant"]](state["q"], state["s"])
        return {k: _from_plain(v) for k, v in state.items()}
    return state


def _leaves(state: Any, prefix: str = "") -> dict:
    """Path → leaf (a tensor, a Q8/Q4, or another value)."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): state}


def _device_of(state: Any) -> Optional[torch.device]:
    for leaf in _leaves(state).values():
        if isinstance(leaf, torch.Tensor) or is_quantized(leaf):
            return leaf.device
    return None


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Write ``state`` (a parameter dict, or a nest of dicts of tensors and
    Q8/Q4) to the file ``path``; without ``force`` an existing file is an
    error."""
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_plain(state), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any | None = None) -> Any:
    """Read a checkpoint onto the device of ``like``'s first tensor (the
    CPU without ``like``). ``like`` also fixes the layout: the restored
    state must have its leaves, kinds, shapes and dtypes, or
    ``ValueError``."""
    path = os.path.abspath(path)
    device = _device_of(like) if like is not None else None
    state = _from_plain(torch.load(path, map_location=device or "cpu", weights_only=True))
    if like is not None:
        want, got = _leaves(like), _leaves(state)
        if want.keys() != got.keys():
            raise ValueError(
                f"checkpoint {path} has leaves {sorted(got)}, expected {sorted(want)}")
        for name, w in want.items():
            g = got[name]
            if type(g) is not type(w):
                raise ValueError(f"checkpoint {path}: {name} is a {type(g).__name__}, "
                                 f"expected a {type(w).__name__}")
            for a, b in ((g.q, w.q), (g.s, w.s)) if is_quantized(w) else ((g, w),):
                if isinstance(b, torch.Tensor) and (a.shape != b.shape or a.dtype != b.dtype):
                    raise ValueError(
                        f"checkpoint {path}: {name} is {a.dtype} {tuple(a.shape)}, "
                        f"expected {b.dtype} {tuple(b.shape)}")
    return state


def maybe_restore_params(config: Any, params: Any, logger: Any = None) -> Any:
    """The engine's boot seam, the reference's: the params restored from
    ``TPU_CHECKPOINT`` when it is set, laid out like ``params``; on any
    failure an error-level log line and ``params`` as they were."""
    path = config.get_or_default("TPU_CHECKPOINT", "") if config is not None else ""
    if not path:
        return params
    try:
        restored = restore_checkpoint(path, like=params)
        if logger is not None:
            logger.infof("restored model params from %s", path)
        return restored
    except Exception as exc:
        if logger is not None:
            logger.errorf("could not restore checkpoint %s: %s", path, exc)
        return params
