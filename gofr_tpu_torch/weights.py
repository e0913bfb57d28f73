"""Parameters of the port: conversion from and to the reference pytree,
and random initialisation on the device; and a reference KV cache carried
over into the port's layout."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.transformer import (
    TransformerConfig,
    check_supported,
    init_params,
)
from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache

__all__ = ["init_params", "kv_cache_from_jax", "params_from_jax",
           "params_to_reference"]


def params_from_jax(
    np_params: dict, cfg: TransformerConfig,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """The reference's ``init_transformer`` pytree (leaves as numpy arrays,
    layer leaves stacked ``[L, ...]``) → the port's parameter dict, with
    Q/K/V and gate/up concatenated along their output axis, in ``dtype``
    (default ``cfg.dtype``; ``torch.float32`` brings f32 master params over
    unrounded). The tensors go to CUDA unless ``device="cpu"``; without
    CUDA that raises."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    lp = np_params["layers"]

    def t(a: Any) -> torch.Tensor:
        # Through f32: exact for bf16 and f32 leaves, and numpy has no bf16.
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    return {
        "embed": t(np_params["embed"]),
        "attn_norm": t(lp["attn_norm"]),
        "wqkv": torch.cat([t(lp["wq"]), t(lp["wk"]), t(lp["wv"])], dim=-1),
        "wo": t(lp["wo"]),
        "mlp_norm": t(lp["mlp_norm"]),
        "w_gate_up": torch.cat([t(lp["w_gate"]), t(lp["w_up"])], dim=-1),
        "w_down": t(lp["w_down"]),
        "final_norm": t(np_params["final_norm"]),
        "lm_head": t(np_params["lm_head"]),
    }


def params_to_reference(params: dict, cfg: TransformerConfig) -> dict:
    """The inverse of ``params_from_jax``: a port parameter dict (or a dict
    of its gradients) → the reference pytree layout, ``wqkv`` split into
    ``wq/wk/wv`` and ``w_gate_up`` into ``w_gate/w_up``, leaves as f32
    numpy arrays on the host."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def n(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    wq, wk, wv = params["wqkv"].split([H * hd, KV * hd, KV * hd], dim=-1)
    w_gate, w_up = params["w_gate_up"].chunk(2, dim=-1)
    return {
        "embed": n(params["embed"]),
        "layers": {
            "wq": n(wq), "wk": n(wk), "wv": n(wv), "wo": n(params["wo"]),
            "attn_norm": n(params["attn_norm"]),
            "mlp_norm": n(params["mlp_norm"]),
            "w_gate": n(w_gate), "w_up": n(w_up),
            "w_down": n(params["w_down"]),
        },
        "final_norm": n(params["final_norm"]),
        "lm_head": n(params["lm_head"]),
    }


def _from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """A host array → a tensor of the same dtype (bf16 through f32, which
    is exact: numpy has no bf16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def kv_cache_from_jax(
    np_cache: Any, device: torch.device | str | None = None,
) -> KVCache | PagedKVCache:
    """A reference ``KVCache`` or ``PagedKVCache`` (its fields as numpy
    arrays) → the port's cache of the same kind, dtype and contents. The
    int8 scale planes drop the reference's x8 sublane replication
    (``k_s[..., 0, :]``). CUDA unless ``device="cpu"``."""
    device = resolve_device(device)

    def scales(a: Any) -> Any:
        return None if a is None else _from_numpy(np.asarray(a)[..., 0, :], device)

    fields = dict(
        k=_from_numpy(np_cache.k, device), v=_from_numpy(np_cache.v, device),
        lengths=_from_numpy(np_cache.lengths, device).to(torch.int32),
        k_s=scales(np_cache.k_s), v_s=scales(np_cache.v_s),
    )
    if hasattr(np_cache, "block_table"):
        return PagedKVCache(
            block_table=_from_numpy(np_cache.block_table, device).to(torch.int32),
            **fields,
        )
    return KVCache(**fields)
