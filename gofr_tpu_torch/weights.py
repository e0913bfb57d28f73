"""Parameters of the port: conversion from and to the reference pytree,
and random initialisation on the device; and a reference KV cache carried
over into the port's layout.

Each family has its pair: ``params_from_jax`` / ``params_to_reference``
for the decoders, ``bert_params_from_jax`` / ``bert_params_to_reference``,
``vit_params_from_jax`` / ``vit_params_to_reference`` and
``resnet_params_from_jax`` / ``resnet_params_to_reference`` and
``t5_params_from_jax`` / ``t5_params_to_reference``. Each ``to``
function inverts its ``from`` exactly (leaves as f32 numpy arrays, which
hold bf16 values exactly)."""

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
from gofr_tpu_torch.ops.quant import Q4, Q8, is_quantized

__all__ = ["bert_params_from_jax", "bert_params_to_reference", "init_params",
           "kv_cache_from_jax", "params_from_jax", "params_to_reference",
           "resnet_params_from_jax", "resnet_params_to_reference",
           "t5_params_from_jax", "t5_params_to_reference",
           "vit_params_from_jax", "vit_params_to_reference"]


# Leaves that cross over unchanged where the config has them: per layer,
# and at the top level.
_LAYER_EXTRAS = ("attn_norm_b", "mlp_norm_b", "wo_b", "w_up_b", "w_down_b")
_TOP_EXTRAS = ("final_norm_b", "pos_embed")
# LoRA leaves ({t}_lora_a [L, N, d_in, r], {t}_lora_b [L, N, r, d_out]):
# the same layout in both packages, carried across unfused.
_LORA_SUFFIXES = ("_lora_a", "_lora_b")


def params_from_jax(
    np_params: dict, cfg: TransformerConfig,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, torch.Tensor]:
    """The reference's ``init_transformer`` pytree (leaves as numpy arrays,
    layer leaves stacked ``[L, ...]``) → the port's parameter dict, with
    Q/K/V (and Qwen2's Q/K/V biases) and gate/up concatenated along their
    output axis (a non-gated MLP keeps ``w_up`` alone; MoE fuses gate/up
    per expert, ``[L, E, D, 2F]``, and keeps its ``router``), the norm and
    projection biases, GPT-2's position table and the LoRA leaves
    (``{t}_lora_a`` / ``{t}_lora_b``) as they are, in
    ``dtype`` (default ``cfg.dtype``; ``torch.float32`` brings f32 master
    params over unrounded). The reference's quantized leaves (Q8/Q4 with
    numpy ``q`` and ``s``) become the port's, fused the same way along the
    output axis of both ``q`` and ``s``, bit for bit. The tensors go to
    CUDA unless ``device="cpu"``; without CUDA that raises."""
    check_supported(cfg, device)
    lp = np_params["layers"]
    t = _leaf_fn(device, cfg.dtype if dtype is None else dtype)

    params = {
        "embed": t(np_params["embed"]),
        "attn_norm": t(lp["attn_norm"]),
        "wqkv": _cat([t(lp["wq"]), t(lp["wk"]), t(lp["wv"])]),
        "wo": t(lp["wo"]),
        "mlp_norm": t(lp["mlp_norm"]),
    }
    if cfg.is_moe:
        params["router"] = t(lp["router"])
    if cfg.ffn == "mlp" and not cfg.is_moe:
        params["w_up"] = t(lp["w_up"])
    else:
        params["w_gate_up"] = _cat([t(lp["w_gate"]), t(lp["w_up"])])
    params.update(
        w_down=t(lp["w_down"]), final_norm=t(np_params["final_norm"]),
        lm_head=t(np_params["lm_head"]),
    )
    if "wq_b" in lp:
        params["wqkv_b"] = torch.cat([t(lp["wq_b"]), t(lp["wk_b"]), t(lp["wv_b"])], dim=-1)
    params.update({k: t(lp[k]) for k in _LAYER_EXTRAS if k in lp})
    params.update({k: t(np_params[k]) for k in _TOP_EXTRAS if k in np_params})
    params.update({k: t(a) for k, a in lp.items() if k.endswith(_LORA_SUFFIXES)})
    return params


def params_to_reference(params: dict, cfg: TransformerConfig) -> dict:
    """The inverse of ``params_from_jax``: a port parameter dict (or a dict
    of its gradients) → the reference pytree layout, ``wqkv`` split into
    ``wq/wk/wv`` (``wqkv_b`` into ``wq_b/wk_b/wv_b``) and ``w_gate_up``
    into ``w_gate/w_up``, the LoRA leaves as they are, leaves as f32
    numpy arrays on the host; a
    quantized leaf stays a Q8/Q4 of numpy ``q`` (int8/uint8) and ``s``
    (f32), split the same way."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = [H * hd, KV * hd, KV * hd]
    n = _host_leaf

    wq, wk, wv = _split(params["wqkv"], qkv)
    layers = {
        "wq": n(wq), "wk": n(wk), "wv": n(wv), "wo": n(params["wo"]),
        "attn_norm": n(params["attn_norm"]),
        "mlp_norm": n(params["mlp_norm"]),
        "w_down": n(params["w_down"]),
    }
    if "w_gate_up" in params:
        half = params["w_gate_up"].shape[-1] // 2
        w_gate, w_up = _split(params["w_gate_up"], [half, half])
        layers.update(w_gate=n(w_gate), w_up=n(w_up))
    else:
        layers["w_up"] = n(params["w_up"])
    if "router" in params:
        layers["router"] = n(params["router"])
    if "wqkv_b" in params:
        bq, bk, bv = params["wqkv_b"].split(qkv, dim=-1)
        layers.update(wq_b=n(bq), wk_b=n(bk), wv_b=n(bv))
    layers.update({k: n(params[k]) for k in _LAYER_EXTRAS if k in params})
    layers.update({k: n(p) for k, p in params.items() if k.endswith(_LORA_SUFFIXES)})
    out = {
        "embed": n(params["embed"]),
        "layers": layers,
        "final_norm": n(params["final_norm"]),
        "lm_head": n(params["lm_head"]),
    }
    out.update({k: n(params[k]) for k in _TOP_EXTRAS if k in params})
    return out


def _leaf_fn(device: torch.device | str | None, dtype: torch.dtype):
    """A reference leaf → the port's: its Q8 / Q4 (numpy ``q`` and ``s``)
    as the port's, bit for bit; a plain leaf in ``dtype`` on ``device``."""
    device = resolve_device(device)
    plain = _tensor_fn(device, dtype)

    def t(a: Any):
        if hasattr(a, "q") and hasattr(a, "s"):  # the reference's Q8 / Q4
            q = torch.from_numpy(np.array(a.q)).to(device)
            s = torch.from_numpy(np.array(a.s, dtype=np.float32)).to(device)
            return (Q4 if q.dtype == torch.uint8 else Q8)(q, s)
        return plain(a)

    return t


def _host_leaf(t: Any):
    """A port leaf → f32 numpy (a quantized one a Q8/Q4 of numpy ``q`` and
    ``s``)."""
    if is_quantized(t):
        return type(t)(t.q.cpu().numpy(), t.s.cpu().numpy())
    return _host(t)


def _tensor_fn(device: torch.device | str | None, dtype: torch.dtype):
    """numpy leaf → tensor of ``dtype`` on ``device`` (through f32: exact
    for bf16 and f32 leaves)."""
    device = resolve_device(device)
    return lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device,
                                                                       dtype=dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# BERT's and ViT's per-layer leaves other than Q/K/V (carried as they are).
_BERT_LAYER = ("wo", "w_in", "w_out", "norm1_w", "norm1_b", "norm2_w", "norm2_b")
_BERT_TOP = ("tok_embed", "pos_embed", "embed_norm_w", "embed_norm_b")
_VIT_LAYER = ("ln1", "ln1_b", "wo", "wo_b", "ln2", "ln2_b", "w_up", "w_up_b",
              "w_down", "w_down_b")
_VIT_TOP = ("patch_proj", "patch_proj_b", "cls_token", "pos_embed", "ln_f", "ln_f_b",
            "head", "head_b")


def bert_params_from_jax(np_params: dict, cfg: Any,
                         device: torch.device | str | None = None,
                         dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The reference's ``init_bert`` pytree (numpy leaves) → the port's
    BERT parameters (``models/bert.py``): ``wq/wk/wv`` concatenated into
    ``wqkv`` along the output axis, the rest as they are, in ``dtype``
    (default ``cfg.dtype``)."""
    t = _tensor_fn(device, cfg.dtype if dtype is None else dtype)
    lp = np_params["layers"]
    params = {k: t(np_params[k]) for k in _BERT_TOP}
    params["wqkv"] = torch.cat([t(lp["wq"]), t(lp["wk"]), t(lp["wv"])], dim=-1)
    params.update({k: t(lp[k]) for k in _BERT_LAYER})
    return params


def bert_params_to_reference(params: dict, cfg: Any) -> dict:
    """The inverse of ``bert_params_from_jax``: f32 numpy leaves in the
    reference's layout."""
    wq, wk, wv = params["wqkv"].split(cfg.d_model, dim=-1)
    layers = {"wq": _host(wq), "wk": _host(wk), "wv": _host(wv)}
    layers.update({k: _host(params[k]) for k in _BERT_LAYER})
    out = {k: _host(params[k]) for k in _BERT_TOP}
    out["layers"] = layers
    return out


def vit_params_from_jax(np_params: dict, cfg: Any,
                        device: torch.device | str | None = None,
                        dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The reference's ``init_vit`` pytree (numpy leaves) → the port's ViT
    parameters (``models/vit.py``): ``wq/wk/wv`` into ``wqkv`` and their
    biases into ``wqkv_b``, the rest as they are, in ``dtype`` (default
    ``cfg.dtype``)."""
    t = _tensor_fn(device, cfg.dtype if dtype is None else dtype)
    lp = np_params["layers"]
    params = {k: t(np_params[k]) for k in _VIT_TOP}
    params["wqkv"] = torch.cat([t(lp["wq"]), t(lp["wk"]), t(lp["wv"])], dim=-1)
    params["wqkv_b"] = torch.cat([t(lp["wq_b"]), t(lp["wk_b"]), t(lp["wv_b"])], dim=-1)
    params.update({k: t(lp[k]) for k in _VIT_LAYER})
    return params


def vit_params_to_reference(params: dict, cfg: Any) -> dict:
    """The inverse of ``vit_params_from_jax``: f32 numpy leaves in the
    reference's layout."""
    D = cfg.d_model
    layers = {}
    for name, leaf in (("w", "wqkv"), ("b", "wqkv_b")):
        for proj, part in zip(("wq", "wk", "wv"), params[leaf].split(D, dim=-1)):
            layers[proj if name == "w" else proj + "_b"] = _host(part)
    layers.update({k: _host(params[k]) for k in _VIT_LAYER})
    out = {k: _host(params[k]) for k in _VIT_TOP}
    out["layers"] = layers
    return out


def resnet_params_from_jax(np_params: dict, cfg: Any = None,
                           device: torch.device | str | None = None) -> dict:
    """The reference's ``init_resnet`` tree (numpy leaves; convolutions
    HWIO) → the port's (``models/resnet.py``; convolutions OIHW), every
    leaf f32 as in the reference. ``cfg`` is accepted for symmetry with
    the other families and not read: the tree carries its own shape."""
    t = _tensor_fn(device, torch.float32)

    def conv(a: Any) -> torch.Tensor:
        return t(a).permute(3, 2, 0, 1).contiguous()

    def tree(d: dict) -> dict:
        return {k: {n: t(x) for n, x in v.items()} if isinstance(v, dict) else conv(v)
                for k, v in d.items()}

    return {
        "stem": tree(np_params["stem"]),
        "stages": [[tree(block) for block in stage] for stage in np_params["stages"]],
        "head": {"w": t(np_params["head"]["w"]), "b": t(np_params["head"]["b"])},
    }


def resnet_params_to_reference(params: dict, cfg: Any = None) -> dict:
    """The inverse of ``resnet_params_from_jax``: f32 numpy leaves,
    convolutions HWIO."""

    def tree(d: dict) -> dict:
        return {k: _host(v.permute(2, 3, 1, 0)) if isinstance(v, torch.Tensor)
                else {n: _host(x) for n, x in v.items()} for k, v in d.items()}

    return {
        "stem": tree(params["stem"]),
        "stages": [[tree(block) for block in stage] for stage in params["stages"]],
        "head": {"w": _host(params["head"]["w"]), "b": _host(params["head"]["b"])},
    }


def t5_params_from_jax(np_params: dict, cfg: Any,
                       device: torch.device | str | None = None,
                       dtype: torch.dtype | None = None) -> dict:
    """The reference's T5 tree (``init_t5``, ``load_hf_t5`` or
    ``quantize_t5_params``; numpy leaves) → the port's, the same tree
    (``models/t5.py`` keeps the reference's layout): the encoder and
    decoder stacks, the bias tables, the embedding, the norms and an
    untied ``lm_head`` in ``dtype`` (default ``cfg.dtype``), and the
    reference's Q8/Q4 leaves as the port's, bit for bit."""
    t = _leaf_fn(device, cfg.dtype if dtype is None else dtype)
    return {k: {kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict) else t(v)
            for k, v in np_params.items()}


def t5_params_to_reference(params: dict, cfg: Any = None) -> dict:
    """The inverse of ``t5_params_from_jax``: f32 numpy leaves (a quantized
    leaf a Q8/Q4 of numpy ``q`` and ``s``) in the same tree."""
    n = _host_leaf
    return {k: {kk: n(vv) for kk, vv in v.items()} if isinstance(v, dict) else n(v)
            for k, v in params.items()}


def _cat(leaves: list):
    """Plain or quantized leaves concatenated along the output axis (a
    quantized leaf's ``q`` and ``s`` both end in it)."""
    if is_quantized(leaves[0]):
        return type(leaves[0])(torch.cat([w.q for w in leaves], dim=-1),
                               torch.cat([w.s for w in leaves], dim=-1))
    return torch.cat(leaves, dim=-1)


def _split(w, sizes: list) -> list:
    """The inverse of ``_cat``: ``w`` split along the output axis."""
    if is_quantized(w):
        return [type(w)(q, s) for q, s in zip(w.q.split(sizes, dim=-1),
                                              w.s.split(sizes, dim=-1))]
    return list(w.split(sizes, dim=-1))


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
