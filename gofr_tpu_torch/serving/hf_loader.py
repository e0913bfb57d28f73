"""HuggingFace safetensors checkpoints → the port's parameters, the port of
``gofr_tpu/serving/hf_loader.py``.

A checkpoint directory holds ``config.json`` and ``*.safetensors`` shards.
The port reads the shards with its own reader (``SafetensorsFile``: an
8-byte little-endian header length, a JSON header of ``dtype``, ``shape``
and ``data_offsets`` per tensor, then the bytes, mapped with ``mmap`` and
viewed with ``torch.frombuffer``), so it needs neither the ``safetensors``
package nor ``transformers``.

The layout, as the reference maps it: HF linear weights are ``[out, in]``
and the port's contract their second-to-last axis, so each projection is
transposed (GPT-2's Conv1D weights are already ``[in, out]``); GPT-NeoX's
fused ``query_key_value`` rows are (head, q|k|v, head_dim); Mixtral's
experts are ``w1`` (gate), ``w3`` (up) and ``w2`` (down) per expert; an
untied ``lm_head.weight`` wins over the embedding's transpose. The leaves
are written straight into the port's fused layout (``wqkv``,
``w_gate_up``), one layer (one expert, for Mixtral) at a time: each slice
is read from the mapped file, cast to the model dtype, moved to the device
and copied, or quantized (``quant``), into its preallocated stacked leaf,
so neither the host nor the device ever holds a whole bf16 leaf. Q8/Q4
scales are per output column (per group and column), so quantizing a
fused or a one-layer slice is the reference's quantization of the
separate whole leaves, bit for bit.

T5 checkpoints load through ``load_hf_t5`` (``models/t5.py``, re-exported
here), which reads the shards through the same ``_TensorSource``.
``mesh=`` waits for multi-device serving (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Any, Callable, Optional

import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.t5 import load_hf_t5
from gofr_tpu_torch.models.transformer import TransformerConfig
from gofr_tpu_torch.ops.quant import (
    empty_quantized,
    params_quant_mode,
    quantize_array,
    quantize_array4,
    quantize_into,
)

__all__ = ["SafetensorsFile", "config_from_hf", "is_hf_checkpoint", "load_hf_llama",
           "load_hf_t5", "params_have_q8", "params_quant_mode"]

# safetensors dtype names → torch dtypes (those a checkpoint of these
# families holds, and the integer types).
_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def is_hf_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "config.json"))
        or bool(glob.glob(os.path.join(path, "*.safetensors")))
    )


def config_from_hf(path: str) -> TransformerConfig:
    """A TransformerConfig from an HF ``config.json`` of one of the seven
    model types the reference reads (llama, mistral, mixtral, qwen2, gemma,
    gpt_neox, gpt2), field for field the reference's mapping, in bf16."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in ("llama", "mistral", "mixtral", "qwen2", "gemma",
                  "gpt_neox", "gpt2"):
        raise ValueError(
            f"unsupported HF model_type {mt!r} "
            "(llama-family + qwen2 + gemma + gpt_neox + gpt2 only)"
        )
    if mt == "gpt2":
        g2act = {
            "gelu_new": "gelu",
            "gelu_pytorch_tanh": "gelu",
            "gelu_fast": "gelu",
            "gelu": "gelu_exact",
        }.get(hf.get("activation_function", "gelu_new"))
        if g2act is None:
            raise ValueError(
                "unsupported gpt2 activation_function "
                f"{hf.get('activation_function')!r}"
            )
        if hf.get("scale_attn_by_inverse_layer_idx"):
            raise ValueError(
                "gpt2 scale_attn_by_inverse_layer_idx is not supported"
            )
        if hf.get("scale_attn_weights") is False:
            raise ValueError(
                "gpt2 scale_attn_weights=false is not supported (attention "
                "always applies the 1/sqrt(head_dim) scale)"
            )
        return TransformerConfig(
            vocab_size=hf["vocab_size"], d_model=hf["n_embd"],
            n_layers=hf["n_layer"], n_heads=hf["n_head"], n_kv_heads=hf["n_head"],
            d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
            max_len=hf.get("n_positions", 1024),
            norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            dtype=torch.bfloat16, attn_bias=True, proj_bias=True, norm="ln",
            ffn="mlp", act=g2act, pos_emb="learned",
        )
    if mt == "gpt_neox":
        hidden_act = hf.get("hidden_act", "gelu")
        act = {
            "gelu": "gelu_exact",
            "gelu_fast": "gelu",
            "gelu_new": "gelu",
            "gelu_pytorch_tanh": "gelu",
        }.get(hidden_act)
        if act is None:
            raise ValueError(
                f"unsupported gpt_neox hidden_act {hidden_act!r}"
            )
        return TransformerConfig(
            vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
            n_layers=hf["num_hidden_layers"], n_heads=hf["num_attention_heads"],
            n_kv_heads=hf["num_attention_heads"], d_ff=hf["intermediate_size"],
            max_len=hf.get("max_position_embeddings", 2048),
            rope_theta=float(hf.get("rope_theta", hf.get("rotary_emb_base", 10000.0))),
            norm_eps=float(hf.get("layer_norm_eps", 1e-5)),
            dtype=torch.bfloat16, attn_bias=True, proj_bias=True, norm="ln",
            parallel_residual=bool(hf.get("use_parallel_residual", True)),
            rotary_pct=float(hf.get("rotary_pct", 0.25)), ffn="mlp", act=act,
        )
    return TransformerConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        d_ff=hf["intermediate_size"],
        max_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        dtype=torch.bfloat16,
        n_experts=int(hf.get("num_local_experts", 0)) if mt == "mixtral" else 0,
        # Qwen2 ships QKV biases (older config.json files have no
        # attention_bias flag: the model type implies it).
        attn_bias=(mt == "qwen2") or bool(hf.get("attention_bias", False)),
        n_experts_active=int(hf.get("num_experts_per_tok", 2)),
        sliding_window=int(hf.get("sliding_window") or 0)
        if mt in ("mistral", "mixtral") else 0,
        head_dim_override=int(hf.get("head_dim", 0)) if mt == "gemma" else 0,
        act="gelu" if mt == "gemma" else "silu",
        norm_offset=(mt == "gemma"),
        embed_scale=(mt == "gemma"),
    )


class SafetensorsFile:
    """One ``.safetensors`` file, mapped: ``header`` (name → dtype, shape,
    data_offsets), ``get(name)`` a CPU tensor viewing the mapped bytes
    (copy it before the file is closed or rewritten)."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no header length)")
            (n,) = struct.unpack("<Q", head)
            self.header = json.loads(f.read(n))
            self._base = 8 + n
            # A private (copy-on-write) map: torch.frombuffer wants a
            # writable buffer, and nothing writes the file.
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.header.pop("__metadata__", None)
        for name, info in self.header.items():
            if info["dtype"] not in _DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r} has dtype {info['dtype']}; the port's "
                    f"safetensors reader takes {', '.join(_DTYPES)}"
                )

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            return torch.empty(info["shape"], dtype=dtype)
        t = torch.frombuffer(self._map, dtype=dtype, count=count, offset=self._base + start)
        return t.reshape(info["shape"])


class _TensorSource:
    """Name → tensor over every shard of a checkpoint directory."""

    def __init__(self, path: str) -> None:
        self._by_name: dict[str, SafetensorsFile] = {}
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        for fname in files:
            shard = SafetensorsFile(fname)
            for name in shard.keys():
                self._by_name[name] = shard

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def get(self, name: str) -> torch.Tensor:
        if name not in self._by_name:
            raise KeyError(f"checkpoint tensor {name!r} not found")
        return self._by_name[name].get(name)


# Config fields a checkpoint must agree on (the reference's list).
_MATCHED = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff",
            "n_experts", "n_experts_active", "attn_bias", "head_dim_override", "act",
            "norm_offset", "embed_scale", "norm", "parallel_residual", "rotary_pct",
            "ffn", "proj_bias", "pos_emb")


def _checked_config(path: str, cfg: Optional[TransformerConfig], logger: Any):
    """``cfg`` (default: ``config_from_hf``) held against the checkpoint's
    ``config.json`` with the reference's errors and warning."""
    file_cfg = (
        config_from_hf(path)
        if os.path.exists(os.path.join(path, "config.json"))
        else None
    )
    if cfg is None:
        cfg = file_cfg
    if cfg is None:
        raise ValueError(f"{path} has no config.json and no cfg was given")
    if file_cfg is not None:
        for field in _MATCHED:
            want, have = getattr(cfg, field), getattr(file_cfg, field)
            if want != have:
                raise ValueError(
                    f"checkpoint/config mismatch: {field}={have} in "
                    f"{path}/config.json but engine expects {want}"
                )
        if cfg.sliding_window != file_cfg.sliding_window and logger is not None:
            # Masking follows the engine's config (v0.2/v0.3 Mistral
            # checkpoints carry sliding_window: null).
            logger.warnf(
                "sliding_window mismatch: checkpoint %s declares %d, "
                "engine serves with %d (masking follows the engine "
                "config)", path, file_cfg.sliding_window,
                cfg.sliding_window,
            )
        if file_cfg.pos_emb == "learned" and cfg.max_len > file_cfg.max_len:
            raise ValueError(
                f"max_len={cfg.max_len} exceeds the checkpoint's learned "
                f"position table ({file_cfg.max_len} rows)"
            )
    return cfg


def load_hf_llama(
    path: str,
    cfg: Optional[TransformerConfig] = None,
    *,
    quant: str = "",
    mesh: Any = None,
    logger: Any = None,
    device: torch.device | str | None = None,
) -> dict:
    """An HF checkpoint of any of the seven model types → the port's
    parameter dict on ``device`` (CUDA unless ``"cpu"``), every leaf in
    ``cfg.dtype``; with ``quant`` (``"int8"``/``"int4"``) each matmul leaf
    quantized on the device as it lands, a layer at a time. ``cfg`` is held
    against the checkpoint's ``config.json`` (the reference's errors; a
    sliding-window difference only warns)."""
    if mesh is not None:
        raise NotImplementedError(
            "load_hf_llama(mesh=...): placing weights on a mesh is not ported "
            "yet (ROADMAP Queue 1 item 8: multi-device)"
        )
    cfg = _checked_config(path, cfg, logger)
    if quant and quant not in ("int8", "int4"):
        raise ValueError(f"unsupported quant {quant!r}")
    src = _TensorSource(path)
    device = resolve_device(device)
    dtype = cfg.dtype
    L, D, H, KV, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def get(name: str) -> torch.Tensor:
        # To the device as stored, then laid out there. On the CPU this is
        # still a view of the mapped file: every leaf below is filled into
        # storage of its own.
        return src.get(name).to(device)

    def land(w: torch.Tensor) -> torch.Tensor:
        return w.to(device).to(dtype)

    def leaf(shape: tuple, slices: Callable[[int], torch.Tensor], quantize: bool = True,
             lead: Optional[tuple] = None):
        """A stacked leaf of ``shape`` filled slice by slice: ``slices(i)``
        gives the ``[in, out]`` (or vector) slice at leading index ``i`` of
        ``lead`` (default: the layers)."""
        lead = lead or tuple((i,) for i in range(L))
        if quant and quantize:
            out = empty_quantized(quant, shape, device)
            for i in lead:
                quantize_into(out, i, land(slices(i)))
        else:
            out = torch.empty(shape, dtype=dtype, device=device)
            for i in lead:
                out[i] = land(slices(i))
        return out

    def whole(w: torch.Tensor, quantize: bool):
        if quant and quantize:
            return (quantize_array4 if quant == "int4" else quantize_array)(land(w))
        out = torch.empty(w.shape, dtype=dtype, device=device)
        out.copy_(w)
        return out

    def raw(fmt: str):
        """The layer's tensor as stored."""
        return lambda i: get(fmt.format(i[0]))

    def lin(*fmts: str):
        """The layer's HF [out, in] weights transposed and concatenated
        along the output axis."""
        return lambda i: torch.cat([get(f.format(i[0])).t() for f in fmts], dim=-1)

    qkv_out = (H + 2 * KV) * hd
    if "wte.weight" in src or "transformer.wte.weight" in src:
        # GPT-2: Conv1D weights are [in, out] already; c_attn packs q|k|v
        # along the output axis, the port's wqkv as it is.
        pre = "transformer." if "transformer.wte.weight" in src else ""
        lp = pre + "h.{}."
        params = {
            "embed": whole(get(pre + "wte.weight"), False),
            "attn_norm": leaf((L, D), raw(lp + "ln_1.weight"), False),
            "attn_norm_b": leaf((L, D), raw(lp + "ln_1.bias"), False),
            "wqkv": leaf((L, D, 3 * D), raw(lp + "attn.c_attn.weight")),
            "wqkv_b": leaf((L, 3 * D), raw(lp + "attn.c_attn.bias"), False),
            "wo": leaf((L, D, D), raw(lp + "attn.c_proj.weight")),
            "wo_b": leaf((L, D), raw(lp + "attn.c_proj.bias"), False),
            "mlp_norm": leaf((L, D), raw(lp + "ln_2.weight"), False),
            "mlp_norm_b": leaf((L, D), raw(lp + "ln_2.bias"), False),
            "w_up": leaf((L, D, cfg.d_ff), raw(lp + "mlp.c_fc.weight")),
            "w_up_b": leaf((L, cfg.d_ff), raw(lp + "mlp.c_fc.bias"), False),
            "w_down": leaf((L, cfg.d_ff, D), raw(lp + "mlp.c_proj.weight")),
            "w_down_b": leaf((L, D), raw(lp + "mlp.c_proj.bias"), False),
            "final_norm": whole(get(pre + "ln_f.weight"), False),
            "final_norm_b": whole(get(pre + "ln_f.bias"), False),
            # Tied by default; an untied fine-tune's own head wins.
            "lm_head": whole(get("lm_head.weight" if "lm_head.weight" in src
                                     else pre + "wte.weight").t(), True),
            "pos_embed": whole(get(pre + "wpe.weight"), False),
        }
        kind = "gpt2"
    elif "gpt_neox.embed_in.weight" in src:
        # GPT-NeoX/Pythia: query_key_value rows are (head, q|k|v, hd).
        lp = "gpt_neox.layers.{}."

        def qkv_w(i):
            w = get(lp.format(i[0]) + "attention.query_key_value.weight")
            w = w.reshape(H, 3, hd, D)
            return torch.cat([w[:, j].reshape(H * hd, D).t() for j in range(3)], dim=-1)

        def qkv_b(i):
            b = get(lp.format(i[0]) + "attention.query_key_value.bias").reshape(H, 3, hd)
            return torch.cat([b[:, j].reshape(H * hd) for j in range(3)])

        params = {
            "embed": whole(get("gpt_neox.embed_in.weight"), False),
            "attn_norm": leaf((L, D), raw(lp + "input_layernorm.weight"), False),
            "attn_norm_b": leaf((L, D), raw(lp + "input_layernorm.bias"), False),
            "wqkv": leaf((L, D, qkv_out), qkv_w),
            "wqkv_b": leaf((L, qkv_out), qkv_b, False),
            "wo": leaf((L, H * hd, D), lin(lp + "attention.dense.weight")),
            "wo_b": leaf((L, D), raw(lp + "attention.dense.bias"), False),
            "mlp_norm": leaf((L, D), raw(lp + "post_attention_layernorm.weight"), False),
            "mlp_norm_b": leaf((L, D), raw(lp + "post_attention_layernorm.bias"), False),
            "w_up": leaf((L, D, cfg.d_ff), lin(lp + "mlp.dense_h_to_4h.weight")),
            "w_up_b": leaf((L, cfg.d_ff), raw(lp + "mlp.dense_h_to_4h.bias"), False),
            "w_down": leaf((L, cfg.d_ff, D), lin(lp + "mlp.dense_4h_to_h.weight")),
            "w_down_b": leaf((L, D), raw(lp + "mlp.dense_4h_to_h.bias"), False),
            "final_norm": whole(get("gpt_neox.final_layer_norm.weight"), False),
            "final_norm_b": whole(get("gpt_neox.final_layer_norm.bias"), False),
            "lm_head": whole(get("embed_out.weight").t(), True),
        }
        kind = "gpt_neox"
    else:
        lp = "model.layers.{}."
        att = lp + "self_attn.{}_proj."
        params = {
            "embed": whole(get("model.embed_tokens.weight"), False),
            "attn_norm": leaf((L, D), raw(lp + "input_layernorm.weight"), False),
            "wqkv": leaf((L, D, qkv_out), lin(*(att.format("{}", p) + "weight"
                                                for p in "qkv"))),
            "wo": leaf((L, H * hd, D), lin(att.format("{}", "o") + "weight")),
            "mlp_norm": leaf((L, D), raw(lp + "post_attention_layernorm.weight"), False),
        }
        if cfg.attn_bias:
            params["wqkv_b"] = leaf((L, qkv_out), lambda i: torch.cat(
                [get(att.format(i[0], p) + "bias") for p in "qkv"]), False)
        Fd = cfg.d_ff
        if cfg.is_moe:
            E = cfg.n_experts
            moe = lp + "block_sparse_moe."
            ex = moe + "experts.{}.w{}.weight"  # Mixtral: w1 gate, w3 up, w2 down
            experts = tuple((i, e) for i in range(L) for e in range(E))
            params["router"] = leaf((L, D, E), lin(moe + "gate.weight"), False)
            params["w_gate_up"] = leaf(
                (L, E, D, 2 * Fd), lambda i: torch.cat(
                    [get(ex.format(i[0], i[1], w)).t() for w in (1, 3)], dim=-1),
                lead=experts)
            params["w_down"] = leaf((L, E, Fd, D), lambda i: get(
                ex.format(i[0], i[1], 2)).t(), lead=experts)
        else:
            mlp = lp + "mlp.{}_proj.weight"
            params["w_gate_up"] = leaf((L, D, 2 * Fd), lin(mlp.format("{}", "gate"),
                                                           mlp.format("{}", "up")))
            params["w_down"] = leaf((L, Fd, D), lin(mlp.format("{}", "down")))
        params["final_norm"] = whole(get("model.norm.weight"), False)
        head = ("lm_head.weight" if "lm_head.weight" in src
                else "model.embed_tokens.weight")  # tie_word_embeddings
        params["lm_head"] = whole(get(head).t(), True)
        kind = "llama"
    if logger is not None:
        logger.infof(
            "loaded HF %s checkpoint from %s (%d layers%s)",
            kind, path, cfg.n_layers, f", {quant}" if quant else "",
        )
    return params


def params_have_q8(params: dict) -> bool:
    return params_quant_mode(params) == "int8"
