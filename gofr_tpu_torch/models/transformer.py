"""The decoder-only transformer families of the reference — the port of
``gofr_tpu/models/transformer.py``: the training/eval forward, the
padded-batch serving prefill, chunked prefill and the split-softmax
decode step.

Parameters are a plain dict of tensors with the layer leaves stacked on
a leading ``[L, ...]`` axis, as in the reference pytree, except that the
Q/K/V projections are stored concatenated (``wqkv``, and their biases
``wqkv_b``) and so are gate/up (``w_gate_up``): one matmul each instead
of three and two, the same columns (``weights.params_from_jax`` builds
them from the reference). The large projections and ``lm_head`` are
``torch.matmul``; attention is ``ops/attention.py`` (the CUDA kernels on a
card). The KV cache — a slot cache or a paged pool, bf16 or int8
(``ops/kv_cache.py``) — is updated in place. Everything but the attention
kernels is plain differentiable torch; ``transformer_forward`` is what
training differentiates (``parallel/sharding.py``).

The reference's dense families all run through the same four forwards,
switched by the config as in the reference: Llama/Mistral (RMSNorm, RoPE,
GQA, SwiGLU, optional sliding window), Qwen2 (QKV bias), Gemma (explicit
head dim, GeGLU, ``(1 + w)`` RMSNorm, ``sqrt(d_model)``-scaled
embeddings), GPT-NeoX/Pythia (LayerNorm with bias, parallel residual,
partial rotary, a non-gated MLP, biases on every projection) and GPT-2
(learned positions instead of RoPE). Mixtral's MoE FFN (``_ffn_moe``)
replaces the dense FFN where ``n_experts > 0``. Every weight product goes
through ``_wein``, so a weight may be a plain tensor or an int8/int4
``ops/quant.py`` Q8/Q4. ``check_supported`` raises
``NotImplementedError`` for a config the kernels refuse.

Multi-LoRA, as in the reference: with ``{t}_lora_a`` [L, N, d_in, r] and
``{t}_lora_b`` [L, N, r, d_out] leaves in ``params`` (``init_lora``) and a
per-row adapter index ``aids`` (0 = base), every forward adds each
target projection's rank-r delta ``(x A[aid]) B[aid]`` to the product
before its bias (``_lora``). A fused projection (``wqkv``, ``w_gate_up``)
takes each target's delta on its slice of the output. MoE experts take
none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.attention import (
    attention,
    cache_chunk_attention,
    decode_attention,
    kernel_refusal,
)
from gofr_tpu_torch.ops.kv_cache import (
    KVCache,
    PagedKVCache,
    fake_quantize_kv,
    quantize_kv,
)
from gofr_tpu_torch.ops.norms import layer_norm, rms_norm
from gofr_tpu_torch.ops.quant import (
    QUANT_KEYS,
    Q4,
    Q8,
    dequantize,
    empty_quantized,
    quant_fn,
    quantize_into,
)
from gofr_tpu_torch.ops.rotary import rope_at, rope_frequencies, rotate

Rope = tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field for field the reference ``TransformerConfig``; ``dtype`` is a
    torch dtype."""

    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    n_experts: int = 0
    n_experts_active: int = 2
    attn_bias: bool = False
    head_dim_override: int = 0
    act: str = "silu"
    norm_offset: bool = False
    embed_scale: bool = False
    norm: str = "rms"
    parallel_residual: bool = False
    rotary_pct: float = 1.0
    ffn: str = "swiglu"
    proj_bias: bool = False
    pos_emb: str = "rope"
    sliding_window: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def rope_dims(self) -> int:
        nd = int(self.head_dim * self.rotary_pct)
        return nd - (nd % 2)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def check_supported(cfg: TransformerConfig,
                    device: torch.device | str | None = None) -> None:
    """Raise ``NotImplementedError`` for a config this port does not serve:
    a dtype other than bf16/f32, or, unless ``device`` is the CPU (whose
    plain versions take any shape), an attention shape that one of the
    three kernels refuses (``ops.attention.kernel_refusal``), so that no
    config passes here and then raises at its first launch on a card.
    ``device`` None is the port's default, the card."""
    if cfg.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"dtype {cfg.dtype} (bf16 or f32 only)")
    if device is not None and torch.device(device).type == "cpu":
        return
    refusal = kernel_refusal(cfg.head_dim, cfg.n_heads, cfg.n_kv_heads)
    if refusal:
        raise NotImplementedError(refusal)


def init_params(
    cfg: TransformerConfig, seed: int, device: torch.device | str | None = None,
    quant: str = "",
) -> dict:
    """Random parameters made on ``device`` (CUDA unless ``"cpu"``; without
    CUDA that raises) from ``seed`` with a ``torch.Generator`` on that
    device (an 8B model is never built on the host): every leaf the
    reference's ``init_transformer`` makes for ``cfg``, normal with std
    fan_in**-0.5 for the projections, the MoE router and experts and the
    learned positions, the norm weights at identity (ones, or zeros where
    the norm applies ``1 + w``), zeros for every bias.

    With ``quant`` (``"int8"``/``"int4"``, the reference's
    ``_init_llm_quantized``) every ``QUANT_KEYS`` leaf is made one layer at
    a time in ``cfg.dtype`` and quantized into its preallocated stacked
    Q8/Q4, so the peak is the quantized tree plus one layer's slice of one
    leaf: Mixtral-8x7B would be 93 GB in bf16, its fused gate|up leaf
    alone 60 GB. A layer-at-a-time quantize is exact (the scales reduce only the
    contraction axis); the random draws are not those of the plain init."""
    check_supported(cfg, device)
    if quant:
        quant_fn(quant)  # the reference's ValueError for any other mode
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, H, KV, hd, Fd, L, E = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
        cfg.n_layers, cfg.n_experts,
    )

    def normal(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        return w.normal_(0.0, fan_in**-0.5, generator=gen)

    def dense(name: str, shape: tuple, fan_in: int):
        if not quant or name not in QUANT_KEYS:
            return normal(shape, fan_in)
        out = empty_quantized(quant, shape, device)
        if len(shape) == 2:  # lm_head: no layer axis
            quantize_into(out, (), normal(shape, fan_in))
        else:
            for layer in range(shape[0]):
                quantize_into(out, layer, normal(shape[1:], fan_in))
        return out

    def const(shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    norm_w = 0.0 if cfg.norm_offset else 1.0
    params = {
        "embed": dense("embed", (cfg.vocab_size, D), D),
        "attn_norm": const((L, D), norm_w),
        "wqkv": dense("wqkv", (L, D, (H + 2 * KV) * hd), D),
        "wo": dense("wo", (L, H * hd, D), H * hd),
        "mlp_norm": const((L, D), norm_w),
    }
    if cfg.is_moe:
        params["router"] = dense("router", (L, D, E), D)
        params["w_gate_up"] = dense("w_gate_up", (L, E, D, 2 * Fd), D)
        params["w_down"] = dense("w_down", (L, E, Fd, D), Fd)
    else:
        if cfg.ffn == "mlp":
            params["w_up"] = dense("w_up", (L, D, Fd), D)
        else:
            params["w_gate_up"] = dense("w_gate_up", (L, D, 2 * Fd), D)
        params["w_down"] = dense("w_down", (L, Fd, D), Fd)
    params["final_norm"] = const((D,), norm_w)
    params["lm_head"] = dense("lm_head", (D, cfg.vocab_size), D)
    if cfg.norm == "ln":
        params.update(attn_norm_b=const((L, D), 0.0), mlp_norm_b=const((L, D), 0.0),
                      final_norm_b=const((D,), 0.0))
    if cfg.proj_bias:
        params.update(wo_b=const((L, D), 0.0), w_up_b=const((L, Fd), 0.0),
                      w_down_b=const((L, D), 0.0))
    if cfg.attn_bias:
        params["wqkv_b"] = const((L, (H + 2 * KV) * hd), 0.0)
    if cfg.pos_emb == "learned":
        params["pos_embed"] = dense("pos_embed", (cfg.max_len, D), D)
    return params


def rope_tables(
    cfg: TransformerConfig, max_len: int, device: torch.device | str
) -> Rope:
    """The (cos, sin) tables for a cache of ``max_len`` positions."""
    return rope_frequencies(cfg.rope_dims, max_len, cfg.rope_theta, device)


def _rope_at(cfg: TransformerConfig, rope: Optional[Rope], table_len: int,
             positions: torch.Tensor) -> Optional[Rope]:
    """The RoPE tables (``rope``, or built for ``table_len`` positions)
    gathered at ``positions`` [b, s] -> [b, s, 1, nd/2] each; None for a
    config without RoPE (learned positions)."""
    if cfg.pos_emb != "rope":
        return None
    cos, sin = rope if rope is not None else rope_tables(cfg, table_len, positions.device)
    return rope_at(cos, sin, positions)


def _leaf(params: dict, name: str, layer: Optional[int] = None):
    """``params[name]`` (its ``layer`` row), or None for a leaf the config
    does not have (the biases, the learned positions)."""
    t = params.get(name)
    return t if t is None or layer is None else t[layer]


def _norm(x: torch.Tensor, params: dict, name: str, layer: Optional[int],
          cfg: TransformerConfig) -> torch.Tensor:
    """The config's norm with weight ``name`` (and bias ``name_b``):
    LayerNorm, or RMSNorm with Gemma's ``1 + w``."""
    w = _leaf(params, name, layer)
    if cfg.norm == "ln":
        return layer_norm(x, w, _leaf(params, name + "_b", layer), cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps, 1.0 if cfg.norm_offset else 0.0)


def _act(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The FFN activation: tanh-approximate gelu (``"gelu"``, Gemma and
    GPT-2), erf gelu (``"gelu_exact"``, GPT-NeoX), else silu."""
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    if cfg.act == "gelu_exact":
        return F.gelu(x)
    return F.silu(x)


def _embed(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings; Gemma's times ``sqrt(d_model)`` rounded to the
    activation dtype first (55.5 in bf16, as the reference), GPT-2's plus
    the learned position rows at ``positions`` (clipped to the table)."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=x.dtype))
    if cfg.pos_emb == "learned":
        table = params["pos_embed"]
        x = x + table[positions.clamp(0, table.shape[0] - 1)]
    return x


def _wein(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where the weight may be quantized, the reference's
    ``_wein``: a Q8 multiplies by its int8 values cast to ``x``'s dtype
    (exact: |q| <= 127) and applies the f32 column scales to the product
    (they commute with the contraction), rounding back to ``x``'s dtype; a
    Q4's group scales do not commute, so it multiplies by the dequantized
    weight. ``w`` contracts its second-to-last axis and broadcasts as
    ``torch.matmul`` does (an [E, D, F] expert stack gives [E, N, F]). A
    plain matrix product (the reference leaves these to XLA)."""
    if isinstance(w, Q8):
        return ((x @ w.q.to(x.dtype)) * w.s).to(x.dtype)
    if isinstance(w, Q4):
        return x @ dequantize(w, x.dtype)
    return x @ w


# Projections LoRA can target (MoE expert weights excluded: per-token
# routing x per-slot adapters would need a double gather; out of scope).
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def lora_dims(cfg: TransformerConfig, target: str) -> tuple[int, int]:
    """(d_in, d_out) of a LoRA-targetable projection."""
    D, Fd = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": (D, H * hd),
        "wk": (D, KV * hd),
        "wv": (D, KV * hd),
        "wo": (H * hd, D),
        "w_gate": (D, Fd),
        "w_up": (D, Fd),
        "w_down": (Fd, D),
    }[target]


def init_lora(
    cfg: TransformerConfig,
    n_adapters: int,
    rank: int,
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo"),
    device: torch.device | str | None = None,
) -> dict:
    """Zero LoRA leaves to merge into ``params``, the reference's layout:
    ``{t}_lora_a`` [L, N, d_in, r] and ``{t}_lora_b`` [L, N, r, d_out] in
    ``cfg.dtype`` on ``device`` (CUDA unless ``"cpu"``), layer-major like
    every stacked leaf and adapter slot second, so a per-row gather
    ``a[layer][aids]`` batches every live adapter into one product. All
    zero: every slot, and slot 0 (requests without an adapter) in
    particular, is an exact no-op on the base model."""
    if cfg.is_moe:
        raise ValueError("LoRA serving does not support MoE models")
    device = resolve_device(device)
    leaves = {}
    for t in targets:
        if t not in LORA_TARGETS:
            raise ValueError(f"unknown LoRA target {t!r} (of {LORA_TARGETS})")
        d_in, d_out = lora_dims(cfg, t)
        leaves[t + "_lora_a"] = torch.zeros(
            (cfg.n_layers, n_adapters, d_in, rank), dtype=cfg.dtype, device=device
        )
        leaves[t + "_lora_b"] = torch.zeros(
            (cfg.n_layers, n_adapters, rank, d_out), dtype=cfg.dtype, device=device
        )
    return leaves


def _lora(x: torch.Tensor, params: dict, name: str, layer: int,
          aids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The per-row LoRA delta of projection ``name`` on x [b, t, d_in]
    (row i under adapter ``aids[i]``): ``(x A) B`` as two batched
    products in x's dtype, the reference's two einsums; None where the
    params hold no leaf for ``name`` or there is no adapter plane."""
    a = params.get(name + "_lora_a")
    if aids is None or a is None:
        return None
    return torch.bmm(torch.bmm(x, a[layer][aids]), params[name + "_lora_b"][layer][aids])


def _plus(y: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    return y if delta is None else y + delta


def _qkv(
    h: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
    cs: Optional[Rope], aids: Optional[torch.Tensor] = None,
):
    """Project (plus each target's LoRA delta on its slice, then Qwen2's
    QKV bias, before RoPE) and rotate: h [P, s, D] → q [P, s, H, hd], k
    and v [P, s, KV, hd], contiguous. Q and K heads rotate in one call
    with the tables ``cs`` already gathered at the step's positions (None:
    no rotation)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = _wein(h, params["wqkv"][layer])
    deltas = [_lora(h, params, t, layer, aids) for t in ("wq", "wk", "wv")]
    if any(d is not None for d in deltas):
        parts = qkv.split([H * hd, KV * hd, KV * hd], dim=-1)
        qkv = torch.cat([_plus(p, d) for p, d in zip(parts, deltas)], dim=-1)
    bias = _leaf(params, "wqkv_b", layer)
    if bias is not None:
        qkv = qkv + bias
    qk, v = qkv.reshape(*h.shape[:-1], H + 2 * KV, hd).split([H + KV, KV], dim=-2)
    if cs is not None:
        qk = rotate(qk, *cs)
    q, k = qk.split([H, KV], dim=-2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _ffn(h: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
         aids: Optional[torch.Tensor] = None):
    """The FFN on the normed ``h``: gated ``act(h W_gate) * (h W_up)``
    (SwiGLU, GeGLU), GPT-NeoX/GPT-2's ``act(h W_up + b) W_down + b``, or
    the MoE FFN (``_ffn_moe``, which takes no adapter). Each product takes
    its LoRA delta before its bias."""
    if cfg.is_moe:
        return _ffn_moe(h, params, layer, cfg)
    if cfg.ffn == "mlp":
        u = _plus(_wein(h, params["w_up"][layer]), _lora(h, params, "w_up", layer, aids))
        bias = _leaf(params, "w_up_b", layer)
        if bias is not None:
            u = u + bias
        u = _act(u, cfg)
        out = _plus(_wein(u, params["w_down"][layer]), _lora(u, params, "w_down", layer, aids))
        bias = _leaf(params, "w_down_b", layer)
        return out if bias is None else out + bias
    gate, up = _wein(h, params["w_gate_up"][layer]).chunk(2, dim=-1)
    gate = _plus(gate, _lora(h, params, "w_gate", layer, aids))
    up = _plus(up, _lora(h, params, "w_up", layer, aids))
    g = _act(gate, cfg) * up
    return _plus(_wein(g, params["w_down"][layer]), _lora(g, params, "w_down", layer, aids))


def route(x: torch.Tensor, router, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE router, the reference's: logits ``x @ router`` in the model
    dtype, then f32; softmax; the top ``k`` renormalised to sum to 1. Ties
    break as ``jax.lax.top_k`` breaks them, lowest expert first (a stable
    descending sort; ``torch.topk`` may pick another of equal
    probabilities, and bf16 logits tie often). x [N, D] → (weights [N, E]
    f32, zero but at the chosen experts; the chosen experts [N, k])."""
    probs = torch.softmax(_wein(x, router).float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, top_i, top_p), top_i


def _ffn_moe(h: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig):
    """Top-k MoE FFN, the reference's dense formulation: every expert
    computes every token (gate|up fused per expert: [E, N, 2F]),
    ``act(gate) * up`` then ``w_down`` ([E, N, D]), summed over the experts
    with the routing weights cast to the activation dtype as one
    contraction (the products are not rounded one by one). Routing each
    token to its own experts only is a speed change (ROADMAP Queue 2)."""
    x = h.reshape(-1, h.shape[-1])
    weights, _ = route(x, params["router"][layer], cfg.n_experts_active)
    gate, up = _wein(x, params["w_gate_up"][layer]).chunk(2, dim=-1)
    out = _wein(_act(gate, cfg) * up, params["w_down"][layer])  # [E, N, D]
    return torch.einsum("end,ne->nd", out, weights.to(x.dtype)).reshape(h.shape)


def _layer(x: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
           cs: Optional[Rope], attend, aids: Optional[torch.Tensor] = None):
    """One decoder layer around ``attend(q, k, v) -> (attn [..., H, hd],
    k, v)``, which may write or transform k and v and returns the pair the
    caller keeps. The MLP reads ``x + attn_out`` (sequential) or ``x``
    itself (GPT-NeoX's parallel residual). ``aids`` [b] selects each row's
    LoRA adapter. Returns (x, (k, v))."""
    h = _norm(x, params, "attn_norm", layer, cfg)
    q, k, v = _qkv(h, params, layer, cfg, cs, aids)
    attn, k, v = attend(q, k, v)
    ao = attn.reshape(*x.shape[:-1], -1)
    attn_out = _plus(_wein(ao, params["wo"][layer]), _lora(ao, params, "wo", layer, aids))
    bias = _leaf(params, "wo_b", layer)
    if bias is not None:
        attn_out = attn_out + bias
    mlp_in = x if cfg.parallel_residual else x + attn_out
    ffn = _ffn(_norm(mlp_in, params, "mlp_norm", layer, cfg), params, layer, cfg, aids)
    x = x + attn_out + ffn if cfg.parallel_residual else mlp_in + ffn
    return x, (k, v)


def _logits(x: torch.Tensor, params: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Final norm and ``lm_head``: f32 logits."""
    return _wein(_norm(x, params, "final_norm", None, cfg), params["lm_head"]).float()


# Leaves stacked on a leading [L, ...] layer axis (those of the config).
_LAYER_LEAVES = (
    "attn_norm", "attn_norm_b", "wqkv", "wqkv_b", "wo", "wo_b", "mlp_norm",
    "mlp_norm_b", "w_gate_up", "w_up", "w_up_b", "w_down", "w_down_b", "router",
)
# The LoRA leaves' name endings (also stacked [L, ...]).
_LORA_SUFFIXES = ("_lora_a", "_lora_b")


def _per_layer(params: dict) -> dict:
    """``params`` with each stacked leaf unbound into a tuple of per-layer
    views (``p[name][layer]`` reads the same): one ``unbind`` per leaf, so
    autograd stacks a leaf's layer gradients once instead of scattering
    each into a full-size zero tensor."""
    return {k: v.unbind(0) if (k in _LAYER_LEAVES or k.endswith(_LORA_SUFFIXES))
            and isinstance(v, torch.Tensor) else v
            for k, v in params.items()}


def _layer_prefill(
    x: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
    cs: Optional[Rope], *,
    lengths: Optional[torch.Tensor] = None, dense_attn: bool = False,
    aids: Optional[torch.Tensor] = None,
):
    """One decoder layer over a full sequence, the counterpart of
    ``_layer_prefill``: x [b, s, D] → (x, (k, v)) with k, v [b, s, KV, hd].
    ``lengths`` (right-padded serving prefill) keeps the kernel path."""

    def attend(q, k, v):
        return attention(q, k, v, causal=True, lengths=lengths,
                         kernel=not dense_attn, window=cfg.sliding_window), k, v

    return _layer(x, params, layer, cfg, cs, attend, aids)


def transformer_forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    remat: bool = False,
    *,
    dense_attn: bool = False,
    aids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Training/eval forward: tokens [b, s] → logits [b, s, vocab] (f32),
    the counterpart of ``transformer_forward``. Attention runs the
    flash_attention kernel under ``FlashAttentionFn`` (``dense_attn``: the
    dense formula). ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` per layer).
    ``aids`` [b]: each row's LoRA adapter slot."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    cs = _rope_at(cfg, None, s, positions)
    lp = _per_layer(params)

    def body(x: torch.Tensor, layer: int) -> torch.Tensor:
        return _layer_prefill(x, lp, layer, cfg, cs, dense_attn=dense_attn, aids=aids)[0]

    x = _embed(params, tokens, cfg, positions)
    for layer in range(cfg.n_layers):
        if remat:
            x = checkpoint(body, x, layer, use_reentrant=False)
        else:
            x = body(x, layer)
    return _logits(x, params, cfg)


@torch.no_grad()
def transformer_prefill(
    params: dict,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    cache: KVCache,
    slots: torch.Tensor,
    cfg: TransformerConfig,
    *,
    dense_attn: bool = False,
    aids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Serving prefill of a right-padded prompt batch, the counterpart of
    ``transformer_prefill``: tokens [b, s_pad]; lengths [b] true lengths;
    slots [b] cache slots. Attention goes to the flash_attention kernel
    with per-row key ``lengths``. Each layer writes its K/V for all s_pad
    positions into the row's slot and zeros the rest of the slot, as the
    reference's padded ``.at[:, slots].set``; ``cache.lengths[slots]``
    becomes ``lengths``. An int8 cache takes the quantized K/V and their
    scales (the zeroed rest of the row gets scale 1, as the reference's
    quantized zero padding). Returns [b, vocab] f32 logits at each row's
    last valid token. ``aids`` [b]: each row's LoRA adapter slot. Slot
    cache only, as in the reference."""
    if not isinstance(cache, KVCache):
        raise TypeError("transformer_prefill writes a slot cache (KVCache)")
    b, s = tokens.shape
    dev = tokens.device
    lengths = lengths.to(torch.int32)
    positions = torch.arange(s, device=dev)[None, :]
    cs = _rope_at(cfg, None, cache.max_len, positions)
    sl = slots.long()
    x = _embed(params, tokens, cfg, positions)
    for layer in range(cfg.n_layers):
        x, (k, v) = _layer_prefill(x, params, layer, cfg, cs, lengths=lengths,
                                   dense_attn=dense_attn, aids=aids)
        for buf, sc, new in ((cache.k, cache.k_s, k), (cache.v, cache.v_s, v)):
            new = new.transpose(1, 2)  # [b, KV, s, hd]
            if sc is not None:
                new, new_sc = quantize_kv(new)
                sc[layer, sl, :, :s] = new_sc
                sc[layer, sl, :, s:] = 1
            buf[layer, sl, :, :s] = new.to(buf.dtype)
            buf[layer, sl, :, s:] = 0
    cache.lengths[sl] = lengths
    last = (lengths.long() - 1).clamp(min=0)
    return _logits(x[torch.arange(b, device=dev), last], params, cfg)  # [b, vocab]


def prefill_chunk(
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache | PagedKVCache,
    slots: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    rope: Optional[Rope] = None,
    dense_attn: bool = False,
    aids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked serving prefill: one fixed-shape [P, c] chunk step, the
    counterpart of ``transformer_prefill_chunk``.

    tokens: [P, c] (right-padded per row); slots/starts/lens: [P] int32 —
    cache slot, global position of the chunk's first token, valid tokens.
    Each layer writes the chunk's K/V into the cache first (quantized, in
    int8 mode; through the rows' table entries, in a pool), then attends
    the cache in place. Padding columns (t >= lens) park their writes at
    ``max_len - 1`` of their slot (a pool: block 0, offset ``block - 1``),
    a position no live query reads. Returns [P, vocab] f32 logits at each
    row's last valid token. ``cache.lengths`` is not updated here (the
    engine sets it when a prompt's last chunk lands). ``aids`` [P]: each
    row's LoRA adapter slot.
    """
    P, c = tokens.shape
    KV = cfg.n_kv_heads
    max_len = cache.max_len
    dev = tokens.device
    t = torch.arange(c, device=dev)
    positions = starts.long()[:, None] + t[None, :]  # [P, c] global
    valid = t[None, :] < lens.long()[:, None]
    rope_pos = positions.clamp(max=max_len - 1)
    if isinstance(cache, PagedKVCache):
        B, table = cache.block, cache.block_table
        rows = table[slots.long()].long().gather(
            1, rope_pos // B
        )  # [P, c] pool block of each position
        idx = (
            torch.where(valid, rows, 0)[:, None, :],
            torch.arange(KV, device=dev)[None, :, None],
            torch.where(valid, positions % B, B - 1)[:, None, :],
        )  # broadcast to [P, KV, c]
    else:
        table = None
        idx = (
            slots.long()[:, None, None],
            torch.arange(KV, device=dev)[None, :, None],
            torch.where(valid, positions, max_len - 1)[:, None, :],
        )
    cs = _rope_at(cfg, rope, max_len, rope_pos)
    x = _embed(params, tokens, cfg, positions)  # [P, c, D]
    for layer in range(cfg.n_layers):
        ck, cv = cache.k[layer], cache.v[layer]  # [rows, KV, len, hd] views
        cks = cvs = None
        if cache.quantized:
            cks, cvs = cache.k_s[layer], cache.v_s[layer]

        def attend(q, k, v):
            k, v = k.transpose(1, 2), v.transpose(1, 2)  # [P, KV, c, hd]
            if cache.quantized:
                k, k_sc = quantize_kv(k)
                v, v_sc = quantize_kv(v)
                cks.index_put_(idx, k_sc)
                cvs.index_put_(idx, v_sc)
            ck.index_put_(idx, k)
            cv.index_put_(idx, v)
            return cache_chunk_attention(
                q, ck, cv, slots, starts, lens, k_scale=cks, v_scale=cvs,
                block_table=table, kernel=not dense_attn,
                window=cfg.sliding_window,
            ), k, v

        x = _layer(x, params, layer, cfg, cs, attend, aids)[0]
    last = (lens.long() - 1).clamp(min=0)
    return _logits(x[torch.arange(P, device=dev), last], params, cfg)  # [P, vocab]


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache | PagedKVCache,
    active: torch.Tensor,
    cfg: TransformerConfig,
    *,
    rope: Optional[Rope] = None,
    dense_attn: bool = False,
    aids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step over all cache slots, the counterpart of
    ``transformer_decode_step``.

    tokens: [S] current token per slot; active: [S] bool. The cache stays
    read-only inside the layer loop: each layer attends the cache prefix
    plus its fresh (k, v) through the split softmax, and one scatter after
    the loop commits every layer's token. In int8 mode the fresh K/V are
    fake-quantized before they are attended, so what is attended is what
    later steps read back, and quantized at the commit. Inactive slots
    park that write at ``max_len - 1`` (a pool: block 0, offset
    ``block - 1``; a slot mid-prefill must not have its fresh K/V at
    ``lengths`` overwritten) and keep their length, and so does an active
    slot whose cache is full (``lengths == max_len``: a mega window keeps
    stepping a slot whose budget ran out while others continue, where the
    reference's scatter drops the out-of-range update). Returns [S, vocab]
    f32 logits; ``cache.lengths`` grows by one on active slots below
    ``max_len``. ``aids`` [S]: each slot's LoRA adapter slot.
    """
    S = cache.n_slots
    KV = cfg.n_kv_heads
    max_len = cache.max_len
    dev = tokens.device
    lengths = cache.lengths
    positions = lengths.long().clamp(max=max_len - 1)  # [S]
    cs = _rope_at(cfg, rope, max_len, positions[:, None])
    paged = isinstance(cache, PagedKVCache)
    table = cache.block_table if paged else None
    # One token per slot: [S, 1, D]; learned positions at the unclamped
    # lengths, as the reference (clipped to the table).
    x = _embed(params, tokens, cfg, lengths.long())[:, None]
    new_k, new_v = [], []
    for layer in range(cfg.n_layers):
        scales = {}
        if cache.quantized:
            scales = dict(k_scale=cache.k_s[layer], v_scale=cache.v_s[layer])

        def attend(q, k, v):
            q, k, v = q[:, 0], k[:, 0], v[:, 0]
            if cache.quantized:
                k, v = fake_quantize_kv(k), fake_quantize_kv(v)
            return decode_attention(
                q, cache.k[layer], cache.v[layer], lengths, k_new=k, v_new=v,
                block_table=table, kernel=not dense_attn,
                window=cfg.sliding_window, **scales,
            ), k, v

        x, (k, v) = _layer(x, params, layer, cfg, cs, attend, aids)
        new_k.append(k)
        new_v.append(v)
    # Commit every layer's token in one scatter: [L, S, KV, hd] values at
    # [l, s, kv, write_pos[s]] (a pool: [l, table[s, pos // B], kv, pos % B]).
    write = active & (lengths < max_len)
    if paged:
        B = cache.block
        blk = table.gather(1, (positions // B)[:, None])[:, 0].long()
        row = torch.where(write, blk, 0)
        write_pos = torch.where(write, positions % B, B - 1)
    else:
        row = torch.arange(S, device=dev)
        write_pos = torch.where(write, lengths, max_len - 1).long()
    idx = (
        torch.arange(cfg.n_layers, device=dev)[:, None, None],
        row[None, :, None],
        torch.arange(KV, device=dev)[None, None, :],
        write_pos[None, :, None],
    )
    k_all, v_all = torch.stack(new_k), torch.stack(new_v)
    if cache.quantized:
        k_all, k_sc = quantize_kv(k_all)
        v_all, v_sc = quantize_kv(v_all)
        cache.k_s.index_put_(idx, k_sc)
        cache.v_s.index_put_(idx, v_sc)
    cache.k.index_put_(idx, k_all)
    cache.v.index_put_(idx, v_all)
    cache.lengths += write.to(torch.int32)
    return _logits(x[:, 0], params, cfg)


def ngram_draft(
    history: torch.Tensor,
    lengths: torch.Tensor,
    current: torch.Tensor,
    n_draft: int,
) -> torch.Tensor:
    """Prompt-lookup drafting, the counterpart of the reference's
    ``ngram_draft``: continue the most recent prior occurrence of the
    current context in the slot's own token history.

    history: [S, max_len] (prompt and generated tokens; entries past
    lengths+1 are stale); lengths: [S] tokens in history BEFORE current;
    current: [S] the token about to be fed to the model (at
    history[lengths]). Matches the bigram (history[p-1], history[p]) ==
    (previous, current), a unigram match when the context has fewer than
    2 tokens, at positions strictly before ``lengths``, and drafts
    ``history[p+1 : p+1+n_draft]`` of the last match p. No match repeats
    ``current``. Returns [S, n_draft] of history's dtype. Static shapes
    only (gather and where), so it runs inside a captured graph."""
    S, T = history.shape
    lengths = lengths.long()
    pos = torch.arange(T, device=history.device)[None, :]  # [1, T]
    prev_idx = (lengths - 1).clamp(min=0)
    prev = history.gather(1, prev_idx[:, None])[:, 0]
    hist_prev = torch.cat(
        [torch.zeros((S, 1), dtype=history.dtype, device=history.device),
         history[:, :-1]], dim=1,
    )
    m1 = history == current[:, None]
    m2 = m1 & (hist_prev == prev[:, None])
    match = torch.where((lengths >= 2)[:, None], m2, m1)
    match = match & (pos < lengths[:, None])
    p_star = torch.where(match, pos, -1).amax(dim=1)  # [S]
    gidx = (
        p_star[:, None] + 1 + torch.arange(n_draft, device=history.device)[None, :]
    ).clamp(0, T - 1)
    draft = history.gather(1, gidx)
    return torch.where((p_star >= 0)[:, None], draft, current[:, None].to(history.dtype))
