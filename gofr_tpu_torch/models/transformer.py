"""Llama-family decoder-only transformer — the port of
``gofr_tpu/models/transformer.py``: the training/eval forward, the
padded-batch serving prefill, chunked prefill and the split-softmax
decode step.

Parameters are a plain dict of tensors with the layer leaves stacked on
a leading ``[L, ...]`` axis, as in the reference pytree, except that the
Q/K/V projections are stored concatenated (``wqkv``) and so are gate/up
(``w_gate_up``): one matmul each instead of three and two, the same
columns (``weights.params_from_jax`` builds them from the reference).
The large projections and ``lm_head`` are ``torch.matmul``; attention is
``ops/attention.py`` (the CUDA kernels on a card). The KV cache — a slot
cache or a paged pool, bf16 or int8 (``ops/kv_cache.py``) — is updated
in place. Everything but the attention kernels is plain
differentiable torch; ``transformer_forward`` is what training
differentiates (``parallel/sharding.py``).

This slice runs the Llama path only: RMSNorm, RoPE, GQA, SwiGLU, no
biases, no MoE, with or without Mistral's sliding window (every attention
call takes ``cfg.sliding_window``; the cache keeps every position, the
window is a mask). ``check_supported`` raises ``NotImplementedError`` for
a config that needs anything else.
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
)
from gofr_tpu_torch.ops.kv_cache import (
    KVCache,
    PagedKVCache,
    fake_quantize_kv,
    quantize_kv,
)
from gofr_tpu_torch.ops.norms import rms_norm
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


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is on the Llama path
    this slice ports."""
    unported = {
        "n_experts (MoE)": cfg.n_experts != 0,
        "attn_bias": cfg.attn_bias,
        "head_dim_override": cfg.head_dim_override != 0,
        f"act={cfg.act!r}": cfg.act != "silu",
        "norm_offset": cfg.norm_offset,
        "embed_scale": cfg.embed_scale,
        f"norm={cfg.norm!r}": cfg.norm != "rms",
        "parallel_residual": cfg.parallel_residual,
        f"rotary_pct={cfg.rotary_pct}": cfg.rotary_pct != 1.0,
        f"ffn={cfg.ffn!r}": cfg.ffn != "swiglu",
        "proj_bias": cfg.proj_bias,
        f"pos_emb={cfg.pos_emb!r}": cfg.pos_emb != "rope",
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(
            "the torch port serves the Llama path only (RMSNorm, RoPE, GQA, "
            "SwiGLU, optional sliding window); this config needs "
            f"{', '.join(missing)} (ROADMAP: other families)"
        )
    if cfg.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"dtype {cfg.dtype} (bf16 or f32 only)")


def init_params(
    cfg: TransformerConfig, seed: int, device: torch.device | str | None = None
) -> dict[str, torch.Tensor]:
    """Random parameters made on ``device`` (CUDA unless ``"cpu"``; without
    CUDA that raises) from ``seed`` with a ``torch.Generator`` on that
    device (an 8B model is never built on the host): normal with std
    fan_in**-0.5 for the projections, ones for the norm weights, as the
    reference's ``init_transformer``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, H, KV, hd, Fd, L = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
        cfg.n_layers,
    )

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        return w.normal_(0.0, fan_in**-0.5, generator=gen)

    return {
        "embed": dense((cfg.vocab_size, D), D),
        "attn_norm": torch.ones((L, D), dtype=cfg.dtype, device=device),
        "wqkv": dense((L, D, (H + 2 * KV) * hd), D),
        "wo": dense((L, H * hd, D), H * hd),
        "mlp_norm": torch.ones((L, D), dtype=cfg.dtype, device=device),
        "w_gate_up": dense((L, D, 2 * Fd), D),
        "w_down": dense((L, Fd, D), Fd),
        "final_norm": torch.ones((D,), dtype=cfg.dtype, device=device),
        "lm_head": dense((D, cfg.vocab_size), D),
    }


def rope_tables(
    cfg: TransformerConfig, max_len: int, device: torch.device | str
) -> Rope:
    """The (cos, sin) tables for a cache of ``max_len`` positions."""
    return rope_frequencies(cfg.rope_dims, max_len, cfg.rope_theta, device)


def _qkv(
    h: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
    cs: tuple[torch.Tensor, torch.Tensor],
):
    """Project and rotate: h [P, s, D] → q [P, s, H, hd], k and v
    [P, s, KV, hd], contiguous. Q and K heads rotate in one call with the
    tables ``cs`` already gathered at the step's positions."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = h @ params["wqkv"][layer]
    qk, v = qkv.split([(H + KV) * hd, KV * hd], dim=-1)
    lead = h.shape[:-1]
    qk = rotate(qk.reshape(*lead, H + KV, hd), *cs)
    q, k = qk.split([H, KV], dim=-2)
    return q.contiguous(), k.contiguous(), v.reshape(*lead, KV, hd).contiguous()


def _ffn(x: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig):
    h = rms_norm(x, params["mlp_norm"][layer], cfg.norm_eps)
    gate, up = (h @ params["w_gate_up"][layer]).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ params["w_down"][layer]


# Leaves stacked on a leading [L, ...] layer axis.
_LAYER_LEAVES = ("attn_norm", "wqkv", "wo", "mlp_norm", "w_gate_up", "w_down")


def _per_layer(params: dict) -> dict:
    """``params`` with each stacked leaf unbound into a tuple of per-layer
    views (``p[name][layer]`` reads the same): one ``unbind`` per leaf, so
    autograd stacks a leaf's layer gradients once instead of scattering
    each into a full-size zero tensor."""
    return {k: v.unbind(0) if k in _LAYER_LEAVES else v for k, v in params.items()}


def _layer_prefill(
    x: torch.Tensor, params: dict, layer: int, cfg: TransformerConfig,
    cs: tuple[torch.Tensor, torch.Tensor], *,
    lengths: Optional[torch.Tensor] = None, dense_attn: bool = False,
):
    """One decoder layer over a full sequence, the counterpart of
    ``_layer_prefill``: x [b, s, D] → (x, (k, v)) with k, v [b, s, KV, hd].
    ``lengths`` (right-padded serving prefill) keeps the kernel path."""
    b, s, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
    q, k, v = _qkv(h, params, layer, cfg, cs)
    attn = attention(q, k, v, causal=True, lengths=lengths,
                     kernel=not dense_attn, window=cfg.sliding_window)
    x = x + attn.reshape(b, s, H * hd) @ params["wo"][layer]
    return x + _ffn(x, params, layer, cfg), (k, v)


def _positions_rope(cfg: TransformerConfig, s: int, table_len: int,
                    dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables of ``table_len`` positions gathered at 0..s-1."""
    cos, sin = rope_tables(cfg, table_len, dev)
    return rope_at(cos, sin, torch.arange(s, device=dev)[None, :])  # [1, s, 1, nd/2]


def transformer_forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    remat: bool = False,
    *,
    dense_attn: bool = False,
) -> torch.Tensor:
    """Training/eval forward: tokens [b, s] → logits [b, s, vocab] (f32),
    the counterpart of ``transformer_forward``. Attention runs the
    flash_attention kernel under ``FlashAttentionFn`` (``dense_attn``: the
    dense formula). ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` per layer)."""
    b, s = tokens.shape
    cs = _positions_rope(cfg, s, s, tokens.device)
    lp = _per_layer(params)

    def body(x: torch.Tensor, layer: int) -> torch.Tensor:
        return _layer_prefill(x, lp, layer, cfg, cs, dense_attn=dense_attn)[0]

    x = params["embed"][tokens]
    for layer in range(cfg.n_layers):
        if remat:
            x = checkpoint(body, x, layer, use_reentrant=False)
        else:
            x = body(x, layer)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


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
    last valid token. Slot cache only, as in the reference."""
    if not isinstance(cache, KVCache):
        raise TypeError("transformer_prefill writes a slot cache (KVCache)")
    b, s = tokens.shape
    dev = tokens.device
    lengths = lengths.to(torch.int32)
    cs = _positions_rope(cfg, s, cache.max_len, dev)
    sl = slots.long()
    x = params["embed"][tokens]
    for layer in range(cfg.n_layers):
        x, (k, v) = _layer_prefill(x, params, layer, cfg, cs, lengths=lengths,
                                   dense_attn=dense_attn)
        for buf, sc, new in ((cache.k, cache.k_s, k), (cache.v, cache.v_s, v)):
            new = new.transpose(1, 2)  # [b, KV, s, hd]
            if sc is not None:
                new, new_sc = quantize_kv(new)
                sc[layer, sl, :, :s] = new_sc
                sc[layer, sl, :, s:] = 1
            buf[layer, sl, :, :s] = new.to(buf.dtype)
            buf[layer, sl, :, s:] = 0
    cache.lengths[sl] = lengths
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = (lengths.long() - 1).clamp(min=0)
    x_last = x[torch.arange(b, device=dev), last]  # [b, D]
    return (x_last @ params["lm_head"]).float()


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
    engine sets it when a prompt's last chunk lands).
    """
    P, c = tokens.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    max_len = cache.max_len
    dev = tokens.device
    cos, sin = rope if rope is not None else rope_tables(cfg, max_len, dev)
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
    cs = rope_at(cos, sin, rope_pos)
    x = params["embed"][tokens]  # [P, c, D]
    for layer in range(cfg.n_layers):
        h = rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
        q, k, v = _qkv(h, params, layer, cfg, cs)
        ck, cv = cache.k[layer], cache.v[layer]  # [rows, KV, len, hd] views
        cks = cvs = None
        k, v = k.transpose(1, 2), v.transpose(1, 2)  # [P, KV, c, hd]
        if cache.quantized:
            cks, cvs = cache.k_s[layer], cache.v_s[layer]
            k, k_sc = quantize_kv(k)
            v, v_sc = quantize_kv(v)
            cks.index_put_(idx, k_sc)
            cvs.index_put_(idx, v_sc)
        ck.index_put_(idx, k)
        cv.index_put_(idx, v)
        attn = cache_chunk_attention(
            q, ck, cv, slots, starts, lens, k_scale=cks, v_scale=cvs,
            block_table=table, kernel=not dense_attn,
            window=cfg.sliding_window,
        )
        x = x + attn.reshape(P, c, H * hd) @ params["wo"][layer]
        x = x + _ffn(x, params, layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = (lens.long() - 1).clamp(min=0)
    x_last = x[torch.arange(P, device=dev), last]  # [P, D]
    return (x_last @ params["lm_head"]).float()


def decode_step(
    params: dict,
    tokens: torch.Tensor,
    cache: KVCache | PagedKVCache,
    active: torch.Tensor,
    cfg: TransformerConfig,
    *,
    rope: Optional[Rope] = None,
    dense_attn: bool = False,
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
    ``max_len``.
    """
    S = cache.n_slots
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    max_len = cache.max_len
    dev = tokens.device
    cos, sin = rope if rope is not None else rope_tables(cfg, max_len, dev)
    lengths = cache.lengths
    positions = lengths.long().clamp(max=max_len - 1)  # [S]
    cs = rope_at(cos, sin, positions[:, None])
    paged = isinstance(cache, PagedKVCache)
    table = cache.block_table if paged else None
    x = params["embed"][tokens][:, None]  # [S, 1, D]: one token per slot
    new_k, new_v = [], []
    for layer in range(cfg.n_layers):
        h = rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
        q, k, v = _qkv(h, params, layer, cfg, cs)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        scales = {}
        if cache.quantized:
            k, v = fake_quantize_kv(k), fake_quantize_kv(v)
            scales = dict(k_scale=cache.k_s[layer], v_scale=cache.v_s[layer])
        attn = decode_attention(
            q, cache.k[layer], cache.v[layer], lengths, k_new=k, v_new=v,
            block_table=table, kernel=not dense_attn,
            window=cfg.sliding_window, **scales,
        )
        x = x + attn.reshape(S, 1, H * hd) @ params["wo"][layer]
        x = x + _ffn(x, params, layer, cfg)
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
    x = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()
