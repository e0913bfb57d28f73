"""BERT-style bidirectional encoder — the port of
``gofr_tpu/models/bert.py`` (the embedding endpoint's model, BASELINE
config 3).

bf16 weights with f32 LayerNorm and pooling, as in the reference.
``bert_embed`` returns mean-pooled, L2-normalised sentence embeddings:
the serving payload of ``/v1/embeddings``.

Parameters are a plain dict of tensors, layer leaves stacked on a leading
``[L, ...]`` axis as in the reference pytree, except that Q/K/V are
stored concatenated (``wqkv`` [L, D, 3D]: one product instead of three,
the same columns; ``weights.bert_params_from_jax`` builds it). The FFN
takes the tanh-approximate GELU (the reference's ``jax.nn.gelu``
default). Attention passes the padding mask, so it takes the dense
formula, as the reference's ``attention`` does whenever a mask is given.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Field for field the reference ``BertConfig``; ``dtype`` is a torch
    dtype."""

    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_len: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_bert(cfg: BertConfig, seed: int,
              device: torch.device | str | None = None) -> dict:
    """Random parameters on ``device`` (CUDA unless ``"cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: every leaf of the
    reference's ``init_bert``, normal with std fan_in**-0.5 for the
    embeddings and projections, LayerNorm weights one and biases zero."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        return w.normal_(0.0, fan_in**-0.5, generator=gen)

    def const(shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    return {
        "tok_embed": dense((cfg.vocab_size, D), D),
        "pos_embed": dense((cfg.max_len, D), D),
        "embed_norm_w": const((D,), 1.0),
        "embed_norm_b": const((D,), 0.0),
        "wqkv": dense((L, D, 3 * D), D),
        "wo": dense((L, D, D), D),
        "w_in": dense((L, D, F_), D),
        "w_out": dense((L, F_, D), F_),
        "norm1_w": const((L, D), 1.0),
        "norm1_b": const((L, D), 0.0),
        "norm2_w": const((L, D), 1.0),
        "norm2_b": const((L, D), 0.0),
    }


def bert_forward(params: dict, tokens: torch.Tensor, mask: torch.Tensor,
                 cfg: BertConfig) -> torch.Tensor:
    """tokens, mask: [b, s] (mask 1 = real token) → hidden states
    [b, s, D] in ``cfg.dtype``."""
    b, s = tokens.shape
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    tokens = tokens.long()
    x = params["tok_embed"][tokens] + params["pos_embed"][None, :s]
    x = layer_norm(x, params["embed_norm_w"], params["embed_norm_b"], cfg.norm_eps)
    attn_mask = mask[:, None, :].bool().expand(b, s, s)
    for layer in range(cfg.n_layers):
        q, k, v = (x @ params["wqkv"][layer]).reshape(b, s, 3, H, hd).unbind(2)
        a = attention(q, k, v, causal=False, mask=attn_mask)
        x = layer_norm(x + a.reshape(b, s, D) @ params["wo"][layer],
                       params["norm1_w"][layer], params["norm1_b"][layer], cfg.norm_eps)
        ffn = F.gelu(x @ params["w_in"][layer], approximate="tanh") @ params["w_out"][layer]
        x = layer_norm(x + ffn, params["norm2_w"][layer], params["norm2_b"][layer],
                       cfg.norm_eps)
    return x


def bert_embed(params: dict, tokens: torch.Tensor, mask: torch.Tensor,
               cfg: BertConfig) -> torch.Tensor:
    """Mean-pooled L2-normalised embeddings [b, D] in f32."""
    hidden = bert_forward(params, tokens, mask, cfg).float()
    m = mask[:, :, None].float()
    pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)
