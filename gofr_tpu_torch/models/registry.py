"""Named model registry — the entries of ``gofr_tpu/models/registry.py``,
same names and dims.

Every entry is registered so names resolve as in the reference. The
engine serves every LLM config ``transformer.check_supported`` accepts
(every dense family, and Mixtral's MoE, which fits one card with int8
weights), the encoders (``bert-*``, behind the dynamic batcher) and the
vision models (``resnet-*``, ``vit-*``) and the seq2seq models
(``flan-t5-small``, ``t5-tiny``; T5 behind the dynamic batcher).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from gofr_tpu_torch.models.bert import BertConfig, init_bert
from gofr_tpu_torch.models.resnet import ResNetConfig, init_resnet, resnet_forward
from gofr_tpu_torch.models.t5 import T5Config, init_t5
from gofr_tpu_torch.models.transformer import TransformerConfig, init_params
from gofr_tpu_torch.models.vit import ViTConfig, init_vit, vit_forward


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    family: str  # "llm" | "encoder" | "vision" | "seq2seq"
    config: Any
    # init(config, seed, device) -> params.
    init: Optional[Callable] = None
    eos_token: int = 2
    # The vision family's forward(params, images, config) -> logits; the
    # LLM and encoder paths are generic and leave it None.
    forward: Optional[Callable] = None

    def describe(self) -> dict:
        return {"name": self.name, "family": self.family}


_REGISTRY: dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def _register_llms() -> None:
    llm_configs = {
        # Flagship target: Llama-3-8B dims.
        "llama-3-8b": TransformerConfig(
            vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_len=8192, rope_theta=500000.0,
        ),
        "llama-3-70b": TransformerConfig(
            vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
            n_kv_heads=8, d_ff=28672, max_len=8192, rope_theta=500000.0,
        ),
        "mixtral-8x7b": TransformerConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_len=8192, rope_theta=1e6,
            n_experts=8, n_experts_active=2,
        ),
        "mistral-7b": TransformerConfig(
            vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_len=8192, rope_theta=10000.0,
            sliding_window=4096,
        ),
        "qwen2-7b": TransformerConfig(
            vocab_size=152064, d_model=3584, n_layers=28, n_heads=28,
            n_kv_heads=4, d_ff=18944, max_len=8192, rope_theta=1e6,
            attn_bias=True,
        ),
        "gemma-7b": TransformerConfig(
            vocab_size=256000, d_model=3072, n_layers=28, n_heads=16,
            n_kv_heads=16, d_ff=24576, max_len=8192, rope_theta=10000.0,
            norm_eps=1e-6, head_dim_override=256, act="gelu",
            norm_offset=True, embed_scale=True,
        ),
        "gemma-2b": TransformerConfig(
            vocab_size=256000, d_model=2048, n_layers=18, n_heads=8,
            n_kv_heads=1, d_ff=16384, max_len=8192, rope_theta=10000.0,
            norm_eps=1e-6, head_dim_override=256, act="gelu",
            norm_offset=True, embed_scale=True,
        ),
        "llama-1b": TransformerConfig(
            vocab_size=32768, d_model=2048, n_layers=22, n_heads=16,
            n_kv_heads=4, d_ff=5632, max_len=4096, rope_theta=500000.0,
        ),
        # Test-size models.
        "llama-tiny": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_len=256, rope_theta=10000.0,
        ),
        # f32 twin: the exact-comparison oracle for token streams.
        "llama-tiny-f32": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_len=256, rope_theta=10000.0,
            dtype=torch.float32,
        ),
        "moe-tiny": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_len=256, rope_theta=10000.0,
            n_experts=4, n_experts_active=2,
        ),
        "pythia-6.9b": TransformerConfig(
            vocab_size=50432, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, d_ff=16384, max_len=2048, rope_theta=10000.0,
            norm_eps=1e-5, norm="ln", parallel_residual=True,
            rotary_pct=0.25, ffn="mlp", act="gelu_exact", attn_bias=True,
            proj_bias=True,
        ),
        "gpt2": TransformerConfig(
            vocab_size=50257, d_model=768, n_layers=12, n_heads=12,
            n_kv_heads=12, d_ff=3072, max_len=1024, norm="ln",
            ffn="mlp", act="gelu", attn_bias=True, proj_bias=True,
            pos_emb="learned",
        ),
        "gpt2-tiny": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=4, d_ff=256, max_len=256, norm="ln",
            ffn="mlp", act="gelu", attn_bias=True, proj_bias=True,
            pos_emb="learned",
        ),
        "neox-tiny": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=4, d_ff=256, max_len=256, rope_theta=10000.0,
            norm="ln", parallel_residual=True, rotary_pct=0.25,
            ffn="mlp", act="gelu_exact", attn_bias=True, proj_bias=True,
        ),
        "gemma-tiny": TransformerConfig(
            vocab_size=512, d_model=128, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=256, max_len=256, rope_theta=10000.0,
            norm_eps=1e-6, head_dim_override=64, act="gelu",
            norm_offset=True, embed_scale=True,
        ),
    }
    eos_tokens = {"gemma-7b": 1, "gemma-2b": 1, "gemma-tiny": 1,
                  "pythia-6.9b": 0, "neox-tiny": 0,
                  "gpt2": 50256, "gpt2-tiny": 0}
    for name, cfg in llm_configs.items():
        register_model(ModelSpec(
            name=name, family="llm", config=cfg, init=init_params,
            eos_token=eos_tokens.get(name, 2),
        ))


def _register_encoders() -> None:
    register_model(ModelSpec(
        name="bert-base", family="encoder", config=BertConfig(), init=init_bert,
    ))
    register_model(ModelSpec(
        name="bert-tiny", family="encoder",
        config=BertConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                          d_ff=256, max_len=128),
        init=init_bert,
    ))


def _register_seq2seq() -> None:
    register_model(ModelSpec(
        name="flan-t5-small", family="seq2seq",
        # t5-v1.1-small / flan-t5-small dims: gated-gelu, untied head.
        config=T5Config(d_model=512, d_kv=64, n_heads=6, n_layers=8, d_ff=1024),
        init=init_t5, eos_token=1,
    ))
    register_model(ModelSpec(
        name="t5-tiny", family="seq2seq",
        config=T5Config(vocab_size=512, d_model=64, d_kv=16, n_heads=4, n_layers=2,
                        d_ff=128, max_len=128),
        init=init_t5, eos_token=1,
    ))


def _register_vision() -> None:
    register_model(ModelSpec(
        name="resnet-50", family="vision", config=ResNetConfig(),
        init=init_resnet, forward=resnet_forward,
    ))
    register_model(ModelSpec(
        name="vit-base", family="vision", config=ViTConfig(),
        init=init_vit, forward=vit_forward,
    ))
    register_model(ModelSpec(
        name="vit-tiny", family="vision",
        config=ViTConfig(image_size=32, patch_size=8, d_model=64, n_layers=2,
                         n_heads=4, d_ff=128, num_classes=10),
        init=init_vit, forward=vit_forward,
    ))
    register_model(ModelSpec(
        name="resnet-tiny", family="vision",
        config=ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16, num_classes=10),
        init=init_resnet, forward=resnet_forward,
    ))


_register_llms()
_register_encoders()
_register_seq2seq()
_register_vision()
