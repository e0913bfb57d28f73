"""Vision Transformer (ViT) image classifier — the port of
``gofr_tpu/models/vit.py``, the transformer half of the vision family
beside ResNet.

The patch embedding is a reshape (``patchify``) and one [N, P·P·3] x
[P·P·3, D] product, equal to the stride-P convolution; pre-LN encoder
layers, learned position embeddings over the class token and the
patches, a class-token head: the ViT-B/16 architecture. Attention is
``ops/attention.py`` non-causal with no mask, so on a card it is the
``flash_attention`` kernel, once a layer. The MLP takes the exact (erf)
GELU, as the reference asks (``approximate=False``).

Parameters are a plain dict of tensors with the layer leaves stacked on a
leading ``[L, ...]`` axis, as in the reference pytree, except that Q/K/V
and their biases are stored concatenated (``wqkv`` [L, D, 3D],
``wqkv_b`` [L, 3D]; ``weights.vit_params_from_jax`` builds them).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Field for field the reference ``ViTConfig``; ``dtype`` is a torch
    dtype."""

    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_vit(cfg: ViTConfig, seed: int,
             device: torch.device | str | None = None) -> dict:
    """Random parameters on ``device`` (CUDA unless ``"cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: every leaf of the
    reference's ``init_vit``, normal with std fan_in**-0.5 for the
    projections, the class token and the positions, LayerNorm weights one,
    every bias zero."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    pdim = cfg.patch_size * cfg.patch_size * 3

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        return w.normal_(0.0, fan_in**-0.5, generator=gen)

    def const(shape: tuple, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    return {
        "patch_proj": dense((pdim, D), pdim),
        "patch_proj_b": const((D,), 0.0),
        "cls_token": dense((1, 1, D), D),
        "pos_embed": dense((1 + cfg.n_patches, D), D),
        "ln1": const((L, D), 1.0),
        "ln1_b": const((L, D), 0.0),
        "wqkv": dense((L, D, 3 * D), D),
        "wqkv_b": const((L, 3 * D), 0.0),
        "wo": dense((L, D, D), D),
        "wo_b": const((L, D), 0.0),
        "ln2": const((L, D), 1.0),
        "ln2_b": const((L, D), 0.0),
        "w_up": dense((L, D, F_), D),
        "w_up_b": const((L, F_), 0.0),
        "w_down": dense((L, F_, D), F_),
        "w_down_b": const((L, D), 0.0),
        "ln_f": const((D,), 1.0),
        "ln_f_b": const((D,), 0.0),
        "head": dense((D, cfg.num_classes), D),
        "head_b": const((cfg.num_classes,), 0.0),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[b, H, W, C] → [b, N, patch·patch·C], each patch flattened row-major
    (rows, then columns, then channels), patches in row-major order."""
    b, H, W, C = images.shape
    hp, wp = H // patch, W // patch
    x = images.reshape(b, hp, patch, wp, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp * wp, patch * patch * C)


def vit_forward(params: dict, images: torch.Tensor, cfg: ViTConfig, *,
                dense_attn: bool = False) -> torch.Tensor:
    """images [b, H, W, 3] (f32) → class logits [b, num_classes] (f32).
    ``dense_attn``: attention by the dense formula instead of the kernel
    (the plain path a card run is held against)."""
    b = images.shape[0]
    H, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    x = patchify(images.to(cfg.dtype), cfg.patch_size) @ params["patch_proj"]
    x = x + params["patch_proj_b"]
    cls = params["cls_token"].expand(b, 1, D).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]  # [b, 1+N, D]
    s = x.shape[1]
    for layer in range(cfg.n_layers):
        h = layer_norm(x, params["ln1"][layer], params["ln1_b"][layer], cfg.norm_eps)
        qkv = h @ params["wqkv"][layer] + params["wqkv_b"][layer]
        q, k, v = qkv.reshape(b, s, 3, H, hd).unbind(2)
        a = attention(q, k, v, causal=False, kernel=not dense_attn).reshape(b, s, D)
        x = x + a @ params["wo"][layer] + params["wo_b"][layer]
        h = layer_norm(x, params["ln2"][layer], params["ln2_b"][layer], cfg.norm_eps)
        h = F.gelu(h @ params["w_up"][layer] + params["w_up_b"][layer])
        x = x + h @ params["w_down"][layer] + params["w_down_b"][layer]
    x = layer_norm(x, params["ln_f"], params["ln_f_b"], cfg.norm_eps)
    return (x[:, 0] @ params["head"] + params["head_b"]).float()
