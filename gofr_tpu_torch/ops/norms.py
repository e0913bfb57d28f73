"""Normalization ops: computed in f32 whatever the input dtype, cast back."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
    offset: float = 0.0,
) -> torch.Tensor:
    """RMSNorm (Llama-family). ``weight`` has shape [d_model].

    ``offset``: the forward applies ``(offset + w)`` (Gemma stores w with
    offset 1.0, so identity is w=0 there).
    """
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    w = weight.float() + offset if offset else weight.float()
    return (out * w).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-12
) -> torch.Tensor:
    """LayerNorm (GPT-NeoX, GPT-2): mean and biased variance in f32, then
    ``(x - mean) / sqrt(var + eps) * w + b``. ``weight``, ``bias``:
    [d_model]."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    centred = xf - mean
    var = torch.mean(centred * centred, dim=-1, keepdim=True)
    out = centred * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float() + bias.float()).to(x.dtype)
