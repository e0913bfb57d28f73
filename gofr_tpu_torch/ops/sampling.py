"""Token sampling from [batch, vocab] logits: greedy, temperature, top-k and
top-p — the port of the reference's ``gofr_tpu/ops/sampling.py``.

The draw is Gumbel-max (an exact categorical sample) with noise from an
explicit ``torch.Generator``; it does not reproduce JAX's threefry bits.
The admissible set is the reference's: top-k keeps logits >= the k-th
largest, top-p keeps logits >= the one at which the cumulative
probability of the (unfiltered) sorted distribution first reaches
``top_p``.
"""

from __future__ import annotations

import torch


def filter_logits(
    logits: torch.Tensor,
    *,
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """``logits / temperature`` in f32 with every token outside the top-k
    and nucleus sets at -inf (``temperature`` > 0)."""
    scaled = logits.float() / temperature
    V = scaled.shape[-1]
    use_k = 0 < top_k < V
    if not (use_k or top_p < 1.0):
        return scaled
    # One descending sort shared by both filters.
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    out = scaled
    if use_k:
        kth = sorted_l[:, top_k - 1: top_k]
        out = out.masked_fill(out < kth, float("-inf"))
    if top_p < 1.0:
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # Keep the smallest prefix with cumulative probability >= top_p.
        cut_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1, keepdim=True)
        cutoff = sorted_l.gather(-1, cut_idx)
        out = out.masked_fill(out < cutoff, float("-inf"))
    return out


def gumbel(shape: tuple, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_logits(
    logits: torch.Tensor,
    generator: torch.Generator,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Token ids [batch] (int64) from [batch, vocab] logits.
    ``temperature`` 0 is greedy; otherwise one categorical draw per row
    from softmax of the filtered ``logits / temperature``, with noise from
    ``generator`` (a generator on the logits' device)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    noise = gumbel(tuple(scaled.shape), generator, scaled.device)
    return torch.argmax(scaled + noise, dim=-1)
