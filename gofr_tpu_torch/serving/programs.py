"""Device programs of the serving engine: the sampler, the chunked-prefill
step and the k-step decode window — the port of the reference's
``serving/programs.py`` (``sample``, ``row_keys``, ``_prefill_core``,
``make_decode_body``/``decode_window``) on this slice's configuration:
greedy and temperature sampling only.

PyTorch runs eagerly, so a "program" is a function that enqueues its
work on the current stream and returns device tensors; the per-slot
planes (``SlotPlanes``) are updated in place on the device, and the host
reads one block per decode window.

Sampling is counter-based, in the spirit of the reference's
``fold_in(fold_in(base, seed), n)`` keys: the noise of a request's n-th
sampled token is a hash of (engine seed, request seed, n, vocab index),
so a seeded stream is the same whatever else shares the batch. The
draw is Gumbel-max over ``logits / temperature``, an exact categorical
sample. It does not reproduce JAX's threefry bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gofr_tpu_torch.models.transformer import (
    Rope,
    TransformerConfig,
    decode_step,
    prefill_chunk,
)
from gofr_tpu_torch.ops.kv_cache import KVCache, PagedKVCache

_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B  # < 2**27: a 32-bit value times it stays inside int64
_GOLDEN = 0x9E3779B9


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash on int64 tensors holding values in [0, 2**32)."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def counter_uniform(
    base_seed: int, seeds: torch.Tensor, counters: torch.Tensor, n: int
) -> torch.Tensor:
    """[rows, n] f32 uniforms in (0, 1), a pure function of (base_seed,
    seeds[row], counters[row], column): the same row key gives the same
    draws on any batch."""
    key = _mix32((seeds.long() ^ (base_seed & _M32)) & _M32)
    key = _mix32((key + (counters.long() & _M32) * _GOLDEN) & _M32)
    cols = torch.arange(n, device=seeds.device, dtype=torch.long)
    h = _mix32(_mix32((key[:, None] + cols[None, :]) & _M32))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    base_seed: int,
    sampling: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(token [rows] int64, logprob [rows] f32). Greedy rows take the
    argmax; the others draw from softmax(logits / temperature) with the
    counter-based noise. ``sampling`` (host-known) skips the noise when
    every row is greedy. The logprob is the model's log-softmax at the
    chosen token."""
    logits = logits.float()
    chosen = torch.argmax(logits, dim=-1)
    if sampling:
        u = counter_uniform(base_seed, seeds, counters, logits.shape[-1])
        gumbel = -torch.log(-torch.log(u))
        scaled = logits / torch.clamp(temps, min=1e-4)[:, None]
        sampled = torch.argmax(scaled + gumbel, dim=-1)
        chosen = torch.where(greedy, chosen, sampled)
    logp = torch.log_softmax(logits, dim=-1)
    return chosen, logp.gather(1, chosen[:, None])[:, 0]


@dataclass
class SlotPlanes:
    """Per-slot device state, [n_slots] each: the token entering the next
    decode step, the slot's sample counter, and the sampling contract of
    the request it holds."""

    tokens: torch.Tensor  # int64
    nsteps: torch.Tensor  # int64
    seeds: torch.Tensor  # int64
    temps: torch.Tensor  # f32
    greedy: torch.Tensor  # bool
    active: torch.Tensor  # bool

    @classmethod
    def create(cls, n_slots: int, device: torch.device) -> "SlotPlanes":
        def z(dtype: torch.dtype) -> torch.Tensor:
            return torch.zeros((n_slots,), dtype=dtype, device=device)

        return cls(
            tokens=z(torch.long), nsteps=z(torch.long),
            seeds=z(torch.long), temps=torch.ones((n_slots,), device=device),
            greedy=torch.ones((n_slots,), dtype=torch.bool, device=device),
            active=z(torch.bool),
        )


def prefill_chunk_step(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    tokens: torch.Tensor,
    slots: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    finalize: torch.Tensor,
    row_valid: torch.Tensor,
    temps: torch.Tensor,
    greedy: torch.Tensor,
    base_seed: int,
    sampling: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One [P, c] chunk: write K/V and attend; on rows whose prompt
    finishes (``finalize`` and ``row_valid``) sample the first token with
    counter 0 and merge it into the slot planes on the device, set the
    slot's cache length and its counter to 1. Padding rows duplicate row
    0 (identical writes; ``row_valid`` keeps them out of the merge).
    Returns the rows' (first token, logprob)."""
    logits = prefill_chunk(
        params, tokens, cache, slots, starts, lens, cfg, rope=rope
    )
    sl = slots.long()
    first, first_lp = sample(
        logits, planes.seeds[sl], torch.zeros_like(sl), temps, greedy,
        base_seed, sampling,
    )
    S = planes.tokens.shape[0]
    match = (
        (torch.arange(S, device=sl.device)[:, None] == sl[None, :])
        & finalize[None, :] & row_valid[None, :]
    )  # [S, P]
    has = match.any(dim=1)
    idx = match.to(torch.int32).argmax(dim=1)
    planes.tokens.copy_(torch.where(has, first[idx], planes.tokens))
    cache.lengths.copy_(
        torch.where(has, (starts + lens)[idx], cache.lengths)
    )
    planes.nsteps.copy_(torch.where(has, 1, planes.nsteps))
    return first, first_lp


def decode_window(
    params: dict,
    cache: KVCache | PagedKVCache,
    cfg: TransformerConfig,
    rope: Rope,
    planes: SlotPlanes,
    k: int,
    base_seed: int,
    sampling: bool,
) -> torch.Tensor:
    """Run k decode steps over every slot on the device and return the
    [2, k, S] f32 block of (token, logprob) each step produced (token ids
    are exact in f32 below 2**24): the host fetches one block per window.
    Active slots advance their counter once per step."""
    S = planes.tokens.shape[0]
    emitted = torch.empty((2, k, S), dtype=torch.float32, device=planes.tokens.device)
    step_inc = planes.active.to(torch.long)
    for step in range(k):
        logits = decode_step(
            params, planes.tokens, cache, planes.active, cfg, rope=rope
        )
        nxt, nlp = sample(
            logits, planes.seeds, planes.nsteps, planes.temps, planes.greedy,
            base_seed, sampling,
        )
        planes.nsteps += step_inc
        planes.tokens.copy_(nxt)
        emitted[0, step] = nxt.float()
        emitted[1, step] = nlp
    return emitted
