"""The training steps — the port of ``gofr_tpu/parallel/sharding.py``
(``cross_entropy_loss``, ``make_train_step``, ``make_lora_train_step``)
for one device.

Mixed precision as in the reference: the master parameters and the AdamW
moments are f32; each step casts the masters to ``cfg.dtype`` for the
forward (no autocast: the explicit cast decides which ops run in f32, as
there), and the gradients land in f32 on the masters. Attention runs the
flash_attention kernel with its dense-recompute backward
(``ops/attention.py::FlashAttentionFn``). The optimizer updates the
parameters and its state in place, where the reference donates them.
The LoRA step trains only f32 adapter factors over a frozen base, which
may be int8/int4 (QLoRA). Meshes (dp/tp/pp/cp > 1) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.transformer import (
    LORA_TARGETS,
    TransformerConfig,
    check_supported,
    init_params,
    lora_dims,
    transformer_forward,
)
from gofr_tpu_torch.ops.quant import is_quantized


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy. logits [b, s, V] f32, targets [b, s]."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate)`` with optax's defaults, on every leaf:
    mu/nu moments, bias correction, ``mu_hat / (sqrt(nu_hat) + eps)``,
    plus ``weight_decay * param``, times ``-learning_rate``. (Not
    ``torch.optim.AdamW``, whose weight decay defaults to 1e-2.)"""

    learning_rate: float
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8
    weight_decay: ClassVar[float] = 1e-4

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             state: AdamWState) -> None:
        """Update ``params`` and ``state`` in place."""
        state.count += 1
        # optax forms 1 - decay**count in f32.
        one, t = np.float32(1), np.float32(state.count)
        bc1 = float(one - np.float32(self.b1) ** t)
        bc2 = float(one - np.float32(self.b2) ** t)
        for name, p in params.items():
            g, mu, nu = grads[name], state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay).mul_(-self.learning_rate)
            p.add_(u)


def loss_and_grads(
    params: dict[str, torch.Tensor], tokens: torch.Tensor, cfg: TransformerConfig,
    *, remat: bool = False, dense_attn: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The step's loss (next-token cross entropy over the full sequence,
    shifted at the loss) and its gradients with respect to ``params``,
    shaped and typed like ``params``."""
    check_plain_params(params)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        compute = {k: p.to(cfg.dtype) for k, p in leaves.items()}
        logits = transformer_forward(compute, tokens, cfg, remat=remat,
                                     dense_attn=dense_attn)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def check_plain_params(params: dict) -> None:
    """Raise ``NotImplementedError`` for a quantized (Q8/Q4) leaf: the
    quantized weights serve only, as in the reference."""
    quantized = sorted(k for k, p in params.items() if is_quantized(p))
    if quantized:
        raise NotImplementedError(
            f"training takes plain weights; {', '.join(quantized)} are quantized "
            "(int8/int4 weights serve only, as in the reference; to train "
            "adapters over a quantized base, use make_lora_train_step)"
        )


def make_train_step(
    cfg: TransformerConfig,
    mesh: Optional[object] = None,
    learning_rate: float = 3e-4,
    sp: bool = True,
    remat: bool = False,
    cp_impl: str = "ring",
    n_microbatches: int = 2,
    device: torch.device | str | None = None,
) -> tuple[Callable, Callable, AdamW]:
    """Build ``(init_state, train_step, optimizer)`` for one device.

    ``init_state(seed) -> (params, opt_state)``: random parameters in
    ``cfg.dtype`` from ``seed`` (``init_params``), cast to f32 masters.
    ``train_step(params, opt_state, tokens) -> (loss, params, opt_state)``:
    forward in ``cfg.dtype``, cross entropy, backward, one AdamW step; the
    params and state are updated in place and returned. ``mesh`` must be
    None: multi-device training is not ported. ``sp``, ``cp_impl`` and
    ``n_microbatches`` shape only multi-device meshes, as in the
    reference, and change nothing here."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: meshes (dp/tp/pp/cp > 1) are not ported yet "
            "(ROADMAP Queue 1 item 8: multi-device); pass mesh=None"
        )
    check_supported(cfg, device)
    device = resolve_device(device)
    optimizer = AdamW(learning_rate)

    def init_state(seed: int) -> tuple[dict, AdamWState]:
        params = {k: p.float() for k, p in init_params(cfg, seed, device).items()}
        return params, optimizer.init(params)

    def train_step(params: dict, opt_state: AdamWState, tokens: torch.Tensor):
        tokens = tokens.to(device=device, dtype=torch.long)
        loss, grads = loss_and_grads(params, tokens, cfg, remat=remat)
        optimizer.step(params, grads, opt_state)
        return loss, params, opt_state

    return init_state, train_step, optimizer


def make_lora_train_step(
    cfg: TransformerConfig,
    base_params: dict,
    rank: int,
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo"),
    mesh: Optional[object] = None,
    learning_rate: float = 1e-3,
    device: torch.device | str | None = None,
) -> tuple[Callable, Callable]:
    """Adapter fine-tuning on a frozen base, the reference's: the
    train-then-serve loop of multi-LoRA (train here, then
    ``engine.load_lora(name, lora)``).

    Only the LoRA factors train, in f32, with optax-default AdamW (its
    state is rank-sized); the base (``base_params``, a port parameter dict
    in ``cfg.dtype``) is used as it is and gets no gradient, so it may be
    int8/int4 (QLoRA: the base products dequantize on the fly and the
    deltas add after them). Each step splices the factors, cast to
    ``cfg.dtype``, into the base with a 1-adapter axis and runs
    ``transformer_forward`` with every row's adapter 0; attention's
    gradient flows through ``FlashAttentionFn``. The factors are the raw
    dict ``load_lora`` takes: ``{target: (a [L, d_in, r], b [L, r,
    d_out])}`` f32; the usual init (a ~ N(0, 1)/r, b = 0) makes step 0
    exactly the base model.

    Returns ``(init_lora_state, lora_train_step)``:
    ``init_lora_state(seed) -> (lora, opt_state)`` (a ``torch.Generator``
    on the device seeded with ``seed``); ``lora_train_step(lora, opt_state,
    tokens) -> (loss, lora, opt_state)``, the factors and the state
    updated in place. ``mesh`` must be None (multi-device is not ported).
    """
    # init_lora's guards: on a MoE base the FFN has no adapter path, so
    # FFN factors would train as silent no-ops and could not serve.
    if cfg.is_moe:
        raise ValueError("LoRA training does not support MoE models")
    for t in targets:
        if t not in LORA_TARGETS:
            raise ValueError(
                f"unknown LoRA target {t!r} (of {LORA_TARGETS})"
            )
    if mesh is not None:
        raise NotImplementedError(
            "make_lora_train_step: meshes (dp/tp) are not ported yet "
            "(ROADMAP Queue 1 item 8: multi-device); pass mesh=None"
        )
    check_supported(cfg, device)
    device = resolve_device(device)
    optimizer = AdamW(learning_rate)

    def flat(lora: dict) -> dict[str, torch.Tensor]:
        """The factors by leaf name, the same tensors (AdamW updates them
        in place)."""
        return {t + s: x for t, ab in lora.items()
                for s, x in zip(("_lora_a", "_lora_b"), ab)}

    def init_state(seed: int) -> tuple[dict, AdamWState]:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        lora = {}
        for t in targets:
            d_in, d_out = lora_dims(cfg, t)
            a = torch.randn((cfg.n_layers, d_in, rank), generator=gen, device=device) / rank
            lora[t] = (a, torch.zeros((cfg.n_layers, rank, d_out), device=device))
        return lora, optimizer.init(flat(lora))

    def train_step(lora: dict, opt_state: AdamWState, tokens: torch.Tensor):
        tokens = tokens.to(device=device, dtype=torch.long)
        leaves = {k: x.detach().requires_grad_(True) for k, x in flat(lora).items()}
        aids = torch.zeros((tokens.shape[0],), dtype=torch.long, device=device)
        with torch.enable_grad():
            merged = dict(base_params)
            merged.update({k: x.to(cfg.dtype)[:, None] for k, x in leaves.items()})
            logits = transformer_forward(merged, tokens, cfg, aids=aids)
            loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
            grads = torch.autograd.grad(loss, list(leaves.values()))
        optimizer.step(flat(lora), dict(zip(leaves, grads)), opt_state)
        return loss.detach(), lora, opt_state

    return init_state, train_step
