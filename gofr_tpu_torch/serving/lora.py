"""LoRA adapter ingestion for multi-adapter serving — the port's copy of
``gofr_tpu/serving/lora.py``.

Parses HF PEFT adapter checkpoints (``adapter_config.json`` +
``*.safetensors``) into the stacked-layer leaf layout: per target
projection, ``a: [L, d_in, r]`` / ``b: [L, r, d_out]`` with the PEFT
scaling ``lora_alpha / r`` folded into ``b`` (serving never needs the
unscaled factors). The engine writes these into adapter slot ``idx`` of
its ``[L, 1 + lora_slots, ...]`` device leaves
(``InferenceEngine.load_lora``).

Every adapter of a batch runs in the same forward: a per-row gather over
the stacked adapter axis feeds two rank-space products next to each base
matmul (``models/transformer.py::_lora``). The rank is fixed per engine
(``TPU_LORA_RANK``); an adapter of smaller r is zero-padded up to it,
which is exact (zero rank columns contribute nothing). The safetensors
files are read by the port's own reader (``hf_loader.SafetensorsFile``).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from gofr_tpu_torch.models.transformer import lora_dims
from gofr_tpu_torch.serving.hf_loader import SafetensorsFile

# HF PEFT module names → the projection leaves.
PEFT_TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}

_HF_MODULE = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def is_peft_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "adapter_config.json")
    )


def load_peft_adapter(
    path: str,
    cfg,
    rank: int,
    targets: tuple[str, ...],
) -> dict:
    """Load a PEFT adapter dir → ``{target: (a, b)}`` stacked over layers,
    f32 CPU tensors.

    a: [L, d_in, rank], b: [L, rank, d_out] with ``lora_alpha/r`` folded
    in. The adapter's r must be ≤ ``rank`` (the engine's rank); smaller
    ranks zero-pad. Adapter targets must be a subset of the engine's
    ``targets``. Layers the adapter leaves out stay zero.
    """
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    r = int(acfg["r"])
    alpha = float(acfg.get("lora_alpha", r))
    scale = alpha / r
    if r > rank:
        raise ValueError(
            f"adapter rank {r} exceeds the engine's compiled "
            f"TPU_LORA_RANK={rank}"
        )
    mod_targets = []
    for m in acfg.get("target_modules", []):
        t = PEFT_TARGET_MAP.get(m)
        if t is None:
            raise ValueError(
                f"unsupported PEFT target module {m!r} "
                f"(supported: {sorted(PEFT_TARGET_MAP)})"
            )
        mod_targets.append(t)
    missing = [t for t in mod_targets if t not in targets]
    if missing:
        raise ValueError(
            f"adapter targets {missing} not compiled into the engine "
            f"(TPU_LORA_TARGETS={','.join(targets)})"
        )

    tensors: dict = {}
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for fname in files:
        h = SafetensorsFile(fname)
        for name in h.keys():
            tensors[name] = h.get(name).float().numpy().copy()

    def find(i: int, t: str, which: str):
        mod = _HF_MODULE[t]
        for pre in (
            f"base_model.model.model.layers.{i}.",
            f"model.layers.{i}.",
        ):
            name = f"{pre}{mod}.lora_{which}.weight"
            if name in tensors:
                return tensors[name]
        return None

    out = {}
    for t in mod_targets:
        d_in, d_out = lora_dims(cfg, t)
        a = np.zeros((cfg.n_layers, d_in, rank), dtype=np.float32)
        b = np.zeros((cfg.n_layers, rank, d_out), dtype=np.float32)
        found = 0
        for i in range(cfg.n_layers):
            wa = find(i, t, "A")  # [r, d_in]
            wb = find(i, t, "B")  # [d_out, r]
            if wa is None or wb is None:
                continue  # PEFT may skip layers via layers_to_transform
            if wa.shape != (r, d_in) or wb.shape != (d_out, r):
                raise ValueError(
                    f"adapter tensor shape mismatch for layer {i} {t}: "
                    f"A{wa.shape} B{wb.shape}, expected A({r},{d_in}) "
                    f"B({d_out},{r})"
                )
            a[i, :, :r] = wa.T
            b[i, :r, :] = wb.T * scale
            found += 1
        if not found:
            raise ValueError(f"adapter has no tensors for target {t!r}")
        out[t] = (torch.from_numpy(a), torch.from_numpy(b))
    return out


def validate_adapter_leaves(
    leaves: dict, cfg, rank: int, targets: tuple[str, ...]
) -> None:
    """Shape-check a raw ``{target: (a, b)}`` dict (the non-PEFT source
    form ``load_lora`` takes, e.g. adapters from ``make_lora_train_step``)."""
    for t, (a, b) in leaves.items():
        if t not in targets:
            raise ValueError(
                f"adapter target {t!r} not compiled into the engine "
                f"(TPU_LORA_TARGETS={','.join(targets)})"
            )
        d_in, d_out = lora_dims(cfg, t)
        if tuple(a.shape) != (cfg.n_layers, d_in, rank):
            raise ValueError(
                f"{t} lora A shape {tuple(a.shape)} != "
                f"({cfg.n_layers}, {d_in}, {rank})"
            )
        if tuple(b.shape) != (cfg.n_layers, rank, d_out):
            raise ValueError(
                f"{t} lora B shape {tuple(b.shape)} != "
                f"({cfg.n_layers}, {rank}, {d_out})"
            )
