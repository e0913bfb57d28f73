"""T5 encoder-decoder (text-to-text) — the port of ``gofr_tpu/models/t5.py``,
the seq2seq family beside the decoders, the encoders and the vision models.

T5's particulars, as the reference keeps them for HF parity: RMSNorm
without bias, **unscaled** attention scores (T5 folds 1/sqrt(d) into its
initialization) taken in f32 with a learned RELATIVE position bias added
(one bucket table per attention kind, owned by layer 0 and shared by every
layer; none on cross-attention), masked entries at -1e30 (a row with no
valid key gets a uniform softmax, not NaN), an explicit per-head ``d_kv``,
a gated tanh-GELU FFN for the v1.1 lineage (plain relu for the original
T5), and the tied head's ``d_model**-0.5`` logit scale only when tied.

Parameters are the reference's tree as it is: ``embed``, ``enc_rel_bias``
and ``dec_rel_bias`` ``[buckets, heads]``, ``enc_norm``/``dec_norm``, an
untied ``lm_head`` ``[D, vocab]``, and the ``encoder``/``decoder`` stacks
of ``[L, ...]`` leaves (``ln1``-``ln3``, ``sa_``/``ca_``-prefixed
``wq wk wv wo``, ``w_gate``/``w_up``/``w_down``). The projections go
through ``transformer._wein``, so a Q8/Q4 leaf of ``quantize_t5_params``
or of ``load_hf_t5(quant=...)`` serves in place of a plain one. The
matmuls are ``torch.matmul`` (the reference leaves them to XLA): no
hand-written kernel covers a dense attention with a bias.

Generation is the reference's: the encoder runs once, then every greedy
step re-runs the decoder over a fixed ``[b, 1 + max_new]`` answer buffer
with causal and validity masks and writes position ``i + 1``; a row that
has emitted EOS writes 0 from then on. ``t5_generate_chunk`` advances the
same buffer ``chunk`` steps from ``start`` (the streaming unit), so a
stepped stream gives the one-shot ids. Only the picked position goes
through the head (the reference takes ``logits[:, i]`` of the whole
buffer: the same products for that row). The bucket ids of the relative
bias are computed once per shape on the host and cached on the device, so
every device reads the CPU's ids.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models.transformer import _wein
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.quant import quant_fn

__all__ = ["T5Config", "config_from_hf_t5", "init_t5", "load_hf_t5", "quantize_t5_params",
           "t5_decode", "t5_encode", "t5_generate", "t5_generate_chunk"]


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Field for field the reference ``T5Config``; ``dtype`` is a torch
    dtype."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64  # per head; T5 does not require d_model / n_heads
    n_heads: int = 8
    n_layers: int = 6  # encoder layers == decoder layers
    d_ff: int = 2048
    rel_buckets: int = 32
    rel_max_distance: int = 128
    norm_eps: float = 1e-6
    gated_ffn: bool = True  # v1.1 gated-gelu; False = original relu
    tied_head: bool = False  # v1.1 unties; tied scales logits by d^-0.5
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_kv


def _rel_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                max_dist: int) -> torch.Tensor:
    """HF T5 bucketing in the reference's f32 arithmetic: exact small
    distances, log-spaced large ones."""
    ret = torch.zeros_like(rel_pos)
    n = rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_dist / max_exact, dtype=torch.float32,
                                       device=rel_pos.device))
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_ratio * (num_buckets - max_exact)
    ).to(rel_pos.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=64)
def bucket_ids(q_len: int, k_len: int, bidirectional: bool, num_buckets: int,
               max_dist: int, device: torch.device) -> torch.Tensor:
    """The ``[q_len, k_len]`` bucket ids of key position minus query
    position, computed on the host CPU and kept on ``device``."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    return _rel_bucket(rel, bidirectional, num_buckets, max_dist).to(device)


def _rel_bias(table: torch.Tensor, q_len: int, k_len: int, bidirectional: bool,
              cfg: T5Config) -> torch.Tensor:
    """``[buckets, heads]`` table → ``[1, heads, q_len, k_len]`` f32 score
    bias."""
    ids = bucket_ids(q_len, k_len, bidirectional, cfg.rel_buckets, cfg.rel_max_distance,
                     table.device)
    return table[ids].permute(2, 0, 1)[None].float()


def init_t5(cfg: T5Config, seed: int, device: torch.device | str | None = None) -> dict:
    """Random parameters on ``device`` (CUDA unless ``"cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: every leaf of the reference's
    ``init_t5``, normal with std fan_in**-0.5 for the embedding, the bias
    tables (fan-in the bucket count) and the projections, the norms one."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    D, H, hd, F_, L = cfg.d_model, cfg.n_heads, cfg.d_kv, cfg.d_ff, cfg.n_layers

    def dense(shape: tuple, fan_in: int) -> torch.Tensor:
        w = torch.empty(shape, dtype=cfg.dtype, device=device)
        return w.normal_(0.0, fan_in**-0.5, generator=gen)

    def ones(*shape: int) -> torch.Tensor:
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    def attn(pre: str) -> dict:
        return {f"{pre}wq": dense((L, D, H * hd), D), f"{pre}wk": dense((L, D, H * hd), D),
                f"{pre}wv": dense((L, D, H * hd), D), f"{pre}wo": dense((L, H * hd, D), H * hd)}

    def ffn() -> dict:
        leaves = {"w_up": dense((L, D, F_), D), "w_down": dense((L, F_, D), F_)}
        if cfg.gated_ffn:
            leaves["w_gate"] = dense((L, D, F_), D)
        return leaves

    enc = {"ln1": ones(L, D), "ln2": ones(L, D), **attn("sa_"), **ffn()}
    dec = {"ln1": ones(L, D), "ln2": ones(L, D), "ln3": ones(L, D), **attn("sa_"),
           **attn("ca_"), **ffn()}
    params = {
        "embed": dense((cfg.vocab_size, D), D),
        "enc_rel_bias": dense((cfg.rel_buckets, H), cfg.rel_buckets),
        "dec_rel_bias": dense((cfg.rel_buckets, H), cfg.rel_buckets),
        "encoder": enc,
        "decoder": dec,
        "enc_norm": ones(D),
        "dec_norm": ones(D),
    }
    if not cfg.tied_head:
        params["lm_head"] = dense((D, cfg.vocab_size), D)
    return params


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _mha(h_q: torch.Tensor, h_kv: torch.Tensor, lp: dict, pre: str, cfg: T5Config,
         bias: Optional[torch.Tensor], mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Unscaled T5 attention. h_q [b, s_q, D], h_kv [b, s_kv, D]; bias
    [1, H, s_q, s_kv] f32 or None; mask [b|1, 1, s_q, s_kv] bool or None.
    Scores in f32 (bf16 operands are exact in f32), probabilities rounded
    to the activations' dtype before the value product."""
    b, s_q, _ = h_q.shape
    s_kv = h_kv.shape[1]
    H, hd = cfg.n_heads, cfg.d_kv
    q = _wein(h_q, lp[pre + "wq"]).reshape(b, s_q, H, hd).transpose(1, 2)
    k = _wein(h_kv, lp[pre + "wk"]).reshape(b, s_kv, H, hd).transpose(1, 2)
    v = _wein(h_kv, lp[pre + "wv"]).reshape(b, s_kv, H, hd).transpose(1, 2)
    scores = q.float() @ k.float().transpose(-1, -2)  # no 1/sqrt(d): T5
    if bias is not None:
        scores = scores + bias
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(h_q.dtype)
    out = (probs @ v).transpose(1, 2).reshape(b, s_q, H * hd)
    return _wein(out, lp[pre + "wo"])


def _ffn(h: torch.Tensor, lp: dict, cfg: T5Config) -> torch.Tensor:
    if cfg.gated_ffn:
        g = F.gelu(_wein(h, lp["w_gate"]), approximate="tanh")
        return _wein(g * _wein(h, lp["w_up"]), lp["w_down"])
    return _wein(F.relu(_wein(h, lp["w_up"])), lp["w_down"])


def _key_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[b] valid lengths → [b, 1, 1, n] key-validity mask."""
    return (torch.arange(n, device=lengths.device)[None, :] < lengths[:, None])[:, None, None, :]


def t5_encode(params: dict, tokens: torch.Tensor, lengths: torch.Tensor,
              cfg: T5Config) -> torch.Tensor:
    """tokens [b, s], lengths [b] → encoder states [b, s, D]."""
    s = tokens.shape[1]
    x = params["embed"][tokens.long()]
    bias = _rel_bias(params["enc_rel_bias"], s, s, True, cfg)
    key_ok = _key_mask(lengths, s)
    enc = params["encoder"]
    for i in range(cfg.n_layers):
        lp = _layer(enc, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _mha(h, h, lp, "sa_", cfg, bias, key_ok)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(h, lp, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _decode_hidden(params: dict, dec_tokens: torch.Tensor, enc_states: torch.Tensor,
                   enc_lengths: torch.Tensor, cfg: T5Config,
                   dec_lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder stack and its final norm: [b, t, D]."""
    t = dec_tokens.shape[1]
    s = enc_states.shape[1]
    dev = dec_tokens.device
    x = params["embed"][dec_tokens.long()]
    bias = _rel_bias(params["dec_rel_bias"], t, t, False, cfg)
    pos = torch.arange(t, device=dev)
    self_mask = (pos[None, :] <= pos[:, None])[None, None]  # [1, 1, t, t]
    if dec_lengths is not None:
        self_mask = self_mask & _key_mask(dec_lengths, t)
    cross_mask = _key_mask(enc_lengths, s)
    dec = params["decoder"]
    for i in range(cfg.n_layers):
        lp = _layer(dec, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + _mha(h, h, lp, "sa_", cfg, bias, self_mask)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mha(h, enc_states, lp, "ca_", cfg, None, cross_mask)
        h = rms_norm(x, lp["ln3"], cfg.norm_eps)
        x = x + _ffn(h, lp, cfg)
    return rms_norm(x, params["dec_norm"], cfg.norm_eps)


def _head(params: dict, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Hidden states → f32 logits (the tied head scaled by d_model**-0.5,
    the scale rounded to the activations' dtype as the reference's weak
    scalar is)."""
    if cfg.tied_head:
        x = x * torch.tensor(cfg.d_model**-0.5, dtype=x.dtype, device=x.device)
        return _wein(x, params["embed"].t()).float()
    return _wein(x, params["lm_head"]).float()


def t5_decode(params: dict, dec_tokens: torch.Tensor, enc_states: torch.Tensor,
              enc_lengths: torch.Tensor, cfg: T5Config,
              dec_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dec_tokens [b, t] (starting with pad = 0, the T5 BOS) → logits
    [b, t, vocab] f32. ``dec_lengths`` masks decoder self-attention keys
    beyond the valid prefix (generation's fixed buffer)."""
    return _head(params, _decode_hidden(params, dec_tokens, enc_states, enc_lengths, cfg,
                                        dec_lengths), cfg)


def _greedy_steps(params: dict, buf: torch.Tensor, done: torch.Tensor,
                  enc_states: torch.Tensor, enc_lengths: torch.Tensor, start: int,
                  steps: int, cfg: T5Config, eos_id: int) -> None:
    """``steps`` greedy steps from position ``start``, in place on ``buf``
    ([b, 1 + N]) and ``done`` ([b])."""
    b = buf.shape[0]
    for i in range(start, start + steps):
        lengths = torch.full((b,), i + 1, dtype=torch.long, device=buf.device)
        h = _decode_hidden(params, buf, enc_states, enc_lengths, cfg, lengths)
        nxt = _head(params, h[:, i:i + 1], cfg)[:, 0].argmax(dim=-1)
        nxt = torch.where(done, torch.zeros_like(nxt), nxt)
        buf[:, i + 1] = nxt
        done |= nxt == eos_id


def t5_generate(params: dict, tokens: torch.Tensor, lengths: torch.Tensor, cfg: T5Config,
                max_new: int = 32, eos_id: int = 1) -> torch.Tensor:
    """Batched greedy generation: tokens [b, s] + lengths [b] → generated
    ids [b, max_new] (int64; entries after EOS are pad = 0). The encoder
    once, then ``max_new`` decoder runs over the fixed ``[b, 1 + max_new]``
    buffer."""
    enc = t5_encode(params, tokens, lengths, cfg)
    b = tokens.shape[0]
    buf = torch.zeros((b, 1 + max_new), dtype=torch.long, device=tokens.device)
    done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    _greedy_steps(params, buf, done, enc, lengths, 0, max_new, cfg, eos_id)
    return buf[:, 1:]


def t5_generate_chunk(params: dict, buf: torch.Tensor, done: torch.Tensor,
                      enc_states: torch.Tensor, enc_lengths: torch.Tensor, start: int,
                      cfg: T5Config, chunk: int, eos_id: int = 1) -> tuple:
    """Advance the fixed ``[b, 1 + N]`` answer buffer by ``chunk`` greedy
    steps from position ``start`` — the stepped-decode unit behind
    streaming seq2seq. The picks equal ``t5_generate``'s: positions past
    ``dec_lengths`` are masked, so the buffer's length does not change the
    logits. ``buf`` and ``done`` are updated in place (the reference
    donates them) and returned."""
    _greedy_steps(params, buf, done, enc_states, enc_lengths, int(start), chunk, cfg, eos_id)
    return buf, done


def config_from_hf_t5(path: str) -> T5Config:
    """A ``T5Config`` from an HF t5/flan-t5 ``config.json``, with the
    reference's refusals."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type") != "t5":
        raise ValueError(f"not a t5 checkpoint: {hf.get('model_type')!r}")
    if hf.get("num_decoder_layers", hf["num_layers"]) != hf["num_layers"]:
        raise ValueError("asymmetric encoder/decoder depths are not supported")
    proj = hf.get("feed_forward_proj", "relu")
    if proj not in ("relu", "gated-gelu"):
        # 'gated-relu' / plain 'gelu' would run the wrong activation.
        raise ValueError(f"unsupported t5 feed_forward_proj {proj!r}")
    return T5Config(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        d_kv=hf["d_kv"],
        n_heads=hf["num_heads"],
        n_layers=hf["num_layers"],
        d_ff=hf["d_ff"],
        rel_buckets=hf.get("relative_attention_num_buckets", 32),
        rel_max_distance=hf.get("relative_attention_max_distance", 128),
        norm_eps=float(hf.get("layer_norm_epsilon", 1e-6)),
        gated_ffn=proj.startswith("gated"),
        tied_head=bool(hf.get("tie_word_embeddings", True)),
    )


_MATCHED = ("vocab_size", "d_model", "d_kv", "n_heads", "n_layers", "d_ff", "rel_buckets",
            "rel_max_distance", "gated_ffn", "tied_head")


def load_hf_t5(path: str, cfg: Optional[T5Config] = None, *, quant: str = "",
               device: torch.device | str | None = None) -> dict:
    """An HF t5/flan-t5 safetensors checkpoint → the T5 tree on ``device``
    (CUDA unless ``"cpu"``), leaves in ``cfg.dtype``. HF linears are
    ``[out, in]`` and are transposed; per-layer tensors stack along the
    layer axis; the relative-bias tables live in block 0 of each stack;
    gated checkpoints map ``wi_0`` → ``w_gate`` and ``wi_1`` → ``w_up``,
    relu ones ``wi`` → ``w_up``; ``shared.weight`` is the embedding, and a
    tied checkpoint has no ``lm_head``. With ``quant`` (``"int8"`` /
    ``"int4"``) each projection is quantized a layer at a time as it lands
    (``hf_loader``'s discipline): the whole bf16 tree never exists."""
    from gofr_tpu_torch.ops.quant import empty_quantized, quantize_into
    from gofr_tpu_torch.serving.hf_loader import _TensorSource

    file_cfg = config_from_hf_t5(path)
    if cfg is None:
        cfg = file_cfg
    else:
        for field in _MATCHED:
            want, have = getattr(cfg, field), getattr(file_cfg, field)
            if want != have:
                raise ValueError(
                    f"checkpoint/config mismatch: {field}={have} in "
                    f"{path}/config.json but engine expects {want}"
                )
    if quant and quant not in ("int8", "int4"):
        raise ValueError(f"unsupported quant {quant!r}")
    device = resolve_device(device)
    src = _TensorSource(path)
    L = cfg.n_layers

    def get(name: str) -> torch.Tensor:
        return src.get(name).to(device)

    def whole(name: str) -> torch.Tensor:
        out = torch.empty(src.get(name).shape, dtype=cfg.dtype, device=device)
        out.copy_(get(name))
        return out

    def stack(fmt: str, transpose: bool = True, quantize: bool = False):
        """A ``[L, ...]`` leaf filled a layer at a time (quantized into
        place with ``quant``)."""
        first = src.get(fmt.format(0))
        shape = (L, *(first.shape[::-1] if transpose else first.shape))
        q = quant if quantize else ""
        out = (empty_quantized(q, shape, device) if q
               else torch.empty(shape, dtype=cfg.dtype, device=device))
        for i in range(L):
            w = get(fmt.format(i))
            w = (w.t() if transpose else w).to(cfg.dtype)
            if q:
                quantize_into(out, i, w)
            else:
                out[i] = w
        return out

    def attn(side: str, layer_idx: int, pre: str) -> dict:
        kind = "SelfAttention" if layer_idx == 0 else "EncDecAttention"
        base = f"{side}.block.{{}}.layer.{layer_idx}.{kind}."
        return {f"{pre}{w}": stack(base + f"{h}.weight", quantize=True)
                for w, h in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "o"))}

    def ffn(side: str, layer_idx: int) -> dict:
        base = f"{side}.block.{{}}.layer.{layer_idx}.DenseReluDense."
        if cfg.gated_ffn:
            return {"w_gate": stack(base + "wi_0.weight", quantize=True),
                    "w_up": stack(base + "wi_1.weight", quantize=True),
                    "w_down": stack(base + "wo.weight", quantize=True)}
        return {"w_up": stack(base + "wi.weight", quantize=True),
                "w_down": stack(base + "wo.weight", quantize=True)}

    def norm(side: str, layer_idx: int):
        return stack(f"{side}.block.{{}}.layer.{layer_idx}.layer_norm.weight", False)

    params = {
        "embed": whole("shared.weight"),
        "enc_rel_bias": whole(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "dec_rel_bias": whole(
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "encoder": {"ln1": norm("encoder", 0), "ln2": norm("encoder", 1),
                    **attn("encoder", 0, "sa_"), **ffn("encoder", 1)},
        "decoder": {"ln1": norm("decoder", 0), "ln2": norm("decoder", 1),
                    "ln3": norm("decoder", 2), **attn("decoder", 0, "sa_"),
                    **attn("decoder", 1, "ca_"), **ffn("decoder", 2)},
        "enc_norm": whole("encoder.final_layer_norm.weight"),
        "dec_norm": whole("decoder.final_layer_norm.weight"),
    }
    if not cfg.tied_head:
        head = get("lm_head.weight").t().to(cfg.dtype)
        params["lm_head"] = quant_fn(quant)(head) if quant else head.contiguous()
    return params


# The reference's quantization policy (``gofr_tpu/ops/quant.py::_QUANT_KEYS``),
# read after the sa_/ca_ prefix: the attention and FFN projections and the
# untied head. Norms, the embedding and the bias tables stay in the dtype.
T5_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})


def quantize_t5_params(params: dict, mode: str = "int8") -> dict:
    """Weight-only int8/int4 quantization of a T5 tree's matmul leaves (the
    reference's, as it runs under jit): a new tree, the other leaves the
    same tensors."""
    quant = quant_fn(mode)

    def qsub(tree: dict) -> dict:
        return {k: quant(v) if k.removeprefix("sa_").removeprefix("ca_") in T5_QUANT_KEYS
                else v for k, v in tree.items()}

    out = dict(params)
    out["encoder"] = qsub(params["encoder"])
    out["decoder"] = qsub(params["decoder"])
    if "lm_head" in params:
        out["lm_head"] = quant(params["lm_head"])
    return out


def t5_param_count(cfg: T5Config) -> int:
    """Parameters of the tree ``init_t5`` makes."""
    D, A, F_, L = cfg.d_model, cfg.n_heads * cfg.d_kv, cfg.d_ff, cfg.n_layers
    ffn = (3 if cfg.gated_ffn else 2) * D * F_
    enc = L * (2 * D + 4 * D * A + ffn)
    dec = L * (3 * D + 8 * D * A + ffn)
    top = cfg.vocab_size * D * (1 if cfg.tied_head else 2) + 2 * cfg.rel_buckets * cfg.n_heads
    return enc + dec + top + 2 * D
