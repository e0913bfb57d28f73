"""Weight-only int8 and int4 quantization for serving — the port of
``gofr_tpu/ops/quant.py``.

A quantized weight is a :class:`Q8` (int8 ``q`` of the weight's shape,
f32 per-output-column scales ``s`` of shape ``[..., 1, out]``) or a
:class:`Q4` (two's-complement nibbles packed two to a byte along the
contraction axis, ``q`` ``[..., D/2, out]`` uint8, and f32 scales
``[..., G, 1, out]``, one per ``group`` contraction rows and column). Both
index by their leading axes (``w[layer]`` is that layer's Q8/Q4), so the
model's ``params["wqkv"][layer]`` reads the same for plain and quantized
weights; ``models/transformer.py::_wein`` does the product. Embeddings,
norms, biases and the MoE router stay in the model dtype.

Every matmul weight contracts its second-to-last axis, and the scales
reduce only that axis, so quantizing the port's fused leaves (``wqkv`` =
Q|K|V, ``w_gate_up`` = gate|up, concatenated along the output axis) gives,
bit for bit, the reference's separate Q8/Q4 leaves concatenated along that
axis: each output column's scale sees only that column. The same holds for
any split along a leading axis (a layer, an expert), which is what lets a
leaf be quantized one slice at a time.

The ``PartitionSpec`` helpers (``q8_spec``, ``q4_spec``,
``quantized_param_specs``) wait for the multi-device slice (ROADMAP Queue 1
item 8).
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class _Quantized:
    """A quantized weight: ``q`` and ``s`` as tensors, indexed together
    along their leading axes."""

    __slots__ = ("q", "s")
    mode = ""

    def __init__(self, q: Any, s: Any) -> None:
        self.q = q
        self.s = s

    def __getitem__(self, idx: Any):
        return type(self)(self.q[idx], self.s[idx])

    def to(self, *args: Any, **kw: Any):
        """``q`` and ``s`` moved (a device only: their dtypes are fixed)."""
        return type(self)(self.q.to(*args, **kw), self.s.to(*args, **kw))

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.q, self.s))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={tuple(self.shape)}, q={self.q.dtype})"


class Q8(_Quantized):
    """Int8 weight ``q`` (the weight's shape) and f32 per-output-column
    scales ``s`` (``[..., 1, out]``)."""

    mode = "int8"

    @property
    def shape(self) -> torch.Size:
        return self.q.shape


class Q4(_Quantized):
    """Int4 weight nibble-packed along the contraction axis (``q``
    ``[..., D/2, out]`` uint8, the even row in the high nibble) and f32
    group scales ``s`` ``[..., G, 1, out]``."""

    mode = "int4"

    @property
    def shape(self) -> torch.Size:  # the logical (unpacked) shape
        *lead, d2, o = self.q.shape
        return torch.Size((*lead, d2 * 2, o))


def is_quantized(w: Any) -> bool:
    return isinstance(w, _Quantized)


def _slices(*shape_lead: int):
    """Every index tuple over the leading axes ``shape_lead`` (one empty
    tuple when there are none)."""
    idx = [()]
    for n in shape_lead:
        idx = [i + (j,) for i in idx for j in range(n)]
    return idx


# The reference quantizes under jit, where XLA turns ``absmax / 127.0``
# (``/ 7.0``) into a product with the reciprocal rounded to f32, which
# differs from the division in the last bit of some scales; the port
# computes what the reference serves with (its loader, its quantized
# init and ``apply_quantization`` are all jitted).
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
_INV_7 = torch.tensor(1.0 / 7.0, dtype=torch.float32).item()


# Contraction rows per int4 scale (shrunk to the axis where it does not
# divide it), the reference's default.
GROUP = 128


def _q8_slice(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _INV_127, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _q4_slice(w: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    D, O = w.shape[-2:]
    G = D // group
    wf = w.float().reshape(G, group, O)
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # [G, 1, O]
    scale = torch.where(absmax > 0, absmax * _INV_7, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32).reshape(D, O)
    nib = torch.where(q < 0, q + 16, q).to(torch.uint8)  # two's complement
    return (nib[0::2] << 4) | nib[1::2], scale


def _group(D: int, group: int) -> int:
    if D % 2:
        raise ValueError(f"int4 nibble packing needs an even contraction "
                         f"axis, got {D}")
    return D if D % group else group


def quantize_array(w: torch.Tensor) -> Q8:
    """Absmax int8 over the contraction (-2) axis, the reference's
    ``quantize_array`` as it runs under jit: ``s = absmax * f32(1/127)``
    (1 for an all-zero column), ``q = clip(round(w / s), -127, 127)``, in
    f32. Computed one leading-axis slice at a time into the stacked
    result, so the f32 temporaries stay one matrix large."""
    *lead, D, O = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((*lead, 1, O), dtype=torch.float32, device=w.device)
    for i in _slices(*lead):
        q[i], s[i] = _q8_slice(w[i])
    return Q8(q, s)


def quantize_array4(w: torch.Tensor, group: int = GROUP) -> Q4:
    """Group-wise absmax int4 over the contraction axis, nibble-packed, the
    reference's ``quantize_array4``: ``group`` shrinks to the axis when it
    does not divide it, and an odd axis is refused. One leading-axis slice
    at a time, as ``quantize_array``."""
    *lead, D, O = w.shape
    group = _group(D, group)
    q = torch.empty((*lead, D // 2, O), dtype=torch.uint8, device=w.device)
    s = torch.empty((*lead, D // group, 1, O), dtype=torch.float32, device=w.device)
    for i in _slices(*lead):
        q[i], s[i] = _q4_slice(w[i], group)
    return Q4(q, s)


def empty_quantized(mode: str, shape: tuple, device: Any) -> Q8 | Q4:
    """An uninitialised Q8/Q4 of logical ``shape``, to be filled a slice at
    a time with ``quantize_into``."""
    *lead, D, O = shape
    if mode == "int8":
        return Q8(torch.empty(shape, dtype=torch.int8, device=device),
                  torch.empty((*lead, 1, O), dtype=torch.float32, device=device))
    group = _group(D, GROUP)
    return Q4(torch.empty((*lead, D // 2, O), dtype=torch.uint8, device=device),
              torch.empty((*lead, D // group, 1, O), dtype=torch.float32, device=device))


def quantize_into(dst: Q8 | Q4, idx: Any, w: torch.Tensor) -> None:
    """Quantize ``w`` into ``dst[idx]`` (a leading-axis slice of a stacked
    leaf); exact, since the scales reduce only the contraction axis."""
    part = quantize_array(w) if isinstance(dst, Q8) else quantize_array4(w)
    dst.q[idx] = part.q
    dst.s[idx] = part.s


def dequantize(w: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The weight in ``dtype``: ``q * s`` in f32, then rounded, as the
    reference; a plain tensor passes through."""
    if isinstance(w, Q8):
        return (w.q.float() * w.s).to(dtype)
    if isinstance(w, Q4):
        *lead, D2, O = w.q.shape
        D = D2 * 2
        hi = (w.q >> 4).to(torch.int32)
        lo = (w.q & 0xF).to(torch.int32)
        n = torch.stack([hi, lo], dim=-2)  # [..., D/2, 2, O]
        n = torch.where(n > 7, n - 16, n).reshape(*lead, D, O)
        G = w.s.shape[-3]
        wf = n.float().reshape(*lead, G, D // G, O) * w.s
        return wf.reshape(*lead, D, O).to(dtype)
    return w


# The port's matmul weights (Q/K/V and gate/up fused): the reference's
# ``_QUANT_KEYS`` plus ``lm_head``. The embedding (a gather), the norms,
# the biases and the MoE router (tiny, and a flipped top-k changes which
# experts run) stay in the model dtype.
QUANT_KEYS = ("wqkv", "wo", "w_gate_up", "w_up", "w_down", "lm_head")


def quant_fn(mode: str) -> Callable[[torch.Tensor], Q8 | Q4]:
    if mode == "int8":
        return quantize_array
    if mode == "int4":
        return quantize_array4
    raise ValueError(f"unsupported quant mode {mode!r} (int8 or int4)")


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """A new parameter dict with every ``QUANT_KEYS`` leaf quantized (Q8 or
    Q4); the other leaves are the same tensors."""
    quant = quant_fn(mode)
    return {k: quant(v) if k in QUANT_KEYS else v for k, v in params.items()}


def params_quant_mode(params: dict) -> str:
    """``"int8"``, ``"int4"`` or ``""``: the mode of the first quantized
    leaf of a parameter dict (nested dicts included: T5's stacks)."""
    for leaf in params.values():
        if isinstance(leaf, _Quantized):
            return leaf.mode
        if isinstance(leaf, dict):
            mode = params_quant_mode(leaf)
            if mode:
                return mode
    return ""


def quantized_bytes(params: dict) -> int:
    """Parameter bytes as stored: int8 one byte an element, int4 half (its
    packed uint8), the f32 scales, every plain leaf at its itemsize (nested
    dicts included)."""
    return int(sum(v.nbytes if isinstance(v, _Quantized)
                   else quantized_bytes(v) if isinstance(v, dict)
                   else v.numel() * v.element_size() for v in params.values()))
