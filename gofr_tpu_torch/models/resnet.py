"""ResNet-50 — the port of ``gofr_tpu/models/resnet.py`` (image
classification over HTTP, BASELINE config 2): a bottleneck ResNet with
inference-mode batch norm (stored moments, folded into a scale and a
bias), the serving path.

Three things follow the reference exactly rather than PyTorch's habits:

* **Padding is XLA's ``"SAME"``**, which is asymmetric where the stride
  does not divide the window: the stem's 7x7/2 convolution on 224 pads
  (2, 3), each 3x3/2 convolution (0, 1), and the 3x3/2 max pool (0, 1)
  with -inf. ``F.pad`` pads explicitly (``same_pads``); a symmetric
  ``padding=`` would shift every window by one.
* **The activations are f32 after the stem.** The input is cast to
  ``cfg.dtype`` (bf16) for the stem convolution; its batch norm multiplies
  by f32 parameters, which promotes the result to f32, and from then on
  each convolution casts its weight to the activation's dtype: every
  later convolution runs in f32, as in the reference. No autocast, and no
  ``nn.BatchNorm2d``.
* **Layout.** The reference's activations are NHWC and its weights HWIO;
  the port takes the same NHWC images, runs NCHW (PyTorch's convolution
  layout) with OIHW weights (``weights.resnet_params_from_jax`` carries
  them across) and returns the same [b, classes] f32 logits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Field for field the reference ``ResNetConfig``; ``dtype`` is a
    torch dtype."""

    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16


def init_resnet(cfg: ResNetConfig, seed: int,
                device: torch.device | str | None = None) -> dict:
    """Random f32 parameters on ``device`` (CUDA unless ``"cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: the reference's
    ``init_resnet`` tree (convolutions He-normal, batch norm at identity,
    the head normal with std in_ch**-0.5), convolution weights OIHW.
    ``stages`` is a list of stages, each a list of block dicts."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def conv(k: int, c_in: int, c_out: int) -> torch.Tensor:
        w = torch.empty((c_out, c_in, k, k), dtype=torch.float32, device=device)
        return w.normal_(0.0, (2.0 / (k * k * c_in)) ** 0.5, generator=gen)

    def bn(c: int) -> dict:
        return {
            "scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device),
        }

    params: dict = {
        "stem": {"conv": conv(7, 3, cfg.width), "bn": bn(cfg.width)},
        "stages": [],
    }
    in_ch = cfg.width
    for stage_idx, n_blocks in enumerate(cfg.stage_sizes):
        mid_ch = cfg.width * (2**stage_idx)
        out_ch = mid_ch * 4
        blocks = []
        for block_idx in range(n_blocks):
            block = {
                "conv1": conv(1, in_ch, mid_ch), "bn1": bn(mid_ch),
                "conv2": conv(3, mid_ch, mid_ch), "bn2": bn(mid_ch),
                "conv3": conv(1, mid_ch, out_ch), "bn3": bn(out_ch),
            }
            if block_idx == 0:
                block["proj"] = conv(1, in_ch, out_ch)
                block["proj_bn"] = bn(out_ch)
            blocks.append(block)
            in_ch = out_ch
        params["stages"].append(blocks)
    head = torch.empty((in_ch, cfg.num_classes), device=device)
    params["head"] = {
        "w": head.normal_(0.0, in_ch**-0.5, generator=gen),
        "b": torch.zeros((cfg.num_classes,), device=device),
    }
    return params


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: (low, high), the odd
    pixel at the high end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """NCHW ``x`` padded for a k x k window at ``stride`` as ``"SAME"``."""
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of NCHW ``x`` by OIHW ``w`` cast to x's dtype."""
    return F.conv2d(_pad_same(x, w.shape[-1], stride), w.to(x.dtype), stride=stride)


def _bn(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over the channel axis; f32 parameters promote
    a bf16 ``x`` to f32, as in the reference."""
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    shift = p["bias"] - p["mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def _bottleneck(x: torch.Tensor, block: dict, stride: int) -> torch.Tensor:
    out = F.relu(_bn(_conv(x, block["conv1"]), block["bn1"]))
    out = F.relu(_bn(_conv(out, block["conv2"], stride=stride), block["bn2"]))
    out = _bn(_conv(out, block["conv3"]), block["bn3"])
    if "proj" in block:
        x = _bn(_conv(x, block["proj"], stride=stride), block["proj_bn"])
    return F.relu(out + x)


def resnet_forward(params: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """images: [b, H, W, 3] NHWC (any H, W divisible by 32) → logits
    [b, classes] f32."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2).contiguous()
    x = _conv(x, params["stem"]["conv"], stride=2)
    x = F.relu(_bn(x, params["stem"]["bn"]))
    x = F.max_pool2d(_pad_same(x, 3, 2, value=float("-inf")), 3, stride=2)
    for stage_idx, blocks in enumerate(params["stages"]):
        for block_idx, block in enumerate(blocks):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            x = _bottleneck(x, block, stride)
    x = x.float().mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]
