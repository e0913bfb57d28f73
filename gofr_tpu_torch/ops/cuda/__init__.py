"""Hand-written CUDA kernels of the port and their ctypes wrappers.

Each kernel module holds the wrapper, the plain PyTorch version of the
same function (the CPU path, and what the kernel is held against on the
card), and a ``launches`` counter that the wrapper bumps once per kernel
launch and nowhere else.
"""

from gofr_tpu_torch.ops.cuda import flash_attention, flash_decode, flash_prefill

KERNELS = {
    "flash_decode": flash_decode,
    "flash_cache_attention": flash_prefill,
    "flash_attention": flash_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
