"""Hand-written CUDA kernels of the port and their ctypes wrappers.

Each kernel module holds the wrapper, the plain PyTorch version of the
same function (the CPU path, and what the kernel is held against on the
card), and a ``launches`` counter of the launches the device ran: the
wrapper adds one where it launches its kernel eagerly; under a CUDA graph
capture (``recording``) the launch is recorded for the graph, and each
replay adds the recorded launches (``replayed``).
"""

from gofr_tpu_torch.ops.cuda import flash_attention, flash_decode, flash_prefill
from gofr_tpu_torch.ops.cuda._count import recording, replayed

KERNELS = {
    "flash_decode": flash_decode,
    "flash_cache_attention": flash_prefill,
    "flash_attention": flash_attention,
}

__all__ = ["KERNELS", "launch_counts", "record_counts", "recording", "replayed",
           "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def record_counts(record) -> dict[str, int]:
    """A ``recording()`` record by kernel name."""
    by_module = {mod.__name__: name for name, mod in KERNELS.items()}
    return {by_module[m]: n for m, n in record.items()}
