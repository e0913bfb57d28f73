"""Checks of the Hopper primitives the attention kernels are built from
(``gofr_tpu_torch/csrc/sm90_selftest.cu``), each beside the plain PyTorch
result it must equal. They run on the card only (``chip_smoke.py``'s
pre-phase, ``tests/test_torch_gpu.py``); the CPU tests run the same C
entries under the emulator. None of them is a ported kernel.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops.cuda import _build

K = 128  # depth of the test product


def _run(name: str, ptrs: list, ints: list, dev: torch.device, ptrs2: tuple = (),
         ints2: tuple = ()) -> None:
    """Call C entry ``name(*ptrs, *ints, *ptrs2, *ints2, stream)``."""
    fn = getattr(_build.lib(), name)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p] * len(ptrs2) + [ctypes.c_int] * len(ints2)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(*ptrs, *ints, *ptrs2, *ints2, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def wgmma_product(a: torch.Tensor, b: torch.Tensor, *, b_mn_major: bool,
                  a_regs: bool) -> torch.Tensor:
    """D = A . B by 8 k-steps of one warpgroup's wgmma m64nNk16 (f32).
    a: [64, 128] bf16; b: [n, 128] (K-major) or [128, n] (MN-major) bf16,
    n 64 or 128. Returns [64, n] f32."""
    n = b.shape[1] if b_mn_major else b.shape[0]
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    _run("gofr_sm90_wgmma_test", [a.data_ptr(), b.data_ptr(), d.data_ptr()],
         [n, int(b_mn_major), int(a_regs)], a.device)
    return d


def wgmma_product_plain(a: torch.Tensor, b: torch.Tensor, *, b_mn_major: bool) -> torch.Tensor:
    return a.float() @ (b.float() if b_mn_major else b.float().t())


def ring_roundtrip(src: torch.Tensor) -> torch.Tensor:
    """src: [n_tiles, 128, 8] int16 through a 3-stage mbarrier ring; each
    consumer thread reads the chunk another producer thread copied."""
    dst = torch.empty_like(src)
    _run("gofr_sm90_ring_test", [src.data_ptr(), dst.data_ptr()], [src.shape[0]], src.device)
    return dst


def ring_roundtrip_plain(src: torch.Tensor) -> torch.Tensor:
    return torch.roll(src, shifts=-37, dims=1)


def tma_box(src: torch.Tensor, r0: int) -> torch.Tensor:
    """One TMA box of 128 rows x 64 columns of src [rows, cols] bf16 from
    row r0, rows past the end zero-filled. Returns [128, 64] bf16."""
    rows, cols = src.shape
    dst = torch.empty((128, 64), dtype=torch.bfloat16, device=src.device)
    _run("gofr_sm90_tma_test", [src.data_ptr(), dst.data_ptr()], [rows, cols, r0], src.device)
    return dst


def tma_box_plain(src: torch.Tensor, r0: int) -> torch.Tensor:
    out = torch.zeros((128, 64), dtype=src.dtype, device=src.device)
    part = src[r0:r0 + 128, :64]
    out[:part.shape[0]] = part
    return out


def bulk_roundtrip(src: torch.Tensor,
                   words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """src: uint8 [bytes] (a multiple of 16) by one 1-D bulk copy, and
    words: int32 [n] by 4-byte cp.async copies, through shared memory on
    one mbarrier phase. Returns the copies of both."""
    dst, dst_words = torch.empty_like(src), torch.empty_like(words)
    _run("gofr_sm90_bulk_test", [src.data_ptr(), dst.data_ptr()], [src.numel()], src.device,
         [words.data_ptr(), dst_words.data_ptr()], [words.numel()])
    return dst, dst_words


def cluster_exchange(src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """src: int32 [n_clusters * 4, 128] through clusters of 4 blocks: each
    block returns its next peer's row rotated by 37, read from that peer's
    shared memory, and its own rank in the cluster."""
    dst = torch.empty_like(src)
    ranks = torch.empty(src.shape[0], dtype=torch.int32, device=src.device)
    _run("gofr_sm90_cluster_test", [src.data_ptr(), dst.data_ptr(), ranks.data_ptr()],
         [src.shape[0] // 4], src.device)
    return dst, ranks


def cluster_exchange_plain(src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n = src.shape[0]
    blocks = torch.arange(n, device=src.device)
    peer = blocks // 4 * 4 + (blocks + 1) % 4
    return torch.roll(src[peer], shifts=-37, dims=1), (blocks % 4).to(torch.int32)
