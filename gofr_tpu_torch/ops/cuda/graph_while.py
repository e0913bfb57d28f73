"""A CUDA graph with a device-side loop (``csrc/graph_while.cu``):

    [prologue] -> set(go) -> WHILE { [body] -> set(go) }

``prologue`` and ``body`` are graphs PyTorch captured with
``keep_graph=True`` (``raw_cuda_graph()``); ``go`` is an int32 on the
device that both write last. The runtime clones them into the loop graph,
so their captures (which own the graph memory their tensors live in) must
outlive it. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops.cuda import _build

_fns = None


def _lib_fns():
    global _fns
    if _fns is None:
        lib = _build.lib()
        build = lib.gofr_while_graph_build
        build.argtypes = [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p)] * 2
        build.restype = ctypes.c_int
        launch = lib.gofr_while_graph_launch
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        launch.restype = ctypes.c_int
        destroy = lib.gofr_while_graph_destroy
        destroy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        destroy.restype = ctypes.c_int
        _fns = (build, launch, destroy)
    return _fns


class WhileGraph:
    """The instantiated loop graph; ``launch()`` enqueues it on the current
    stream."""

    def __init__(self, prologue: int, body: int, go: torch.Tensor) -> None:
        if go.dtype != torch.int32 or go.numel() != 1 or go.device.type != "cuda":
            raise ValueError("go must be one int32 on the card")
        build, self._launch, self._destroy = _lib_fns()
        graph, exec_ = ctypes.c_void_p(), ctypes.c_void_p()
        rc = build(prologue, body, go.data_ptr(), ctypes.byref(graph), ctypes.byref(exec_))
        if rc != 0:
            raise RuntimeError(f"building the WHILE graph failed: cudaError {rc}")
        self._graph, self._exec = graph.value, exec_.value
        self._go = go  # the loop reads it on every launch

    def launch(self) -> None:
        rc = self._launch(self._exec, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launching the WHILE graph failed: cudaError {rc}")

    def __del__(self) -> None:
        if getattr(self, "_exec", None) is not None:
            self._destroy(self._graph, self._exec)
            self._exec = None
