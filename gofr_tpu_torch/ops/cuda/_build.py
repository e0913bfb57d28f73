"""Build the port's CUDA kernels and load them with ctypes.

Every ``*.cu`` under ``gofr_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process (all started together) for ``sm_90a``, then linked into
one shared library with a plain C interface, at first use. The library
lands in ``gofr_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so an unchanged tree reuses it.
Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What nvcc printed per source in the last verbose build (with -Xptxas -v:
# each kernel's registers, spills, stack and barriers).
ptxas_log: dict[str, str] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on a machine with the "
        "CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels (unless this tree's library exists) and return
    the library's path. ``verbose`` adds ``-Xptxas -v`` and prints what
    nvcc says (registers, shared memory and spills per kernel)."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"libgofr_kernels_{_digest(sources + headers)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, *extra, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failures = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
            elif verbose and out.strip():
                ptxas_log[src.name] = out
                print(f"[nvcc {src.name}]\n{out.strip()}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, lib_path)
    return lib_path


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build(verbose=verbose)))
        return _lib
