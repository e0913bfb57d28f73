"""The port stands alone: importing every gofr_tpu_torch module and
chip_smoke's import surface pulls in neither JAX nor anything of gofr_tpu.
Checked in a subprocess (this test process has JAX loaded by conftest),
with an import hook that refuses those packages outright. Also: without
CUDA, chip_smoke.py exits non-zero and prints no result — in the repo and
alone in an empty directory."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

def banned(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib") or root == "gofr_tpu"

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import gofr_tpu_torch
names = ["chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(gofr_tpu_torch.__path__, "gofr_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
for fn in (chip_smoke.phase_kernels, chip_smoke.phase_kernel_variants,
           chip_smoke.phase_forward, chip_smoke.phase_serve,
           chip_smoke.phase_profile, chip_smoke.phase_flash_attention,
           chip_smoke.phase_attention_grad, chip_smoke.phase_train,
           chip_smoke.phase_prefill_padded):
    assert callable(fn)
leaked = sorted(m for m in sys.modules if banned(m))
assert not leaked, leaked
print("imported", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_neither_jax_nor_gofr_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[-1])
    assert n >= 20  # every module of the package, not a stub


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_cuda(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even where there is one
    out = _run_smoke(REPO, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone)
    env.pop("PYTHONPATH")
    out = _run_smoke(alone, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
