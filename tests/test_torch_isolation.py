"""The port stands alone: importing every gofr_tpu_torch module and
chip_smoke's import surface pulls in neither JAX nor anything of gofr_tpu,
nor the packages the card's machine lacks (transformers, tokenizers,
regex, jinja2: the port's tokenizers use the standard library), nor a
pub/sub, SQL or HTTP client driver (kafka, google, pymysql, psycopg2,
httpx, urllib3, requests, aiohttp), nor gRPC's (grpc, h2, hpack,
hyperframe, google.protobuf: the port speaks gRPC on the standard
library), even when the backend factories that would want one run.
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

# Some installs put the bare ``google``/``google.cloud`` namespace packages
# in sys.modules at interpreter start; only what the port imports counts.
PRELOADED = set(sys.modules)

def banned(name):
    root = name.split(".")[0]
    return name not in PRELOADED and root in (
        "jax", "jaxlib", "gofr_tpu", "transformers", "tokenizers", "regex", "jinja2",
        "kafka", "google", "pymysql", "psycopg2", "httpx", "grpc", "h2", "hpack",
        "hyperframe", "aiohttp", "urllib3", "requests")

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
           chip_smoke.phase_prefill_padded, chip_smoke.phase_window_kernels,
           chip_smoke.phase_window_grad, chip_smoke.phase_mistral_forward,
           chip_smoke.phase_full_sequence, chip_smoke.phase_serve_options,
           chip_smoke.phase_http, chip_smoke.phase_pubsub, chip_smoke.phase_lora,
           chip_smoke.phase_lora_train,
           chip_smoke.phase_device_services, chip_smoke.phase_encoders,
           chip_smoke.phase_family_train, chip_smoke.profiler_under_replays,
           chip_smoke.phase_grpc):
    assert callable(fn)
for name in ("gofr_tpu_torch.serving.lora", "gofr_tpu_torch.serving.lora_runtime",
             "gofr_tpu_torch.serving.hf_tokenizer", "gofr_tpu_torch.serving.native_tokenizer",
             "gofr_tpu_torch.serving.device_telemetry",
             "gofr_tpu_torch.serving.profiler_capture",
             "gofr_tpu_torch.analysis.lockcheck", "gofr_tpu_torch.serving.batcher",
             "gofr_tpu_torch.serving.modalities", "gofr_tpu_torch.models.bert",
             "gofr_tpu_torch.models.vit", "gofr_tpu_torch.models.resnet",
             "gofr_tpu_torch.subscriber", "gofr_tpu_torch.crud",
             "gofr_tpu_torch.datasource.mongo", "gofr_tpu_torch.datasource.pubsub.base",
             "gofr_tpu_torch.datasource.pubsub.inproc", "gofr_tpu_torch.datasource.pubsub.mqtt",
             "gofr_tpu_torch.datasource.pubsub.kafka", "gofr_tpu_torch.datasource.pubsub.google",
             "gofr_tpu_torch.datasource.redis.client", "gofr_tpu_torch.datasource.redis.miniredis",
             "gofr_tpu_torch.datasource.sql.db", "gofr_tpu_torch.datasource.sql.fakedb",
             "gofr_tpu_torch.datasource.sql.query_builder", "gofr_tpu_torch.migration.migration",
             "gofr_tpu_torch.tracing.exporter", "gofr_tpu_torch.cli.cmd",
             "gofr_tpu_torch.testutil.mqtt_broker", "gofr_tpu_torch.grpc.protowire",
             "gofr_tpu_torch.grpc.inference_pb2", "gofr_tpu_torch.grpc.hpack",
             "gofr_tpu_torch.grpc.h2", "gofr_tpu_torch.grpc.server",
             "gofr_tpu_torch.grpc.channel", "gofr_tpu_torch.grpc.inference_pb2_grpc",
             "gofr_tpu_torch.grpc.inference", "gofr_tpu_torch.grpc.inference_typed",
             "gofr_tpu_torch.faults.injector", "gofr_tpu_torch.service.wrapper",
             "gofr_tpu_torch.service.client", "gofr_tpu_torch.service.options",
             "gofr_tpu_torch.service.circuit_breaker"):
    assert name in names, name
leaked = sorted(m for m in sys.modules if banned(m))
assert not leaked, leaked
# Every backend factory runs without a driver: KAFKA and GOOGLE log and
# give no client, as do mysql and postgres with no registered factory.
from gofr_tpu_torch.config import MockConfig
from gofr_tpu_torch.datasource.pubsub import new_pubsub_from_config
from gofr_tpu_torch.datasource.sql import new_sql_from_config
for backend in ("KAFKA", "GOOGLE"):
    assert new_pubsub_from_config(MockConfig({"PUBSUB_BACKEND": backend})) is None
for dialect in ("mysql", "postgres"):
    assert new_sql_from_config(MockConfig({"DB_DIALECT": dialect})) is None
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
