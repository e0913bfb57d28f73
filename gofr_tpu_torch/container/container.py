"""The central DI container (reference ``container/container.go:26-131``).

Owns the logger, the metrics manager, and every configured datasource;
creates each from config at boot like the reference's ``Create``
(``container/container.go:56-131``): Redis, SQL and pub/sub gated on
``REDIS_HOST``, ``DB_DIALECT`` and ``PUBSUB_BACKEND``, plus the TPU backend
gated on ``TPU_MODEL`` (the serving engine is a container member like
``SQL``/``Redis``). Aggregate health mirrors ``container/health.go:8-28``.

The port's copy of ``gofr_tpu/container/container.py``. A datasource that
cannot connect is logged and left ``None``, as in the reference; an engine
that cannot be built raises (the reference logs and serves without one).
The secondary encoder engine (``TPU_EMBED_MODEL``) is ``tpu_embed``;
downstream service clients (``App.add_http_service``) are ``services``,
each in the aggregate health as ``service:<name>``.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from gofr_tpu_torch.config.env import Config
from gofr_tpu_torch.logging import Level, Logger, RemoteLevelLogger, level_from_string
from gofr_tpu_torch.metrics import Manager, new_metrics_manager

class Container:
    def __init__(self, config: Config, logger: Optional[Logger] = None) -> None:
        self.config = config
        self.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.app_version = config.get_or_default("APP_VERSION", "dev")
        self.logger: Logger = logger or Logger(
            level=level_from_string(config.get("LOG_LEVEL"), Level.INFO)
        )
        self.metrics: Manager = new_metrics_manager(self.logger)

        self.sql = None
        self.redis = None
        self.pubsub = None
        self.mongo = None  # injected seam (reference datasource/mongo.go:8)
        self.tpu = None  # net-new: TPU inference backend (SURVEY §2.6)
        self.tpu_embed = None  # secondary encoder engine (TPU_EMBED_MODEL)
        self.services: dict[str, Any] = {}  # name → service.HTTP clients

        self._remote_logger: Optional[RemoteLevelLogger] = None

    # -- creation (reference container/container.go:41-131) --------------

    @classmethod
    def create(cls, config: Config, logger: Optional[Logger] = None) -> "Container":
        c = cls(config, logger=logger)
        c.logger.infof(
            "container created for app %s (version %s)", c.app_name, c.app_version
        )

        c.register_framework_metrics()

        # Each datasource in its own module; one that cannot connect logs
        # and stays None (the reference logs and continues).
        from gofr_tpu_torch.datasource.pubsub import new_pubsub_from_config
        from gofr_tpu_torch.datasource.redis import new_redis_from_config
        from gofr_tpu_torch.datasource.sql import new_sql_from_config

        c.redis = new_redis_from_config(config, c.logger, c.metrics)
        c.sql = new_sql_from_config(config, c.logger, c.metrics)
        c.pubsub = new_pubsub_from_config(config, c.logger, c.metrics)

        from gofr_tpu_torch.serving.backend import (
            new_tpu_embed_from_config,
            new_tpu_from_config,
        )

        # An engine that cannot be built raises here (the reference logs
        # and serves with no engine), after closing what was built first.
        try:
            c.tpu = new_tpu_from_config(config, c.logger, c.metrics)
            c.tpu_embed = new_tpu_embed_from_config(config, c.logger, c.metrics)
        except BaseException:
            c._close_built()
            raise

        remote_url = config.get_or_default("REMOTE_LOG_URL", "")
        if remote_url:
            interval = float(config.get_or_default("REMOTE_LOG_FETCH_INTERVAL", "15"))
            c._remote_logger = RemoteLevelLogger(
                c.logger, remote_url, interval, metrics=c.metrics
            )
            c._remote_logger.start()
        return c

    # -- service registry (reference gofr.go:189-199) ---------------------

    def get_http_service(self, name: str):
        return self.services.get(name)

    def get_publisher(self):
        return self.pubsub

    def get_subscriber(self):
        return self.pubsub

    def use_mongo(self, client) -> None:
        """User-injected Mongo driver (reference ``gofr.go:376-378``)."""
        self.mongo = client

    def use_pubsub(self, client) -> None:
        """User-injected pub/sub client (same seam as ``use_mongo`` — lets
        apps wire a broker whose driver the framework doesn't bundle)."""
        self.pubsub = client

    # -- framework metrics (reference container/container.go:143-172) -----

    def register_framework_metrics(self) -> None:
        m = self.metrics
        # System / app metrics.
        m.new_gauge("app_go_routines", "number of async tasks + threads")
        m.new_gauge("app_sys_memory_alloc", "resident memory bytes")
        m.new_gauge("app_sys_total_alloc", "total allocated bytes")
        m.new_gauge("app_go_numGC", "gc collection count")
        m.new_gauge("app_go_sys", "runtime sys bytes")
        # HTTP server and client (buckets follow container.go:153-154).
        http_buckets = (0.001, 0.003, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 30)
        m.new_histogram("app_http_response", "HTTP server response time in s", http_buckets)
        m.new_histogram(
            "app_http_service_response", "outbound HTTP client response time in s", http_buckets
        )
        # Redis / SQL (container.go:158-163).
        m.new_histogram(
            "app_redis_stats", "redis command duration in ms",
            (0.05, 0.075, 0.1, 0.125, 0.15, 0.2, 0.3, 0.5, 0.75, 1, 2, 3),
        )
        m.new_histogram(
            "app_sql_stats", "sql query duration in ms",
            (0.05, 0.075, 0.1, 0.125, 0.15, 0.2, 0.3, 0.5, 0.75, 1, 2, 3, 4, 5, 7.5, 10),
        )
        m.new_gauge("app_sql_open_connections", "open sql connections")
        m.new_gauge("app_sql_inUse_connections", "in-use sql connections")
        # PubSub.
        m.new_counter("app_pubsub_publish_total_count", "messages published")
        m.new_counter("app_pubsub_publish_success_count", "publish successes")
        m.new_counter("app_pubsub_subscribe_total_count", "subscribe polls")
        m.new_counter("app_pubsub_subscribe_success_count", "messages handled")
        # The serving engine's instruments (serving/engine.py records
        # them), with the reference's names, descriptions and buckets.
        m.new_gauge("app_tpu_queue_depth", "dynamic batcher queue depth")
        m.new_gauge("app_tpu_kv_slots_in_use", "KV-cache slots occupied")
        m.new_gauge("app_tpu_lora_adapters", "loaded LoRA adapters")
        m.new_histogram(
            "app_tpu_infer_latency", "device execute latency in s",
            (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5),
        )
        m.new_histogram(
            "app_tpu_batch_size", "executed batch sizes",
            (1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        m.new_counter("app_tpu_tokens_generated", "tokens generated")
        m.new_counter(
            "app_tpu_prefix_hits", "prompts admitted via prefix-KV reuse"
        )
        m.new_histogram(
            "app_tpu_spec_tokens_per_step",
            "speculative decoding: tokens accepted per live step",
            (1, 1.5, 2, 2.5, 3, 4, 5, 6, 8),
        )
        m.new_gauge(
            "app_tpu_kv_blocks_free", "paged KV cache: free pool blocks"
        )
        # The prefix cache (TPU_AUTO_PREFIX): radix-index lookups at
        # admission, prompt tokens served by aliased cached blocks instead
        # of prefill, and the index's resident block count.
        m.new_counter(
            "app_tpu_prefix_lookup_total",
            "radix prefix-cache lookups at admission (result=hit|miss)",
        )
        m.new_counter(
            "app_tpu_prefix_hit_tokens_total",
            "prompt tokens admission-aliased from cached KV blocks "
            "(prefill skipped)",
        )
        m.new_gauge(
            "app_tpu_prefix_cached_blocks",
            "KV blocks currently held by the radix prefix index",
        )
        m.new_counter(
            "app_tpu_requests_shed_total",
            "submits rejected by admission control (429/504 before a slot)",
        )
        m.new_counter(
            "app_tpu_requests_cancelled_total",
            "sequences retired mid-decode by cancel/disconnect",
        )
        m.new_counter(
            "app_tpu_deadline_exceeded_total",
            "sequences retired because their deadline expired",
        )
        m.new_gauge(
            "app_tpu_engine_state",
            "engine health state machine "
            "(0=SERVING 1=DEGRADED 2=RESTARTING 3=DOWN)",
        )
        m.new_gauge(
            "app_http_service_circuit_open",
            "circuit breaker state per downstream service (1 = open)",
        )
        m.new_gauge(
            "app_tpu_decode_step_seconds",
            "decode-step duration (window dispatch→processed over its "
            "steps; includes pipeline queueing)",
        )
        m.new_gauge(
            "app_tpu_kv_pool_occupancy_ratio",
            "paged KV pool: used blocks / total blocks",
        )
        # Device-resource observability (serving/device_telemetry.py):
        # the HBM ledger's per-component bytes and derived headroom, and
        # the compile accounting (CUDA graph captures, the kernel
        # library's load) with the steady-state recompile counter.
        m.new_gauge(
            "app_tpu_hbm_bytes",
            "HBM ledger bytes by component "
            "(params/lora/kv_pool/prefix_pool/workspace)",
        )
        m.new_gauge(
            "app_tpu_hbm_headroom_ratio",
            "free fraction of the per-device HBM budget "
            "(budget slack + free paged-KV blocks)",
        )
        m.new_counter(
            "app_tpu_compiles_total",
            "program compiles by serving program (CUDA graph captures, "
            "the kernel library's load)",
        )
        m.new_histogram(
            "app_tpu_compile_seconds",
            "wall clock of a compiling call (capture or build — the "
            "latency a request actually pays)",
            (0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
        )
        m.new_counter(
            "app_tpu_steady_state_recompiles_total",
            "compiles AFTER the warm-up fence (mark_steady_state)",
        )

    def push_system_metrics(self) -> None:
        """Per-scrape system gauges (reference ``metrics/handler.go:21-35``)."""
        import gc
        import threading

        self.metrics.set_gauge("app_go_routines", threading.active_count())
        try:
            with open("/proc/self/statm") as fp:
                rss = int(fp.read().split()[1]) * 4096
        except Exception:
            rss = 0
        self.metrics.set_gauge("app_sys_memory_alloc", rss)
        self.metrics.set_gauge("app_go_numGC", sum(s.get("collections", 0) for s in gc.get_stats()))

    # -- health (reference container/health.go:8-28) ----------------------

    def health(self) -> dict:
        out: dict[str, Any] = {
            "name": self.app_name,
            "version": self.app_version,
            "status": "UP",
            "startedAt": getattr(self, "_started_at", ""),
        }
        details: dict[str, Any] = {}
        for name in ("sql", "redis", "pubsub", "tpu", "tpu_embed", "mongo"):
            ds = getattr(self, name)
            if ds is None or not hasattr(ds, "health_check"):
                # health_check is opt-in for injected members (an engine
                # set as container.tpu) — a minimal one must not flip the
                # app to DEGRADED just for lacking one.
                continue
            try:
                check = ds.health_check()
            except Exception as exc:
                check = {"status": "DOWN", "error": str(exc)}
            details[name] = check
            if check.get("status") != "UP":
                out["status"] = "DEGRADED"
        for svc_name, svc in self.services.items():
            try:
                check = svc.health_check()
            except Exception as exc:
                check = {"status": "DOWN", "error": str(exc)}
            details[f"service:{svc_name}"] = check
            if check.get("status") != "UP":
                out["status"] = "DEGRADED"
        out["details"] = details
        return out

    def mark_started(self) -> None:
        self._started_at = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    def _close_built(self) -> None:
        """Close what ``create`` built before an engine failed to build."""
        for name in ("tpu", "pubsub", "sql", "redis"):
            ds = getattr(self, name)
            if ds is not None and hasattr(ds, "close"):
                try:
                    ds.close()
                except Exception:
                    pass

    async def close(self) -> None:
        for name in ("sql", "redis", "pubsub", "tpu", "tpu_embed", "mongo"):
            ds = getattr(self, name)
            if ds is not None and hasattr(ds, "close"):
                try:
                    res = ds.close()
                    if hasattr(res, "__await__"):
                        await res
                except Exception:
                    pass
        if self._remote_logger is not None:
            self._remote_logger.stop()
