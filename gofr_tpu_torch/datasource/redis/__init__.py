"""Redis datasource (reference: ``pkg/gofr/datasource/redis``).

A from-scratch RESP2 client (the role go-redis plays in the reference) with
per-command logging + the ``app_redis_stats`` histogram (reference
``redis/hook.go:17-105``), plus :class:`MiniRedis`, an in-process RESP server
that plays the role miniredis plays in the reference's tests (SURVEY §4).

The port's copy of ``gofr_tpu/datasource/redis/__init__.py``.
"""

from gofr_tpu_torch.datasource.redis.client import Redis, new_redis_from_config
from gofr_tpu_torch.datasource.redis.miniredis import MiniRedis

__all__ = ["Redis", "new_redis_from_config", "MiniRedis"]
