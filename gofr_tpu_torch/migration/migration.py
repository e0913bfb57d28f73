"""Migration runner.

Behavioral parity with the reference (``migration/migration.go:12-126``):

* migrations are a ``{version: Migrate(up=fn)}`` map; keys validated (>0) and
  run in sorted order (``migration.go:19-26``);
* applied versions are tracked in a ``gofr_migrations`` SQL table
  (``migration/sql.go:13-20``) and/or Redis hash (``migration/redis.go:70-123``),
  whichever datasources exist — the chain-of-responsibility composition of
  ``migration.go:98-126``;
* each migration runs inside a SQL transaction; on failure it rolls back and
  the run stops (``migration.go:63-77``);
* migrations also get pub/sub topic create/delete ops
  (``migration/pubsub.go:5-24``).

The port's copy of ``gofr_tpu/migration/migration.py``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class Migrate:
    """One migration; ``up`` receives the datasource bundle
    (reference ``migration/migration.go:12-16``)."""

    up: Callable[["MigrationDatasources"], None]


class MigrationDatasources:
    """What a migration sees: SQL (tx-scoped), Redis, and pub/sub topic admin
    (reference ``migration/datasource.go:12-60``)."""

    def __init__(self, container, sql_tx=None) -> None:
        self._container = container
        self.sql = sql_tx if sql_tx is not None else container.sql
        self.redis = container.redis
        self.pubsub = container.pubsub
        self.logger = container.logger

    def create_topic(self, name: str) -> None:
        if self.pubsub is not None:
            self.pubsub.create_topic(name)

    def delete_topic(self, name: str) -> None:
        if self.pubsub is not None:
            self.pubsub.delete_topic(name)


_SQL_TABLE_DDL = (
    "CREATE TABLE IF NOT EXISTS gofr_migrations ("
    "version INTEGER PRIMARY KEY, method TEXT, start_time TEXT, duration_ms REAL)"
)
_REDIS_HASH = "gofr_migrations"


def _last_migration(container) -> int:
    """Max applied version across trackers (reference ``migration.go:45``)."""
    last = 0
    if container.sql is not None:
        row = container.sql.query_row("SELECT MAX(version) AS v FROM gofr_migrations")
        if row and row.get("v") is not None:
            last = max(last, int(row["v"]))
    if container.redis is not None:
        data = container.redis.hgetall(_REDIS_HASH)
        last = max(last, max((int(k) for k in data), default=0))
    return last


def run(migrations: dict[int, Migrate], container) -> None:
    """Execute pending migrations (reference ``migration/migration.go:18-79``)."""
    logger = container.logger
    if not migrations:
        logger.warn("no migrations to run")
        return
    for key, m in migrations.items():
        if not isinstance(key, int) or isinstance(key, bool) or key <= 0:
            raise ValueError(f"migration version must be a positive int, got {key!r}")
        if not isinstance(m, Migrate) or not callable(m.up):
            raise ValueError(f"migration {key} must be Migrate(up=callable)")

    if container.sql is None and container.redis is None and container.pubsub is None:
        logger.warn("no datasources available for migrations; skipping")
        return

    if container.sql is not None:
        container.sql.exec(_SQL_TABLE_DDL)

    last = _last_migration(container)

    for version in sorted(migrations):
        if version <= last:
            continue
        start = time.time()
        tx = container.sql.begin() if container.sql is not None else None
        ds = MigrationDatasources(container, sql_tx=tx)
        try:
            migrations[version].up(ds)
        except Exception as exc:
            if tx is not None:
                tx.rollback()
            logger.errorf("migration %d failed: %s", version, exc)
            raise
        duration_ms = (time.time() - start) * 1e3
        started_at = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(start))
        if tx is not None:
            from gofr_tpu_torch.datasource.sql.query_builder import insert_query

            # Dialect-aware bindvars: postgres needs $n, mysql/sqlite ?.
            tx.exec(
                insert_query(
                    container.sql.dialect(), "gofr_migrations",
                    ["version", "method", "start_time", "duration_ms"],
                ),
                version,
                "UP",
                started_at,
                duration_ms,
            )
            tx.commit()
        if container.redis is not None:
            container.redis.hset(
                _REDIS_HASH,
                str(version),
                json.dumps(
                    {"method": "UP", "startTime": started_at, "duration": duration_ms}
                ),
            )
        logger.infof("migration %d ran successfully in %.1fms", version, duration_ms)
