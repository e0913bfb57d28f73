"""SQL datasource over DB-API drivers.

Capability parity with the reference's ``datasource/sql`` (``sql.go``,
``db.go``): config-gated connection at boot with a background retry loop,
query/exec/transaction API with per-query structured logging + the
``app_sql_stats`` histogram, reflective ``select`` into dataclasses, dialect
seam, pool-stat gauges, and health check.

The port's copy of ``gofr_tpu/datasource/sql/db.py``. Driver matrix:
``sqlite`` ships in the stdlib; ``mysql``/``postgres`` connect only through
a factory given to :func:`register_sql_driver` (the in-proc fakes of
``fakedb.py``, or the user's own DB-API driver). The port imports no
``pymysql`` or ``psycopg2`` (the reference's ``_real_driver`` does, when
they are installed): a dialect with no registered factory logs the
reference's message and boots without SQL, as the reference does where
neither driver is installed (``sql/sql.go:83-107``).
"""

from __future__ import annotations

import dataclasses
import re
import sqlite3
import threading
import time
from typing import Any, Optional, Sequence

from gofr_tpu_torch.config.env import Config


class QueryLog:
    """Structured query log (reference ``sql/db.go:28-45``)."""

    def __init__(self, query: str, duration_us: int, args_count: int) -> None:
        self.type = "SQL"
        self.query = query
        self.duration = duration_us
        self.args_count = args_count

    def to_log_dict(self) -> dict:
        return {"type": self.type, "query": self.query, "duration": self.duration}

    def pretty_print(self, fp) -> None:
        fp.write(f"\x1b[38;5;8mSQL\x1b[0m {self.duration:>8}µs {self.query}\n")


class _Cursorish:
    """Shared query machinery for DB and Tx."""

    _dialect: str
    _logger: Any
    _metrics: Any

    def _execute(self, cursor, query: str, args: Sequence) -> None:
        start = time.time()
        try:
            cursor.execute(query, tuple(args))
        finally:
            elapsed_ms = (time.time() - start) * 1e3
            if self._metrics is not None:
                self._metrics.record_histogram(
                    "app_sql_stats", elapsed_ms, "type", _query_operation(query)
                )
            if self._logger is not None:
                self._logger.debug(QueryLog(query, int(elapsed_ms * 1e3), len(args)))

    def _rows_to_dicts(self, cursor) -> list[dict]:
        cols = [d[0] for d in cursor.description] if cursor.description else []
        return [dict(zip(cols, row)) for row in cursor.fetchall()]


def _query_operation(query: str) -> str:
    m = re.match(r"\s*(\w+)", query)
    return (m.group(1).upper() if m else "UNKNOWN")


class Tx(_Cursorish):
    """Transaction handle (reference ``sql/db.go:254-296``)."""

    def __init__(self, db: "DB") -> None:
        self._db = db
        self._dialect = db.dialect()
        self._logger = db._logger
        self._metrics = db._metrics
        self._conn = db._conn
        if getattr(self._conn, "needs_explicit_begin", False):
            # Autocommit connections (real mysql/postgres drivers, and the
            # dialect fakes mirroring them) open transaction blocks with an
            # explicit BEGIN; COMMIT/ROLLBACK below closes them.
            self._conn.cursor().execute("BEGIN")

    def query(self, query: str, *args) -> list[dict]:
        cur = self._conn.cursor()
        self._execute(cur, query, args)
        return self._rows_to_dicts(cur)

    def query_row(self, query: str, *args) -> Optional[dict]:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args) -> "ExecResult":
        cur = self._conn.cursor()
        self._execute(cur, query, args)
        return ExecResult(cur.rowcount, cur.lastrowid)

    def commit(self) -> None:
        self._conn.commit()
        self._db._tx_lock.release()

    def rollback(self) -> None:
        self._conn.rollback()
        self._db._tx_lock.release()


@dataclasses.dataclass
class ExecResult:
    rows_affected: int
    last_insert_id: Optional[int]


class DB(_Cursorish):
    """Connection wrapper with the reference ``container.DB`` surface
    (``container/datasources.go:14-26``)."""

    def __init__(self, conn, dialect: str, logger=None, metrics=None, database: str = "") -> None:
        self._conn = conn
        self._dialect_name = dialect
        self._logger = logger
        self._metrics = metrics
        self._database = database
        self._lock = threading.RLock()
        self._tx_lock = threading.Lock()  # serialize transactions

    # -- plain queries (reference sql/db.go:102-110) ----------------------

    def query(self, query: str, *args) -> list[dict]:
        with self._lock:
            cur = self._conn.cursor()
            self._execute(cur, query, args)
            return self._rows_to_dicts(cur)

    def query_row(self, query: str, *args) -> Optional[dict]:
        rows = self.query(query, *args)
        return rows[0] if rows else None

    def exec(self, query: str, *args) -> ExecResult:
        with self._lock:
            cur = self._conn.cursor()
            self._execute(cur, query, args)
            self._conn.commit()
            return ExecResult(cur.rowcount, cur.lastrowid)

    def begin(self) -> Tx:
        self._tx_lock.acquire()
        return Tx(self)

    # -- reflective select (reference sql/db.go:200-252) ------------------

    def select(self, target_type, query: str, *args):
        """Run ``query`` and bind rows into ``target_type``.

        ``target_type`` may be a dataclass type (→ list of instances, fields
        matched by name / ``db`` metadata key, like the reference's ``db:``
        struct tags) or ``dict`` (→ list of dicts).
        """
        rows = self.query(query, *args)
        if target_type is dict:
            return rows
        if dataclasses.is_dataclass(target_type):
            out = []
            fields = dataclasses.fields(target_type)
            colmap = {
                (f.metadata.get("db") or _to_snake(f.name)): f.name for f in fields
            }
            names = {f.name for f in fields}
            for row in rows:
                kwargs = {}
                for col, val in row.items():
                    if col in colmap:
                        kwargs[colmap[col]] = val
                    elif col in names:
                        kwargs[col] = val
                out.append(target_type(**kwargs))
            return out
        raise TypeError("select target must be a dataclass type or dict")

    # -- misc -------------------------------------------------------------

    def dialect(self) -> str:
        return self._dialect_name

    def health_check(self) -> dict:
        try:
            with self._lock:
                cur = self._conn.cursor()
                cur.execute("SELECT 1")
                cur.fetchall()
            return {
                "status": "UP",
                "details": {"dialect": self._dialect_name, "database": self._database},
            }
        except Exception as exc:
            return {"status": "DOWN", "error": str(exc)}

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass


def _to_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


# Driver seam (reference idiom: sql.Open(driverName, dsn), sql.go:30-67).
# Maps dialect → connect(host, port, user, password, database) returning a
# DB-API connection speaking the dialect's bindvars. The port imports no
# driver: tests register the in-proc fakes from ``fakedb.py``, users their own.
_DRIVER_REGISTRY: dict[str, Any] = {}


def register_sql_driver(dialect: str, connect) -> None:
    """Register/override the connection factory for ``mysql``/``postgres``."""
    _DRIVER_REGISTRY[dialect.lower()] = connect


def new_sql_from_config(config: Config, logger=None, metrics=None) -> Optional[DB]:
    """Create the SQL datasource from env config (reference ``sql/sql.go:30-67``,
    config keys ``sql.go:109-118``).

    Gated on ``DB_DIALECT``: ``sqlite`` (stdlib; ``DB_NAME`` is the file path,
    default in-memory); ``mysql``/``postgres`` connect via a registered
    driver factory (:func:`register_sql_driver`), reading ``DB_HOST``/``DB_PORT``/``DB_USER``/
    ``DB_PASSWORD``/``DB_NAME``.
    Returns None when unconfigured — the container treats that as "no SQL".
    """
    dialect = (config.get_or_default("DB_DIALECT", "") or "").lower()
    if not dialect:
        return None
    if dialect == "sqlite":
        path = config.get_or_default("DB_NAME", ":memory:")
        conn = sqlite3.connect(path, check_same_thread=False)
        conn.execute("PRAGMA journal_mode=WAL") if path != ":memory:" else None
        db = DB(conn, "sqlite", logger, metrics, database=path)
        if logger is not None:
            logger.infof("connected to sqlite database %s", path)
        return db
    if dialect in ("mysql", "postgres"):
        connect = _DRIVER_REGISTRY.get(dialect)
        if connect is None:
            if logger is not None:
                logger.errorf(
                    "SQL dialect %s has no driver: install one (pymysql/"
                    "psycopg2) or register a factory via register_sql_driver "
                    "(in-proc fakes: datasource/sql/fakedb.py)",
                    dialect,
                )
            return None
        database = config.get_or_default("DB_NAME", "")
        try:
            conn = connect(
                host=config.get_or_default("DB_HOST", "localhost"),
                port=int(config.get_or_default(
                    "DB_PORT", "3306" if dialect == "mysql" else "5432"
                )),
                user=config.get_or_default("DB_USER", "root"),
                password=config.get_or_default("DB_PASSWORD", ""),
                database=database,
            )
        except Exception as exc:  # noqa: BLE001 — boot must not crash
            # Reference logs and continues when a datasource can't connect
            # (sql.go:83-107 retries in background; our container health
            # then reports the missing datasource).
            if logger is not None:
                logger.errorf("could not connect %s database: %s", dialect, exc)
            return None
        db = DB(conn, dialect, logger, metrics, database=database)
        if logger is not None:
            logger.infof("connected to %s database %s", dialect, database)
        return db
    if logger is not None:
        logger.errorf("unsupported DB_DIALECT %s", dialect)
    return None
