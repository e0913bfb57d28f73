"""In-proc DB-API peers speaking the mysql / postgres SQL dialects.

The miniredis idiom (SURVEY §4: "interface-seam every external dependency
→ a fake in-process peer") applied to SQL: the reference validates its
mysql/postgres code against sqlmock + real CI containers
(``pkg/gofr/datasource/sql/sql_mock.go:13-33``,
``.github/workflows/go.yml:86-87``); this environment has neither driver
nor server, so these fakes make the mysql/pg dialect branches executable.

Each fake is a DB-API connection backed by in-memory sqlite that accepts
its dialect's surface syntax — the exact forms ``query_builder.py``
generates and handlers write:

* **mysql**: backtick-quoted identifiers and ``?`` bindvars (both
  sqlite-native), ``AUTO_INCREMENT`` / common column types translated in
  DDL;
* **postgres**: double-quoted identifiers (sqlite-native), ``$n``
  bindvars (→ sqlite's positional ``?n``), ``SERIAL``/``BIGSERIAL``
  translated in DDL.

Wire them into the config seam with
:func:`gofr_tpu_torch.datasource.sql.register_sql_driver` — tests register
``connect_fake_mysql`` / ``connect_fake_postgres`` and the whole stack
(container → DB → query builder → CRUD → migrations) runs mysql/pg SQL.

The port's copy of ``gofr_tpu/datasource/sql/fakedb.py``.
"""

from __future__ import annotations

import re
import sqlite3


def _translate_mysql(query: str) -> str:
    # Backticks and ? placeholders are sqlite-native; only DDL niceties
    # need mapping. AUTO_INCREMENT only works in sqlite as the exact
    # INTEGER PRIMARY KEY AUTOINCREMENT form.
    q = re.sub(
        r"(?i)\b(?:INT|BIGINT|INTEGER)\s+PRIMARY\s+KEY\s+AUTO_INCREMENT",
        "INTEGER PRIMARY KEY AUTOINCREMENT", query,
    )
    q = re.sub(r"(?i)\s+AUTO_INCREMENT\b", "", q)
    q = re.sub(r"(?i)\bDATETIME\b", "TEXT", q)
    return q


def _translate_postgres(query: str) -> str:
    # $n → sqlite positional ?n; SERIAL pseudo-types → AUTOINCREMENT.
    q = re.sub(
        r"(?i)\b(?:BIG)?SERIAL\s+PRIMARY\s+KEY",
        "INTEGER PRIMARY KEY AUTOINCREMENT", query,
    )
    q = re.sub(r"(?i)\b(?:BIG)?SERIAL\b", "INTEGER", q)
    q = re.sub(r"(?i)\bTIMESTAMPTZ?\b", "TEXT", q)
    q = re.sub(r"\$(\d+)", r"?\1", q)
    return q


_TRANSLATORS = {"mysql": _translate_mysql, "postgres": _translate_postgres}


class _FakeCursor:
    def __init__(self, cur: sqlite3.Cursor, translate) -> None:
        self._cur = cur
        self._translate = translate

    def execute(self, query: str, args=()):  # DB-API
        return self._cur.execute(self._translate(query), tuple(args))

    def fetchall(self):
        return self._cur.fetchall()

    def fetchone(self):
        return self._cur.fetchone()

    @property
    def description(self):
        return self._cur.description

    @property
    def rowcount(self):
        return self._cur.rowcount

    @property
    def lastrowid(self):
        return self._cur.lastrowid

    def close(self) -> None:
        self._cur.close()


class FakeDialectConnection:
    """DB-API connection accepting mysql/postgres surface SQL over sqlite.

    Mirrors the real drivers' transaction semantics: autocommit outside
    explicit blocks (sqlite ``isolation_level=None``), transactions opened
    by ``Tx``'s explicit ``BEGIN`` (``needs_explicit_begin``).

    Fidelity caveat: ``lastrowid`` behaves like mysql's insert id; real
    postgres returns no insert id without ``INSERT ... RETURNING``.
    """

    needs_explicit_begin = True

    def __init__(self, dialect: str) -> None:
        if dialect not in _TRANSLATORS:
            raise ValueError(f"unsupported fake dialect {dialect!r}")
        self.dialect = dialect
        self._translate = _TRANSLATORS[dialect]
        self._conn = sqlite3.connect(
            ":memory:", check_same_thread=False, isolation_level=None
        )

    def cursor(self) -> _FakeCursor:
        return _FakeCursor(self._conn.cursor(), self._translate)

    def commit(self) -> None:
        self._conn.commit()

    def rollback(self) -> None:
        self._conn.rollback()

    def close(self) -> None:
        self._conn.close()


def connect_fake_mysql(**_kw) -> FakeDialectConnection:
    """Driver-seam factory (ignores host/port/user — in-proc)."""
    return FakeDialectConnection("mysql")


def connect_fake_postgres(**_kw) -> FakeDialectConnection:
    return FakeDialectConnection("postgres")
