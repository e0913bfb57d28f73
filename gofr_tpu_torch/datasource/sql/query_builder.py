"""Dialect-aware SQL query builder (reference ``sql/query_builder.go:8-70`` +
``sql/bind.go:24-51``).

Generates the CRUD statements the REST-handler generator uses, quoting
identifiers and numbering bind variables per dialect: backticks + ``?`` for
mysql/sqlite, double quotes + ``$n`` for postgres.

The port's copy of ``gofr_tpu/datasource/sql/query_builder.py``.
"""

from __future__ import annotations

from typing import Sequence


def _quote(dialect: str, ident: str) -> str:
    if dialect == "postgres":
        return f'"{ident}"'
    return f"`{ident}`"


def _bindvar(dialect: str, n: int) -> str:
    if dialect == "postgres":
        return f"${n}"
    return "?"


def insert_query(dialect: str, table: str, fields: Sequence[str]) -> str:
    cols = ", ".join(_quote(dialect, f) for f in fields)
    vals = ", ".join(_bindvar(dialect, i + 1) for i in range(len(fields)))
    return f"INSERT INTO {_quote(dialect, table)} ({cols}) VALUES ({vals})"


def select_query(dialect: str, table: str) -> str:
    return f"SELECT * FROM {_quote(dialect, table)}"


def select_by_query(dialect: str, table: str, field: str) -> str:
    return (
        f"SELECT * FROM {_quote(dialect, table)} "
        f"WHERE {_quote(dialect, field)} = {_bindvar(dialect, 1)}"
    )


def update_by_query(dialect: str, table: str, fields: Sequence[str], by: str) -> str:
    sets = ", ".join(
        f"{_quote(dialect, f)} = {_bindvar(dialect, i + 1)}" for i, f in enumerate(fields)
    )
    return (
        f"UPDATE {_quote(dialect, table)} SET {sets} "
        f"WHERE {_quote(dialect, by)} = {_bindvar(dialect, len(fields) + 1)}"
    )


def delete_by_query(dialect: str, table: str, field: str) -> str:
    return (
        f"DELETE FROM {_quote(dialect, table)} "
        f"WHERE {_quote(dialect, field)} = {_bindvar(dialect, 1)}"
    )
