"""REST CRUD handler generator (reference ``pkg/gofr/crud_handlers.go``).

``app.add_rest_handlers(Entity)`` scans a dataclass (field 0 = primary key,
reference ``crud_handlers.go:17-43``), derives the table name by
snake-casing the class name, and registers the five routes with default
SQL-backed handlers built on the dialect query builder. Any of
``create/get_all/get/update/delete`` defined on the entity class override
the defaults (reference ``crud_handlers.go:53-70``).

The port's copy of ``gofr_tpu/crud.py``.
"""

from __future__ import annotations

import dataclasses
import re

from gofr_tpu_torch.datasource.sql import (
    delete_by_query,
    insert_query,
    select_by_query,
    select_query,
    update_by_query,
)
from gofr_tpu_torch.errors import ErrorEntityNotFound


def to_snake_case(name: str) -> str:
    """CamelCase → snake_case (reference ``crud_handlers.go:246-266``)."""
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


def scan_entity(entity_cls) -> tuple[str, list, str]:
    """Returns (table, fields, primary_key). Field 0 is the PK."""
    if not (isinstance(entity_cls, type) and dataclasses.is_dataclass(entity_cls)):
        raise TypeError("add_rest_handlers requires a dataclass type")
    fields = dataclasses.fields(entity_cls)
    if not fields:
        raise TypeError("entity has no fields")
    cols = [f.metadata.get("db") or to_snake_case(f.name) for f in fields]
    return to_snake_case(entity_cls.__name__), cols, cols[0]


def register_crud_handlers(app, entity_cls) -> None:
    table, cols, pk = scan_entity(entity_cls)
    route = f"/{table}"
    dialect = "sqlite"

    def _dialect(ctx) -> str:
        return ctx.sql.dialect() if ctx.sql is not None else dialect

    def default_create(ctx):
        data = ctx.bind({})
        values = [data.get(c) for c in cols]
        ctx.sql.exec(insert_query(_dialect(ctx), table, cols), *values)
        return f"{entity_cls.__name__} successfully created with id: {data.get(pk)}"

    def default_get_all(ctx):
        return ctx.sql.query(select_query(_dialect(ctx), table))

    def default_get(ctx):
        row = ctx.sql.query_row(
            select_by_query(_dialect(ctx), table, pk), ctx.path_param("id")
        )
        if row is None:
            raise ErrorEntityNotFound(pk, ctx.path_param("id"))
        return row

    def default_update(ctx):
        data = ctx.bind({})
        non_pk = [c for c in cols if c != pk]
        values = [data.get(c) for c in non_pk] + [ctx.path_param("id")]
        result = ctx.sql.exec(
            update_by_query(_dialect(ctx), table, non_pk, pk), *values
        )
        if result.rows_affected == 0:
            raise ErrorEntityNotFound(pk, ctx.path_param("id"))
        return f"{entity_cls.__name__} successfully updated with id: {ctx.path_param('id')}"

    def default_delete(ctx):
        result = ctx.sql.exec(
            delete_by_query(_dialect(ctx), table, pk), ctx.path_param("id")
        )
        if result.rows_affected == 0:
            raise ErrorEntityNotFound(pk, ctx.path_param("id"))
        return f"{entity_cls.__name__} successfully deleted with id: {ctx.path_param('id')}"

    # User overrides win (reference crud_handlers.go:53-70): class-level
    # create/get_all/get/update/delete callables taking (ctx).
    handlers = {
        "create": getattr(entity_cls, "create", None) or default_create,
        "get_all": getattr(entity_cls, "get_all", None) or default_get_all,
        "get": getattr(entity_cls, "get", None) or default_get,
        "update": getattr(entity_cls, "update", None) or default_update,
        "delete": getattr(entity_cls, "delete", None) or default_delete,
    }

    app.add_route("POST", route, handlers["create"])
    app.add_route("GET", route, handlers["get_all"])
    app.add_route("GET", route + "/{id}", handlers["get"])
    app.add_route("PUT", route + "/{id}", handlers["update"])
    app.add_route("DELETE", route + "/{id}", handlers["delete"])
