"""SQL datasource (reference: ``pkg/gofr/datasource/sql``).

The port's copy of ``gofr_tpu/datasource/sql/__init__.py``.
"""

from gofr_tpu_torch.datasource.sql.db import (
    DB,
    Tx,
    new_sql_from_config,
    register_sql_driver,
)
from gofr_tpu_torch.datasource.sql.query_builder import (
    delete_by_query,
    insert_query,
    select_by_query,
    select_query,
    update_by_query,
)

__all__ = [
    "DB",
    "Tx",
    "new_sql_from_config",
    "register_sql_driver",
    "insert_query",
    "select_query",
    "select_by_query",
    "update_by_query",
    "delete_by_query",
]
