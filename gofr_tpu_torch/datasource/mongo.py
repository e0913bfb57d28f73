"""Mongo datasource seam — interface only, driver injected by the user.

Reference: ``pkg/gofr/datasource/mongo.go:8-53`` defines an 11-method CRUD
interface and ships **no driver**; apps call ``App.UseMongo`` with their own
client (``gofr.go:376-378``, doc
``docs/advanced-guide/injecting-databases-drivers``). Same here:
:class:`Mongo` is a :class:`typing.Protocol` the injected client must
satisfy; ``app.use_mongo(client)`` stores it on the container and
``ctx.mongo`` hands it to handlers. A client exposing ``health_check()``
joins the aggregate ``/.well-known/health`` report.

The port's copy of ``gofr_tpu/datasource/mongo.py``.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class Mongo(Protocol):
    """CRUD surface mirroring the reference interface (``mongo.go:8-53``)."""

    def find(self, collection: str, filter: dict, results: Any) -> None: ...
    def find_one(self, collection: str, filter: dict, result: Any) -> None: ...
    def insert_one(self, collection: str, document: dict) -> Any: ...
    def insert_many(self, collection: str, documents: list) -> Any: ...
    def delete_one(self, collection: str, filter: dict) -> int: ...
    def delete_many(self, collection: str, filter: dict) -> int: ...
    def update_by_id(self, collection: str, id: Any, update: dict) -> int: ...
    def update_one(self, collection: str, filter: dict, update: dict) -> None: ...
    def update_many(self, collection: str, filter: dict, update: dict) -> int: ...
    def count_documents(self, collection: str, filter: dict) -> int: ...
    def drop(self, collection: str) -> None: ...


class InMemoryMongo:
    """Dict-backed :class:`Mongo` implementation — the test double apps can
    inject (the role miniredis plays for Redis, SURVEY §4)."""

    def __init__(self) -> None:
        self._collections: dict[str, list[dict]] = {}
        self._next_id = 0

    def _coll(self, name: str) -> list[dict]:
        return self._collections.setdefault(name, [])

    @staticmethod
    def _matches(doc: dict, filter: dict) -> bool:
        return all(doc.get(k) == v for k, v in (filter or {}).items())

    @staticmethod
    def _apply_update(doc: dict, update: dict) -> None:
        """Mongo update-operator semantics ($set/$inc/$unset). Operator-less
        documents are rejected like real MongoDB rejects them for update_*,
        so code that passes against this double also works on a driver."""
        if not update or not all(k.startswith("$") for k in update):
            raise ValueError(
                "update document must use operators, e.g. {'$set': {...}}"
            )
        for op, fields in update.items():
            if op == "$set":
                doc.update(fields)
            elif op == "$inc":
                for k, v in fields.items():
                    doc[k] = doc.get(k, 0) + v
            elif op == "$unset":
                for k in fields:
                    doc.pop(k, None)
            else:
                raise ValueError(f"unsupported update operator {op!r}")

    def find(self, collection: str, filter: dict, results: list) -> None:
        results.extend(
            dict(d) for d in self._coll(collection) if self._matches(d, filter)
        )

    def find_one(self, collection: str, filter: dict, result: dict) -> None:
        for d in self._coll(collection):
            if self._matches(d, filter):
                result.update(d)
                return

    def insert_one(self, collection: str, document: dict) -> Any:
        doc = dict(document)
        if "_id" not in doc:
            self._next_id += 1
            doc["_id"] = self._next_id
        self._coll(collection).append(doc)
        return doc["_id"]

    def insert_many(self, collection: str, documents: list) -> list:
        return [self.insert_one(collection, d) for d in documents]

    def delete_one(self, collection: str, filter: dict) -> int:
        coll = self._coll(collection)
        for i, d in enumerate(coll):
            if self._matches(d, filter):
                del coll[i]
                return 1
        return 0

    def delete_many(self, collection: str, filter: dict) -> int:
        coll = self._coll(collection)
        keep = [d for d in coll if not self._matches(d, filter)]
        removed = len(coll) - len(keep)
        self._collections[collection] = keep
        return removed

    def update_by_id(self, collection: str, id: Any, update: dict) -> int:
        return self.update_many(collection, {"_id": id}, update)

    def update_one(self, collection: str, filter: dict, update: dict) -> None:
        for d in self._coll(collection):
            if self._matches(d, filter):
                self._apply_update(d, update)
                return

    def update_many(self, collection: str, filter: dict, update: dict) -> int:
        n = 0
        for d in self._coll(collection):
            if self._matches(d, filter):
                self._apply_update(d, update)
                n += 1
        return n

    def count_documents(self, collection: str, filter: dict) -> int:
        return sum(1 for d in self._coll(collection) if self._matches(d, filter))

    def drop(self, collection: str) -> None:
        self._collections.pop(collection, None)

    def health_check(self) -> dict:
        return {
            "status": "UP",
            "details": {
                "backend": "INMEMORY-MONGO",
                "collections": {
                    k: len(v) for k, v in self._collections.items()
                },
            },
        }
