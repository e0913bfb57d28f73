"""The port's datasources against the reference's: SQL over ``sqlite3``
(both packages' ``DB`` on one sqlite file: the same statements give the
same rows and the same error messages; ``select`` into dataclasses and
dicts; transactions; the connection shared across threads; the
``app_sql_stats`` labels), the mysql and postgres dialect fakes (``$n``
bindvars, backticks and ``AUTO_INCREMENT``/``SERIAL`` rewritten in DDL), a
dialect with no driver, the query builder, migrations (their bookkeeping
table, order, a second run, a failing migration rolled back, the App
logging a panicking one), ``add_rest_handlers`` over HTTP, Redis (each
package's client against the other's ``MiniRedis``: nil, integer and error
replies, a bulk string holding CRLF, TTL expiry on an injected clock,
``KEYS``), Mongo's injected seam, ``/.well-known/health`` with every
datasource, and the container's datasource metrics. Each scenario runs on
both packages and their observables are held equal.
"""

from __future__ import annotations

import asyncio
import dataclasses
import http.client
import json
import re
import sqlite3
import threading
import types

import pytest

import gofr_tpu
import gofr_tpu.config
import gofr_tpu.container
import gofr_tpu.metrics
import gofr_tpu.crud as ref_crud
import gofr_tpu.datasource.mongo as ref_mongo
import gofr_tpu.datasource.redis as ref_redis
import gofr_tpu.datasource.redis.miniredis as ref_miniredis
import gofr_tpu.datasource.sql as ref_sql
import gofr_tpu.datasource.sql.db as ref_db
import gofr_tpu.datasource.sql.fakedb as ref_fakedb
import gofr_tpu.migration as ref_migration
import gofr_tpu_torch
import gofr_tpu_torch.config
import gofr_tpu_torch.container
import gofr_tpu_torch.metrics
import gofr_tpu_torch.crud as port_crud
import gofr_tpu_torch.datasource.mongo as port_mongo
import gofr_tpu_torch.datasource.redis as port_redis
import gofr_tpu_torch.datasource.redis.miniredis as port_miniredis
import gofr_tpu_torch.datasource.sql as port_sql
import gofr_tpu_torch.datasource.sql.db as port_db
import gofr_tpu_torch.datasource.sql.fakedb as port_fakedb
import gofr_tpu_torch.migration as port_migration
from gofr_tpu.testutil.mock_logger import MockLogger

PKGS = {"port": gofr_tpu_torch, "reference": gofr_tpu}
SQL = {"port": (port_sql, port_db, port_fakedb), "reference": (ref_sql, ref_db, ref_fakedb)}
REDIS = {"port": (port_redis, port_miniredis), "reference": (ref_redis, ref_miniredis)}
MIGRATION = {"port": port_migration, "reference": ref_migration}
MONGO = {"port": port_mongo, "reference": ref_mongo}
CRUD = {"port": port_crud, "reference": ref_crud}
CROSS = [("port", "reference"), ("reference", "port")]


class _Metrics:
    def __init__(self):
        self.calls = []

    def record_histogram(self, name, value, *labels):
        assert value >= 0
        self.calls.append((name, labels))

    def increment_counter(self, name, *labels):
        self.calls.append((name, labels))


def _config(pkg, keys):
    return PKGS[pkg].config.MockConfig(keys)


def _messages(logger):
    """The logged lines, with file paths and durations masked."""
    return [(log.level, re.sub(r"[\d.]+ms", "<t>ms", re.sub(r"/\S+\.db", "<file>",
                                                            str(log.message))))
            for log in logger.logs if not hasattr(log.message, "to_log_dict")]


# ---------------------------------------------------------------------------
# SQL over sqlite3: both packages on one file
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Employee:
    id: int = 0
    name: str = ""
    dept_name: str = dataclasses.field(default="", metadata={"db": "department"})


def _sql_script(db):
    """Statements on ``db``; every result or error message, in order."""
    out = []

    def step(fn):
        try:
            res = fn()
            out.append(dataclasses.asdict(res) if dataclasses.is_dataclass(res) else res)
        except Exception as exc:  # noqa: BLE001 — the message is the observable
            out.append((type(exc).__name__, str(exc)))

    step(lambda: db.exec("INSERT INTO employee (name, department) VALUES (?, ?)", "Ada", "eng"))
    step(lambda: db.exec("INSERT INTO employee (name, department) VALUES (?, ?)", "Bo", "ops"))
    step(lambda: db.query("SELECT * FROM employee ORDER BY id"))
    step(lambda: db.query_row("SELECT name FROM employee WHERE department = ?", "ops"))
    step(lambda: db.query_row("SELECT name FROM employee WHERE id = ?", 999))
    step(lambda: [dataclasses.asdict(e) for e in db.select(Employee, "SELECT * FROM employee")])
    step(lambda: db.select(dict, "SELECT name FROM employee ORDER BY name DESC"))
    step(lambda: db.select(int, "SELECT 1"))
    step(lambda: db.query("SELECT * FROM nope"))
    step(lambda: db.exec("INSERT INTO employee (id, name) VALUES (?, ?)", 1, "dup"))
    step(lambda: db.exec("SELEC 1"))
    tx = db.begin()
    tx.exec("INSERT INTO employee (name) VALUES (?)", "committed")
    tx.commit()
    tx = db.begin()
    tx.exec("INSERT INTO employee (name) VALUES (?)", "rolled back")
    step(lambda: tx.query("SELECT COUNT(*) AS n FROM employee"))
    tx.rollback()
    # The connection is shared across threads (check_same_thread=False).
    box = {}
    t = threading.Thread(target=lambda: box.update(
        rows=db.query("SELECT name FROM employee ORDER BY id")))
    t.start()
    t.join(10)
    out.append(box["rows"])
    step(lambda: db.exec("DELETE FROM employee WHERE name = ?", "committed"))
    out.append(db.health_check()["status"])
    return out


def test_sql_on_one_sqlite_file_matches_the_reference(tmp_path):
    path = str(tmp_path / "shared.db")
    dbs, metrics = {}, {}
    for pkg, (mod, _, _) in SQL.items():
        metrics[pkg] = _Metrics()
        dbs[pkg] = mod.new_sql_from_config(
            _config(pkg, {"DB_DIALECT": "sqlite", "DB_NAME": path}), metrics=metrics[pkg])
    try:
        dbs["port"].exec(
            "CREATE TABLE employee (id INTEGER PRIMARY KEY, name TEXT, department TEXT)")
        metrics["port"].calls.clear()
        out, calls = {}, {}
        for pkg in ("port", "reference"):
            out[pkg] = _sql_script(dbs[pkg])
            calls[pkg] = list(metrics[pkg].calls)
            dbs[pkg].exec("DELETE FROM employee")  # the other package starts from empty
        assert out["port"] == out["reference"]
        port = out["port"]
        assert port[2] == [{"id": 1, "name": "Ada", "department": "eng"},
                           {"id": 2, "name": "Bo", "department": "ops"}]
        assert port[5][0] == {"id": 1, "name": "Ada", "dept_name": "eng"}
        assert port[7] == ("TypeError", "select target must be a dataclass type or dict")
        assert port[8] == ("OperationalError", "no such table: nope")
        assert port[9][0] == "IntegrityError"
        assert port[11] == [{"n": 4}]  # the open transaction sees its own row
        assert port[12] == [{"name": "Ada"}, {"name": "Bo"}, {"name": "committed"}]
        assert calls["port"] == calls["reference"]
        assert ("app_sql_stats", ("type", "SELECT")) in calls["port"]
        assert ("app_sql_stats", ("type", "INSERT")) in calls["port"]
        # Rows written by one package are read by the other.
        dbs["port"].exec("INSERT INTO employee (name) VALUES (?)", "from port")
        assert dbs["reference"].query("SELECT name FROM employee") == [{"name": "from port"}]
        assert dbs["port"].health_check() == dbs["reference"].health_check()
    finally:
        for db in dbs.values():
            db.close()


def test_sql_unconfigured_and_unknown_dialect_match_the_reference():
    out = {}
    for pkg, (mod, _, _) in SQL.items():
        logger = MockLogger()
        out[pkg] = (mod.new_sql_from_config(_config(pkg, {})),
                    mod.new_sql_from_config(_config(pkg, {"DB_DIALECT": "oracle"}), logger),
                    _messages(logger))
    assert out["port"] == out["reference"]
    assert out["port"][2] == [(out["port"][2][0][0], "unsupported DB_DIALECT oracle")]


@pytest.mark.parametrize("dialect", ["mysql", "postgres"])
def test_dialect_fakes_match_the_reference(dialect, monkeypatch):
    """The query builder's statements (backticks and ? against quotes and
    $n), DDL with AUTO_INCREMENT / SERIAL, a transaction, and a
    migration's bookkeeping row, on each package's fakes."""
    out = {}
    for pkg, (mod, db_mod, fakes) in SQL.items():
        monkeypatch.setitem(db_mod._DRIVER_REGISTRY, "mysql", fakes.connect_fake_mysql)
        monkeypatch.setitem(db_mod._DRIVER_REGISTRY, "postgres", fakes.connect_fake_postgres)
        db = mod.new_sql_from_config(_config(pkg, {
            "DB_DIALECT": dialect, "DB_HOST": "fake", "DB_NAME": "testdb"}))
        q = "`" if dialect == "mysql" else '"'
        ddl = (f"CREATE TABLE {q}book{q} ({q}id{q} "
               + ("INT PRIMARY KEY AUTO_INCREMENT" if dialect == "mysql" else "SERIAL PRIMARY KEY")
               + f", {q}title{q} VARCHAR(64), {q}pages{q} INT)")
        rec = [db.dialect()]
        db.exec(ddl)
        for title, pages in (("Dune", 412), ("Hyperion", 482)):
            res = db.exec(mod.insert_query(dialect, "book", ["title", "pages"]), title, pages)
            rec.append(res.rows_affected)
        rec.append(db.select(dict, mod.select_by_query(dialect, "book", "id"), 1))
        rec.append(db.exec(mod.update_by_query(dialect, "book", ["pages"], "title"),
                           500, "Dune").rows_affected)
        # $2 before $1: postgres bindvars are positional, not in order.
        if dialect == "postgres":
            rec.append(db.query('SELECT "title" FROM "book" WHERE "pages" = $2 OR "id" = $1',
                                7, 482))
        rec.append(db.exec(mod.delete_by_query(dialect, "book", "title"), "Hyperion").rows_affected)
        tx = db.begin()
        tx.exec(mod.insert_query(dialect, "book", ["title", "pages"]), "kept", 1)
        tx.commit()
        tx = db.begin()
        tx.exec(mod.insert_query(dialect, "book", ["title", "pages"]), "dropped", 2)
        tx.rollback()
        rec.append(db.select(dict, f"SELECT {q}title{q}, {q}pages{q} FROM {q}book{q}"))
        rec.append(db.health_check())
        db.close()
        out[pkg] = rec
    assert out["port"] == out["reference"]
    assert out["port"][-2] == [{"title": "Dune", "pages": 500}, {"title": "kept", "pages": 1}]


@pytest.mark.parametrize("dialect", ["mysql", "postgres"])
def test_dialect_without_a_driver_logs_the_reference_message(dialect, monkeypatch):
    out = {}
    for pkg, (mod, db_mod, _) in SQL.items():
        monkeypatch.setattr(db_mod, "_DRIVER_REGISTRY", {})
        logger = MockLogger()
        db = mod.new_sql_from_config(_config(pkg, {"DB_DIALECT": dialect}), logger=logger)
        out[pkg] = (db, _messages(logger))
    assert out["port"] == out["reference"]
    assert out["port"][0] is None and "has no driver" in out["port"][1][0][1]


@pytest.mark.parametrize("dialect", ["sqlite", "mysql", "postgres"])
def test_query_builder_matches_the_reference(dialect):
    cols = ["id", "name", "dept"]
    for fn, args in (("insert_query", ("user", cols)), ("select_query", ("user",)),
                     ("select_by_query", ("user", "id")),
                     ("update_by_query", ("user", ["name", "dept"], "id")),
                     ("delete_by_query", ("user", "id"))):
        assert getattr(port_sql, fn)(dialect, *args) == getattr(ref_sql, fn)(dialect, *args)


# ---------------------------------------------------------------------------
# Migrations
# ---------------------------------------------------------------------------


def _container(pkg, keys, logger=None):
    mod = PKGS[pkg]
    return mod.container.Container.create(_config(pkg, keys), logger=logger or MockLogger())


def _migration_run(pkg, path):
    mod = MIGRATION[pkg]
    c = _container(pkg, {"DB_DIALECT": "sqlite", "DB_NAME": path})
    order = []

    def create(ds):
        order.append(1)
        ds.sql.exec("CREATE TABLE t1 (id INTEGER)")

    def bad(ds):
        order.append(3)
        ds.sql.exec("INSERT INTO t1 (id) VALUES (?)", 3)
        raise RuntimeError("boom")

    migrations = {2: mod.Migrate(up=lambda ds: order.append(2)), 1: mod.Migrate(up=create)}
    mod.run(migrations, c)
    mod.run(migrations, c)  # a second run is a no-op
    failed = None
    try:
        mod.run({**migrations, 3: mod.Migrate(up=bad)}, c)
    except RuntimeError as exc:
        failed = str(exc)
    errors = []
    for bad_key in (0, -5, "1"):
        try:
            mod.run({bad_key: mod.Migrate(up=lambda ds: None)}, c)
        except ValueError as exc:
            errors.append(str(exc))
    table = [tuple(r) for r in sqlite3.connect(path).execute(
        "PRAGMA table_info(gofr_migrations)").fetchall()]
    rows = c.sql.query("SELECT version, method FROM gofr_migrations ORDER BY version")
    tables = sorted(r["name"] for r in c.sql.query(
        "SELECT name FROM sqlite_master WHERE type = 'table'"))
    tables.append(c.sql.query("SELECT COUNT(*) AS n FROM t1"))
    stamps = c.sql.query("SELECT start_time, duration_ms FROM gofr_migrations")
    assert all(s["start_time"].endswith("Z") and s["duration_ms"] >= 0 for s in stamps)
    c.sql.close()
    return order, failed, errors, table, rows, tables, _messages(c.logger)


def test_migrations_match_the_reference(tmp_path):
    out = {pkg: _migration_run(pkg, str(tmp_path / f"{pkg}.db")) for pkg in MIGRATION}
    assert out["port"] == out["reference"]
    order, failed, errors, table, rows, tables, _ = out["port"]
    assert order == [1, 2, 3] and failed == "boom" and len(errors) == 3
    assert [c[1] for c in table] == ["version", "method", "start_time", "duration_ms"]
    assert rows == [{"version": 1, "method": "UP"}, {"version": 2, "method": "UP"}]
    # The failing migration's insert rolled back, and it left no row.
    assert tables == ["gofr_migrations", "t1", [{"n": 0}]]


def _redis_migration(pkg, mini):
    mod = MIGRATION[pkg]
    c = _container(pkg, {"REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(mini.port)})
    mod.run({1: mod.Migrate(up=lambda ds: ds.redis.set(f"migrated-{pkg}", "yes"))}, c)
    mod.run({1: mod.Migrate(up=lambda ds: ds.redis.set(f"migrated-{pkg}", "twice"))}, c)
    value = c.redis.get(f"migrated-{pkg}")
    c.redis.delete("gofr_migrations")
    c.redis.close()
    none = _container(pkg, {})
    mod.run({1: mod.Migrate(up=lambda ds: None)}, none)
    mod.run({}, none)
    return value, _messages(none.logger)


def test_redis_migrations_and_no_datasource_match_the_reference():
    mini = port_miniredis.MiniRedis().start()
    try:
        out = {pkg: _redis_migration(pkg, mini) for pkg in MIGRATION}
    finally:
        mini.stop()
    assert out["port"] == out["reference"]
    assert out["port"][0] == "yes"
    assert [m for _, m in out["port"][1]][-2:] == [
        "no datasources available for migrations; skipping", "no migrations to run"]


# ---------------------------------------------------------------------------
# Apps over HTTP: migrate, add_rest_handlers, health
# ---------------------------------------------------------------------------


class Harness:
    def __init__(self, app) -> None:
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()
        self.run(app.start())

    def run(self, coro, timeout: float = 60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout=timeout)

    def close(self) -> None:
        try:
            self.run(self.app.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=5)
            self.loop.close()

    def request(self, method, path, body=None, port=None):
        conn = http.client.HTTPConnection("127.0.0.1", port or self.app.http_port, timeout=60)
        try:
            payload = None if body is None else json.dumps(body).encode()
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"} if payload else {})
            resp = conn.getresponse()
            return resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()


@dataclasses.dataclass
class UserAccount:
    id: int = 0
    full_name: str = ""
    email: str = dataclasses.field(default="", metadata={"db": "mail"})


@pytest.mark.parametrize("name", ["UserAccount", "Employee", "HTTPServerLog", "X", "already_snake"])
def test_crud_names_match_the_reference(name):
    """Table and route names come from the entity's class name and field
    names (reference ``crud.py:43-46``); a non-dataclass is refused alike."""
    assert port_crud.to_snake_case(name) == ref_crud.to_snake_case(name)
    assert port_crud.scan_entity(UserAccount) == ref_crud.scan_entity(UserAccount) == (
        "user_account", ["id", "full_name", "mail"], "id")
    msgs = []
    for mod in CRUD.values():
        with pytest.raises(TypeError) as err:
            mod.scan_entity(dict)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _crud_app(pkg, tmp_path, mini):
    # Each App its own Redis: the migrations' Redis hash is their bookkeeping too.
    mod = PKGS[pkg]
    app = mod.App(config=_config(pkg, {
        "APP_NAME": "ds-test", "HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "WARN",
        "DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / f"crud-{pkg}.db"),
        "REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(mini.port), "PUBSUB_BACKEND": "INPROC"}))
    mig = MIGRATION[pkg]
    app.migrate({1: mig.Migrate(up=lambda ds: ds.sql.exec(
        "CREATE TABLE user_account (id INTEGER PRIMARY KEY, full_name TEXT, mail TEXT)"))})
    # A migration that panics is logged; the App goes on (reference app.py:185-194).
    app.migrate({2: mig.Migrate(up=lambda ds: 1 / 0)})
    app.add_rest_handlers(UserAccount)
    app.use_mongo(MONGO[pkg].InMemoryMongo())
    return app


def test_rest_handlers_and_health_match_the_reference(tmp_path):
    """CRUD routes from the entity (table and route ``user_account``), the
    reference's response strings and 404 message word for word, and
    ``/.well-known/health`` with SQL, Redis, pub/sub and Mongo."""
    minis = {pkg: REDIS[pkg][1].MiniRedis().start() for pkg in PKGS}
    harnesses = {}
    try:
        harnesses = {pkg: Harness(_crud_app(pkg, tmp_path, minis[pkg])) for pkg in PKGS}
        script = [
            ("POST", "/user_account", {"id": 1, "full_name": "Ada L", "mail": "ada@x"}),
            ("POST", "/user_account", {"id": 2, "full_name": "Bo", "mail": "bo@x"}),
            ("GET", "/user_account", None),
            ("GET", "/user_account/1", None),
            ("GET", "/user_account/9", None),
            ("PUT", "/user_account/2", {"full_name": "Bo B", "mail": "b@x"}),
            ("PUT", "/user_account/9", {"full_name": "nobody", "mail": ""}),
            ("DELETE", "/user_account/1", None),
            ("DELETE", "/user_account/1", None),
            ("GET", "/user_account", None),
        ]
        out = {pkg: [h.request(*step) for step in script] for pkg, h in harnesses.items()}
        assert out["port"] == out["reference"]
        port = out["port"]
        assert json.loads(port[0][2])["data"] == "UserAccount successfully created with id: 1"
        assert port[4][0] == 404
        assert json.loads(port[10 - 1][2])["data"] == [
            {"id": 2, "full_name": "Bo B", "mail": "b@x"}]
        health = {}
        for pkg, h in harnesses.items():
            status, _, body = h.request("GET", "/.well-known/health")
            body = json.loads(body)
            body["data"].pop("startedAt")
            body["data"]["details"]["sql"]["details"].pop("database")  # a file each
            body["data"]["details"]["redis"]["details"].pop("host")  # a server each
            health[pkg] = (status, body)
        assert health["port"] == health["reference"]
        details = health["port"][1]["data"]["details"]
        assert set(details) == {"sql", "redis", "pubsub", "mongo"}
        assert all(d["status"] == "UP" for d in details.values())
    finally:
        for h in harnesses.values():
            h.close()
        for mini in minis.values():
            mini.stop()


def test_app_migrate_logs_a_panic_and_goes_on(capsys):
    for pkg in PKGS:
        app = PKGS[pkg].App(config=_config(pkg, {
            "HTTP_PORT": "0", "METRICS_PORT": "0", "DB_DIALECT": "sqlite"}))
        app.migrate({1: MIGRATION[pkg].Migrate(up=lambda ds: 1 / 0)})
        err = capsys.readouterr()
        text = err.out + err.err
        assert "migration panicked" in text and "ZeroDivisionError" in text, (pkg, text)
        assert app.container.sql.query("SELECT * FROM gofr_migrations") == []
        app.container.sql.close()


# ---------------------------------------------------------------------------
# Redis: each client against the other package's MiniRedis
# ---------------------------------------------------------------------------


def _redis_script(client):
    out = []

    def step(fn):
        try:
            out.append(fn())
        except Exception as exc:  # noqa: BLE001 — the error reply is the observable
            out.append((type(exc).__name__, str(exc)))

    step(lambda: client.ping())
    step(lambda: client.set("k", "v"))
    step(lambda: client.get("k"))
    step(lambda: client.get("missing"))  # nil
    step(lambda: client.set("crlf", "a\r\nb\r\n"))  # a bulk string holding CRLF
    step(lambda: client.get("crlf"))
    step(lambda: client.incr("n"))  # integer replies
    step(lambda: client.incr("n"))
    step(lambda: client.incr("k"))  # an error reply
    step(lambda: client.command("NOSUCH", "x"))
    step(lambda: client.exists("k", "n", "zz"))
    step(lambda: client.hset("h", "a", "1", "b", "2"))
    step(lambda: client.hget("h", "a"))
    step(lambda: client.hgetall("h"))
    step(lambda: client.hdel("h", "a"))
    step(lambda: client.rpush("l", "1", "2", "3"))
    step(lambda: client.lpush("l", "0"))
    step(lambda: client.lrange("l", 0, -1))
    step(lambda: client.sadd("s", "x", "y", "x"))
    step(lambda: sorted(client.smembers("s")))
    step(lambda: sorted(client.keys("*")))
    step(lambda: sorted(client.keys("[hl]")))
    step(lambda: sorted(client.keys("c?lf")))
    pipe = client.tx_pipeline()
    pipe.set("a", "1").hset("h2", "f", "v").delete("k")
    step(lambda: pipe.exec())
    step(lambda: client.delete("a", "missing"))
    step(lambda: client.health_check()["status"])
    step(lambda: client.flushdb())
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", CROSS)
def test_redis_replies_match_the_reference(client_pkg, server_pkg):
    server = REDIS[server_pkg][1].MiniRedis().start()
    try:
        out = {}
        for pkg, (mod, _) in REDIS.items():
            metrics = _Metrics()
            client = mod.Redis("127.0.0.1", server.port, metrics=metrics)
            out[pkg] = (_redis_script(client), metrics.calls)
            client.close()
    finally:
        server.stop()
    # Each package's client gives the same replies from this server.
    assert out["port"] == out["reference"]
    replies = out[client_pkg][0]
    assert replies[3] is None and replies[5] == "a\r\nb\r\n" and replies[6:8] == [1, 2]
    assert replies[8][0] == "RedisError" and replies[8][1].startswith("ERR ")
    assert ("app_redis_stats", ("type", "GET")) in out["port"][1]


def test_miniredis_ttl_expiry_on_an_injected_clock(monkeypatch):
    out = {}
    for pkg, (mod, mini_mod) in REDIS.items():
        now = {"t": 1000.0}
        monkeypatch.setattr(mini_mod, "time", types.SimpleNamespace(time=lambda: now["t"]))
        server = mini_mod.MiniRedis().start()
        client = mod.Redis("127.0.0.1", server.port)
        try:
            rec = [client.set("a", "1", ex=10), client.ttl("a"), client.set("b", "2"),
                   client.expire("b", 5), client.ttl("b"), client.ttl("nokey")]
            now["t"] += 6
            rec += [client.ttl("a"), client.get("b"), client.exists("b"), sorted(client.keys("*"))]
            now["t"] += 5
            rec += [client.get("a"), sorted(client.keys("*"))]
        finally:
            client.close()
            server.stop()
        out[pkg] = rec
    assert out["port"] == out["reference"]
    assert out["port"][6:] == [4, None, 0, ["a"], None, []]


def test_redis_from_config_matches_the_reference():
    mini = port_miniredis.MiniRedis().start()
    try:
        out = {}
        for pkg, (mod, _) in REDIS.items():
            logger = MockLogger()
            up = mod.new_redis_from_config(_config(pkg, {
                "REDIS_HOST": "127.0.0.1", "REDIS_PORT": str(mini.port)}), logger=logger)
            down = mod.new_redis_from_config(_config(pkg, {
                "REDIS_HOST": "127.0.0.1", "REDIS_PORT": "1"}), logger=logger)
            up.get("x")
            logs = [(log.level, log.message.to_log_dict()["command"])
                    if hasattr(log.message, "to_log_dict")
                    else (log.level, str(log.message).split(":")[0]) for log in logger.logs]
            out[pkg] = (type(up).__name__, down, mod.new_redis_from_config(_config(pkg, {})),
                        up.health_check()["status"], logs)
            up.close()
    finally:
        mini.stop()
    assert out["port"] == out["reference"]


# ---------------------------------------------------------------------------
# Mongo's injected seam
# ---------------------------------------------------------------------------


def _mongo_script(mod):
    db = mod.InMemoryMongo()
    out = [isinstance(db, mod.Mongo)]
    uid = db.insert_one("users", {"name": "ada", "role": "admin"})
    out.append(db.insert_many("users", [{"name": "bo"}, {"name": "cy", "role": "admin"}]))
    found: list = []
    db.find("users", {"role": "admin"}, found)
    out.append(sorted(d["name"] for d in found))
    one: dict = {}
    db.find_one("users", {"name": "bo"}, one)
    out.append(one["name"])
    out.append(db.update_by_id("users", uid, {"$set": {"role": "owner"}}))
    out.append(db.count_documents("users", {"role": "owner"}))
    out.append(db.update_many("users", {}, {"$set": {"active": True}}))
    db.update_one("users", {"name": "ada"}, {"$inc": {"logins": 2}})
    one = {}
    db.find_one("users", {"name": "ada"}, one)
    out.append(one["logins"])
    try:
        db.update_one("users", {"name": "ada"}, {"role": "boss"})
    except ValueError as exc:
        out.append(str(exc))
    out += [db.delete_one("users", {"name": "bo"}), db.delete_many("users", {}),
            db.health_check()]
    db.drop("users")
    out.append(db.count_documents("users", {}))
    return out


def test_mongo_seam_matches_the_reference():
    port = _mongo_script(port_mongo)
    assert port == _mongo_script(ref_mongo)
    assert port[0] is True and port[2] == ["ada", "cy"] and port[-1] == 0
    for pkg in PKGS:
        c = PKGS[pkg].container.Container(_config(pkg, {}))
        db = MONGO[pkg].InMemoryMongo()
        c.use_mongo(db)
        broker = object()
        c.use_pubsub(broker)
        assert c.mongo is db and c.health()["details"]["mongo"]["status"] == "UP"
        assert c.get_publisher() is broker and c.get_subscriber() is broker


# ---------------------------------------------------------------------------
# The container's datasource metrics
# ---------------------------------------------------------------------------

_DATASOURCE_METRICS = ("app_redis_stats", "app_sql_stats", "app_sql_open_connections",
                       "app_sql_inUse_connections", "app_pubsub_publish_total_count",
                       "app_pubsub_publish_success_count", "app_pubsub_subscribe_total_count",
                       "app_pubsub_subscribe_success_count")


def test_container_metrics_match_the_reference(tmp_path):
    """The datasource instruments are registered as the reference's, and a
    query, a Redis command and a pub/sub round trip land on /metrics alike."""
    mini = port_miniredis.MiniRedis().start()
    out = {}
    try:
        for pkg in PKGS:
            c = _container(pkg, {"DB_DIALECT": "sqlite", "REDIS_HOST": "127.0.0.1",
                                 "REDIS_PORT": str(mini.port), "PUBSUB_BACKEND": "INPROC"})
            c.sql.query("SELECT 1")
            c.redis.set(f"k-{pkg}", "v")
            c.pubsub.publish("t", b"x")
            c.pubsub.subscribe("t", 1).commit()
            text = PKGS[pkg].metrics.render_prometheus(c.metrics, app_name="m")
            lines = [ln for ln in text.splitlines()
                     if ln.lstrip("# HELPTY").startswith(_DATASOURCE_METRICS)]
            # Durations differ run to run: keep the series, drop the values
            # of the two histograms.
            out[pkg] = sorted(ln.rsplit(" ", 1)[0] if "_stats" in ln and not ln.startswith("#")
                              else ln for ln in lines)
            asyncio.run(c.close())
    finally:
        mini.stop()
    assert out["port"] == out["reference"]
    assert any(ln.startswith('app_pubsub_subscribe_success_count{topic="t"}') for ln in out["port"])
