"""Drivers for the PostgreSQL chain-state backend (``state/pg.py``):
the port's copy of the JAX package's ``state/pgdriver.py``, standard
library only.

Two implementations of one small synchronous facade:

* :class:`AsyncpgDriver` — production: asyncpg (the reference's own
  driver, database.py:33-91) behind a dedicated event-loop thread, so
  the storage layer keeps the same short-synchronous-call model the
  sqlite backend uses.  asyncpg is imported lazily, inside
  ``_connect``: it is not a dependency of the port and only needed when
  an operator points the node at a PostgreSQL uPow database.  Without
  it, building the driver raises ``ModuleNotFoundError``; nothing falls
  back to sqlite.

* :class:`MockPgDriver` — tests and ``chip_smoke.py``: executes the
  same pg-dialect SQL against stdlib sqlite, translating ``$n``
  placeholders and the handful of type-representation differences
  (TEXT[]/BIGINT[] arrays, NUMERIC, TIMESTAMP, BOOLEAN).  This is what
  lets the PgChainState SQL and conversion logic run with no server.

The SQL subset the pg backend restricts itself to (so both drivers
behave identically): explicit column lists, ``$n`` parameters, whole
arrays as values (never indexed/ANY'd in SQL — the one exception,
``= ANY(col)``, is translated by the mock), no NOW() (timestamps are
passed in), row-value IN lists built with explicit placeholders.
"""

from __future__ import annotations

import asyncio
import datetime
import decimal as decimal_mod
import json
import re
import threading
from decimal import Decimal
from functools import lru_cache
from typing import Any, Iterable, List, Optional, Sequence


class PgDriverError(Exception):
    """Driver-neutral error taxonomy.  AsyncpgDriver maps asyncpg's
    SQLSTATE-classed exceptions onto these; MockPgDriver maps sqlite's —
    so storage-layer code (and tests) can catch ONE set of classes with
    both drivers.  ``sqlstate`` carries the PostgreSQL class code."""

    sqlstate: Optional[str] = None


class IntegrityViolation(PgDriverError):
    sqlstate = "23000"


class UniqueViolation(IntegrityViolation):
    sqlstate = "23505"


class ForeignKeyViolation(IntegrityViolation):
    sqlstate = "23503"


class NumericValueOutOfRange(PgDriverError):
    sqlstate = "22003"


def _map_asyncpg_error(e):
    """asyncpg.PostgresError -> the shim taxonomy (by SQLSTATE)."""
    code = getattr(e, "sqlstate", None) or ""
    if code == "23505":
        cls = UniqueViolation
    elif code == "23503":
        cls = ForeignKeyViolation
    elif code.startswith("23"):
        cls = IntegrityViolation
    elif code == "22003":
        cls = NumericValueOutOfRange
    else:
        return e  # pass through: connection/protocol errors keep their type
    out = cls(str(e))
    out.sqlstate = code
    return out


def _map_sqlite_error(e):
    """sqlite3.IntegrityError -> the shim taxonomy (by message)."""
    msg = str(e)
    if "UNIQUE constraint" in msg:
        return UniqueViolation(msg)
    if "FOREIGN KEY constraint" in msg:
        return ForeignKeyViolation(msg)
    return IntegrityViolation(msg)


def _utc(dt_or_epoch) -> datetime.datetime:
    """Naive-UTC datetime (what the reference stores in TIMESTAMP(0)
    columns via datetime.utcfromtimestamp)."""
    if isinstance(dt_or_epoch, datetime.datetime):
        return dt_or_epoch
    return datetime.datetime.fromtimestamp(
        int(dt_or_epoch), datetime.timezone.utc).replace(tzinfo=None)


def _epoch(dt) -> int:
    if isinstance(dt, (int, float)):
        return int(dt)
    return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp())


class AsyncpgDriver:
    """One asyncpg connection on a private loop thread, sync facade.

    Single-connection by design: block acceptance wraps BEGIN/COMMIT
    around the connection (a pool would break that transaction
    affinity).  asyncpg allows ONE operation in flight per connection,
    so every facade call — sync or awaitable — runs under a per-
    statement lock on the driver loop; transaction-scope exclusivity
    (no foreign writer joining an open BEGIN) is the storage layer's
    job (PgChainState's writer lock).

    Two call styles:

    * ``afetch``/``aexecute``/... — awaitable from the node's event
      loop: the coroutine runs on the driver thread's loop and the
      caller awaits a wrapped future, so a network round trip never
      blocks the node (gossip, heartbeats and other endpoints keep
      being served during storage I/O).  This is what PgChainState's
      async methods use.
    * ``fetch``/``execute``/... — synchronous, blocking the calling
      thread for one round trip; for CLI tools (reindex) and tests.

    The storage layer additionally batches its hot paths into
    executemany/JOIN shapes to keep statements-per-block low;
    deployments should still colocate the node with the database (the
    reference's asyncpg setup assumes the same).
    """

    def __init__(self, dsn: str):
        self._dsn = dsn
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, daemon=True, name="pg-driver")
        self._thread.start()
        # per-statement serialization: asyncpg raises InterfaceError on
        # a second in-flight operation; the lock lives on (binds to) the
        # driver loop where every operation runs
        self._oplock = None
        # transaction state, mutated ONLY on the driver loop inside the
        # op lock (see the _do_* helpers): _txn_open tracks an open
        # BEGIN; _txn_lost poisons writes after a mid-transaction
        # connection loss until the owner rolls back.
        self._txn_open = False
        self._txn_lost = False
        self._conn = self._call(self._connect(dsn))

    async def _connect(self, dsn: str):
        import asyncpg  # lazy: only a pg-backed node pays this import

        return await asyncpg.connect(dsn)

    async def _ensure_conn(self):
        """Reconnect once if the server dropped the connection (restart,
        idle timeout) — the reference's pool does the same implicitly
        (database.py:36-43).  Runs under the op lock, so no statement is
        in flight while the connection is swapped.

        A drop MID-TRANSACTION poisons writes (``_txn_lost``) rather
        than raising at whoever happens to touch the connection next:
        the server already rolled the transaction back, so the OWNER's
        next write/COMMIT must fail loudly (a COMMIT on the fresh
        connection would be a silent no-op), while incidental readers
        are fine on the fresh connection."""
        if self._conn.is_closed():
            import logging

            logging.getLogger("upow_tpu_torch.state").warning(
                "pg connection lost; reconnecting")
            self._conn = await self._connect(self._dsn)
            if self._txn_open:
                self._txn_open = False
                self._txn_lost = True

    def _check_not_lost(self):
        if self._txn_lost:
            raise ConnectionError(
                "pg connection was lost mid-transaction; the open "
                "transaction was rolled back server-side — roll back "
                "and retry")

    # the _do_* helpers run on the driver loop under the op lock, so
    # transaction-state reads/writes are race-free

    async def _do_fetch(self, sql, args):
        return await self._conn.fetch(sql, *args)

    async def _do_execute(self, sql, args):
        self._check_not_lost()
        return await self._conn.execute(sql, *args)

    async def _do_executemany(self, sql, rows):
        self._check_not_lost()
        return await self._conn.executemany(sql, rows)

    async def _do_begin(self):
        self._check_not_lost()
        await self._conn.execute("BEGIN")
        self._txn_open = True

    async def _do_commit(self):
        self._check_not_lost()
        await self._conn.execute("COMMIT")
        self._txn_open = False

    async def _do_rollback(self):
        # clears the poison: nothing is left to roll back server-side
        # after a connection loss, and the caller has now observed it
        try:
            if not self._txn_lost:
                await self._conn.execute("ROLLBACK")
        finally:
            self._txn_open = False
            self._txn_lost = False

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def _submit(self, coro):
        """Awaitable-from-any-loop handle for a coroutine running on the
        driver thread's loop."""
        return asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(coro, self._loop))

    async def _locked(self, op):
        if self._oplock is None:
            self._oplock = asyncio.Lock()
        async with self._oplock:
            await self._ensure_conn()
            try:
                return await op()
            except Exception as e:
                import asyncpg

                if isinstance(e, asyncpg.PostgresError):
                    mapped = _map_asyncpg_error(e)
                    if mapped is not e:
                        raise mapped from e
                raise

    # -- sync facade (CLI tools, tests) --

    def fetch(self, sql: str, args: Sequence[Any] = ()) -> List[Any]:
        return self._call(self._locked(lambda: self._do_fetch(sql, args)))

    def execute(self, sql: str, args: Sequence[Any] = ()) -> None:
        self._call(self._locked(lambda: self._do_execute(sql, args)))

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        rows = list(rows)
        if rows:
            self._call(self._locked(lambda: self._do_executemany(sql, rows)))

    def begin(self) -> None:
        self._call(self._locked(self._do_begin))

    def commit(self) -> None:
        self._call(self._locked(self._do_commit))

    def rollback(self) -> None:
        self._call(self._locked(self._do_rollback))

    # -- awaitable facade (the node's event loop) --

    async def afetch(self, sql: str, args: Sequence[Any] = ()) -> List[Any]:
        return await self._submit(
            self._locked(lambda: self._do_fetch(sql, args)))

    async def aexecute(self, sql: str, args: Sequence[Any] = ()) -> None:
        await self._submit(
            self._locked(lambda: self._do_execute(sql, args)))

    async def aexecutemany(self, sql: str,
                           rows: Iterable[Sequence[Any]]) -> None:
        rows = list(rows)
        if rows:
            await self._submit(
                self._locked(lambda: self._do_executemany(sql, rows)))

    async def abegin(self) -> None:
        await self._submit(self._locked(self._do_begin))

    async def acommit(self) -> None:
        await self._submit(self._locked(self._do_commit))

    async def arollback(self) -> None:
        await self._submit(self._locked(self._do_rollback))

    def close(self) -> None:
        try:
            self._call(self._conn.close())
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)


# --- mock driver ---------------------------------------------------------

# Output-column representation map (reference schema.sql types).  The pg
# backend's SQL keeps these column names stable (including aliases), so
# name-based conversion is unambiguous.
_ARRAY_COLS = {"inputs_addresses", "outputs_addresses", "outputs_amounts"}
_NUMERIC_COLS = {"fees", "reward", "difficulty"}
_TIMESTAMP_COLS = {"timestamp", "propagation_time", "block_ts", "ts"}
_BOOL_COLS = {"is_stake"}

# sqlite DDL mirroring schema.sql's tables (same names, sqlite types);
# "index" is kept verbatim — sqlite accepts it quoted.  journal_seq is
# the PG_SCHEMA migration column (pg: BIGINT DEFAULT nextval); INTEGER
# PRIMARY KEY AUTOINCREMENT reproduces the never-reissued monotonic
# assignment the mempool stamp relies on.
_MOCK_DDL = """
CREATE TABLE IF NOT EXISTS blocks (
    id INTEGER PRIMARY KEY,
    hash TEXT UNIQUE,
    content TEXT NOT NULL,
    address TEXT NOT NULL,
    random INTEGER NOT NULL,
    difficulty TEXT NOT NULL,
    reward TEXT NOT NULL,
    timestamp INTEGER
);
CREATE TABLE IF NOT EXISTS transactions (
    block_hash TEXT NOT NULL,
    tx_hash TEXT UNIQUE,
    tx_hex TEXT,
    inputs_addresses TEXT,
    outputs_addresses TEXT,
    outputs_amounts TEXT,
    fees TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS unspent_outputs (
    tx_hash TEXT,
    "index" INTEGER NOT NULL,
    address TEXT NULL,
    is_stake INTEGER
);
CREATE TABLE IF NOT EXISTS pending_transactions (
    journal_seq INTEGER PRIMARY KEY AUTOINCREMENT,
    tx_hash TEXT UNIQUE,
    tx_hex TEXT,
    inputs_addresses TEXT,
    fees TEXT NOT NULL,
    propagation_time INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS pending_spent_outputs (
    tx_hash TEXT,
    "index" INTEGER NOT NULL
);
"""
for _t in ("inode_registration_output", "validator_registration_output",
           "validators_voting_power", "delegates_voting_power",
           "validators_ballot", "inodes_ballot"):
    _MOCK_DDL += f"""
CREATE TABLE IF NOT EXISTS {_t} (
    tx_hash TEXT,
    "index" INTEGER NOT NULL,
    address TEXT NULL
);
"""

_PLACEHOLDER = re.compile(r"\$(\d+)")
_ANY_CLAUSE = re.compile(r"\$(\d+)\s*=\s*ANY\s*\(\s*(\w+)\s*\)")
_ANY_PARAM = re.compile(r"(\w+)\s*=\s*ANY\s*\(\s*\$(\d+)\s*\)")
_INSERT_COLS = re.compile(
    r"INSERT\s+INTO\s+\w+\s*\(([^)]*)\)\s*VALUES\s*\(([^)]*)\)", re.I)

# reference schema.sql column types the mock must emulate on WRITE:
# NUMERIC(p, s) quantizes (PostgreSQL rounds half away from zero) and
# raises numeric_value_out_of_range when integer digits exceed p - s;
# TIMESTAMP(0) rounds fractional seconds to the nearest second
_NUMERIC_SPEC = {"difficulty": (3, 1), "reward": (14, 6), "fees": (14, 6)}
_TS0_COLS = {"timestamp", "propagation_time"}


def _quantize_numeric(value: Decimal, col: str) -> Decimal:
    precision, scale = _NUMERIC_SPEC[col]
    q = value.quantize(Decimal(1).scaleb(-scale),
                       rounding=decimal_mod.ROUND_HALF_UP)
    if q.adjusted() + 1 > precision - scale:
        raise NumericValueOutOfRange(
            f"numeric field overflow: {col} NUMERIC({precision},{scale}) "
            f"cannot hold {value}")
    return q


class MockPgDriver:
    """sqlite stand-in executing the pg backend's SQL (tests only)."""

    supports_composite_types = False  # no CREATE TYPE in sqlite
    schema_preinstalled = True  # __init__ applies the sqlite-dialect DDL
    # (the reference-dialect PG_SCHEMA text is pg-only: it spells the
    # outpoint column as unquoted `index`, reserved in sqlite)

    def __init__(self, threadsafe: bool = False):
        import sqlite3

        # threadsafe=True lets a caller share this sqlite handle across
        # threads (a fake asyncpg server behind AsyncpgDriver's loop
        # thread, or a node served on a loop thread of its own) that
        # serialize their use of it themselves.
        self.db = sqlite3.connect(":memory:",
                                  check_same_thread=not threadsafe)
        self.db.isolation_level = None  # autocommit; BEGIN/COMMIT explicit
        self.db.row_factory = sqlite3.Row
        self.db.executescript(_MOCK_DDL)

    # -- translation --

    @staticmethod
    def _convert_in(value):
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, list):
            return json.dumps(value)
        if isinstance(value, datetime.datetime):
            return _epoch(value)
        if isinstance(value, Decimal):
            return str(value)
        return value

    @staticmethod
    def _convert_out(row) -> dict:
        out = {}
        for key in row.keys():
            v = row[key]
            if v is None:
                out[key] = None
            elif key in _ARRAY_COLS:
                out[key] = json.loads(v)
            elif key in _NUMERIC_COLS:
                out[key] = Decimal(str(v))
            elif key in _TIMESTAMP_COLS:
                out[key] = _utc(v)
            elif key in _BOOL_COLS:
                out[key] = bool(v)
            else:
                out[key] = v
        return out

    @classmethod
    def _translate(cls, sql: str):
        """pg-dialect SQL -> (sqlite SQL using :pN named params)."""
        # `$k = ANY(col)`: pg array membership -> sqlite json_each scan
        sql = _ANY_CLAUSE.sub(
            r"EXISTS (SELECT 1 FROM json_each(\2) WHERE"
            r" json_each.value = :p\1)", sql)
        # `col = ANY($k)`: asyncpg list param -> IN over the JSON array
        # the list converts to
        sql = _ANY_PARAM.sub(
            r"\1 IN (SELECT value FROM json_each(:p\2))", sql)
        return _PLACEHOLDER.sub(r":p\1", sql)

    @staticmethod
    @lru_cache(maxsize=256)
    def _insert_param_cols(pg_sql: str) -> tuple:
        """For INSERT statements: map 1-based param index -> column name
        (None where the value isn't a bare placeholder), so write-side
        type semantics (NUMERIC quantization, TIMESTAMP(0) rounding)
        apply to the right params."""
        m = _INSERT_COLS.search(pg_sql)
        if not m:
            return ()
        cols = [c.strip().strip('"') for c in m.group(1).split(",")]
        out = {}
        for col, val in zip(cols, m.group(2).split(",")):
            pm = re.fullmatch(r"\s*\$(\d+)\s*", val)
            if pm:
                out[int(pm.group(1))] = col
        return tuple(sorted(out.items()))

    def _params(self, args: Sequence[Any], pg_sql: str = "") -> dict:
        by_idx = dict(self._insert_param_cols(pg_sql)) if pg_sql else {}
        out = {}
        for i, v in enumerate(args):
            col = by_idx.get(i + 1)
            if isinstance(v, Decimal) and col in _NUMERIC_SPEC:
                v = _quantize_numeric(v, col)
            elif isinstance(v, datetime.datetime) and col in _TS0_COLS \
                    and v.microsecond:
                v = v.replace(microsecond=0) + datetime.timedelta(
                    seconds=1 if v.microsecond >= 500_000 else 0)
            out[f"p{i + 1}"] = self._convert_in(v)
        return out

    # -- facade --

    def _run(self, sqlite_sql: str, params: dict):
        import sqlite3

        try:
            return self.db.execute(sqlite_sql, params)
        except sqlite3.IntegrityError as e:
            raise _map_sqlite_error(e) from e

    def fetch(self, sql: str, args: Sequence[Any] = ()) -> List[dict]:
        rows = self._run(self._translate(sql), self._params(args, sql)).fetchall()
        return [self._convert_out(r) for r in rows]

    def execute(self, sql: str, args: Sequence[Any] = ()) -> None:
        self._run(self._translate(sql), self._params(args, sql))

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        """Row loop under an implicit transaction (when none is open) —
        asyncpg's executemany is atomic, and the backend relies on that
        (pg.py add_transactions); the mock must not be weaker."""
        sqlite_sql = self._translate(sql)
        own_txn = not self.db.in_transaction
        if own_txn:
            self.db.execute("BEGIN")
        try:
            for args in rows:
                self._run(sqlite_sql, self._params(args, sql))
        except BaseException:
            if own_txn:
                self.db.execute("ROLLBACK")
            raise
        else:
            if own_txn:
                self.db.execute("COMMIT")

    def begin(self) -> None:
        self.db.execute("BEGIN")

    def commit(self) -> None:
        self.db.execute("COMMIT")

    def rollback(self) -> None:
        self.db.execute("ROLLBACK")

    def close(self) -> None:
        self.db.close()

    # awaitable facade: same semantics, sqlite is in-process so the
    # "await" is immediate — what matters is interface parity with
    # AsyncpgDriver so PgChainState's SQL runs identically on both

    async def afetch(self, sql: str, args: Sequence[Any] = ()) -> List[dict]:
        return self.fetch(sql, args)

    async def aexecute(self, sql: str, args: Sequence[Any] = ()) -> None:
        self.execute(sql, args)

    async def aexecutemany(self, sql: str,
                           rows: Iterable[Sequence[Any]]) -> None:
        self.executemany(sql, rows)

    async def abegin(self) -> None:
        self.begin()

    async def acommit(self) -> None:
        self.commit()

    async def arollback(self) -> None:
        self.rollback()
