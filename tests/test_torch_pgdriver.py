"""The port's ``AsyncpgDriver`` against the JAX package's, over
``tests/fake_asyncpg.py`` injected as ``sys.modules["asyncpg"]``.

JAX ``tests/test_pgdriver_asyncpg.py``'s cases (type round trips, the
SQLSTATE mapping, a reconnect after an idle drop, the write poison after
a mid-transaction loss and after a mid-statement drop, the atomic
``executemany``, the awaitable facade's per-statement lock, the
awaitable transaction cycle, ``close``), each run once on the JAX driver
and once on the port's, each on a fresh fake server.  Every outcome is
logged (rows, exception class names, messages, SQLSTATEs and chained
causes, the server's connection and statement counts) and the two logs
must be equal.
"""

import asyncio
import datetime
import sys
from decimal import Decimal
from types import SimpleNamespace

import pytest

import fake_asyncpg
import upow_tpu.state.pgdriver as jdrv
import upow_tpu_torch.state.pgdriver as tdrv

INSERT = ("INSERT INTO pending_transactions (tx_hash, tx_hex, "
          "inputs_addresses, fees, propagation_time) "
          "VALUES ($1, $2, $3, $4, $5)")
SELECT = ("SELECT tx_hash, inputs_addresses, fees, propagation_time "
          "FROM pending_transactions ORDER BY tx_hash")


def _row(i):
    return (f"tx{i:02d}", "00" * 8, ["addr_a", "addr_b"], Decimal("0.5"),
            datetime.datetime(2026, 8, 1, 12, 0, i))


class Log:
    """Outcomes of driver calls, comparable across the two packages."""

    def __init__(self, server):
        self.server, self.out = server, []

    def __call__(self, fn, *args):
        try:
            value = fn(*args)
            if asyncio.iscoroutine(value):
                value = asyncio.run(value)
            self.out.append(("ok", value))
            return value
        except Exception as e:  # the class, not the package, is compared
            self.out.append((type(e).__name__, str(e),
                             getattr(e, "sqlstate", None),
                             type(e.__cause__).__name__))
            return None

    def counts(self):
        self.out.append(("server", self.server.connect_count,
                         len(self.server.connections),
                         self.server.store.db.in_transaction))


def round_trips(drv, log, server):
    log(drv.execute, INSERT, _row(1))
    log(drv.fetch, SELECT)
    log.counts()


def sqlstate_mapping(drv, log, server):
    log(drv.execute, INSERT, _row(1))
    log(drv.execute, INSERT, _row(1))
    log(drv.execute, INSERT, ("txbig", "00", [], Decimal("123456789.0"),
                              _row(0)[4]))


def reconnect_after_idle_drop(drv, log, server):
    log(drv.execute, INSERT, _row(1))
    server.drop_connections()
    log(drv.fetch, SELECT)
    log.counts()


def mid_transaction_loss_poisons_writes(drv, log, server):
    log(drv.execute, INSERT, _row(1))
    log(drv.begin)
    log(drv.execute, INSERT, _row(2))
    server.drop_connections()
    log(drv.execute, INSERT, _row(3))
    log(drv.commit)
    log(drv.fetch, SELECT)
    before = server.statement_count
    log(drv.rollback)
    log.out.append(("statements", server.statement_count - before))
    log(drv.execute, INSERT, _row(4))
    log(drv.fetch, SELECT)


def mid_statement_drop_then_poisons(drv, log, server):
    log(drv.begin)
    server.drop_after(1)
    log(drv.execute, INSERT, _row(1))
    log(drv.execute, INSERT, _row(2))
    log(drv.rollback)
    log(drv.execute, INSERT, _row(3))
    log(drv.fetch, SELECT)
    log.counts()


def executemany_is_atomic(drv, log, server):
    log(drv.executemany, INSERT, [_row(1), _row(2), _row(2)])
    log(drv.fetch, SELECT)
    log(drv.executemany, INSERT, [_row(1), _row(2)])
    log(drv.executemany, INSERT, [])
    log(drv.fetch, SELECT)


def awaitable_facade_serializes(drv, log, server):
    async def main():
        await asyncio.gather(*[drv.aexecute(INSERT, _row(i))
                               for i in range(10)])
        return [r["tx_hash"] for r in await drv.afetch(SELECT)]
    log(main)


def awaitable_transaction_cycle(drv, log, server):
    async def main():
        await drv.abegin()
        await drv.aexecute(INSERT, _row(1))
        await drv.acommit()
        await drv.abegin()
        await drv.aexecutemany(INSERT, [_row(2)])
        await drv.arollback()
        server.drop_connections()
        await drv.abegin()
        await drv.aexecute(INSERT, _row(3))
        await drv.acommit()
        return [r["tx_hash"] for r in await drv.afetch(SELECT)]
    log(main)
    log.counts()


def close_mid_transaction_aborts(drv, log, server):
    log(drv.begin)
    log(drv.execute, INSERT, _row(1))


CASES = {f.__name__: f for f in (
    round_trips, sqlstate_mapping, reconnect_after_idle_drop,
    mid_transaction_loss_poisons_writes, mid_statement_drop_then_poisons,
    executemany_is_atomic, awaitable_facade_serializes,
    awaitable_transaction_cycle, close_mid_transaction_aborts)}


def _run(pkg, case, monkeypatch):
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg)
    server = fake_asyncpg.FakeServer(f"postgresql://fake/{pkg.name}")
    log = Log(server)
    drv = pkg.drv.AsyncpgDriver(server.dsn)
    thread = drv._thread
    try:
        CASES[case](drv, log, server)
    finally:
        drv.close()
    log.out.append(("closed", thread.is_alive(), len(server.connections),
                    server.store.db.in_transaction))
    # a later connection finds no dangling transaction to join
    after = pkg.drv.AsyncpgDriver(server.dsn)
    try:
        log(after.fetch, SELECT)
        log(after.execute, INSERT, _row(9))
    finally:
        after.close()
    log.counts()
    fake_asyncpg.reset()
    return log.out


JAX = SimpleNamespace(name="jax", drv=jdrv)
PORT = SimpleNamespace(name="port", drv=tdrv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_case_matches_jax(case, monkeypatch):
    got = _run(PORT, case, monkeypatch)
    want = _run(JAX, case, monkeypatch)
    assert got == want
    assert ("closed", False, 0, False) in got


def test_mapped_errors_are_the_port_classes(monkeypatch):
    """The port's driver raises its own taxonomy, chained to the
    asyncpg exception, and asyncpg is imported only when it connects."""
    monkeypatch.setitem(sys.modules, "asyncpg", None)
    with pytest.raises(ImportError):
        tdrv.AsyncpgDriver("postgresql://nowhere/db")
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg)
    server = fake_asyncpg.FakeServer("postgresql://fake/classes")
    drv = tdrv.AsyncpgDriver(server.dsn)
    try:
        drv.execute(INSERT, _row(1))
        with pytest.raises(tdrv.UniqueViolation) as info:
            drv.execute(INSERT, _row(1))
        assert not isinstance(info.value, jdrv.PgDriverError)
        assert isinstance(info.value.__cause__,
                          fake_asyncpg.UniqueViolationError)
    finally:
        drv.close()
        fake_asyncpg.reset()
