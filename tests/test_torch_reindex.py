"""The port's reindex tool (``python -m upow_tpu_torch.state.reindex``)
against the JAX package's, and ``rebuild_utxos`` on the port's sqlite
backend.

On a sqlite chain written by the JAX package (a fan-out, leaf spends,
empty blocks), both CLIs print the same lines: the block count and the
two fingerprints.  ``--check`` exits 0 on the clean chain and 1 after
one UTXO row is deleted, and it leaves the live file byte for byte as it
was.  With no database both exit 2 with the same line.  ``--pg-dsn``
runs the PostgreSQL path through the port's ``AsyncpgDriver`` on
``tests/fake_asyncpg.py``: the check replays inside one rolled-back
transaction.
"""

import asyncio
import hashlib
import os
import shutil
import sqlite3
import subprocess
import sys
from decimal import Decimal

import pytest

import fake_asyncpg
import upow_tpu.state.reindex as jreindex
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.reindex as treindex
from test_torch_block import JAX, PORT
from test_torch_sync import _build, _freeze_after_chain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def easy_chain(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
        pkg.clock.freeze(1_760_000_000)
    for env in ("UPOW_NODE_DB_PATH", "UPOW_NODE_DB_BACKEND",
                "UPOW_NODE_PG_DSN"):
        monkeypatch.delenv(env, raising=False)
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()
    fake_asyncpg.reset()


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _cli(module, *args):
    """(exit code, stdout lines) of ``amain(args)`` in this process."""
    out = []

    def capture(*a, **k):
        out.append(" ".join(str(x) for x in a))

    module_globals = module.amain.__globals__
    module_globals["print"] = capture
    try:
        rc = asyncio.run(module.amain(list(args)))
    finally:
        module_globals.pop("print", None)
    return rc, out


@pytest.fixture
def chain(tmp_path):
    _build(tmp_path)
    _freeze_after_chain()
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "a.db", tmp_path / f"{name}.db")
    return tmp_path


@pytest.mark.parametrize("check", [False, True])
def test_clean_chain_prints_the_jax_lines(chain, check):
    flags = ["--check"] if check else []
    before = _digest(chain / "port.db")
    got = _cli(treindex, "--db", str(chain / "port.db"), *flags)
    want = _cli(jreindex, "--db", str(chain / "jax.db"), *flags)
    assert got == want
    rc, lines = got
    assert rc == 0 and lines[0].startswith("7 blocks; live state ")
    live, replayed = lines[0].rsplit(" ", 1)[1], lines[1].rsplit(" ", 1)[1]
    assert live == replayed
    assert (lines[2:] == ["OK: live tables match the replay"]) is check
    if check:
        assert _digest(chain / "port.db") == before


def test_check_detects_a_deleted_row_and_keeps_the_file(chain):
    for name in ("jax", "port"):
        with sqlite3.connect(chain / f"{name}.db") as db:
            db.execute("DELETE FROM unspent_outputs WHERE rowid ="
                       " (SELECT MIN(rowid) FROM unspent_outputs)")
    before = _digest(chain / "port.db")
    got = _cli(treindex, "--db", str(chain / "port.db"), "--check")
    want = _cli(jreindex, "--db", str(chain / "jax.db"), "--check")
    assert got == want
    rc, lines = got
    assert rc == 1
    assert lines[0].rsplit(" ", 1)[1] != lines[1].rsplit(" ", 1)[1]
    assert lines[2].startswith("MISMATCH")
    assert _digest(chain / "port.db") == before
    # without --check the tool repairs the file from the tx log
    rc, repaired = _cli(treindex, "--db", str(chain / "port.db"))
    assert rc == 0 and repaired[1] == lines[1]
    assert _cli(treindex, "--db", str(chain / "port.db"),
                "--check")[0] == 0


def test_no_database_exits_2_like_jax():
    got, want = _cli(treindex, "--db", ""), _cli(jreindex, "--db", "")
    assert got == want and got[0] == 2


def test_rebuild_utxos_on_sqlite_matches_jax(chain):
    """``rebuild_utxos`` on the port's sqlite ``ChainState``, index armed
    on the CPU: the JAX backend's fingerprints, and the index rebuilt."""
    async def rebuild(pkg, path, **kw):
        state = pkg.ChainState(str(path), **kw)
        await state.rebuild_utxos()
        out = (await state.get_full_state_hash(),
               await state.get_unspent_outpoints())
        if kw:
            entries = state.index_stats()["entries"]
            out += (entries,)
        state.close()
        return out

    want = asyncio.run(rebuild(JAX, chain / "jax.db"))
    got = asyncio.run(rebuild(PORT, chain / "port.db", device_index=True,
                              device="cpu"))
    assert got[:2] == want
    assert got[2] == len(want[1])  # the chain has no governance outputs


def test_pg_dsn_check_through_asyncpg_driver(monkeypatch):
    """``--pg-dsn`` over the port's AsyncpgDriver on a fake server
    holding a chain: ``--check`` exits 0 and leaves the tables as they
    were; after one UTXO row is deleted it exits 1."""
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg)
    server = fake_asyncpg.FakeServer("postgresql://fake/reindex")

    async def build():
        from test_torch_pg import Run

        state = tpg.PgChainState(server.dsn)
        run = Run(PORT, state)
        d_g, a_g = run.actors["genesis"]
        for _ in range(3):
            await run.mine(a_g)
        await run.push(await run.builder.create_transaction(
            d_g, run.actors["outsider"][1], "1.5"))
        await run.mine(a_g, include_pending=True)
        out = await state.get_full_state_hash()
        state.close()
        return out

    live = asyncio.run(build())
    rc, lines = _cli(treindex, "--pg-dsn", server.dsn, "--check")
    assert rc == 0 and lines == [
        f"4 blocks; live state fingerprint {live}",
        f"replayed state fingerprint {live}",
        "OK: live tables match the replay"]
    server.store.execute("DELETE FROM unspent_outputs WHERE tx_hash ="
                         " (SELECT MIN(tx_hash) FROM unspent_outputs)")
    rc, lines = _cli(treindex, "--pg-dsn", server.dsn, "--check")
    assert rc == 1 and lines[1] == f"replayed state fingerprint {live}"


def test_module_runs_as_a_script(chain):
    out = subprocess.run(
        [sys.executable, "-m", "upow_tpu_torch.state.reindex", "--db",
         str(chain / "port.db"), "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "OK: live tables match the replay"
