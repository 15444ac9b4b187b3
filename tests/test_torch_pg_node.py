"""The port's node on the PostgreSQL backend against the JAX node on it.

A JAX node and the port's node (``device="cpu"``) each run on a pg state
over their package's mock driver, injected as JAX ``tests/test_node.py``
injects it, with the read cache and ``/ws`` at their defaults.  Both
ingest the same fork chain (JAX ``tests/test_torch_sync.py``'s: three
blocks, then blocks 4' and 5'), get the same ``push_tx``, a
``/sync_blockchain`` from a JAX node serving the longer chain (a reorg
that removes 4' and 5'), a ``push_block`` and the read routes.  Every
body, the tip and the UTXO and full-state fingerprints must be equal.
With ``mempool.reinject_on_reorg`` on, the pending tables are equal too:
as in the JAX pg backend, the removed blocks' txs do not go back into
the journal.

Besides: the backend switch of both nodes' config (a file, the
``UPOW_NODE_*`` environment, an unknown backend, ``postgres`` without
asyncpg), and the public surface of the port's two backends.
"""

import asyncio
import json
import sys

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.config as jconfig
import upow_tpu.core.header as jheader
import upow_tpu.core.merkle as jmerkle
import upow_tpu.node.app as japp
import upow_tpu.state.pg as jpg
import upow_tpu.state.pgdriver as jdrv
import upow_tpu.state.storage as jstorage
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.pgdriver as tdrv
import upow_tpu_torch.state.storage as tstorage
from test_torch_block import JAX, PORT
from test_torch_node import Pair, easy_chain  # noqa: F401  (fixture)
from test_torch_sync import (_build, _copy, _freeze_after_chain, _jcfg,
                             _tcfg)
from upow_tpu_torch import trace
from upow_tpu_torch.node.http import ws_connect
from upow_tpu_torch.telemetry import exposition

# the archive and snapshot methods of the JAX backends (ROADMAP A13d):
# both are on both of the port's backends
A13D = {"archive_export_span", "archive_prune_span",
        "archive_hot_row_counts"}
SNAPSHOT = {"export_snapshot_rows", "export_snapshot_txs",
            "export_snapshot_blocks", "restore_snapshot"}


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")
            and callable(getattr(cls, n))}


def test_backend_surfaces_match():
    """The port's ``PgChainState`` has every public method of its
    ``ChainState``, and more only where the JAX pg backend has more than
    the JAX sqlite one; the snapshot and archive methods of A13d are on
    both port backends, and the port's pg surface is the JAX pg one."""
    tsql, tpgs = _public(tstorage.ChainState), _public(tpg.PgChainState)
    jsql, jpgs = _public(jstorage.ChainState), _public(jpg.PgChainState)
    assert tsql - tpgs == set()
    assert tpgs - tsql == jpgs - jsql == {"ensure_schema",
                                          "replay_transaction"}
    assert A13D | SNAPSHOT <= jsql & jpgs
    assert A13D | SNAPSHOT <= tsql & tpgs
    assert jpgs == tpgs


def test_db_backend_config_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"node": {
        "db_backend": "postgres", "pg_dsn": "postgresql://u@h/upow"}}))
    for env in ("UPOW_NODE_DB_BACKEND", "UPOW_NODE_PG_DSN"):
        monkeypatch.delenv(env, raising=False)
    for pkg in (jconfig, tconfig):
        node = pkg.Config.load(str(path)).node
        assert (node.db_backend, node.pg_dsn) == (
            "postgres", "postgresql://u@h/upow")
        assert pkg.Config().node.db_backend == "sqlite"
    monkeypatch.setenv("UPOW_NODE_DB_BACKEND", "sqlite")
    monkeypatch.setenv("UPOW_NODE_PG_DSN", "postgresql://other/db")
    got = [(c.node.db_backend, c.node.pg_dsn) for c in
           (jconfig.Config.load(str(path)), tconfig.Config.load(str(path)))]
    assert got[0] == got[1] == ("sqlite", "postgresql://other/db")
    assert tconfig.Config.load(node__db_backend="postgres").node.db_backend \
        == "postgres"


def _node_errors(tmp_path, backend, monkeypatch):
    """The exception each node raises for ``backend``, the port node
    never building a sqlite state."""
    built = []
    monkeypatch.setattr(tapp, "ChainState",
                        lambda *a, **k: built.append(a) or 1 / 0)
    jcfg = _jcfg(tmp_path, "j", db_backend=backend, pg_dsn="postgresql://x/y")
    tcfg = _tcfg(tmp_path, "t", db_backend=backend, pg_dsn="postgresql://x/y")
    out = []
    for make in (lambda: japp.Node(jcfg),
                 lambda: tapp.Node(tcfg, device="cpu")):
        with pytest.raises(Exception) as info:
            make()
        out.append((type(info.value), str(info.value)))
    assert built == []
    assert not (tmp_path / "t.db").exists()
    return out


def test_unknown_backend_raises_the_jax_error(tmp_path, monkeypatch):
    (jtype, jmsg), (ttype, tmsg) = _node_errors(tmp_path, "mysql",
                                                monkeypatch)
    assert jtype is ttype is ValueError
    assert tmsg == jmsg == ("node.db_backend must be 'sqlite' or 'postgres',"
                            " not 'mysql'")


def test_postgres_without_asyncpg_raises(tmp_path, monkeypatch):
    """No asyncpg: both nodes fail when built, with the same exception
    type, and the port's node builds no sqlite state instead."""
    monkeypatch.setitem(sys.modules, "asyncpg", None)
    (jtype, _jmsg), (ttype, tmsg) = _node_errors(tmp_path, "postgres",
                                                 monkeypatch)
    assert jtype is ttype and issubclass(ttype, ImportError)
    assert "asyncpg" in tmsg


async def _mine(node, txs, address):
    """A block on the JAX node's tip, mined by the JAX package's code."""
    diff, last = await node.manager.calculate_difficulty()
    header = jheader.BlockHeader(
        previous_hash=last["hash"], address=address,
        merkle_root=jmerkle.merkle_root(txs),
        timestamp=JAX.clock.timestamp(), difficulty_x10=int(diff * 10),
        nonce=0)
    while not JAX.difficulty.check_pow(header.hex(), last["hash"], diff):
        header.nonce += 1
    return header.hex()


READS = ["/get_pending_transactions", "/get_mining_info",
         "/get_block?block=3", "/get_block?block=5",
         "/get_blocks?offset=1&limit=20", "/get_block_details?block=4",
         "/get_blocks_details?offset=2&limit=4", "/get_supply_info",
         "/dobby_info", "/get_validators_info", "/get_delegates_info"]


@pytest.mark.parametrize("reinject,indexed", [(True, True),
                                              (False, False)])
def test_pg_nodes_match_jax(tmp_path, reinject, indexed):
    leaves = _build(tmp_path, fork=True)
    _freeze_after_chain()
    _copy(tmp_path, "a", "a_serve")

    async def main():
        jstate = jpg.PgChainState(driver=jdrv.MockPgDriver())
        tstate = tpg.PgChainState(driver=tdrv.MockPgDriver(), device="cpu")
        if indexed:
            jstate.enable_device_index()
            tstate.enable_device_index()
        served = japp.Node(_jcfg(tmp_path, "a", db="a_serve"))
        served.started = True
        jcfg = _jcfg(tmp_path, "c", sync_reorg_window=3)
        jcfg.device.sig_backend = "host"
        jcfg.mempool.reinject_on_reorg = reinject
        tcfg = _tcfg(tmp_path, "b", sync_reorg_window=3)
        tcfg.mempool.reinject_on_reorg = reinject
        jnode = japp.Node(jcfg, state=jstate)
        jnode.started = True
        tnode = tapp.Node(tcfg, state=tstate, device="cpu")
        servers = [TestServer(served.app), TestServer(jnode.app)]
        for server in servers:
            await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        a_url, j_url = (f"http://127.0.0.1:{s.port}" for s in servers)
        t_url = f"http://127.0.0.1:{tserver.port}"
        try:
            fork = jstorage.ChainState(str(tmp_path / "fork.db"))
            page = await fork.get_blocks(1, 100)
            fork.close()
            for node in (jnode, tnode):
                errors = []
                assert await node.create_blocks(page, errors), errors
            assert jnode.state.reinject_reorg_txs is reinject
            assert tnode.state.reinject_reorg_txs is reinject
            fork_tip = (await tstate.get_last_block())["hash"]
            async with aiohttp.ClientSession() as session:
                pair = Pair(session, j_url, t_url)
                ws = await ws_connect(t_url + "/ws")
                assert (await ws.receive_json())["type"] == \
                    "connection_established"
                await ws.send_json({"type": "subscribe_block"})
                assert (await ws.receive_json())["type"] == "success"

                spend = [PORT.tx.Tx([PORT.tx.TxInput(h, i)], [
                    PORT.tx.TxOutput(_addr(), a)]) for h, i, a in leaves[7:9]]
                spend = [_sign(t) for t in spend]
                for tx in spend:
                    assert (await pair.both("POST", "/push_tx", {
                        "tx_hex": tx.hex()}))["tx_hash"] == tx.hash()
                assert (await pair.both("POST", "/push_tx", {
                    "tx_hex": spend[0].hex()}))["ok"] is False
                for path in READS:
                    await pair.both("GET", path)

                body = await pair.both(
                    "GET", f"/sync_blockchain?node_url={a_url}")
                assert body == {"ok": True, "peer": a_url}
                assert await tstate.get_block(fork_tip) is None
                pending = (await pair.both(
                    "GET", "/get_pending_transactions"))["result"]
                # no re-injection on pg: only the two pushed spends
                assert sorted(pending) == sorted(t.hex() for t in spend)

                JAX.clock.advance(60)
                PORT.clock.advance(60)
                txs = [JAX.tx.tx_from_hex(t.hex()) for t in spend]
                content = await _mine(jnode, txs, _addr())
                trace.reset()
                assert await pair.both("POST", "/push_block", {
                    "block_content": content,
                    "txs": [t.hex() for t in spend]}) == {"ok": True}
                # the armed index answered the accept's inputs (the
                # fused scan, its probe on an executor thread while the
                # mock driver refuses any thread but the loop's)
                assert (trace.counters().get("index.probes", 0) > 0) \
                    is indexed
                frame = await asyncio.wait_for(ws.receive_json(), 30)
                assert frame["type"] == "new_block"
                await ws.close()
                for path in READS + [
                        f"/get_transaction?tx_hash={spend[0].hash()}",
                        f"/get_address_info?address={_addr()}"
                        "&show_pending=true&stake_outputs=true",
                        f"/get_address_transactions?address={_addr()}"]:
                    await pair.both("GET", path)
                assert (await pair.both(
                    "GET", "/get_pending_transactions"))["result"] == []
                async with session.get(t_url + "/metrics") as resp:
                    scrape = (await resp.read()).decode()
            assert not exposition.validate(scrape)
            for state in (jstate, tstate):
                assert (await state.get_last_block())["id"] == 8
            fingerprints = {(await s.get_unspent_outputs_hash(),
                             await s.get_full_state_hash())
                            for s in (jstate, tstate)}
            assert len(fingerprints) == 1
            if indexed:
                assert tstate.index_stats()["entries"] > 0
                assert "upow_utxo_index_entries" in scrape
        finally:
            for server in servers:
                await server.close()
            for node in (tnode, jnode, served):
                await node.close()

    asyncio.run(main())


def _key():
    return PORT.curve.keygen(rng=0xB10C)


def _addr():
    return PORT.core.point_to_string(_key()[1])


def _sign(tx):
    d, pub = _key()
    return tx.sign([d], lambda _i: pub)
