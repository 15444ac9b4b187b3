"""Chain sync and reorg on the port's node against the JAX node's.

A chain is written by the JAX package at difficulty 1.0 with both
packages' clocks frozen: genesis, a coinbase fanned out 1 -> 4 -> 4 x 3
(blocks 2 and 3 spend outputs of the blocks before them, so a sync page
resolves inputs against itself), a block of 6 leaf spends, and empty
blocks after it.  The JAX node serves it on an aiohttp ``TestServer``;
the port's node (``device="cpu"``: the plain versions of the kernels)
and a second JAX node each sync from it through ``/sync_blockchain
?node_url=`` (the JAX node serves its copy uncached, as the port does).
Every ``/sync_blockchain`` body, the tip and ``get_unspent_outputs_hash``
must be equal.  The scenarios are the JAX package's own
(``tests/test_node.py``), cut to a few blocks and tens of txs:

* sync from scratch, and over several pages with the next page
  prefetched;
* a page with ``txid_backend = device`` gives one txid batch and one
  signature verify for the whole page, whose verdicts answer every
  block's checks;
* a faulty device txid gives the merkle mismatch and the host retry
  (``sync.host_txid_retry``), over HTTP and on a page without header
  content;
* a fork onto a longer chain inside a small ``sync_reorg_window``, with
  removed blocks whose txs depend on each other, and the pending journal
  after it;
* a ``push_block`` gap with ``Sender-Node`` starts a sync;
* "Node is already syncing" from ``push_tx``, ``push_block`` and
  ``/sync_blockchain``;
* ``ChainState.remove_blocks`` with ``reinject_reorg_txs`` on and off
  against the JAX package's;
* a JAX node syncing from the port's node.
"""

import asyncio
import hashlib
import json
import shutil
import sqlite3

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.config as jconfig
import upow_tpu.crypto.sha256 as jsha
import upow_tpu.node.app as japp
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.node.app as tapp
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_node import Pair, easy_chain  # noqa: F401  (fixture)
from upow_tpu_torch import trace
from upow_tpu_torch.crypto import p256, sha256 as tsha

EMPTY_TAIL = 3


def _spends(chain, leaves):
    return [chain.spend([leaf]) for leaf in leaves]


def _build(tmp_path, fork=False):
    """The served chain (``a.db``): genesis, fan-out, 12 leaves, a block
    of 6 leaf spends, ``EMPTY_TAIL`` empty blocks.  With ``fork``, also
    ``fork.db``: the first three blocks and its own blocks 4' (a spend of
    leaf 0, which block 4 spends too, and a spend of leaf 6, which the
    served chain never spends) and 5' (a spend of that tx's output).
    Returns the leaves."""
    async def build():
        chain = Chain(JAX, JAX.ChainState(str(tmp_path / "a.db")))
        JAX.clock.advance(60)
        assert (await chain.submit([]))[0]
        coin = (await chain.state.get_spendable_outputs(chain.addr))[0]
        fan = chain.spend([(coin.tx_hash, coin.index, coin.amount)], 4)
        JAX.clock.advance(60)
        assert (await chain.submit([fan]))[0]
        mids = [chain.spend([(fan.hash(), j, fan.outputs[j].amount)], 3)
                for j in range(4)]
        JAX.clock.advance(60)
        assert (await chain.submit(mids))[0]
        leaves = [(m.hash(), k, o.amount) for m in mids
                  for k, o in enumerate(m.outputs)]
        with sqlite3.connect(tmp_path / "prefix.db") as prefix:
            chain.state.db.backup(prefix)
        JAX.clock.advance(60)
        ok, errors, _ = await chain.submit(_spends(chain, leaves[:6]))
        assert ok, errors
        for _ in range(EMPTY_TAIL):
            JAX.clock.advance(60)
            assert (await chain.submit([]))[0]
        chain.state.close()
        if fork:
            shutil.copyfile(tmp_path / "prefix.db", tmp_path / "fork.db")
            other = Chain(JAX, JAX.ChainState(str(tmp_path / "fork.db")))
            JAX.clock.advance(-(EMPTY_TAIL + 1) * 60 + 7)
            kept = other.spend([leaves[6]])
            ok, errors, _ = await other.submit(
                [other.spend([leaves[0]], 2), kept])
            assert ok, errors
            JAX.clock.advance(60)
            child = other.spend([(kept.hash(), 0, kept.outputs[0].amount)])
            ok, errors, _ = await other.submit([child])
            assert ok, errors
            other.state.close()
            JAX.clock.advance(EMPTY_TAIL * 60)
        return leaves
    return asyncio.run(build())


def _freeze_after_chain():
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 3600)


def _jcfg(tmp_path, name, db=None, **node):
    cfg = jconfig.Config()
    cfg.node.db_path = str(tmp_path / f"{db or name}.db")
    cfg.node.seed_url = ""
    cfg.node.peers_file = str(tmp_path / f"{name}.nodes.json")
    cfg.node.ip_config_file = ""
    cfg.node.rate_limits_enabled = False
    cfg.node.sync_fetch_interval = 0
    cfg.log.path = ""
    cfg.log.console = False
    for key, value in node.items():
        setattr(cfg.node, key, value)
    return cfg


def _tcfg(tmp_path, name, db=None, **node):
    cfg = tconfig.Config.load(
        node__db_path=str(tmp_path / f"{db or name}.db"),
        node__seed_url="", node__peers_file=str(tmp_path / f"{name}.nodes.json"),
        node__ip_config_file="", node__rate_limits_enabled=False,
        node__sync_fetch_interval=0)
    for key, value in node.items():
        setattr(cfg.node, key, value)
    return cfg


def _copy(tmp_path, src, *names):
    for name in names:
        shutil.copyfile(tmp_path / f"{src}.db", tmp_path / f"{name}.db")


class Cluster:
    """The serving JAX node ``a``, the port's node ``b`` and a second JAX
    node ``c``, each on its own file and an ephemeral port; closed in
    reverse order."""

    def __init__(self):
        self.nodes, self.servers, self.urls = {}, [], {}

    async def jax(self, name, cfg):
        node = japp.Node(cfg)
        node.started = True  # no first-request bootstrap
        server = TestServer(node.app)
        await server.start_server()
        self.nodes[name] = node
        self.servers.append(server)
        self.urls[name] = f"http://127.0.0.1:{server.port}"
        return node

    async def port(self, name, cfg):
        node = tapp.Node(cfg, device="cpu")
        server = await node.serve("127.0.0.1", 0)
        self.nodes[name] = node
        self.urls[name] = f"http://127.0.0.1:{server.port}"
        return node

    async def close(self):
        for server in reversed(self.servers):
            await server.close()
        for node in reversed(list(self.nodes.values())):
            await node.close()

    async def utxo(self, name):
        return await self.nodes[name].state.get_unspent_outputs_hash()

    async def tip(self, name):
        return (await self.nodes[name].state.get_last_block())["hash"]


async def _sync(session, url, peer):
    async with session.get(url + "/sync_blockchain",
                           params={"node_url": peer}) as resp:
        return resp.status, await resp.read()


async def _both_sync(session, cl, port="b", jax="c", peer="a"):
    """One /sync_blockchain to the port's node and to the JAX one, from
    ``peer``; the bodies must be equal.  Returns the decoded body."""
    got = await _sync(session, cl.urls[port], cl.urls[peer])
    want = await _sync(session, cl.urls[jax], cl.urls[peer])
    assert got == want
    return json.loads(got[1])


def _run(tmp_path, scenario, fork=False, port_cfg=None, jax_cfg=None,
         port_db="b", jax_db="c"):
    """Serve ``a.db`` from a JAX node; the port's node ``b`` and the JAX
    node ``c`` on their own copies of ``port_db``/``jax_db`` (``b``/``c``:
    empty files); run ``scenario(session, cluster)``."""
    leaves = _build(tmp_path, fork=fork)
    _freeze_after_chain()
    _copy(tmp_path, "a", "a_serve")
    for src, dst in ((port_db, "b"), (jax_db, "c")):
        if src not in ("b", "c"):
            _copy(tmp_path, src, dst)

    async def main():
        cl = Cluster()
        try:
            await cl.jax("a", _jcfg(tmp_path, "a", db="a_serve"))
            await cl.port("b", port_cfg or _tcfg(tmp_path, "b"))
            await cl.jax("c", jax_cfg or _jcfg(tmp_path, "c"))
            async with aiohttp.ClientSession() as session:
                return await scenario(session, cl, leaves)
        finally:
            await cl.close()
    return asyncio.run(main())


async def _converged(cl, *names):
    tips = {await cl.tip(n) for n in names}
    hashes = {await cl.utxo(n) for n in names}
    assert len(tips) == 1 and len(hashes) == 1
    return tips.pop()


def test_sync_from_scratch_matches_jax(tmp_path):
    async def scenario(session, cl, _leaves):
        trace.reset()
        body = await _both_sync(session, cl)
        assert body == {"ok": True, "peer": cl.urls["a"]}
        await _converged(cl, "a", "b", "c")
        assert await cl.nodes["b"].state.get_next_block_id() == \
            4 + EMPTY_TAIL + 1
        # a second sync finds nothing new
        assert (await _both_sync(session, cl))["ok"]
        counters = trace.counters()
        assert counters.get("sync.host_txid_retry", 0) == 0
        assert counters.get("snapshot_recommended", 0) == 0
    _run(tmp_path, scenario)


def test_sync_multi_page_with_prefetch(tmp_path):
    """Page size 2 over 7 blocks: 4 pages with the next one prefetched
    at every boundary, and the short last page ends the loop."""
    calls = []

    async def scenario(session, cl, _leaves):
        real = cl.nodes["b"].iface_factory

        def factory(url, cfg, **kw):
            iface = real(url, cfg, **kw)
            get_blocks = iface.get_blocks

            async def spy(offset, limit):
                calls.append((offset, limit))
                return await get_blocks(offset, limit)
            iface.get_blocks = spy
            return iface

        cl.nodes["b"].iface_factory = factory
        assert (await _both_sync(session, cl))["ok"]
        await _converged(cl, "a", "b", "c")

    _run(tmp_path, scenario, port_cfg=_tcfg(tmp_path, "b", sync_page=2),
         jax_cfg=_jcfg(tmp_path, "c", sync_page=2))
    assert calls == [(1, 2), (3, 2), (5, 2), (7, 2), (8, 2)]


def test_sync_page_one_txid_batch_and_one_signature_verify(tmp_path,
                                                           monkeypatch):
    """With ``txid_backend = device`` and the device signature backend the
    page's txids are one ``txid_batch`` on the device path (here the plain
    version) and its 11 signature checks one verify (pass 1 with the two
    canaries, pass 2 for the bad canary); every block's accept is then
    answered from the page's verdicts, and every stored txid equals a
    fresh hash of its tx."""
    verifies, digest_rows = [], []
    real_verify = p256.verify_batch_prehashed
    real_blocks = tsha.sha256_ragged_plain

    def spy_verify(digests, sigs, pubs, device=None):
        verifies.append(len(digests))
        return real_verify(digests, sigs, pubs, device=device)

    def spy_blocks(words, table):
        digest_rows.append(int(table.shape[0]))
        return real_blocks(words, table)

    monkeypatch.setattr(p256, "verify_batch_prehashed", spy_verify)
    monkeypatch.setattr(tsha, "sha256_ragged_plain", spy_blocks)
    cfg = _tcfg(tmp_path, "b")
    cfg.device.txid_backend = "device"
    cfg.device.txid_min_batch = 2
    cfg.device.sig_backend = "device"

    async def scenario(session, cl, _leaves):
        trace.reset()
        assert (await _both_sync(session, cl))["ok"]
        await _converged(cl, "a", "b", "c")
        spans = trace.stats()
        assert spans["sync.page_txids"]["count"] == 1
        assert spans["sync.page_sig_prefill"]["count"] == 1
        state = cl.nodes["b"].state
        for n in range(2, 5):
            block = await state.get_block_by_id(n)
            for h in await state.get_block_transaction_hashes(block["hash"]):
                tx = await state.get_transaction(h)
                assert h == hashlib.sha256(bytes.fromhex(tx.hex())).hexdigest()

    _run(tmp_path, scenario, port_cfg=cfg)
    assert verifies == [1 + 4 + 6 + 2, 1]
    assert digest_rows  # the page's batch ran on the device path


def _faulty(real, target):
    def faulty(payloads, **kw):
        out = real(payloads, backend="host")
        return ["0" * 64 if p == target else d for p, d in zip(payloads, out)]
    return faulty


def test_faulty_device_txid_retries_on_host(tmp_path, monkeypatch):
    """One persistent wrong lane in the page's device txids: the merkle
    check catches it, the page is accepted on a host-hashed retry, and
    the JAX node, under the same fault, answers alike."""
    async def scenario(session, cl, leaves):
        served = cl.nodes["a"].state
        block = await served.get_block_by_id(4)
        txs = [await served.get_transaction(h) for h in
               await served.get_block_transaction_hashes(block["hash"])]
        tx = next(t for t in txs if not t.is_coinbase).hash()
        payload = bytes.fromhex((await served.get_transaction(tx)).hex())
        monkeypatch.setattr(tapp, "txid_batch",
                            _faulty(tsha.txid_batch, payload))
        monkeypatch.setattr(jsha, "txid_batch",
                            _faulty(jsha.txid_batch, payload))
        for name in ("b", "c"):  # the page prefill reads the config
            cl.nodes[name].config.device.txid_backend = "device"
            cl.nodes[name].config.device.txid_min_batch = 2
        trace.reset()
        assert (await _both_sync(session, cl))["ok"]
        await _converged(cl, "a", "b", "c")
        assert trace.counters()["sync.host_txid_retry"] == 1
        state = cl.nodes["b"].state
        block = await state.get_block_by_id(4)
        assert tx in await state.get_block_transaction_hashes(block["hash"])

        # the same fault on a page without header content: the rebuilt
        # header hashes the raw hexes, so the wrong seed cannot pass
        page = await cl.nodes["a"].state.get_blocks(1, 500)
        for entry in page:
            entry["block"] = dict(entry["block"])
            entry["block"].pop("content", None)
        for name in ("b", "c"):
            await cl.nodes[name].state.remove_blocks(1)
            errors = []
            assert await cl.nodes[name].create_blocks(page, errors), errors
        await _converged(cl, "a", "b", "c")
        assert trace.counters()["sync.host_txid_retry"] == 2

    _run(tmp_path, scenario)


def test_fork_reorg_converges_like_jax(tmp_path):
    """Both syncing nodes hold the first three blocks and their own
    blocks 4' and 5'; the served chain is longer.  With
    ``sync_reorg_window = 3`` both find block 3 in common, roll 4' and 5'
    back (restoring leaves 0 and 6 but not the output that 5' spent, a
    removed tx's), accept 4 onwards, and re-inject the txs that spend
    nothing removed into the pending journal."""
    async def scenario(session, cl, leaves):
        fork_tip = await cl.tip("b")
        assert fork_tip == await cl.tip("c") != await cl.tip("a")
        removed = []
        cl.nodes["b"].state.on_blocks_removed = removed.append
        body = await _both_sync(session, cl)
        assert body == {"ok": True, "peer": cl.urls["a"]}
        await _converged(cl, "a", "b", "c")
        assert removed == [4]
        assert await cl.nodes["b"].state.get_block(fork_tip) is None
        pair = Pair(session, cl.urls["c"], cl.urls["b"])
        pending = (await pair.both("GET", "/get_pending_transactions"))[
            "result"]
        assert len(pending) == 2  # the spends of leaves 0 and 6, not the child

    _run(tmp_path, scenario, fork=True,
         port_cfg=_tcfg(tmp_path, "b", sync_reorg_window=3),
         jax_cfg=_jcfg(tmp_path, "c", sync_reorg_window=3),
         port_db="fork", jax_db="fork")


def test_push_block_gap_starts_a_sync(tmp_path):
    """A block from beyond the tip, with ``Sender-Node``, answers the
    reference's body and starts a sync from the sender."""
    async def scenario(session, cl, leaves):
        tip = await cl.nodes["a"].state.get_last_block()
        pair = Pair(session, cl.urls["c"], cl.urls["b"])

        async def push(base):
            async with session.post(
                    base + "/push_block",
                    json={"block_content": tip["content"], "txs": [],
                          "block_no": tip["id"]},
                    headers={"Sender-Node": cl.urls["a"]}) as resp:
                return resp.status, await resp.read()

        got, want = await push(pair.turl), await push(pair.jurl)
        assert got == want
        assert b"Blocks missing, had to sync" in got[1]
        for _ in range(200):
            if all([await cl.nodes[n].state.get_next_block_id() ==
                    tip["id"] + 1 for n in ("b", "c")]):
                break
            await asyncio.sleep(0.05)
        await _converged(cl, "a", "b", "c")

    _run(tmp_path, scenario, port_db="prefix", jax_db="prefix")


def test_already_syncing_on_all_three_routes(tmp_path):
    async def scenario(session, cl, leaves):
        pair = Pair(session, cl.urls["c"], cl.urls["b"])
        for name in ("b", "c"):
            cl.nodes[name].is_syncing = True
        busy = {"ok": False, "error": "Node is already syncing"}
        assert await pair.both("POST", "/push_tx", {"tx_hex": "00"}) == busy
        assert await pair.both("POST", "/push_block",
                               {"block_content": "00"}) == busy
        assert await pair.both(
            "GET", f"/sync_blockchain?node_url={cl.urls['a']}") == busy
        for name in ("b", "c"):
            cl.nodes[name].is_syncing = False
        # without a url and with no peer book, both find no node
        assert await pair.both("GET", "/sync_blockchain") == {
            "ok": False, "error": "No nodes found."}

    _run(tmp_path, scenario)


def test_jax_node_syncs_from_the_port_node(tmp_path):
    """The port's node serves the chain; a JAX node syncs all of it."""
    async def scenario(session, cl, leaves):
        served = cl.nodes["b"]
        assert (await served.state.get_next_block_id()) == 4 + EMPTY_TAIL + 1
        body = await _sync(session, cl.urls["c"], cl.urls["b"])
        assert body[0] == 200
        assert json.loads(body[1]) == {
            "ok": True, "peer": cl.urls["b"]}
        await _converged(cl, "a", "b", "c")

    _run(tmp_path, scenario, port_db="a")


@pytest.mark.parametrize("reinject", [True, False])
def test_remove_blocks_matches_jax(tmp_path, reinject):
    """``remove_blocks`` of a block whose tx (parent) spends a confirmed
    output and of the next, whose tx (child) spends the parent's output
    (JAX ``tests/test_mempool.py``'s scenario): the same UTXO set,
    journal and pending-spent overlay, with re-injection on and off."""
    async def run(pkg, path):
        chain = Chain(pkg, pkg.ChainState(str(path)))
        chain.state.reinject_reorg_txs = reinject
        removed = []
        chain.state.on_blocks_removed = removed.append
        pkg.clock.advance(60)
        assert (await chain.submit([]))[0]
        coin = (await chain.state.get_spendable_outputs(chain.addr))[0]
        fan = chain.spend([(coin.tx_hash, coin.index, coin.amount)], 3)
        pkg.clock.advance(60)
        assert (await chain.submit([fan]))[0]
        before = await chain.state.get_unspent_outputs_hash()
        parent = chain.spend([(fan.hash(), 0, fan.outputs[0].amount)])
        pkg.clock.advance(60)
        assert (await chain.submit([parent]))[0]
        child = chain.spend([(parent.hash(), 0, parent.outputs[0].amount)])
        pkg.clock.advance(60)
        assert (await chain.submit([child]))[0]
        await chain.state.remove_blocks(3)
        journal = sorted(r["tx_hash"]
                         for r in await chain.state.load_pending_journal())
        out = (removed, await chain.state.get_unspent_outputs_hash(),
               journal,
               sorted(await chain.state.get_pending_spent_outpoints()),
               await chain.state.get_next_block_id(), before,
               parent.hash(), child.hash())
        chain.state.close()
        return out

    got = asyncio.run(run(PORT, tmp_path / "port.db"))
    want = asyncio.run(run(JAX, tmp_path / "jax.db"))
    assert got == want
    removed, utxo, journal, spent, next_id, before, parent, child = got
    assert removed == [3] and next_id == 3 and utxo == before
    assert journal == ([parent] if reinject else [])
    assert len(spent) == (1 if reinject else 0)
