"""The port's node over HTTP against the JAX package's, byte for byte.

Both nodes open copies of one chain database written by the JAX package
(a coinbase fanned out into 28 spendable leaves), with both packages'
clocks frozen at one time and rate limits off.  The JAX ``Node`` serves
on an aiohttp ``TestServer``, the port's on its standard-library server
(``device="cpu"``: the plain versions of the kernels), each at an
ephemeral port.  One request sequence goes to both, parametrised over
``device.verify_kernel`` (``jac`` and ``complete``):

``/`` and ``get_mining_info``; a concurrent burst of 16 ``push_tx`` (the
intake coalesces them, so the port's signature checks reach the device
path, here the plain version of the selected kernel); the duplicate, a
pending double spend, a bad signature, a pushed coinbase and unparseable
hex; ``get_pending_transactions``; a block mined by the port's ``mine(job,
"torch")`` pushed by tx hashes; ``get_block`` (by id, and by hash with
full transactions), ``get_blocks`` and ``get_transaction``; then "Too old
block", "Previous hash not found" and a block with one corrupted
signature.  Every body must be byte-equal (``/`` apart from its
``timings`` and ``counters``, which report each package's own
instrumentation), and so must ``get_unspent_outputs_hash`` at the end.
Both nodes run with the hot read cache and ``/ws`` at their defaults
(on), so every read after an accept or an admission is also a check of
the cache's invalidation.

Beside it: the middleware's envelopes (403, 302, 404, 405, 422, 429)
with rate limits on; the port's intake one request at a time against
the JAX node's serial path (``mempool.enabled = False`` there),
``TxVerifier.verify`` and the pending journal's count and wipe; a kernel
that fails to build or launch answered with the 500 envelope, never as
a reject; the node refusing to start without a card; and one config
file and environment read alike by both packages.
"""

import asyncio
import json
import shutil
from decimal import Decimal

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.config as jconfig
import upow_tpu.node.app as japp
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.mine.engine as tengine
import upow_tpu_torch.mine.miner as tminer
import upow_tpu_torch.node.app as tapp
from test_torch_block import JAX, PORT, T0, Chain
from upow_tpu.crypto import p256 as jp256
from upow_tpu_torch import trace
from upow_tpu_torch.crypto import p256
from upow_tpu_torch.telemetry import exposition

LEAVES = 28
BURST = 16


@pytest.fixture(autouse=True)
def easy_chain(monkeypatch):
    """Difficulty 1.0 and frozen clocks in BOTH packages; the port's
    kernel choice restored afterwards."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
        pkg.clock.freeze(T0)
    monkeypatch.setattr(p256, "VERIFY_KERNEL", p256.VERIFY_KERNEL)
    monkeypatch.setattr(jp256, "PALLAS_KERNEL", jp256.PALLAS_KERNEL)
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()


def _build_chain(path):
    """Genesis, a 1 -> 4 fan-out, then 4 x 7 leaves, written by the JAX
    package; returns the leaf outpoints (tx_hash, index, amount)."""
    async def build():
        chain = Chain(JAX, JAX.ChainState(str(path)))
        JAX.clock.advance(60)
        assert (await chain.submit([]))[0]
        coin = (await chain.state.get_spendable_outputs(chain.addr))[0]
        fan = chain.spend([(coin.tx_hash, coin.index, coin.amount)], 4)
        JAX.clock.advance(60)
        assert (await chain.submit([fan]))[0]
        mids = [chain.spend([(fan.hash(), j, fan.outputs[j].amount)],
                            LEAVES // 4) for j in range(4)]
        JAX.clock.advance(60)
        assert (await chain.submit(mids))[0]
        chain.state.close()
        return [(m.hash(), k, o.amount) for m in mids
                for k, o in enumerate(m.outputs)]
    return asyncio.run(build())


def _corrupt(tx):
    r, s = tx.inputs[0].signature
    tx.inputs[0].signature = (r, s + 1)
    tx._hex_cache.pop(True, None)
    tx._hash = None
    return tx


class Pair:
    """The two nodes, and one request sent to both."""

    def __init__(self, session, jurl, turl):
        self.session, self.jurl, self.turl = session, jurl, turl

    async def _one(self, base, method, path, payload):
        async with self.session.request(
                method, base + path, json=payload,
                allow_redirects=False) as resp:
            return resp.status, await resp.read()

    async def both(self, method, path, payload=None, strip=()):
        """(status, body) from both nodes, asserted equal; returns the
        decoded body."""
        got = await asyncio.gather(self._one(self.jurl, method, path, payload),
                                   self._one(self.turl, method, path, payload))
        (js, jb), (ts, tb) = got
        if strip:
            jb, tb = (json.dumps({k: v for k, v in json.loads(b).items()
                                  if k not in strip}).encode()
                      for b in (jb, tb))
        assert (ts, tb) == (js, jb), (path, payload)
        return json.loads(tb)


def _configs(tmp_path, kernel):
    jcfg = jconfig.Config()
    jcfg.node.db_path = str(tmp_path / "jax.db")
    jcfg.node.seed_url = ""
    jcfg.node.peers_file = str(tmp_path / "nodes.json")
    jcfg.node.ip_config_file = ""
    jcfg.node.rate_limits_enabled = False
    jcfg.device.verify_kernel = kernel
    jcfg.log.path = ""
    jcfg.log.console = False
    tcfg = tconfig.Config.load(node__db_path=str(tmp_path / "port.db"),
                               node__seed_url="",
                               node__peers_file=str(tmp_path / "port.nodes.json"),
                               node__ip_config_file="",
                               node__rate_limits_enabled=False)
    tcfg.device.verify_kernel = kernel
    return jcfg, tcfg


async def _sequence(pair, chain, leaves, tnode):
    T = PORT.tx
    trace.reset()
    await pair.both("GET", "/", strip=("timings", "counters"))
    info = (await pair.both("GET", "/get_mining_info"))["result"]
    assert info["pending_transactions"] == []

    # a concurrent burst: the intake coalesces it into shared verifies
    txs = [chain.spend([leaf]) for leaf in leaves[:BURST]]
    burst = await asyncio.gather(*(
        pair.both("POST", "/push_tx", {"tx_hex": tx.hex()}) for tx in txs))
    assert all(r["ok"] for r in burst), burst
    sizes = trace.histograms()["mempool.intake_batch_size"]
    assert sizes["sum"] == BURST
    assert max(tnode.intake.batch_sizes) >= 8  # the device path ran

    # the duplicate, a pending double spend, a bad signature, a coinbase
    # and garbage
    rejects = [
        await pair.both("POST", "/push_tx", {"tx_hex": txs[0].hex()}),
        await pair.both("POST", "/push_tx",
                        {"tx_hex": chain.spend([leaves[0]], 2).hex()}),
        await pair.both("POST", "/push_tx", {
            "tx_hex": _corrupt(chain.spend([leaves[BURST]])).hex()}),
        await pair.both("POST", "/push_tx", {"tx_hex": T.CoinbaseTx(
            "ab" * 32, chain.addr, 10 ** 6).hex()}),
        await pair.both("GET", "/push_tx?tx_hex=zz"),
    ]
    assert [r["ok"] for r in rejects] == [False] * 5
    assert rejects[0]["error"] == "Transaction just added"
    assert rejects[1]["error"] == rejects[2]["error"] == \
        rejects[3]["error"] == "Transaction has not been added"
    assert rejects[4]["error"].startswith("Invalid transaction")
    pending = (await pair.both("GET", "/get_pending_transactions"))["result"]
    assert len(pending) == BURST

    # a block mined by the port's own engine, pushed by tx hashes
    PORT.clock.advance(60)
    JAX.clock.advance(60)
    info = (await pair.both("GET", "/get_mining_info"))["result"]
    assert len(info["pending_transactions_hashes"]) == BURST
    job, hashes, block_no = tminer.build_job(info, chain.addr)
    mined = tengine.mine(job, "torch", batch=1 << 12)
    content = job.block_content(mined.nonce)
    body = {"block_content": content, "txs": hashes, "block_no": block_no}
    assert (await pair.both("POST", "/push_block", body)) == {"ok": True}
    assert (await pair.both("GET", "/get_pending_transactions"))["result"] == []

    await pair.both("GET", f"/get_block?block={block_no}")
    tip = (await pair.both("GET", "/get_mining_info"))["result"]["last_block"]
    full = await pair.both(
        "GET", f"/get_block?block={tip['hash']}&full_transactions=true")
    assert len(full["result"]["full_transactions"]) == BURST + 1
    await pair.both("GET", "/get_blocks?offset=0&limit=10")
    await pair.both("GET", "/get_blocks?offset=x")
    got = await pair.both("GET", f"/get_transaction?tx_hash={txs[3].hash()}")
    assert got["result"]["is_confirm"]
    await pair.both("GET", "/get_transaction?tx_hash=" + "00" * 32)

    # rejected blocks: too old, unknown parent, one corrupted signature
    assert (await pair.both("POST", "/push_block", body))["error"] == \
        "Too old block"
    orphan = {"block_content": tengine.MiningJob.from_header_fields(
        previous_hash="11" * 32, address=chain.addr,
        merkle_root=info["merkle_root"], timestamp=PORT.clock.timestamp(),
        difficulty=info["difficulty"]).block_content(0), "txs": hashes}
    assert (await pair.both("POST", "/push_block", orphan))["error"] == \
        "Previous hash not found"
    PORT.clock.advance(60)
    JAX.clock.advance(60)
    rest = [chain.spend([leaf]) for leaf in leaves[BURST + 1:]]
    rest[2] = _corrupt(rest[2])
    info = (await pair.both("GET", "/get_mining_info"))["result"]
    job = tengine.MiningJob.from_header_fields(
        previous_hash=info["last_block"]["hash"], address=chain.addr,
        merkle_root=PORT.merkle.merkle_root(rest),
        timestamp=PORT.clock.timestamp(), difficulty=info["difficulty"])
    mined = tengine.mine(job, "torch", batch=1 << 12)
    bad = {"block_content": job.block_content(mined.nonce),
           "txs": [tx.hex() for tx in rest]}
    assert (await pair.both("POST", "/push_block", bad))["error"] == \
        "signature verification failed"
    await pair.both("GET", "/get_mining_info")
    return (await pair.both("GET", "/", strip=("timings", "counters")))[
        "unspent_outputs_hash"]


@pytest.mark.parametrize("kernel", ["jac", "complete"])
def test_port_node_answers_like_the_jax_node(tmp_path, monkeypatch, kernel):
    leaves = _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):  # both nodes see one time, after the chain's
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    jcfg, tcfg = _configs(tmp_path, kernel)

    async def main():
        jnode = japp.Node(jcfg)
        jnode.started = True  # no first-request bootstrap
        tnode = tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        chain = Chain(PORT, tnode.state)
        try:
            async with aiohttp.ClientSession() as session:
                pair = Pair(session, f"http://127.0.0.1:{server.port}",
                            f"http://127.0.0.1:{tserver.port}")
                utxo = await _sequence(pair, chain, leaves, tnode)
            assert utxo == await jnode.state.get_unspent_outputs_hash() == \
                await tnode.state.get_unspent_outputs_hash()
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    assert p256.VERIFY_KERNEL == "jac"
    launches = (p256.LAUNCHES, p256.COMPLETE_LAUNCHES, p256.EXCEPTION_LANES)
    ran = {"jac": 0, "complete": 0}
    for name, fn in (("jac", "verify_plain"),
                     ("complete", "verify_complete_plain")):
        def spy(packed, *args, _real=getattr(p256, fn), _name=name, **kw):
            ran[_name] += 1
            return _real(packed, *args, **kw)
        monkeypatch.setattr(p256, fn, spy)
    asyncio.run(main())
    assert p256.VERIFY_KERNEL == kernel
    # the burst and the corrupted block reached the selected ladder only
    assert ran[kernel] >= 2 and sum(ran.values()) == ran[kernel]
    # on the CPU nothing launches, and the complete ladder flags nothing
    if kernel == "complete":
        assert (p256.LAUNCHES, p256.COMPLETE_LAUNCHES,
                p256.EXCEPTION_LANES) == launches


def test_middleware_envelopes_match(tmp_path):
    """403 (IP filter and blocked endpoint), 302 (path normalisation),
    404, 405, 422 and 429 (the reference's 3/minute on ``/``), byte for
    byte, with rate limits on."""
    ipcfg = tmp_path / "ip_config.json"
    ipcfg.write_text(json.dumps({"block_endpoints": ["get_blocks"]}))
    jcfg, tcfg = _configs(tmp_path, "")
    for cfg in (jcfg, tcfg):
        cfg.node.db_path = ""
        cfg.node.rate_limits_enabled = True
        cfg.node.ip_config_file = str(ipcfg)

    async def main():
        jnode = japp.Node(jcfg)
        jnode.started = True
        tnode = tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as session:
                pair = Pair(session, f"http://127.0.0.1:{server.port}",
                            f"http://127.0.0.1:{tserver.port}")
                out = [await pair.both("GET", "/get_blocks"),
                       await pair.both("POST", "/push_tx", {})]
                for _ in range(3):
                    await pair.both("GET", "/", strip=("timings", "counters"))
                out.append(await pair.both("GET", "/"))
                for method, path in (("GET", "//get_mining_info?x=1"),
                                     ("GET", "/nope"),
                                     ("POST", "/get_block")):
                    async with session.request(
                            method, pair.turl + path,
                            allow_redirects=False) as t, session.request(
                            method, pair.jurl + path,
                            allow_redirects=False) as j:
                        assert (t.status, await t.read(),
                                t.headers.get("Location")) == \
                            (j.status, await j.read(),
                             j.headers.get("Location"))
                        out.append(t.status)
            return out
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    out = asyncio.run(main())
    assert out == [{"ok": False, "error": "Access forbidden temporarily."},
                   {"ok": False, "error": "Missing tx_hex"},
                   {"ok": False, "error": "Rate limit exceeded"},
                   302, 404, 405]


def test_node_on_the_card_raises_without_one(tmp_path):
    """No fallback: the default device is the card, and without one the
    node refuses to start."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _jcfg, tcfg = _configs(tmp_path, "complete")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.Node(tcfg)


def test_config_reads_the_jax_file_and_environment(tmp_path, monkeypatch):
    """One config file and one environment configure both packages'
    nodes alike; fields of the JAX schema the port does not read are
    skipped."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({
        "node": {"port": 3111, "mempool_clean_interval": 30,
                 "seed_url": "", "self_url": "http://10.0.0.1:3111",
                 "sync_page": 50, "sync_reorg_window": 7},
        "mempool": {"coalesce_window_ms": 5.0, "max_intake_batch": 64,
                    "allow_rbf": True, "reinject_on_reorg": False},
        "device": {"verify_kernel": "jac", "verify_window": 4,
                   "txid_backend": "device"},
        "cache": {"enabled": False}}))
    monkeypatch.setenv("UPOW_DEVICE_VERIFY_KERNEL", "complete")
    monkeypatch.setenv("UPOW_MEMPOOL_ENABLED", "false")
    monkeypatch.setenv("UPOW_NODE_RATE_LIMITS_ENABLED", "0")
    monkeypatch.setenv("UPOW_NODE_SYNC_FETCH_INTERVAL", "0.25")
    monkeypatch.setenv("UPOW_DEVICE_TXID_MIN_BATCH", "64")
    got = tconfig.Config.load(str(path), node__host="127.0.0.1")
    want = jconfig.Config.load(str(path), node__host="127.0.0.1")
    for section in ("device", "node", "mempool", "cache"):
        for f in __import__("dataclasses").fields(getattr(got, section)):
            assert getattr(getattr(got, section), f.name) == \
                getattr(getattr(want, section), f.name), (section, f.name)
    assert got.device.verify_kernel == "complete"
    assert got.node.port == 3111 and got.mempool.max_intake_batch == 64
    assert (got.node.sync_page, got.node.sync_reorg_window,
            got.node.sync_fetch_interval) == (50, 7, 0.25)
    assert (got.device.txid_backend, got.device.txid_min_batch) == \
        ("device", 64)
    assert got.mempool.reinject_on_reorg is False
    assert got.cache.enabled is False
    # read by the JAX node, skipped by the port's (it always runs the
    # coalescing intake); allow_rbf is read by both
    assert not want.mempool.enabled
    assert not hasattr(got.mempool, "enabled")
    assert got.mempool.allow_rbf is want.mempool.allow_rbf is True
    assert got.node.self_url == want.node.self_url == "http://10.0.0.1:3111"
    got.device.apply_kernel_overrides()
    assert p256.VERIFY_KERNEL == "complete"
    got.device.verify_kernel = "rcb"
    with pytest.raises(ValueError):
        got.device.apply_kernel_overrides()
    with pytest.raises(KeyError):
        tconfig.Config.load(node__nope=1)


def test_serial_intake_and_journal_match_jax(tmp_path):
    """The port's intake, one request at a time, answers as the JAX
    node's reference-shaped serial push_tx path (``mempool.enabled =
    False`` there, one verify per request); then TxVerifier.verify and
    the pending journal's count and wipe, against the JAX package's."""
    leaves = _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    jcfg, tcfg = _configs(tmp_path, "complete")
    jcfg.mempool.enabled = False
    # the journal's wipe below is a write behind both nodes' backs: both
    # caches re-anchor on every read, so the next read sees it
    for cfg in (jcfg, tcfg):
        cfg.cache.revalidate_interval = 0.0

    async def main():
        jnode = japp.Node(jcfg)
        jnode.started = True
        tnode = tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        chain = Chain(PORT, tnode.state)
        try:
            async with aiohttp.ClientSession() as session:
                pair = Pair(session, f"http://127.0.0.1:{server.port}",
                            f"http://127.0.0.1:{tserver.port}")
                txs = [chain.spend([leaf]) for leaf in leaves[:2]]
                out = [await pair.both("POST", "/push_tx",
                                       {"tx_hex": tx.hex()})
                       for tx in txs + [txs[0], chain.spend([leaves[1]], 2),
                                        _corrupt(chain.spend([leaves[2]]))]]
                pending = await pair.both("GET", "/get_pending_transactions")
                fresh = chain.spend([leaves[3]])
                verdicts = []
                for verifier in (jnode.make_tx_verifier(),
                                 tnode.make_tx_verifier()):
                    verdicts.append((await verifier.verify(fresh),
                                     await verifier.verify(txs[0]),
                                     await verifier.verify(_corrupt(
                                         chain.spend([leaves[4]])))))
                counts = [await jnode.state.get_pending_transactions_count(),
                          await tnode.state.get_pending_transactions_count()]
                await jnode.state.remove_pending_transactions()
                await tnode.state.remove_pending_transactions()
                emptied = await pair.both("GET", "/get_pending_transactions")
                left = await tnode.state.get_pending_transactions_count()
            return out, pending, verdicts, counts, emptied, left
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    out, pending, verdicts, counts, emptied, left = asyncio.run(main())
    assert [r.get("error") for r in out] == [
        None, None, "Transaction just added",
        "Transaction has not been added", "Transaction has not been added"]
    assert len(pending["result"]) == 2 and counts == [2, 2]
    assert verdicts[0] == verdicts[1] == (True, True, False)
    assert emptied["result"] == [] and left == 0


def test_mempool_gc_matches_jax(tmp_path):
    """``BlockManager.clear_pending_transactions`` on one journal that
    holds a double spend and a spend of a missing output: the same txs
    evicted, in the same notifications, as the JAX package's."""
    leaves = _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)

    async def gc(pkg, path):
        chain = Chain(pkg, pkg.ChainState(str(path)))
        removed = []
        chain.manager.on_pending_removed = removed.append
        txs = [chain.spend([leaves[0]]), chain.spend([leaves[0]], 2),
               chain.spend([leaves[1]]),
               chain.spend([("ab" * 32, 0, 10)]),
               chain.spend([leaves[2]])]
        for tx in txs:  # straight into the journal, as another writer would
            await chain.state.add_pending_transaction(tx)
        await chain.manager.clear_pending_transactions()
        left = await chain.state.get_pending_transactions_limit(hex_only=True)
        chain.state.close()
        return removed, sorted(left), [tx.hash() for tx in txs]

    got = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
        got[name] = asyncio.run(gc(pkg, tmp_path / f"{name}.db"))
    assert got["port"] == got["jax"]
    removed, left, hashes = got["port"]
    gone = [h for batch in removed for h in batch]
    # one of the two spends of leaf 0, then the spend of a missing output
    assert len(gone) == 2 and gone[0] in hashes[:2] and gone[1] == hashes[3]
    assert len(left) == 3


def test_kernel_failure_is_no_reject(tmp_path, monkeypatch):
    """On a card, a complete kernel that fails to launch reaches the
    client as the node's 500 envelope, never as the invalid-tx reject:
    the tx is not admitted and not verified some other way, the degrade
    records the failure (in ``txverify.DEGRADE`` and the node's
    ``/metrics``),
    and once the kernel works again the same tx is accepted.  The card's
    rule runs here on the plain version (``host_may_serve`` answers as
    for a card).  A runtime that failed to arm its device also reaches
    the client as the 500 envelope."""
    from upow_tpu_torch.device import runtime as truntime
    from upow_tpu_torch.verify import txverify as ttxverify

    leaves = _build_chain(tmp_path / "chain.db")
    PORT.clock.freeze(T0 + 600)
    shutil.copyfile(tmp_path / "chain.db", tmp_path / "port.db")
    _jcfg, tcfg = _configs(tmp_path, "complete")
    tcfg.device.sig_backend = "device"  # one tx reaches the kernel
    real = p256.verify_complete_packed
    calls = {"broken": 0}

    def broken(packed):
        calls["broken"] += 1
        raise RuntimeError("launch failed for p256_complete")

    def arm_fails(self, *a, **k):
        raise truntime.ArmError("device runtime failed to arm cpu: nvcc")

    ttxverify.DEGRADE.reset()
    truntime.reset_runtime()

    async def main():
        tnode = tapp.Node(tcfg, device="cpu")
        tserver = await tnode.serve("127.0.0.1", 0)
        base = f"http://127.0.0.1:{tserver.port}/"
        chain = Chain(PORT, tnode.state)
        tx, tx2 = chain.spend([leaves[0]]), chain.spend([leaves[1]])
        counts = []
        try:
            async with aiohttp.ClientSession() as session:
                monkeypatch.setattr(ttxverify, "host_may_serve",
                                    lambda device=None: False)
                monkeypatch.setattr(p256, "verify_complete_packed", broken)
                async with session.post(base + "push_tx",
                                        json={"tx_hex": tx.hex()}) as r:
                    failed = (r.status, await r.json())
                counts.append(
                    await tnode.state.get_pending_transactions_count())
                async with session.get(base + "metrics") as r:
                    scrape = exposition.samples(await r.text())
                health = {**ttxverify.DEGRADE.snapshot(),
                          "gauge": scrape["upow_device_verify_health"],
                          "errors_total": scrape[
                              "upow_resilience_device_error_total"]}
                monkeypatch.setattr(p256, "verify_complete_packed", real)
                async with session.post(base + "push_tx",
                                        json={"tx_hex": tx.hex()}) as r:
                    again = (r.status, await r.json())
                truntime.reset_runtime()
                monkeypatch.setattr(truntime.DeviceRuntime, "arm", arm_fails)
                async with session.post(base + "push_tx",
                                        json={"tx_hex": tx2.hex()}) as r:
                    unarmed = (r.status, await r.json())
                counts.append(
                    await tnode.state.get_pending_transactions_count())
                monkeypatch.undo()
                truntime.reset_runtime()
                async with session.post(base + "push_tx",
                                        json={"tx_hex": tx2.hex()}) as r:
                    armed = (r.status, await r.json())
            return failed, health, again, unarmed, counts, armed
        finally:
            await tnode.close()

    try:
        failed, health, again, unarmed, counts, armed = asyncio.run(main())
    finally:
        ttxverify.DEGRADE.reset()
        truntime.reset_runtime()
    assert failed == (500, {"ok": False,
                            "error": "Uncaught RuntimeError exception"})
    assert calls["broken"] == 1 and counts[0] == 0
    assert health["state"] == "ok" and health["errors"] == 1
    assert health["gauge"] == 0 and health["errors_total"] == 1
    assert "launch failed for p256_complete" in health["last_error"]
    assert again[0] == 200 and again[1]["ok"], again
    assert unarmed == (500, {"ok": False,
                             "error": "Uncaught ArmError exception"})
    assert counts[1] == 1
    assert armed[0] == 200 and armed[1]["ok"], armed
