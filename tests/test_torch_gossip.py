"""The port's node in a network with the JAX package's nodes, over HTTP.

Port nodes serve on their standard-library server (``device="cpu"``:
the plain versions of the kernels), JAX nodes on aiohttp
``TestServer``s, each on a copy of one JAX-written chain (a coinbase
fanned out into 28 leaves) with both packages' clocks frozen, rate
limits off and no seed (``node.seed_url = ""``).  Each node's
``self_url`` is its own address, so its gossip carries ``Sender-Node``.

* Two-way gossip: a tx pushed to a JAX node reaches the port node's
  pool, the block that mines it, pushed to the JAX node, reaches the
  port node; then a tx and a block pushed to the port node reach the
  JAX node.  Pools, tips and UTXO hashes end equal.
* ``/add_node`` (missing url, itself, added, already present, a dead
  peer) and ``/get_nodes`` after a ``Sender-Node`` header: byte-equal
  bodies from a port and a JAX node.
* The first-request bootstrap: a request whose ``Host`` is not local
  makes a port node and a JAX node learn their seed's peers, announce
  themselves and sync to the seed's tip; a local ``Host`` does not.
* ``node.trust_proxy_headers`` on and off against the IP filter's
  blocklist, with ``X-Forwarded-For`` and ``X-Real-IP``: the same status
  and body from both nodes.
* A journal tx last gossiped over 300 s ago is sent again once.
* A dead peer's breaker opens while gossip to a live one lands within
  ``resilience.propagate_deadline``; ``/debug/breakers`` byte-equal.
* ``/sync_blockchain`` with no ``node_url`` tries the dead peer and then
  the live one, from both nodes, with the same body.
"""

import asyncio
import json
import shutil
import socket
import time
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
from test_torch_node import _build_chain

BLOCKED_IP = "10.1.1.1"


@pytest.fixture(autouse=True)
def easy_chain(monkeypatch):
    """Difficulty 1.0 and frozen clocks in both packages."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
        pkg.clock.freeze(T0)
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()


def _dead_url() -> str:
    """A local port nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}"


def _jcfg(tmp_path, name, resilience=(), **node):
    cfg = jconfig.Config()
    cfg.node.db_path = str(tmp_path / f"{name}.db")
    cfg.node.seed_url = ""
    cfg.node.peers_file = str(tmp_path / f"{name}.nodes.json")
    cfg.node.ip_config_file = ""
    cfg.node.rate_limits_enabled = False
    cfg.node.sync_fetch_interval = 0
    cfg.log.path = ""
    cfg.log.console = False
    cfg.resilience.rpc_backoff_base = 0.01
    for key, value in node.items():
        setattr(cfg.node, key, value)
    for key, value in dict(resilience).items():
        setattr(cfg.resilience, key, value)
    return cfg


def _tcfg(tmp_path, name, resilience=(), **node):
    cfg = tconfig.Config.load(
        node__db_path=str(tmp_path / f"{name}.db"), node__seed_url="",
        node__peers_file=str(tmp_path / f"{name}.nodes.json"),
        node__ip_config_file="", node__rate_limits_enabled=False,
        node__sync_fetch_interval=0, resilience__rpc_backoff_base=0.01)
    for key, value in node.items():
        setattr(cfg.node, key, value)
    for key, value in dict(resilience).items():
        setattr(cfg.resilience, key, value)
    return cfg


class Net:
    """JAX and port nodes on their own files and ephemeral ports; each
    node's ``self_url`` is its address."""

    def __init__(self, tmp_path):
        self.tmp = tmp_path
        self.nodes, self.urls, self.servers = {}, {}, []

    def copy(self, src, *names):
        for name in names:
            shutil.copyfile(self.tmp / f"{src}.db", self.tmp / f"{name}.db")

    async def jax(self, name, **kw):
        node_ = japp.Node(_jcfg(self.tmp, name, **kw))
        server = TestServer(node_.app)
        await server.start_server()
        self.servers.append(server)
        return self._up(name, node_, server.port)

    async def port(self, name, **kw):
        node_ = tapp.Node(_tcfg(self.tmp, name, **kw), device="cpu")
        server = await node_.serve("127.0.0.1", 0)
        return self._up(name, node_, server.port)

    def _up(self, name, node, port):
        url = f"http://127.0.0.1:{port}"
        node.self_url = url
        self.nodes[name], self.urls[name] = node, url
        return node

    async def get(self, session, name, path, headers=None, params=None):
        async with session.get(self.urls[name] + path, headers=headers,
                               params=params, allow_redirects=False) as r:
            return r.status, await r.read()

    async def post(self, session, name, path, payload):
        async with session.post(self.urls[name] + path, json=payload) as r:
            return json.loads(await r.read())

    async def close(self):
        for server in reversed(self.servers):
            await server.close()
        for node in reversed(list(self.nodes.values())):
            await node.close()


def _run(tmp_path, scenario):
    leaves = _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)

    async def main():
        net = Net(tmp_path)
        try:
            async with aiohttp.ClientSession() as session:
                return await scenario(net, session, leaves)
        finally:
            await net.close()
    return asyncio.run(main())


async def until(pred, what, timeout=90.0):
    """Poll the coroutine function ``pred`` until it is true."""
    deadline = time.monotonic() + timeout
    while not await pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.05)


async def _pending(node):
    return sorted(await node.state.get_pending_transactions_limit(
        hex_only=True))


async def _tip(node):
    return (await node.state.get_last_block())["hash"]


async def _mine_push(net, session, name, chain):
    """A block on ``name``'s template, pushed to it by tx hashes."""
    for pkg in (JAX, PORT):
        pkg.clock.advance(60)
    _status, raw = await net.get(session, name, "/get_mining_info")
    info = json.loads(raw)["result"]
    job, hashes, block_no = tminer.build_job(info, chain.addr)
    mined = tengine.mine(job, "torch", batch=1 << 12)
    return await net.post(session, name, "/push_block", {
        "block_content": job.block_content(mined.nonce), "txs": hashes,
        "block_no": block_no})


async def _coinbase_block(node, chain):
    """One coinbase-only block accepted straight into ``node``."""
    for pkg in (JAX, PORT):
        pkg.clock.advance(60)
    chain.manager = node.manager
    ok, errors, _ = await chain.submit([])
    assert ok, errors


def test_blocks_and_txs_gossip_both_ways(tmp_path):
    async def scenario(net, session, leaves):
        net.copy("chain", "j", "p")
        j = await net.jax("j")
        p = await net.port("p")
        j.peers.add(net.urls["p"])
        p.peers.add(net.urls["j"])
        chain = Chain(PORT, p.state)
        # a tx and its block pushed to the JAX node reach the port node
        tx1 = chain.spend([leaves[0]])
        assert (await net.post(session, "j", "/push_tx",
                               {"tx_hex": tx1.hex()}))["ok"]
        await until(lambda: _has(p, tx1), "tx1 in the port node's pool")
        assert await _pending(p) == await _pending(j) == [tx1.hex()]
        assert await _mine_push(net, session, "j", chain) == {"ok": True}
        await until(lambda: _same_tip(p, j), "block 4 on the port node")
        # and from the port node to the JAX node
        tx2 = chain.spend([leaves[1]])
        assert (await net.post(session, "p", "/push_tx",
                               {"tx_hex": tx2.hex()}))["ok"]
        await until(lambda: _has(j, tx2), "tx2 in the JAX node's pool")
        assert await _pending(p) == await _pending(j) == [tx2.hex()]
        assert await _mine_push(net, session, "p", chain) == {"ok": True}
        await until(lambda: _same_tip(p, j), "block 5 on the JAX node")
        hashes = [await n.state.get_unspent_outputs_hash() for n in (j, p)]
        assert (await j.state.get_next_block_id()) == 6
        assert await _pending(p) == await _pending(j) == []
        # each learned the other from its Sender-Node and heard from it
        return hashes, p.peers._data[net.urls["j"]]["last_message"] > 0

    hashes, heard = _run(tmp_path, scenario)
    assert hashes[0] == hashes[1] and heard


async def _has(node, tx):
    return bool(await node.state.get_pending_transactions_by_hash(
        [tx.hash()]))


async def _same_tip(a, b):
    return await _tip(a) == await _tip(b)


def test_add_node_and_get_nodes_answer_like_jax(tmp_path):
    async def scenario(net, session, _leaves):
        net.copy("chain", "x", "y", "live")
        await net.jax("y")
        await net.port("x")
        await net.jax("live")
        dead = _dead_url()
        out = {}
        for name in ("x", "y"):
            steps = [
                {},
                {"url": net.urls[name]},
                {"url": net.urls["live"]},
                {"url": net.urls["live"] + "/"},
                {"url": dead},
                {"url": ""},
            ]
            replies = [await net.get(session, name, "/add_node",
                                     params=params) for params in steps]
            replies.append(await net.get(
                session, name, "/get_nodes",
                headers={"Sender-Node": "10.9.9.9:3006"}))
            out[name] = replies
        return out, net.urls["live"]

    out, live = _run(tmp_path, scenario)
    assert out["x"] == out["y"]
    bodies = [(s, json.loads(b)) for s, b in out["x"]]
    assert bodies == [
        (422, {"ok": False, "error": "Missing url"}),
        (200, {"ok": False, "error": "Recursively adding node"}),
        (200, {"ok": True, "result": "Node added"}),
        (200, {"ok": False, "error": "Node already present"}),
        (200, {"ok": False, "error": "Could not add node"}),
        (422, {"ok": False, "error": "Missing url"}),
        (200, {"ok": True, "result": [live, "http://10.9.9.9:3006"]})]


def test_first_request_bootstraps_from_the_seed(tmp_path):
    async def scenario(net, session, _leaves):
        net.copy("chain", "seed", "peer", "cp", "cj")
        seed = await net.jax("seed")
        await _coinbase_block(seed, Chain(JAX, seed.state))
        peer = await net.port("peer")
        tip = await seed.state.get_last_block()
        assert await peer.manager.create_block(tip["content"], [])
        seed.peers.add(net.urls["peer"])
        out = {}
        for name, start in (("cp", net.port), ("cj", net.jax)):
            node = await start(name, seed_url=net.urls["seed"])
            # a local Host starts nothing
            await net.get(session, name, "/get_supply_info")
            assert not node.started
            status, _ = await net.get(
                session, name, "/get_supply_info",
                headers={"Host": f"{name}.example:3006"})
            assert status == 200 and node.started
            await until(lambda: _same_tip(node, seed), f"{name} synced")
            await until(lambda: _knows(net, ("seed", "peer"), name),
                        f"{name} announced")
            out[name] = (sorted(node.peers.all_nodes()),
                         await node.state.get_unspent_outputs_hash())
        return out, net.urls, await seed.state.get_unspent_outputs_hash()

    out, urls, seed_hash = _run(tmp_path, scenario)
    assert out["cp"][0] == sorted([urls["seed"], urls["peer"]])
    assert out["cj"][0] == sorted([urls["seed"], urls["peer"], urls["cp"]])
    assert out["cp"][1] == out["cj"][1] == seed_hash


async def _knows(net, holders, name):
    return all(net.nodes[h].peers.contains(net.urls[name]) for h in holders)


def test_trust_proxy_headers_against_the_ip_filter(tmp_path):
    (tmp_path / "ip.json").write_text(json.dumps({"blocklist": [BLOCKED_IP]}))
    ip_file = str(tmp_path / "ip.json")

    async def scenario(net, session, _leaves):
        net.copy("chain", "x", "y")
        nodes = [await net.port("x", ip_config_file=ip_file),
                 await net.jax("y", ip_config_file=ip_file)]
        out = []
        for trust in (False, True):
            for node in nodes:
                node.config.node.trust_proxy_headers = trust
            for headers in ({}, {"X-Forwarded-For": BLOCKED_IP},
                            {"X-Forwarded-For": f"{BLOCKED_IP}, 127.0.0.1"},
                            {"X-Forwarded-For": f"127.0.0.1, {BLOCKED_IP}"},
                            {"X-Real-IP": BLOCKED_IP},
                            {"X-Real-IP": "127.0.0.1"}):
                got = [await net.get(session, name, "/get_supply_info",
                                     headers=headers) for name in ("x", "y")]
                assert got[0] == got[1], (trust, headers)
                out.append(got[0][0])
        return out

    assert _run(tmp_path, scenario) == [200] * 6 + [200, 403, 200, 403,
                                                    403, 200]


def test_old_journal_tx_is_gossiped_again_once(tmp_path):
    async def scenario(net, session, leaves):
        net.copy("chain", "p", "j")
        j = await net.jax("j")
        p = await net.port("p")
        p.peers.add(net.urls["j"])
        sent = []
        real = p.propagate

        async def spy(path, args, **kw):
            sent.append((path, args.get("tx_hex")))
            await real(path, args, **kw)
        p.propagate = spy
        tx = Chain(PORT, p.state).spend([leaves[2]])
        await p.state.add_pending_transaction(tx)  # as another writer would
        await net.get(session, "p", "/get_supply_info")
        await asyncio.sleep(0.2)
        assert sent == []  # gossiped at its insert time, not 300 s ago
        p.state.db.execute(
            "UPDATE pending_transactions SET propagation_time = ?",
            (PORT.clock.timestamp() - 301,))
        p.state.db.commit()
        await net.get(session, "p", "/get_supply_info")
        await until(lambda: _has(j, tx), "the old tx on the JAX node")
        for _ in range(3):
            await net.get(session, "p", "/get_supply_info")
        await asyncio.sleep(0.2)
        return sent, await p.state.get_need_propagate_transactions(), \
            tx.hex()

    sent, left, tx_hex = _run(tmp_path, scenario)
    assert sent == [("push_tx", tx_hex)] and left == []


def test_dead_peer_opens_its_breaker_while_gossip_lands(tmp_path):
    async def scenario(net, session, leaves):
        net.copy("chain", "x", "y", "live")
        live = await net.jax("live")
        dead = "http://127.0.0.1:1"
        senders = []
        for name, start in (("x", net.port), ("y", net.jax)):
            node = await start(name, resilience={
                "breaker_failure_threshold": 2})
            node.self_url = ""  # no Sender-Node: live gossips nothing back
            node.peers.add(dead)
            node.peers.add(net.urls["live"])
            senders.append(node)
        tx = Chain(PORT, senders[0].state).spend([leaves[3]])
        walls = []
        for node in senders:
            for _ in range(3):
                t0 = time.monotonic()
                await node.propagate("push_tx", {"tx_hex": tx.hex()})
                walls.append(time.monotonic() - t0)
        await until(lambda: _has(live, tx), "gossip on the live peer")
        bodies = [await net.get(session, name, "/debug/breakers")
                  for name in ("x", "y")]
        deadline = senders[0].config.resilience.propagate_deadline
        return bodies, walls, deadline, dead, net.urls["live"]

    bodies, walls, deadline, dead, live = _run(tmp_path, scenario)
    assert bodies[0] == bodies[1]
    status, body = bodies[0]
    result = json.loads(body)["result"]
    assert status == 200 and result["state_counts"] == {
        "closed": 1, "open": 1, "half_open": 0}
    assert result["peers"][dead]["state"] == "open"
    assert result["peers"][live] == {"state": "closed", "score": 1.0,
                                     "consecutive_failures": 0, "flips": 0}
    assert max(walls) < deadline


def test_sync_without_node_url_takes_the_live_peer(tmp_path):
    async def scenario(net, session, _leaves):
        net.copy("chain", "live", "x", "y")
        live = await net.jax("live")
        await _coinbase_block(live, Chain(JAX, live.state))
        replies = []
        for name, start in (("x", net.port), ("y", net.jax)):
            node = await start(name)
            node.peers.add("http://127.0.0.1:1")  # ranked first: its URL
            node.peers.add(net.urls["live"])
            replies.append(await net.get(session, name, "/sync_blockchain"))
            assert await _same_tip(node, live)
        empty = await net.port("z")
        empty_reply = await net.get(session, "z", "/sync_blockchain")
        return replies, net.urls["live"], empty_reply, empty.peers.all_nodes()

    replies, live, empty_reply, book = _run(tmp_path, scenario)
    assert replies[0] == replies[1]
    assert json.loads(replies[0][1]) == {"ok": True, "peer": live}
    assert json.loads(empty_reply[1]) == {"ok": False,
                                          "error": "No nodes found."}
    assert book == []
