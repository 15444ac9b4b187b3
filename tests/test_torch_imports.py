"""The port imports with ``jax``, the JAX package, ``aiohttp`` and
``filelock`` out of reach.

A subprocess puts a finder on ``sys.meta_path`` that refuses ``jax``,
``jaxlib``, ``upow_tpu`` (but not ``upow_tpu_torch``), ``aiohttp`` (the
JAX node's server; the port's node serves on the standard library) and
``filelock`` (the JAX peer book's lock; the port's is ``fcntl``), then
imports every module of the port, and ``chip_smoke.py`` with it.  A second
subprocess starts the port's node under the same finder, with its
resident UTXO index armed on the CPU, and serves requests (``/``, and
``/metrics`` with its degrade gauge and the device runtime's armed event
on ``/debug/events``, the telemetry package, the logger and a
``/debug/profile`` capture on ``torch.profiler``, one ``/ws`` exchange on
the port's own WebSocket transport, ``/debug/cache`` after a cache hit
and ``/debug/alerts`` with the watchtower on); a third builds a
two-block chain
on one port node and syncs a second from it over HTTP
(``node/peers.py``'s client); a fourth runs the port's node on its
PostgreSQL backend (the mock driver, the index armed on the CPU); a
fifth drives the wallet (``/send_to_address``, the nodeless wallet and
the CLI) and a snapshot built on one node and restored into another.
"""

import os
import pkgutil
import subprocess
import sys

import upow_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "upow_tpu", "aiohttp", "filelock")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked for the port: " + name)
        return None


sys.meta_path.insert(0, Block())


def serve():
    import asyncio, json, os, tempfile
    from upow_tpu_torch.config import Config
    from upow_tpu_torch.device.runtime import get_runtime
    from upow_tpu_torch.telemetry import exposition
    from upow_tpu_torch.node.app import Node
    from upow_tpu_torch.node.http import fetch, ws_connect

    async def main():
        cfg = Config.load(node__db_path="", node__ip_config_file="",
                          node__seed_url="", node__peers_file="",
                          log__path="", log__json_format=True,
                          profile__enabled=True,
                          profile__trace_dir=tempfile.mkdtemp(),
                          watchtower__enabled=True,
                          watchtower__interval=0.05)
        cfg.device.verify_kernel = "complete"
        cfg.device.utxo_index = True
        node = Node(cfg, device="cpu")
        assert node.state.index_stats()["entries"] == 0
        get_runtime("cpu").arm()  # as serve_forever does
        server = await node.serve("127.0.0.1", 0)
        try:
            base = "http://127.0.0.1:%d" % server.port
            status, body = await fetch(base + "/get_mining_info")
            assert status == 200 and json.loads(body)["ok"], body
            status, body = await fetch(base + "/push_tx", "POST", b"{}")
            assert status == 422, body
            status, body = await fetch(base + "/")
            assert sorted(json.loads(body)) == [
                "counters", "ok", "timings", "unspent_outputs_hash",
                "version"], body
            status, body = await fetch(base + "/metrics")
            assert not exposition.validate(body.decode()), body
            scrape = exposition.samples(body.decode())
            assert scrape["upow_device_verify_health"] == 0, scrape
            status, body = await fetch(
                base + "/debug/events?kind=device_runtime_armed")
            armed = json.loads(body)["result"]
            assert [e["platform"] for e in armed] == ["cpu"], armed
            for action in ("start", "status", "stop"):
                status, body = await fetch(
                    base + "/debug/profile?action=" + action)
                assert status == 200 and json.loads(body)["ok"], body
            assert os.path.exists(json.loads(body)["result"]["trace_file"])
            ws = await ws_connect(base + "/ws")
            hello = await ws.receive_json()
            assert hello["type"] == "connection_established", hello
            await ws.send_json({"type": "subscribe_block"})
            assert (await ws.receive_json())["type"] == "success"
            await ws.send_json({"type": "ping"})
            assert await ws.receive_json() == {"type": "pong"}
            await ws.close()
            assert ws.close_code == 1000
            for _ in range(2):
                status, body = await fetch(base + "/get_supply_info")
                assert status == 200, body
            status, body = await fetch(base + "/debug/cache")
            stats = json.loads(body)["result"]
            assert (stats["hits"], stats["misses"]) == (1, 1), stats
            await asyncio.sleep(0.2)
            status, body = await fetch(base + "/debug/alerts")
            alerts = json.loads(body)["result"]
            assert alerts["enabled"] and alerts["stats"]["evaluations"] > 0
            assert alerts["counts"]["firing"] == 0, alerts
        finally:
            await node.close()
    asyncio.run(main())
    print("served")


def sync():
    import asyncio, json, time
    from decimal import Decimal
    from urllib.parse import quote
    from upow_tpu_torch.config import Config
    from upow_tpu_torch.core import clock, curve, difficulty, point_to_string
    from upow_tpu_torch.core.header import BlockHeader
    from upow_tpu_torch.core.merkle import merkle_root
    from upow_tpu_torch.node.app import GENESIS_PREV_HASH, Node
    from upow_tpu_torch.node.http import fetch

    difficulty.START_DIFFICULTY = Decimal("1.0")
    clock.freeze(int(time.time()) - 600)
    addr = point_to_string(curve.keygen(rng=7)[1])

    async def main():
        nodes = [Node(Config.load(node__db_path="", node__ip_config_file="",
                                  node__seed_url="", node__peers_file="",
                                  node__sync_fetch_interval=0), device="cpu")
                 for _ in range(2)]
        try:
            urls = []
            for node in nodes:
                server = await node.serve("127.0.0.1", 0)
                urls.append("http://127.0.0.1:%d" % server.port)
            manager = nodes[0].manager
            for _ in range(2):
                clock.advance(60)
                diff, last = await manager.calculate_difficulty()
                prev = last["hash"] if last else GENESIS_PREV_HASH
                h = BlockHeader(previous_hash=prev, address=addr,
                                merkle_root=merkle_root([]),
                                timestamp=clock.timestamp(),
                                difficulty_x10=int(diff * 10), nonce=0)
                while last and not difficulty.check_pow(h.hex(), prev, diff):
                    h.nonce += 1
                assert await manager.create_block(h.hex(), [])
            status, body = await fetch(
                urls[1] + "/sync_blockchain?node_url=" + quote(urls[0]))
            assert status == 200 and json.loads(body)["ok"], body
            tips = [await n.state.get_last_block() for n in nodes]
            assert tips[0]["id"] == 2 and tips[0] == tips[1], tips
        finally:
            for node in nodes:
                await node.close()
    asyncio.run(main())
    print("synced")


def pg():
    import asyncio, json, time
    from decimal import Decimal
    from upow_tpu_torch.config import Config
    from upow_tpu_torch.core import clock, curve, difficulty, point_to_string
    from upow_tpu_torch.core.header import BlockHeader
    from upow_tpu_torch.core.merkle import merkle_root
    from upow_tpu_torch.node.app import GENESIS_PREV_HASH, Node
    from upow_tpu_torch.node.http import fetch
    from upow_tpu_torch.state.pg import PgChainState
    from upow_tpu_torch.state.pgdriver import MockPgDriver
    from upow_tpu_torch.state.reindex import check_replay_pg

    difficulty.START_DIFFICULTY = Decimal("1.0")
    clock.freeze(int(time.time()) - 600)
    addr = point_to_string(curve.keygen(rng=7)[1])

    async def main():
        state = PgChainState(driver=MockPgDriver(), device="cpu")
        state.enable_device_index()
        node = Node(Config.load(node__db_backend="postgres",
                                node__ip_config_file="", node__seed_url="",
                                node__peers_file=""),
                    state=state, device="cpu")
        try:
            server = await node.serve("127.0.0.1", 0)
            base = "http://127.0.0.1:%d" % server.port
            for _ in range(2):
                clock.advance(60)
                diff, last = await node.manager.calculate_difficulty()
                prev = last["hash"] if last else GENESIS_PREV_HASH
                h = BlockHeader(previous_hash=prev, address=addr,
                                merkle_root=merkle_root([]),
                                timestamp=clock.timestamp(),
                                difficulty_x10=int(diff * 10), nonce=0)
                while last and not difficulty.check_pow(h.hex(), prev, diff):
                    h.nonce += 1
                if not last:  # the genesis block, as a sync takes it
                    assert await node.manager.create_block(h.hex(), [])
                    continue
                status, body = await fetch(
                    base + "/push_block", "POST",
                    json.dumps({"block_content": h.hex(), "txs": []}).encode())
                assert json.loads(body) == {"ok": True}, body
            status, body = await fetch(base + "/get_block?block=2")
            assert json.loads(body)["result"]["block"]["id"] == 2, body
            assert state.index_stats()["entries"] == 2
            before, after = await check_replay_pg(state)
            assert before == after
        finally:
            await node.close()
    asyncio.run(main())
    print("pg served")


def wallet_snapshot():
    import asyncio, json, os, tempfile, time
    from decimal import Decimal
    from urllib.parse import urlencode
    from upow_tpu_torch.config import Config
    from upow_tpu_torch.core import clock, curve, difficulty, point_to_string
    from upow_tpu_torch.core.header import BlockHeader
    from upow_tpu_torch.core.merkle import merkle_root
    from upow_tpu_torch.node.app import GENESIS_PREV_HASH, Node
    from upow_tpu_torch.node.http import fetch
    from upow_tpu_torch.wallet import KeyStore, cli, nodeless

    difficulty.START_DIFFICULTY = Decimal("1.0")
    clock.freeze(int(time.time()) - 6000)
    work = tempfile.mkdtemp()
    os.chdir(work)
    d, pub = curve.keygen(rng=11)
    addr = point_to_string(pub)
    with open("key_pair_list.json", "w") as fh:
        json.dump({"keys": [{"private_key": d, "public_key": addr}]}, fh)

    async def main():
        nodes = [Node(Config.load(
            node__db_path=os.path.join(work, "n%d.db" % i),
            node__ip_config_file="", node__seed_url="",
            node__peers_file="", node__rate_limits_enabled=False,
            snapshot__dir=os.path.join(work, "snap%d" % i),
            snapshot__chunk_bytes=512, device__utxo_index=True),
            device="cpu") for i in range(2)]
        try:
            urls = []
            for node in nodes:
                server = await node.serve("127.0.0.1", 0)
                urls.append("http://127.0.0.1:%d" % server.port)
            manager = nodes[0].manager
            for _ in range(3):
                clock.advance(60)
                diff, last = await manager.calculate_difficulty()
                prev = last["hash"] if last else GENESIS_PREV_HASH
                h = BlockHeader(previous_hash=prev, address=addr,
                                merkle_root=merkle_root([]),
                                timestamp=clock.timestamp(),
                                difficulty_x10=int(diff * 10), nonce=0)
                while last and not difficulty.check_pow(h.hex(), prev, diff):
                    h.nonce += 1
                assert await manager.create_block(h.hex(), [])
            dest = point_to_string(curve.keygen(rng=12)[1])
            status, body = await fetch(
                urls[0] + "/send_to_address?" + urlencode(
                    {"to_address": dest, "amount": "1.5"}),
                headers={"Authorization": addr})
            assert json.loads(body)["result"] == \
                "Transaction has been accepted", body
            w = nodeless.NodelessWallet(urls[0])
            assert (await w.get_balance(addr))[0] == Decimal(18)
            await w.send(d, dest, "0.5")
            rc = await cli.amain(["balance", "--db",
                                  os.path.join(work, "n0.db"), "--node", ""])
            assert rc == 0 and KeyStore().addresses() == [addr]
            manifest = await nodes[0].build_snapshot()
            status, body = await fetch(urls[0] + "/snapshot/chunk/0")
            assert json.loads(body)["result"]["i"] == 0, body
            res = await nodes[1].bootstrap_from_snapshot(sources=[urls[0]])
            assert res["method"] == "snapshot", res
            assert res["chunks"] == len(manifest["chunks"]) > 1, res
            assert nodes[1].state.index_stats()["entries"] == 3
            for node in nodes:
                assert (await node.state.get_unspent_outputs_hash()
                        == manifest["utxo_fingerprint"])
        finally:
            for node in nodes:
                await node.close()
    asyncio.run(main())
    print("wallet and snapshot served")


for name in sys.argv[1:]:
    if name == "--serve":
        serve()
    elif name == "--wallet-snapshot":
        wallet_snapshot()
    elif name == "--sync":
        sync()
    elif name == "--pg":
        pg()
    else:
        importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def _port_modules():
    names = [upow_tpu_torch.__name__]
    for info in pkgutil.walk_packages(upow_tpu_torch.__path__,
                                      upow_tpu_torch.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    names = _port_modules()
    # the slice's modules are all there
    for must in ("core.tx", "crypto.fp", "crypto.p256", "verify.block",
                 "verify.dispatch", "verify.txverify", "state.storage",
                 "state.views", "trace", "device", "_build",
                 "crypto.sha256", "config", "parallel.multihost",
                 "mine.engine", "mine.miner", "mempool", "mempool.pool",
                 "mempool.intake", "mempool.template", "node.app",
                 "node.http", "node.peers", "node.ratelimit",
                 "node.ipfilter", "node.run", "state.device_index",
                 "parallel.mesh", "mine.mesh_engine", "resilience",
                 "resilience.policy", "resilience.breaker",
                 "resilience.faultinject", "resilience.degrade",
                 "device.runtime", "native", "logger", "telemetry",
                 "telemetry.scope", "telemetry.metrics",
                 "telemetry.tracing", "telemetry.events",
                 "telemetry.exposition", "telemetry.slo",
                 "telemetry.device", "telemetry.selfcheck", "profiling",
                 "state.hotcache", "ws", "ws.hub", "watchtower",
                 "watchtower.alerts", "watchtower.burnrate",
                 "watchtower.detectors", "watchtower.engine",
                 "watchtower.benchlog", "watchtower.__main__", "state.pg",
                 "state.pgdriver", "state.reindex", "wallet",
                 "wallet.keystore", "wallet.builders", "wallet.nodeless",
                 "wallet.cli", "snapshot", "snapshot.layout",
                 "snapshot.builder", "snapshot.client"):
        assert "upow_tpu_torch." + must in names, must
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, *names, "chip_smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(names) + 1}" in out.stdout


def test_port_node_serves_without_jax_or_aiohttp():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, "--serve"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served" in out.stdout


def test_port_node_syncs_without_jax_or_aiohttp():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, "--sync"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "synced" in out.stdout


def test_port_node_serves_on_pg_without_jax_or_aiohttp():
    """The port's node on its PostgreSQL backend (the mock driver, the
    resident index armed on the CPU): a block accepted, one pushed, a
    read and the replay check."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, "--pg"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "pg served" in out.stdout


def test_port_wallet_and_snapshot_without_jax_or_aiohttp():
    """The port's wallet and snapshots under the blocker: a
    ``/send_to_address`` from the keystore in the working directory, a
    nodeless send, the CLI's balance, then a snapshot built on one node
    and restored into a second over HTTP, its index re-armed on the
    CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKER, "--wallet-snapshot"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "wallet and snapshot served" in out.stdout


def test_port_sources_name_no_jax_import():
    """No ``import jax`` / ``from upow_tpu`` line anywhere in the port."""
    bad = []
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "upow_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        for line in open(path, encoding="utf-8"):
            s = line.strip()
            if s.startswith(("import jax", "from jax", "from upow_tpu ",
                             "from upow_tpu.", "import upow_tpu ",
                             "import upow_tpu.", "import aiohttp",
                             "from aiohttp")):
                bad.append((path, s))
    assert len(sources) > 20 and not bad, bad
