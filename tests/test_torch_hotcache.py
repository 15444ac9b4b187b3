"""The port's hot read cache against the JAX package's.

Unit cases drive each package's ``HotStateCache`` (and each ``WsHub``
for the one-encode broadcast) with the same calls: the generation bump,
the LRU byte cap, the oversized entry, the single-flight of 32
concurrent misses.  Node cases open a JAX node (aiohttp ``TestServer``)
and the port's node (``device="cpu"``) on copies of one JAX-written
chain, both with the cache at its defaults, and send each request to
both: every body must be byte-equal, and each node's own hit, miss and
bump counters must move alike.  The cases: a hit, a block accept's
invalidation and the ``X-Upow-Cache-Bypass`` header; an admitted tx's
invalidation of the pending reads; accept, a reorg by
``remove_blocks`` on the state and a re-accept, each stage read cached
twice and bypassed once; a pending tx written behind both nodes' backs
(a foreign write) with ``revalidate_interval = 0``; the pagination
parameters' 400s and clamps; ``/debug/cache`` and the ``hotcache_*``
families of ``/metrics``.
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
import upow_tpu.state.hotcache as jhotcache
import upow_tpu.ws.hub as jhub
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.mine.engine as tengine
import upow_tpu_torch.mine.miner as tminer
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.state.hotcache as thotcache
import upow_tpu_torch.ws.hub as thub
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_node import _build_chain, _configs
from upow_tpu.core.tx import tx_from_hex as jtx_from_hex
from upow_tpu_torch.telemetry import exposition

BYPASS = {"X-Upow-Cache-Bypass": "1"}

#: (HotStateCache, CacheConfig, hub module) of each package
PACKAGES = {"jax": (jhotcache.HotStateCache, jconfig.CacheConfig, jhub),
            "port": (thotcache.HotStateCache, tconfig.CacheConfig, thub)}


# ----------------------------------------------------------------- unit ----

def _cache(pkg, **kw):
    cache_cls, cfg_cls, _hub = PACKAGES[pkg]
    kw.setdefault("revalidate_interval", -1.0)  # sole writer
    return cache_cls(state=None, config=cfg_cls(**kw))


async def _bump_invalidates(pkg):
    cache = _cache(pkg)
    calls = {"n": 0}

    async def produce():
        calls["n"] += 1
        return b'{"ok": true}'

    out = []
    for _ in range(2):
        out.append(await cache.get_bytes("supply", (), produce))
    out.append((calls["n"], cache.hits, cache.misses))
    cache.bump("block")
    out.append(await cache.get_bytes("supply", (), produce))
    out.append((calls["n"], cache.hits, cache.misses))
    await cache.get_bytes("supply", (), produce)
    out.append((calls["n"], cache.hits, cache.stats()["bumps"]))
    assert out[2] == (1, 1, 1) and out[4] == (2, 1, 2) and out[5] == (2, 2, 1)
    return out


async def _lru_byte_cap(pkg):
    cache = _cache(pkg, class_caps="blocks=100")

    async def produce():
        return b"x" * 60

    await cache.get_bytes("blocks", ("a",), produce)
    await cache.get_bytes("blocks", ("b",), produce)  # 120 > 100
    stats = cache.stats()
    assert stats["evictions"] == 1
    assert stats["classes"]["blocks"] == {"entries": 1, "bytes": 60,
                                          "cap_bytes": 100}
    await cache.get_bytes("blocks", ("b",), produce)  # the newest survived
    assert cache.hits == 1
    stats = cache.stats()
    stats.pop("generation_age_seconds")
    return stats


async def _oversized_entry(pkg):
    cache = _cache(pkg, max_entry_bytes=32)
    calls = {"n": 0}

    async def produce():
        calls["n"] += 1
        return b"y" * 64

    for _ in range(2):
        await cache.get_bytes("blocks", ("big",), produce)
    assert calls["n"] == 2  # never stored: a giant page must not flush
    assert cache.stats()["classes"]["blocks"]["bytes"] == 0
    return calls["n"]


async def _singleflight(pkg):
    cache = _cache(pkg)
    gate = asyncio.Event()
    calls = {"n": 0}

    async def produce():
        calls["n"] += 1
        await gate.wait()
        return b'{"slow": 1}'

    tasks = [asyncio.ensure_future(
        cache.get_bytes("address", ("hot",), produce)) for _ in range(32)]
    await asyncio.sleep(0)  # all 32 reach the flight table
    gate.set()
    bodies = await asyncio.gather(*tasks)
    assert calls["n"] == 1 and set(bodies) == {b'{"slow": 1}'}
    assert cache.singleflight_coalesced == 31 and cache.misses == 32
    return calls["n"], cache.singleflight_coalesced, cache.misses


async def _encode_once(pkg, monkeypatch):
    hub_mod = PACKAGES[pkg][2]
    hub = hub_mod.WsHub()

    class Sink:
        def __init__(self):
            self.frames = []

        async def send_str(self, payload):
            self.frames.append(payload)

    sinks = [Sink(), Sink()]
    for sink in sinks:
        hub.connect_local(sink, channels=("block",))
    real, counts = hub_mod._encode, {"n": 0}

    def counting(obj, *a, **kw):
        counts["n"] += 1
        return real(obj, *a, **kw)

    monkeypatch.setattr(hub_mod, "_encode", counting)
    sent = await hub.broadcast_to_channel(
        "block", {"type": "new_block", "data": {"id": 7}})
    for _ in range(100):  # the writers drain asynchronously
        if all(s.frames for s in sinks):
            break
        await asyncio.sleep(0.01)
    hub.close()
    assert sent == 2 and counts["n"] == 1  # one encode, two subscribers
    assert sinks[0].frames == sinks[1].frames
    assert json.loads(sinks[0].frames[0])["data"] == {"id": 7}
    return sinks[0].frames


UNIT = {"bump_invalidates_exactly": _bump_invalidates,
        "lru_byte_cap_evicts_oldest": _lru_byte_cap,
        "oversized_entry_never_stored": _oversized_entry,
        "singleflight_coalesces_32_concurrent_misses": _singleflight,
        "ws_broadcast_encodes_once": _encode_once}


@pytest.mark.parametrize("case", list(UNIT))
def test_unit_cases_match_jax(case, monkeypatch):
    got = {}
    for pkg in PACKAGES:
        fn = UNIT[case]
        args = (pkg, monkeypatch) if case == "ws_broadcast_encodes_once" \
            else (pkg,)
        got[pkg] = asyncio.run(fn(*args))
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------- nodes ----

@pytest.fixture(scope="module")
def chain_file(tmp_path_factory):
    """A JAX-written chain (test_torch_node's fan-out) and its leaves."""
    path = tmp_path_factory.mktemp("hotcache") / "chain.db"
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (JAX, PORT):
            mp.setattr(pkg.difficulty, "START_DIFFICULTY", Decimal("1.0"))
            pkg.clock.freeze(T0)
        try:
            leaves = _build_chain(path)
        finally:
            for pkg in (JAX, PORT):
                pkg.clock.reset()
                pkg.clear()
    return path, leaves


@pytest.fixture
def nodes(tmp_path, chain_file, monkeypatch):
    """(JAX config, port config, leaves) on copies of the chain, both
    clocks frozen after it and difficulty 1.0."""
    path, leaves = chain_file
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(path, tmp_path / f"{name}.db")
    jcfg, tcfg = _configs(tmp_path, "")
    yield jcfg, tcfg, leaves
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()


class Both:
    """A JAX node and the port's node serving, and one client for both."""

    def __init__(self, jcfg, tcfg):
        self.jnode = japp.Node(jcfg)
        self.tnode = tapp.Node(tcfg, device="cpu")
        for node in (self.jnode, self.tnode):
            node.started = True  # no first-request bootstrap
        self.chain = Chain(PORT, self.tnode.state)

    async def __aenter__(self):
        self.server = TestServer(self.jnode.app)
        await self.server.start_server()
        tserver = await self.tnode.serve("127.0.0.1", 0)
        self.urls = {"jax": f"http://127.0.0.1:{self.server.port}",
                     "port": f"http://127.0.0.1:{tserver.port}"}
        self.session = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.session.close()
        await self.server.close()
        await self.jnode.close()
        await self.tnode.close()

    @property
    def caches(self):
        return {"jax": self.jnode.hotcache, "port": self.tnode.hotcache}

    async def one(self, name, path, params=None, bypass=False,
                  method="GET", payload=None):
        async with self.session.request(
                method, self.urls[name] + path, params=params or {},
                json=payload, headers=BYPASS if bypass else {}) as r:
            return r.status, await r.read()

    async def both(self, path, params=None, bypass=False, method="GET",
                   payload=None):
        """(status, body), asserted equal on both nodes."""
        got = [await self.one(n, path, params, bypass, method, payload)
               for n in ("jax", "port")]
        assert got[1] == got[0], (path, params, bypass)
        return got[1]

    def counts(self, *names):
        out = {n: tuple(getattr(c, k) for k in names)
               for n, c in self.caches.items()}
        assert out["port"] == out["jax"], (names, out)
        return out["port"]

    async def push_block(self):
        """Mine the template both nodes serve and push it to both."""
        for pkg in (JAX, PORT):
            pkg.clock.advance(60)
        _s, raw = await self.both("/get_mining_info")
        job, hashes, block_no = tminer.build_job(json.loads(raw)["result"],
                                                 self.chain.addr)
        mined = tengine.mine(job, "torch", batch=1 << 12)
        _s, raw = await self.both("/push_block", method="POST", payload={
            "block_content": job.block_content(mined.nonce), "txs": hashes,
            "block_no": block_no})
        assert json.loads(raw) == {"ok": True}


def test_node_cache_hit_block_invalidation_and_bypass(nodes):
    jcfg, tcfg, _leaves = nodes

    async def main():
        async with Both(jcfg, tcfg) as b:
            await b.push_block()
            _s, body1 = await b.both("/get_supply_info")
            hits0 = b.counts("hits")[0]
            _s, body2 = await b.both("/get_supply_info")
            assert body2 == body1 and b.counts("hits")[0] == hits0 + 1
            # the bypass: computed fresh, byte-equal, no hit
            _s, body3 = await b.both("/get_supply_info", bypass=True)
            assert body3 == body1 and b.counts("hits")[0] == hits0 + 1
            # an accept invalidates: the next read is a new body
            await b.push_block()
            misses0 = b.counts("misses")[0]
            _s, body4 = await b.both("/get_supply_info")
            assert body4 != body1 and b.counts("misses")[0] == misses0 + 1

    asyncio.run(main())


def test_admission_invalidates_pending_reads(nodes):
    """With foreign revalidation off (a sole writer), only the node's own
    bumps invalidate: an admitted tx must reach the cached pending list
    and the address view at once."""
    jcfg, tcfg, leaves = nodes
    for cfg in (jcfg, tcfg):
        cfg.cache.revalidate_interval = -1.0

    async def main():
        async with Both(jcfg, tcfg) as b:
            params = {"address": b.chain.addr, "show_pending": "true"}
            _s, pending0 = await b.both("/get_pending_transactions")
            _s, view0 = await b.both("/get_address_info", params)
            tx = b.chain.spend([leaves[1]])
            _s, raw = await b.both("/push_tx", method="POST",
                                   payload={"tx_hex": tx.hex()})
            assert json.loads(raw)["ok"]
            _s, pending1 = await b.both("/get_pending_transactions")
            _s, view1 = await b.both("/get_address_info", params)
            assert tx.hex().encode() in pending1 and pending1 != pending0
            assert view1 != view0
            b.counts("bumps", "hits", "misses")

    asyncio.run(main())


def test_reorg_differential_byte_identical(nodes):
    """Cached and bypassed bodies match at every stage of accept, a
    reorg through ``remove_blocks`` on the state (the storage hook) and
    a re-accept, on both nodes alike."""
    jcfg, tcfg, _leaves = nodes

    async def stage(b, addr):
        bodies = {}
        for path, params in (
                ("/get_supply_info", {}),
                ("/get_address_info", {"address": addr,
                                       "show_pending": "true",
                                       "verify": "true"}),
                ("/get_blocks_details", {"offset": "0", "limit": "10"}),
                ("/get_pending_transactions", {})):
            s1, cached1 = await b.both(path, params)
            s2, cached2 = await b.both(path, params)
            s3, fresh = await b.both(path, params, bypass=True)
            assert s1 == s2 == s3 == 200, path
            assert cached1 == cached2 == fresh, path
            bodies[path] = cached1
        return bodies

    async def main():
        async with Both(jcfg, tcfg) as b:
            addr = b.chain.addr
            for _ in range(2):
                await b.push_block()
            before = await stage(b, addr)
            for node in (b.jnode, b.tnode):
                last = await node.state.get_last_block()
                await node.state.remove_blocks(last["id"])
            after = await stage(b, addr)
            assert after["/get_supply_info"] != before["/get_supply_info"]
            await b.push_block()
            await stage(b, addr)
            b.counts("bumps", "hits", "misses")

    asyncio.run(main())


def test_multiworker_foreign_write_forces_miss(nodes):
    """``revalidate_interval = 0``: every read re-anchors on the tip and
    the journal stamp, so a pending tx written straight into each state
    (another worker's write, no local bump) forces a miss."""
    jcfg, tcfg, leaves = nodes

    async def main():
        async with Both(jcfg, tcfg) as b:
            for _ in range(2):
                await b.push_block()
            for cache in b.caches.values():
                cache.config.revalidate_interval = 0.0
            _s, body1 = await b.both("/get_pending_transactions")
            hits0 = b.counts("hits")[0]
            await b.both("/get_pending_transactions")
            assert b.counts("hits")[0] == hits0 + 1
            tx = b.chain.spend([leaves[0]])
            await b.tnode.state.add_pending_transaction(tx)
            await b.jnode.state.add_pending_transaction(
                jtx_from_hex(tx.hex(), check_signatures=False))
            foreign0, misses0 = b.counts("foreign_bumps", "misses")
            _s, body2 = await b.both("/get_pending_transactions")
            assert b.counts("foreign_bumps", "misses") == (foreign0 + 1,
                                                           misses0 + 1)
            assert body2 != body1 and tx.hex().encode() in body2

    asyncio.run(main())


def test_pagination_hardening(nodes):
    jcfg, tcfg, _leaves = nodes

    async def main():
        async with Both(jcfg, tcfg) as b:
            await b.push_block()
            addr = b.chain.addr
            for path, params in (
                    ("/get_blocks", {"limit": "abc"}),
                    ("/get_blocks", {"offset": "1e3"}),
                    ("/get_blocks_details", {"offset": "abc"}),
                    ("/get_address_transactions",
                     {"address": addr, "page": "zz"}),
                    ("/get_address_transactions",
                     {"address": addr, "limit": "0x10"})):
                status, body = await b.both(path, params)
                assert status == 400 and json.loads(body)["ok"] is False
            for path, params in (
                    ("/get_blocks", {"offset": "-5", "limit": "99999999"}),
                    ("/get_blocks_details", {"offset": str(2 ** 80)}),
                    ("/get_address_transactions",
                     {"address": addr, "page": "-2",
                      "limit": str(2 ** 70)})):
                status, body = await b.both(path, params)
                assert status == 200 and json.loads(body)["ok"] is True

    asyncio.run(main())


def test_debug_cache_endpoint_and_families(nodes):
    jcfg, tcfg, _leaves = nodes

    async def main():
        async with Both(jcfg, tcfg) as b:
            await b.push_block()
            for _ in range(2):
                await b.both("/get_supply_info")
            got, scrapes = {}, {}
            for name in ("jax", "port"):
                status, body = await b.one(name, "/debug/cache")
                assert status == 200
                got[name] = json.loads(body)["result"]
                status, body = await b.one(name, "/metrics")
                scrapes[name] = exposition.samples(body.decode())
            return got, scrapes

    got, scrapes = asyncio.run(main())
    for stats in got.values():
        stats.pop("generation_age_seconds")
    assert got["port"] == got["jax"]
    stats = got["port"]
    assert stats["enabled"] is True and stats["hits"] >= 1
    assert stats["misses"] >= 1 and stats["generation"] >= 1
    assert stats["classes"]["supply"]["bytes"] > 0
    fams = {n: {k: v for k, v in s.items() if k.startswith("upow_hotcache_")
                and "age_seconds" not in k} for n, s in scrapes.items()}
    assert fams["port"] == fams["jax"]
    assert fams["port"]["upow_hotcache_hits_total"] == stats["hits"]
    assert "upow_hotcache_generation" in fams["port"]
