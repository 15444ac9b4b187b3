"""The port's swarm base (``upow_tpu_torch.swarm``: links, the loopback
transport, the harness) against the JAX package's.

JAX ``tests/test_swarm.py``'s link, peer-ranking and transport cases run
on the port's swarm: the link matrix's partitions, isolation, per-link
seeded drops and the ``swarm.link`` fault site; the peer book's health
ranking; a driver request through a port node's whole middleware and a
peer RPC whose partition failure reaches the caller's breaker and
``/debug/breakers``.  Besides: the port's matrix draws the JAX matrix's
drops and jitters for the same seed and links, the port's
``LoopbackInterface`` overrides only the ``_fetch`` attempt seam of the
port's ``NodeInterface``, the hub hands each request its caller's
simulated IP (a node's IP filter refuses a blocklisted peer), and,
on both packages' swarms with equal outcomes: the flight recorder's
trigger precedence and its frames over a swarm, the scenario helpers'
verdict and fingerprint, the eclipse and spam adversaries, and
``/ws`` subscribers that stall, resume and are cut by a partition.  A
3-node port swarm, in a subprocess with
CUDA's initialisation made to raise, carries a mined block to every node
under one trace id across the gossip hops.
"""

import asyncio
import functools
import os
import random
import subprocess
import sys
from decimal import Decimal
from types import SimpleNamespace

import pytest

import upow_tpu.fleet.recorder as jrecorder
import upow_tpu.swarm as jswarm
import upow_tpu.swarm.adversary  # noqa: F401
import upow_tpu.swarm.links as jlinks
import upow_tpu_torch.fleet.recorder as trecorder
import upow_tpu_torch.swarm as tswarm
import upow_tpu_torch.swarm.adversary  # noqa: F401
from upow_tpu_torch.config import NodeConfig
from upow_tpu_torch.node.peers import NodeInterface, PeerBook
from upow_tpu_torch.resilience import faultinject
from upow_tpu_torch.resilience.faultinject import FaultInjected
from upow_tpu_torch.swarm import (LinkDown, LinkMatrix, LinkPolicy,
                                  LoopbackInterface, Swarm)
from upow_tpu_torch.swarm.scenarios import deterministic_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A, B, C = "http://10.0.0.1:1", "http://10.0.0.2:1", "http://10.0.0.3:1"


def _matrix(seed=0, module=None, **kw):
    m = (module.LinkMatrix if module else LinkMatrix)(seed, **kw)
    for url in (A, B, C):
        m.register(url)
    return m


# ------------------------------------------------------------- links ----

def test_partition_blocks_cross_traffic_and_heals():
    async def main():
        m = _matrix()
        await m.transfer(A, B)
        m.partition([[A], [B, C]])
        with pytest.raises(LinkDown) as e:
            await m.transfer(A, B)
        assert e.value.reason == "partitioned"
        await m.transfer(B, C)
        # unlisted endpoints (the driver) always bypass shaping, and are
        # not counted
        await m.transfer("http://driver.local", A)
        m.heal()
        await m.transfer(A, B)
        assert m.stats()["blocked"] == 1
        assert m.stats()["delivered"] == 3

    asyncio.run(main())


def test_isolation_cuts_every_link_of_one_url():
    async def main():
        m = _matrix()
        m.isolate(A)
        for src, dst in ((A, B), (B, A), (C, A)):
            with pytest.raises(LinkDown):
                await m.transfer(src, dst)
        await m.transfer(B, C)
        m.restore(A)
        await m.transfer(A, B)

    asyncio.run(main())


def test_drop_draws_are_per_link_and_seed_deterministic():
    async def outcomes(seed):
        m = _matrix(seed, default=LinkPolicy(drop=0.5))
        out = []
        for _ in range(20):
            try:
                await m.transfer(A, B)
                out.append(1)
            except LinkDown:
                out.append(0)
        return out

    async def main():
        first = await outcomes(123)
        assert first == await outcomes(123)
        assert first != await outcomes(321)
        assert 0 < sum(first) < 20

    asyncio.run(main())


def test_swarm_link_fault_site_fires():
    async def main():
        m = _matrix()
        faultinject.install("swarm.link:error:key=10.0.0.2", seed=1)
        try:
            with pytest.raises(FaultInjected):
                await m.transfer(A, B)
            await m.transfer(C, A)
        finally:
            faultinject.uninstall()

    asyncio.run(main())


@pytest.mark.parametrize("seed", [0, 123, 2 ** 40 + 7])
def test_drop_and_jitter_draws_equal_the_jax_matrix(seed, monkeypatch):
    """Both matrices, the same seed, policies and call sequence over six
    ordered links: the same drops, the same jitter delays and the same
    counters."""
    links = [(s, d) for s in (A, B, C) for d in (A, B, C) if s != d]

    async def outcomes(module):
        delays = []

        async def sleep(delay):
            delays.append(delay)
        monkeypatch.setattr(module.asyncio, "sleep", sleep)
        m = _matrix(seed, module=module,
                    default=module.LinkPolicy(drop=0.3, jitter=0.01))
        m.set_link(A, C, module.LinkPolicy(latency=0.002, drop=0.6),
                   symmetric=False)
        out = []
        for k in range(60):
            src, dst = links[(k * 5) % len(links)]
            try:
                await m.transfer(src, dst)
                out.append((src, dst, "ok", delays[-1] if delays else None))
            except module.LinkDown as e:
                out.append((src, dst, e.reason, None))
        return out, m.stats(), m.per_link

    port = asyncio.run(outcomes(sys.modules[LinkMatrix.__module__]))
    jax = asyncio.run(outcomes(jlinks))
    assert port == jax
    assert {o[2] for o in port[0]} == {"ok", "dropped"}


# ------------------------------------------------- peer health ranking ----

def _book(**kw):
    cfg = NodeConfig()
    cfg.peers_file = ""
    cfg.seed_url = ""
    return PeerBook(cfg, **kw)


def test_ranked_orders_by_state_then_score_then_url():
    book = _book()
    urls = ["http://b:1", "http://a:1", "http://d:1", "http://c:1"]
    for u in urls:
        book.add(u)
    book.breakers.record_failure("http://c:1")          # score 0.7
    for _ in range(5):
        book.breakers.record_failure("http://d:1")      # tripped open
    assert book.ranked(urls) == [
        "http://a:1", "http://b:1", "http://c:1", "http://d:1"]


def test_propagate_nodes_is_health_ranked():
    book = _book(rng=random.Random(4))
    urls = [f"http://peer{i}:1" for i in range(8)]
    for u in urls:
        book.add(u)
    book.breakers.record_failure("http://peer0:1")
    book.breakers.record_failure("http://peer0:1")
    for _ in range(5):
        book.breakers.record_failure("http://peer5:1")
    picks = book.propagate_nodes()
    assert picks, "unseen peers must still be gossiped to"
    assert picks == book.ranked(picks)
    assert "http://peer5:1" not in picks
    assert picks[-1] == "http://peer0:1"


# ---------------------------------------------------------- transport ----

def test_loopback_interface_overrides_only_the_attempt_seam():
    """The breaker gate, fault site, retries and headers are inherited."""
    own = {k for k, v in vars(LoopbackInterface).items()
           if callable(v) and not k.startswith("__")}
    assert own == {"_fetch"}
    for name in ("request", "get", "_resilient", "_rpc_headers"):
        assert getattr(LoopbackInterface, name) is \
            getattr(NodeInterface, name)


def test_loopback_dispatch_real_middleware():
    async def main():
        swarm = Swarm(2, seed=0, device="cpu")
        await swarm.start()
        try:
            res = await swarm.get(0, "/")
            assert res["ok"] and "unspent_outputs_hash" in res
            res = await swarm.get(0, "get_nodes")
            assert swarm.urls[1] in res["result"]
            swarm.matrix.partition([[swarm.urls[0]], [swarm.urls[1]]])
            iface = swarm.nodes[0].iface_factory(
                swarm.urls[1], swarm.nodes[0].config.node,
                resilience=swarm.nodes[0].resilience)
            with pytest.raises(ConnectionError):
                await iface.get("get_nodes")
            snap = swarm.nodes[0].breakers.snapshot()
            assert snap[swarm.urls[1]]["consecutive_failures"] > 0
        finally:
            await swarm.close()

    with deterministic_world(0):
        asyncio.run(main())


def test_debug_breakers_endpoint():
    async def main():
        swarm = Swarm(2, seed=0, device="cpu")
        await swarm.start()
        try:
            swarm.matrix.partition([[swarm.urls[0]], [swarm.urls[1]]])
            iface = swarm.nodes[0].iface_factory(
                swarm.urls[1], swarm.nodes[0].config.node,
                resilience=swarm.nodes[0].resilience)
            with pytest.raises(ConnectionError):
                await iface.get("get_nodes")
            res = await swarm.get(0, "debug/breakers")
            assert res["ok"]
            peers = res["result"]["peers"]
            assert peers[swarm.urls[1]]["consecutive_failures"] > 0
            assert set(peers[swarm.urls[1]]) == {
                "state", "score", "consecutive_failures", "flips"}
            assert "closed" in res["result"]["state_counts"]
        finally:
            await swarm.close()

    with deterministic_world(0):
        asyncio.run(main())


def test_transport_carries_the_callers_ip():
    """The hub hands each request its caller's simulated IP: with node
    1's IP on node 0's blocklist, node 1's RPC is refused by node 0's IP
    filter and the driver's (127.0.0.1) is served."""
    async def main():
        swarm = await Swarm(2, seed=0, device="cpu").start()
        try:
            swarm.nodes[0].ip_filter.blocklist = {swarm.ips[1]}
            iface = swarm.nodes[1].iface_factory(
                swarm.urls[0], swarm.nodes[1].config.node,
                resilience=swarm.nodes[1].resilience)
            peer = await iface.get("get_nodes")
            driver = await swarm.get(0, "get_nodes")
            return peer, driver, swarm.urls[1]
        finally:
            await swarm.close()

    with deterministic_world(0):
        peer, driver, url1 = asyncio.run(main())
    assert peer == {"ok": False, "error": "Access forbidden."}
    assert driver["ok"] and url1 in driver["result"]


# ------------------------------------- both packages' swarms, one case ----

def _swarm_pkg(swarm, harness, transport, adversary, scenarios, recorder,
               **swarm_kw):
    return SimpleNamespace(
        Swarm=functools.partial(harness.Swarm, **swarm_kw), LoopbackWsClient=transport.LoopbackWsClient,
        EclipseAdversary=adversary.EclipseAdversary,
        SpamAdversary=adversary.SpamAdversary, LinkDown=swarm.LinkDown,
        world=scenarios.deterministic_world, wallet=scenarios._wallet,
        core_ok=scenarios.core_ok,
        artifact_fingerprint=scenarios.artifact_fingerprint,
        recorder=recorder)


SWARMS = {
    "jax": _swarm_pkg(jswarm, jswarm.harness, jswarm.transport,
                      jswarm.adversary, jswarm.scenarios, jrecorder),
    "port": _swarm_pkg(tswarm, tswarm.harness, tswarm.transport,
                       tswarm.adversary, tswarm.scenarios, trecorder,
                       device="cpu"),
}


def _both(run):
    """``run(P)`` once on each package's swarm; the two results."""
    return {name: run(P) for name, P in SWARMS.items()}


@pytest.mark.parametrize("pkg", list(SWARMS))
def test_trigger_reason_precedence(pkg):
    recorder = SWARMS[pkg].recorder
    fault = [{"kind": "fault_injected", "site": "rpc"}]
    slow = {"swarm.x.node0": {"p99_ms": 900.0}}
    assert recorder.trigger_reason(False, fault) == "core_assertion_failed"
    assert recorder.trigger_reason(True, fault) == "fault_injected"
    breach = recorder.trigger_reason(True, [], slo_rows=slow,
                                     p99_budget_ms=500.0)
    assert breach == "slo_breach:swarm.x.node0:p99_ms=900.0"
    assert recorder.trigger_reason(True, [], slo_rows=slow,
                                   p99_budget_ms=2000.0) is None


@pytest.mark.parametrize("core", [
    {},
    {"converged": True, "final_height": 3, "final_tip": "ab" * 32},
    {"converged": True, "split": False, "reward": Decimal("6.25"),
     "nested": {"b": [1, 2], "a": None}},
])
def test_core_ok_and_fingerprint_equal_the_jax_helpers(core):
    """The determinism contract: the same core gives both packages the
    same verdict and the same fingerprint."""
    jax, port = SWARMS["jax"], SWARMS["port"]
    assert port.core_ok(core) == jax.core_ok(core)
    assert port.core_ok(core) == (core.get("split") is not False)
    assert port.artifact_fingerprint(core) == \
        jax.artifact_fingerprint(core)


def test_flight_recorder_frames_over_a_swarm_equal_the_jax_recorder():
    """The harness's recorder marks a frame per node at each phase and
    dumps them: on both packages the same nodes, labels and frame keys,
    and the second frame holds the mined block's counter deltas."""
    def run(P):
        async def main():
            swarm = await P.Swarm(2, seed=3, reorg_window=4).start()
            try:
                _, addr = P.wallet(3, "shared")
                swarm.recorder.mark(swarm, label="start")
                assert (await swarm.mine(0, addr))["ok"]
                await swarm.settle()
                assert await swarm.wait_converged()
                swarm.recorder.mark(swarm, label="final")
                windows = {n.config.node.sync_reorg_window
                           for n in swarm.nodes}
                return swarm.recorder.dump("fault_injected"), windows
            finally:
                await swarm.close()

        with P.world(3):
            box, windows = asyncio.run(main())
        assert windows == {4}
        return (box["kind"], box["reason"], box["marks"],
                {node: [(f["label"], sorted(f)) for f in frames]
                 for node, frames in box["nodes"].items()},
                {node: bool(frames[-1]["counter_deltas"])
                 for node, frames in box["nodes"].items()})

    out = _both(run)
    assert out["port"] == out["jax"]
    kind, reason, marks, labels, deltas = out["port"]
    assert (kind, reason, marks) == ("flight_recorder", "fault_injected", 2)
    assert set(labels) == {"node0", "node1"}
    assert [lb for lb, _ in labels["node0"]] == ["start", "final"]
    assert deltas == {"node0": True, "node1": True}


def test_adversaries_lie_then_go_dark_and_spam_is_shaped():
    """The eclipse clique answers a node's RPCs with its own lies until
    unmasked, then every RPC fails as a dead peer; the spammer's garbage
    is refused by every node, and once its links are cut its pushes
    fail at the matrix.  The same counts on both packages."""
    def run(P):
        async def main():
            swarm = await P.Swarm(2, seed=5).start()
            try:
                eclipse = P.EclipseAdversary(swarm.hub, count=2)
                node = swarm.nodes[0]
                iface = node.iface_factory(eclipse.urls[0],
                                           node.config.node,
                                           resilience=node.resilience)
                nodes = (await iface.get("get_nodes"))["result"]
                page = (await iface.get("get_blocks",
                                        {"offset": 1, "limit": 10}))
                eclipse.unmask()
                with pytest.raises(ConnectionError):
                    await iface.get("get_nodes")
                spam = P.SpamAdversary(swarm.hub)
                await spam.flood_garbage(swarm.urls, 4)
                await spam.flood_duplicates(swarm.urls, "00" * 40, 2)
                swarm.matrix.isolate(spam.url)
                await spam.flood_garbage(swarm.urls, 2)
                return (nodes == eclipse.urls, page,
                        eclipse.calls_after_unmask > 0,
                        eclipse.calls - eclipse.calls_after_unmask,
                        (spam.sent, spam.accepted, spam.rejected),
                        swarm.matrix.stats()["blocked"])
            finally:
                await swarm.close()

        with P.world(5):
            return asyncio.run(main())

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"] == (True, {"ok": True, "result": []}, True, 2,
                           (8, 0, 8), 2)


def test_ws_client_stalls_resumes_and_is_cut_by_a_partition():
    """Three in-process subscribers of node 0's ``/ws`` hub with a queue
    of 4: a live one takes every block, a stalled one sheds the oldest
    and takes the rest on resume, and one routed over the swarm's links
    takes the blocks before its link is cut and none after.  The same
    counts on both packages."""
    def run(P):
        async def main():
            swarm = await P.Swarm(2, seed=7, ws=True,
                                  ws_queue_max=4).start()
            try:
                _, addr = P.wallet(7, "ws_miner")
                hub = swarm.nodes[0].ws_hub
                live, slow = P.LoopbackWsClient(), P.LoopbackWsClient()
                routed = P.LoopbackWsClient(swarm.matrix, swarm.urls[0],
                                            "http://10.99.0.3:1")
                for k, sink in enumerate((live, slow, routed)):
                    hub.connect_local(sink, ip=f"10.99.0.{k + 1}",
                                      channels=("block",))
                slow.stall()

                async def blocks(n):
                    for _ in range(n):
                        assert (await swarm.mine(
                            0, addr, push_to=list(range(swarm.n))))["ok"]
                        await swarm.settle()
                        await asyncio.sleep(0.005)

                async def until(cond):
                    for _ in range(200):
                        if cond():
                            return
                        await asyncio.sleep(0.01)

                await blocks(3)
                await until(lambda: len(routed.of_type("new_block")) >= 3)
                swarm.matrix.isolate("http://10.99.0.3:1")
                await blocks(5)
                await until(lambda: len(live.of_type("new_block")) >= 8)
                slow.resume()
                await until(lambda: hub.get_stats()["dropped_messages"]
                            >= 3 and len(slow.of_type("new_block")) >= 5)
                return (len(live.of_type("new_block")),
                        len(slow.of_type("new_block")),
                        hub.get_stats()["dropped_messages"],
                        len(routed.of_type("new_block")),
                        swarm.matrix.stats()["blocked"] > 0)
            finally:
                await swarm.close()

        with P.world(7):
            return asyncio.run(main())

    out = _both(run)
    assert out["port"] == out["jax"]
    live, slow, dropped, routed, cut = out["port"]
    # the stalled writer holds one frame and its queue four: 3 shed
    assert (live, slow, dropped, routed, cut) == (8, 5, 3, 3, True)


_PROPAGATE = r"""
import asyncio, sys
import torch


def refuse(*a, **k):
    raise AssertionError("a swarm node initialised CUDA")
torch.cuda._lazy_init = refuse
torch.cuda.init = refuse
from upow_tpu_torch import telemetry
from upow_tpu_torch.swarm import Swarm
from upow_tpu_torch.swarm.scenarios import _wallet, deterministic_world


def roots(node, tid):
    buf = node.telemetry_scope.traces.snapshot()["recent"]
    return [t["name"] for t in buf if t.get("trace_id") == tid]


async def main():
    swarm = await Swarm(3, seed=11, device="cpu").start()
    try:
        _, addr = _wallet(11, "shared")
        for _ in range(2):
            assert (await swarm.mine(0, addr))["ok"]
        await swarm.settle()
        with telemetry.request_trace("swarm.step") as root:
            assert (await swarm.mine(0, addr))["ok"]
        await swarm.settle()
        assert await swarm.wait_converged()
        tips = await swarm.tips()
        assert [t["id"] for t in tips] == [3, 3, 3], tips
        names = [roots(node, root.trace_id) for node in swarm.nodes]
        assert "http.push_block" in names[0], names
        for hop in names[1:]:
            assert "http.push_block" in hop, names
        print("hops", names)
    finally:
        await swarm.close()

with deterministic_world(11):
    asyncio.run(main())
assert not torch.cuda.is_initialized()
print("one trace, no cuda")
"""


def test_three_node_swarm_carries_a_block_under_one_trace(tmp_path):
    """A block mined on node 0 inside a driver trace reaches nodes 1 and
    2 by gossip; each node's ``http.push_block`` root carries the
    driver's trace id; no node initialises CUDA."""
    env = dict(os.environ, PYTHONPATH=ROOT, UPOW_NODE_SEED_URL="")
    out = subprocess.run([sys.executable, "-c", _PROPAGATE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("one trace, no cuda")
