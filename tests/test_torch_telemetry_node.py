"""The port's node telemetry against the JAX node's, over HTTP on the CPU.

A JAX node on an aiohttp ``TestServer`` and the port's node on its
standard-library server (``device="cpu"``), on copies of one JAX-written
chain with both packages' clocks frozen (``test_torch_node.py``'s set-up:
the hot read cache and ``/ws`` on, as by default, the watchtower off,
``device.sig_backend = "device"`` so every
signature batch goes through the device path: the port's plain version,
the JAX package's XLA program on the CPU), receive the same sequence:
``/``, three ``push_tx`` one at a time, ``get_mining_info``, a 404, a
422, and the block that mines the three txs, pushed by tx hashes.  Then:

* ``/`` bodies are equal in their keys, values and span names (the span
  durations apart), the counters that both packages count alike equal;
* the (family, type) sets of ``/metrics`` are equal apart from the
  names listed below with their reasons, both scrapes pass both
  validators, and ``lanes_real``, the runtime's submissions and
  dispatches, the verdict cache, the pipeline stages' items and the SLO
  request counts are equal;
* the ``/debug/traces`` trees have equal root and child names and
  nesting (the port's ``runtime.dispatch`` spans apart), and the
  ``/debug/events`` kinds are equal in order;
* ``X-Upow-Trace`` is adopted when well formed and replaced when not;
* a ``push_tx`` gossiped port -> JAX and one gossiped JAX -> port each
  keep one trace id on both nodes;
* the debug routes are gated by ``telemetry.debug_endpoints`` and
  ``profile.enabled`` alike, and the port's ``/debug/profile`` start,
  status and stop capture a trace on the CPU.
"""

import asyncio
import json
import re
import shutil
from decimal import Decimal

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu_torch.mine.engine as tengine
import upow_tpu_torch.mine.miner as tminer
import upow_tpu_torch.node.app as tapp
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_gossip import _has, _jcfg, _run, _tcfg, until
from test_torch_node import _build_chain, _configs
from upow_tpu import telemetry as jtelemetry
from upow_tpu.device import runtime as jruntime
from upow_tpu.verify import txverify as jtxverify
from upow_tpu_torch import telemetry as ttelemetry
from upow_tpu_torch.device import runtime as truntime
from upow_tpu_torch.verify import txverify as ttxverify

#: families only the port exports, each with its reason
PORT_ONLY = {
    # one a record_batch call: chip_smoke.py counts a node's launches by it
    r"upow_kernel_\w+_batches_total": "launch count a batch",
    # the Jacobian kernel's launches by window (a node's windows check)
    r"upow_kernel_p256_verify_w\d+_launches_total": "launches by window",
    # the kernel libraries in _build/ (the JAX gauge needs a compile
    # cache directory, off by default)
    r"upow_compile_cache_persistent_entries": "kernel libraries built",
    # the native host batch's library could not be built (no g++)
    r"upow_native_unavailable_total": "no g++",
    # the test mines its block in the node's process, and the port's
    # engine counts every backend's nonces (the miner's /metrics)
    r"upow_mine_hashes_total": "nonces the in-process engine searched",
    # ... and its rounds, beside them
    r"upow_mine_rounds_total": "rounds the in-process engine searched",
}

#: families only the JAX node exports: none.  The hotcache_*, ws_*,
#: alert_*, send_to_address, snapshot_* and archive_* families (the
#: archive routes' SLO series among them) are compared: both nodes
#: export them
JAX_ONLY = {}

#: counters both packages count alike
SAME_COUNTS = (
    "upow_kernel_p256_verify_lanes_real_total",
    "upow_runtime_submissions_total", "upow_runtime_dispatches_total",
    "upow_runtime_source_block_total", "upow_runtime_source_mempool_total",
    "upow_sig_cache_hits_total", "upow_sig_cache_misses_total",
    "upow_sig_cache_entries",
    "upow_pipeline_block_decode_items_total",
    "upow_pipeline_block_sig_wait_items_total",
    "upow_pipeline_front_submissions_total",
    "upow_pipeline_front_dispatches_total",
    "upow_mempool_intake_txs_total", "upow_mempool_intake_batches_total",
    "upow_block_height", "upow_mempool_transactions",
    "upow_mempool_pool_depth", "upow_device_verify_health",
    "upow_verify_canary_pass_total",
    # the archive tier is off on both nodes: its families read zero
    "upow_archive_segments", "upow_archive_archived_blocks",
    "upow_archive_archived_txs", "upow_archive_hot_rows_pruned_total",
    "upow_archive_fallthrough_reads_total",
)

#: spans only the port records (a runtime dispatch in its submitter's
#: trace, device/runtime.py)
PORT_ONLY_SPANS = {"runtime.dispatch"}


def _families(text: str) -> set:
    return {tuple(line.split()[2:4]) for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _listed(name: str, table: dict) -> bool:
    return any(re.fullmatch(p, name) for p in table)


def _tree(t: dict) -> tuple:
    """(name, error, children) of a trace, the port-only spans left out."""
    kids = tuple(_tree(c) for c in t.get("spans", ())
                 if c["name"] not in PORT_ONLY_SPANS)
    return t["name"], t.get("error"), kids


async def _get(session, url, headers=None):
    async with session.get(url, headers=headers,
                           allow_redirects=False) as r:
        return r.status, await r.read(), dict(r.headers)


async def _post(session, url, payload):
    async with session.post(url, json=payload) as r:
        return r.status, await r.read(), dict(r.headers)


@pytest.fixture(scope="module")
def differential(tmp_path_factory):
    """The request sequence on both nodes, and what they served after."""
    tmp = tmp_path_factory.mktemp("telemetry_node")
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (JAX, PORT):
            mp.setattr(pkg.difficulty, "START_DIFFICULTY", Decimal("1.0"))
            pkg.clock.freeze(T0)
        try:
            return _differential(tmp)
        finally:
            for pkg in (JAX, PORT):
                pkg.clock.reset()
                pkg.clear()


def _differential(tmp):
    leaves = _build_chain(tmp / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(tmp / "chain.db", tmp / f"{name}.db")
    # the chain's build filled the JAX verdict cache: both start empty,
    # and both runtimes armed before the event rings are read
    jtxverify.clear_sig_verdicts()
    ttxverify.clear_sig_verdicts()
    jruntime.get_runtime().arm()
    truntime.get_runtime("cpu").arm()
    jcfg, tcfg = _configs(tmp, "jac")
    for cfg in (jcfg, tcfg):
        cfg.device.sig_backend = "device"
        cfg.profile.enabled = True
        cfg.profile.trace_dir = str(tmp / f"{id(cfg)}.prof")
    jcfg.watchtower.enabled = False
    tcfg.log.path, tcfg.log.console = "", False
    for p in (jtelemetry, ttelemetry):
        p.reset()
        p.configure()
    out = {}

    async def main():
        jnode = japp.Node(jcfg)
        tnode = tapp.Node(tcfg, device="cpu")
        for node in (jnode, tnode):
            node.started = True  # no bootstrap from the test's Host
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        urls = {"jax": f"http://127.0.0.1:{server.port}",
                "port": f"http://127.0.0.1:{tserver.port}"}
        chain = Chain(PORT, tnode.state)
        txs = [chain.spend([leaf]) for leaf in leaves[:3]]
        try:
            async with aiohttp.ClientSession() as session:
                async def both(fn, path, *args, same_body=True):
                    got = {}
                    for name in ("jax", "port"):
                        got[name] = await fn(session, urls[name] + path,
                                             *args)
                    n = 2 if same_body else 1
                    assert got["jax"][:n] == got["port"][:n], path
                    return got

                out["root_before"] = await both(_get, "/", same_body=False)
                for tx in txs:
                    await both(_post, "/push_tx", {"tx_hex": tx.hex()})
                info = await both(_get, "/get_mining_info")
                await both(_get, "/nope")
                await both(_get, "/get_validators_info?offset=x")
                result = json.loads(info["port"][1])["result"]
                job, hashes, block_no = tminer.build_job(result, chain.addr)
                PORT.clock.advance(60)
                JAX.clock.advance(60)
                mined = tengine.mine(job, "native", batch=1 << 14)
                out["block"] = await both(_post, "/push_block", {
                    "block_content": job.block_content(mined.nonce),
                    "txs": hashes, "block_no": block_no})
                out["root"] = await both(_get, "/", same_body=False)
                # the header: adopted when well formed, else replaced
                for tid in ("0123456789abcdef" * 2, "NOT-a-trace-id"):
                    out[tid] = await both(_get, "/get_nodes",
                                          {"X-Upow-Trace": tid})
                out["metrics"] = await both(_get, "/metrics", same_body=False)
                out["traces"] = await both(_get, "/debug/traces", same_body=False)
                out["events"] = await both(_get, "/debug/events", same_body=False)
                out["profile"] = [await _get(session, urls["port"]
                                             + "/debug/profile?action="
                                             + action)
                                  for action in ("start", "status", "stop")]
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    asyncio.run(main())
    return out


def _body(got, name):
    return json.loads(got[name][1])


def test_push_block_accepted_by_both(differential):
    assert _body(differential["block"], "jax") == {"ok": True}
    assert _body(differential["block"], "port") == {"ok": True}


@pytest.mark.parametrize("when", ["root_before", "root"])
def test_root_body_is_the_jax_body(differential, when):
    jb, tb = (_body(differential[when], n) for n in ("jax", "port"))
    assert list(tb) == list(jb) == ["ok", "version", "unspent_outputs_hash",
                                    "timings", "counters"]
    assert {k: tb[k] for k in ("ok", "version", "unspent_outputs_hash")} \
        == {k: jb[k] for k in ("ok", "version", "unspent_outputs_hash")}
    assert sorted(tb["timings"]) == sorted(jb["timings"])
    for name, span in tb["timings"].items():
        assert set(span) == {"count", "total_s", "max_s"}, name
        assert span["count"] == jb["timings"][name]["count"], name
    for name in ("mempool.intake_txs", "runtime.dispatches",
                 "pipeline.front.dispatches", "kernel.p256_verify.lanes_real"):
        assert tb["counters"].get(name) == jb["counters"].get(name), name


def test_metrics_content_type_and_both_validators(differential):
    for name in ("jax", "port"):
        status, body, headers = differential["metrics"][name]
        assert status == 200
        assert headers["Content-Type"] == ttelemetry.exposition.CONTENT_TYPE
        text = body.decode()
        assert jtelemetry.exposition.validate(text) == []
        assert ttelemetry.exposition.validate(text) == []


def test_metrics_family_sets_match_apart_from_the_listed(differential):
    fams = {n: _families(differential["metrics"][n][1].decode())
            for n in ("jax", "port")}
    port_only = {f for f in fams["port"] - fams["jax"]
                 if not _listed(f[0], PORT_ONLY)}
    jax_only = {f for f in fams["jax"] - fams["port"]
                if not _listed(f[0], JAX_ONLY)}
    assert port_only == set() and jax_only == set()
    # each listed port-only family did appear (no stale entries)
    listed = {p for p in PORT_ONLY for f in fams["port"]
              if re.fullmatch(p, f[0])}
    # (the launches by window count CUDA launches only)
    assert r"upow_kernel_\w+_batches_total" in listed


@pytest.mark.parametrize("sample", SAME_COUNTS)
def test_counted_alike(differential, sample):
    got = {n: ttelemetry.exposition.samples(
        differential["metrics"][n][1].decode()) for n in ("jax", "port")}
    assert got["port"][sample] == got["jax"][sample], sample


def test_slo_request_counts_match(differential):
    got = {n: ttelemetry.exposition.samples(
        differential["metrics"][n][1].decode()) for n in ("jax", "port")}
    slo = {k: v for k, v in got["port"].items()
           if k.startswith("upow_slo_http_") and (
               k.endswith("_requests_total") or k.endswith("_errors_total"))}
    assert slo["upow_slo_http_push_tx_requests_total"] == 3
    assert slo["upow_slo_http_get_validators_info_requests_total"] == 1
    assert {k: got["jax"][k] for k in slo} == slo


def test_kernel_lanes_are_the_verified_checks(differential):
    got = ttelemetry.exposition.samples(
        differential["metrics"]["port"][1].decode())
    # three push_tx of one check each, each batch with the two canary
    # lanes and the hex-form retry of its one check; the block's three
    # checks answered by the verdict cache
    assert got["upow_kernel_p256_verify_lanes_real_total"] == 12
    assert got["upow_kernel_p256_verify_batches_total"] == 6
    assert got["upow_sig_cache_hits_total"] == 3


def test_trace_trees_match(differential):
    trees = {}
    for name in ("jax", "port"):
        recent = _body(differential["traces"], name)["result"]["recent"]
        trees[name] = [_tree(t) for t in recent]
    assert trees["port"] == trees["jax"]
    names = [t[0] for t in trees["port"]]
    assert names[:4] == ["http.root", "http.push_tx", "http.push_tx",
                         "http.push_tx"]
    errors = {t[0]: t[1] for t in trees["port"] if t[1]}
    assert errors == {"http.nope": "HTTPNotFound",
                      "http.get_validators_info": "_BadParam"}


def test_port_tree_splits_the_push_tx_wall(differential):
    recent = _body(differential["traces"], "port")["result"]["recent"]
    push = [t for t in recent if t["name"] == "http.push_tx"][0]

    def walk(t):
        yield t
        for c in t.get("spans", ()):
            yield from walk(c)
    spans = {s["name"]: s for s in walk(push)}
    assert {"intake.queue_wait", "mempool.intake_batch",
            "mempool.sig_dispatch", "intake.sig_dispatch",
            "runtime.dispatch", "push_tx.journal_write",
            "push_tx.effects"} <= set(spans)
    assert spans["runtime.dispatch"]["fields"]["source"] == "mempool"
    assert spans["runtime.dispatch"]["duration_ms"] <= \
        spans["mempool.sig_dispatch"]["duration_ms"]


def test_event_kinds_match_in_order(differential):
    # the tests' concurrency sanitizer (tests/conftest.py) writes its
    # sanitizer.* findings into the JAX package's ring, not the node
    kinds = {n: [e["kind"] for e in _body(differential["events"], n)[
        "result"] if not e["kind"].startswith("sanitizer.")]
        for n in ("jax", "port")}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"].count("tx_seen") == 3
    assert kinds["port"].count("block_seen") == 1


def test_trace_header_adopted_when_well_formed(differential):
    good = "0123456789abcdef" * 2
    for name in ("jax", "port"):
        assert differential[good][name][2]["X-Upow-Trace"] == good
        bad = differential["NOT-a-trace-id"][name][2]["X-Upow-Trace"]
        assert bad != "NOT-a-trace-id"
        assert ttelemetry.valid_trace_id(bad)


def test_port_profile_capture_on_the_cpu(differential):
    (s1, b1, _), (s2, b2, _), (s3, b3, _) = differential["profile"]
    assert (s1, s2, s3) == (200, 200, 200)
    assert json.loads(b1)["result"]["active"]
    assert json.loads(b2)["result"]["active"]
    stopped = json.loads(b3)
    assert stopped["ok"] and stopped["result"]["reason"] == "requested"
    with open(stopped["result"]["trace_file"]) as f:
        assert json.load(f)["traceEvents"]


@pytest.fixture
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


def test_push_tx_gossip_keeps_one_trace_id_both_ways(tmp_path, easy_chain):
    async def scenario(net, session, leaves):
        net.copy("chain", "j", "p")
        j = await net.jax("j")
        p = await net.port("p")
        j.peers.add(net.urls["p"])
        p.peers.add(net.urls["j"])
        chain = Chain(PORT, p.state)
        ids = []
        for first, second, leaf in (("p", "j", leaves[0]),
                                    ("j", "p", leaves[1])):
            tx = chain.spend([leaf])
            async with session.post(net.urls[first] + "/push_tx",
                                    json={"tx_hex": tx.hex()}) as r:
                assert (await r.json())["ok"]
                tid = r.headers["X-Upow-Trace"]
            other = net.nodes[second]
            await until(lambda: _has(other, tx), f"the tx on {second}")

            async def traced_on_second():
                _s, raw = await net.get(session, second, "/debug/traces")
                recent = json.loads(raw)["result"]["recent"]
                return any(t["name"] == "http.push_tx"
                           and t["trace_id"] == tid for t in recent)
            await until(traced_on_second, f"{tid} on {second}")
            ids.append(tid)
        return ids

    ids = _run(tmp_path, scenario)
    assert len(set(ids)) == 2


@pytest.mark.parametrize("debug, profile", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_debug_routes_gated_alike(tmp_path, debug, profile):
    jcfg, tcfg = _jcfg(tmp_path, "j"), _tcfg(tmp_path, "p")
    for cfg in (jcfg, tcfg):
        cfg.node.db_path = ""  # in memory: only the routes matter
        cfg.telemetry.debug_endpoints = debug
        cfg.profile.enabled = profile
        cfg.profile.trace_dir = str(tmp_path / "prof")

    async def main():
        jnode, tnode = japp.Node(jcfg), tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        codes = {}
        try:
            async with aiohttp.ClientSession() as session:
                for path in ("/debug/traces", "/debug/events",
                             "/debug/breakers",
                             "/debug/profile?action=status", "/metrics"):
                    got = [(await _get(session, f"http://127.0.0.1:{port}"
                                       + path))[0]
                           for port in (server.port, tserver.port)]
                    assert got[0] == got[1], (path, got)
                    codes[path] = got[1]
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()
        return codes

    codes = asyncio.run(main())
    assert codes["/metrics"] == 200
    assert codes["/debug/traces"] == codes["/debug/events"] == \
        codes["/debug/breakers"] == (200 if debug else 404)
    assert codes["/debug/profile?action=status"] == (
        200 if debug and profile else 404)
