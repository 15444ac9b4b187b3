"""The port's ``fleet/`` (scrape, stitch, propagation, geo soak, CLI) and
the selfcheck's fleet half against the JAX package's.

JAX ``tests/test_fleet.py``'s cases run once with each package's modules
(the port's swarms on ``device="cpu"``), as the two cases of one
parametrised test, and the port's outputs must equal the JAX ones on the
same inputs: the scoped registries of three in-loop nodes, the
propagation report's quantiles and NaN edges, the stitcher, the flight
recorder's dump on an injected fault, the geo soak's core and
fingerprint at seeds 5 and 11 with its ``fleet_rows`` shape, and
``render_fleet`` through each package's exposition validator with
crafted violations.  (The gate's ``--trend`` case is in
``test_torch_loadgen.py``.)  Then the CLIs: ``python -m
upow_tpu_torch.fleet --check-determinism --device cpu`` and ``python -m
upow_tpu_torch.telemetry.selfcheck --device cpu`` print the JAX CLIs'
lines; without ``--device`` the selfcheck fails naming the missing card
and builds no node on the host (C5).
"""

import asyncio
import functools
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import upow_tpu.fleet.geosoak as jgeosoak
import upow_tpu.fleet.propagation as jpropagation
import upow_tpu.fleet.scrape as jscrape
import upow_tpu.fleet.stitch as jstitch
import upow_tpu.resilience.faultinject as jfaultinject
import upow_tpu.swarm.harness as jharness
import upow_tpu.swarm.scenarios as jsc
import upow_tpu.telemetry.exposition as jexposition
import upow_tpu_torch.fleet.geosoak as tgeosoak
import upow_tpu_torch.fleet.propagation as tpropagation
import upow_tpu_torch.fleet.scrape as tscrape
import upow_tpu_torch.fleet.stitch as tstitch
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.resilience.faultinject as tfaultinject
import upow_tpu_torch.swarm.harness as tharness
import upow_tpu_torch.swarm.scenarios as tsc
import upow_tpu_torch.telemetry.exposition as texposition
import upow_tpu_torch.telemetry.selfcheck as tselfcheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": SimpleNamespace(
        propagation=jpropagation, scrape=jscrape, stitch=jstitch,
        geosoak=jgeosoak, sc=jsc, faultinject=jfaultinject,
        exposition=jexposition, swarm=lambda n, **kw: jharness.Swarm(n, **kw),
        kw={}),
    "port": SimpleNamespace(
        propagation=tpropagation, scrape=tscrape, stitch=tstitch,
        geosoak=tgeosoak, sc=tsc, faultinject=tfaultinject,
        exposition=texposition,
        swarm=lambda n, **kw: tharness.Swarm(n, device="cpu", **kw),
        kw={"device": "cpu"}),
}
both = pytest.mark.parametrize("pkg", ["jax", "port"])


@functools.lru_cache(maxsize=None)
def _run(pkg: str, name: str, seed: int) -> dict:
    p = PKGS[pkg]
    return p.sc.run_scenario(name, seed=seed, **p.kw)


# ------------------------------------------------- scoped registries ----

def _counter_value(metrics_text: str, family: str) -> float:
    for ln in metrics_text.splitlines():
        if ln.startswith(family + " "):
            return float(ln.split()[1])
    return 0.0


@both
def test_scoped_registries_disjoint_across_nodes(pkg):
    """Node i serves i+1 requests and its own /metrics reports exactly
    that, not the fleet total."""
    p = PKGS[pkg]
    family = "upow_slo_http_get_supply_info_requests_total"

    async def main():
        swarm = await p.swarm(3, seed=0).start()
        try:
            for i in range(3):
                for _ in range(i + 1):
                    res = await swarm.get(i, "get_supply_info")
                    assert res["ok"]
            snapshot = await p.scrape.scrape(swarm)
            return [_counter_value(
                snapshot["nodes"][f"node{i}"]["metrics_text"], family)
                for i in range(3)]
        finally:
            await swarm.close()

    with p.sc.deterministic_world(0):
        assert asyncio.run(main()) == [1.0, 2.0, 3.0]


# ------------------------------------------------------- propagation ----

def _block_events():
    return {
        "driver": [{"kind": "block_seen", "hash": "aa", "ts": 0.0}],
        "node0": [{"kind": "block_seen", "hash": "aa", "ts": 10.0}],
        "node1": [{"kind": "block_seen", "hash": "aa", "ts": 10.1}],
        "node2": [{"kind": "block_seen", "hash": "aa", "ts": 10.4}],
    }


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN (the empty quantiles)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b


@both
def test_propagation_report_quantiles(pkg):
    prop = PKGS[pkg].propagation
    events = _block_events()
    rep = prop.report(events, n_nodes=3, coverage=0.9)
    blocks = rep["blocks"]
    assert blocks["hashes"] == 1 and blocks["covered"] == 1
    assert abs(blocks["p50_ms"] - 400.0) < 1e-6
    assert abs(blocks["p99_ms"] - 400.0) < 1e-6
    events["node0"].append({"kind": "block_seen", "hash": "bb", "ts": 11.0})
    rep = prop.report(events, n_nodes=3, coverage=0.9)
    assert rep["blocks"]["hashes"] == 2
    assert rep["blocks"]["covered"] == 1
    assert _same(rep, jpropagation.report(events, n_nodes=3, coverage=0.9))


@both
def test_propagation_tx_spread_needs_two_seers(pkg):
    prop = PKGS[pkg].propagation
    events = {
        "node0": [{"kind": "tx_seen", "hash": "t1", "ts": 5.0}],
        "node1": [{"kind": "tx_seen", "hash": "t1", "ts": 5.25}],
        "node2": [{"kind": "tx_seen", "hash": "lonely", "ts": 9.0}],
    }
    rep = prop.report(events, n_nodes=3)
    assert rep["txs"]["covered"] == 1
    assert abs(rep["txs"]["p50_ms"] - 250.0) < 1e-6
    assert _same(rep, jpropagation.report(events, n_nodes=3))


@both
def test_propagation_empty_is_nan_not_crash(pkg):
    prop = PKGS[pkg].propagation
    rep = prop.report({"node0": []}, n_nodes=1)
    assert rep["blocks"]["hashes"] == 0
    assert math.isnan(rep["blocks"]["p50_ms"])
    assert math.isnan(rep["txs"]["max_ms"])
    assert prop.gate_rows(rep) == {}
    assert _same(rep, jpropagation.report({"node0": []}, n_nodes=1))


def test_propagation_matches_jax_on_seeded_stamps():
    import random

    rng = random.Random(0xF1EE7)
    events = {"driver": []}
    for n in range(7):
        recs = []
        for h in range(40):
            if rng.random() < 0.85:
                recs.append({"kind": "block_seen", "hash": f"b{h}",
                             "ts": 100.0 + h + rng.random()})
            if rng.random() < 0.6:
                recs.append({"kind": "tx_seen", "hash": f"t{h}",
                             "ts": 50.0 + h + rng.random()})
        recs.append({"kind": "block_seen", "hash": None, "ts": 1.0})
        recs.append({"kind": "other", "hash": "b0", "ts": 0.0})
        events[f"node{n}"] = recs
    for coverage in (0.5, 0.9, 1.0):
        t = tpropagation.report(events, coverage=coverage)
        j = jpropagation.report(events, coverage=coverage)
        assert _same(t, j)
        assert tpropagation.gate_rows(t, prefix="x") == \
            jpropagation.gate_rows(j, prefix="x")
    assert tpropagation.first_seen(events, "tx_seen") == \
        jpropagation.first_seen(events, "tx_seen")


# ----------------------------------------------------------- stitcher ----

def _root(node_ts, name, tid, duration_ms=2.0):
    return {"trace_id": tid, "name": name, "start_ts": node_ts,
            "duration_ms": duration_ms, "spans": []}


@both
def test_stitch_joins_one_trace_across_nodes(pkg):
    stitch = PKGS[pkg].stitch
    tid = "aabbccdd"
    traces = {
        "driver": {"recent": [_root(1.000, "fleet.push_tx", tid)]},
        "node0": {"recent": [_root(1.002, "GET /push_tx", tid)]},
        "node1": {"recent": [_root(1.010, "POST /push_tx", tid),
                             _root(5.0, "GET /", "other")]},
        "node2": {"recent": [_root(1.025, "POST /push_tx", tid)]},
    }
    fleet = stitch.stitch(traces)
    assert set(fleet) == {tid, "other"}
    t = fleet[tid]
    assert t["nodes"] == ["driver", "node0", "node1", "node2"]
    assert t["node_count"] == 4
    assert [h["node"] for h in t["hops"]] == t["nodes"]
    lat = {(e["from"], e["to"]): e["latency_ms"]
           for e in t["hop_latencies_ms"]}
    assert abs(lat[("node0", "node1")] - 8.0) < 1e-6
    assert abs(lat[("node1", "node2")] - 15.0) < 1e-6
    assert abs(t["duration_ms"] - 27.0) < 1e-6
    assert stitch.stitch_one(traces, "missing") is None
    assert fleet == jstitch.stitch(traces)
    assert stitch.stitch_one(traces, tid) == jstitch.stitch_one(traces, tid)


# ----------------------------------------------------- flight recorder ----

@both
def test_flight_recorder_dump_on_injected_fault(pkg):
    """An injected link fault marks the run: the black box lands in the
    artifact though every core assertion held."""
    p = PKGS[pkg]
    p.faultinject.install(
        "swarm.link:latency:times=1,delay=0.001,key=3006->")
    try:
        art = p.sc.run_scenario("spam", seed=5, **p.kw)
    finally:
        p.faultinject.uninstall()
    assert all(v for v in art["core"].values() if isinstance(v, bool))
    box = art["flight_recorder"]
    assert box["reason"] == "fault_injected"
    assert box["marks"] >= 2
    assert box["nodes"], "per-node frames recorded"
    frame = next(iter(box["nodes"].values()))[-1]
    assert set(frame) >= {"label", "ts", "counter_deltas", "events",
                          "open_traces"}
    assert art["fingerprint"] == _run("jax", "spam", 5)["fingerprint"]


@both
def test_no_flight_recorder_on_clean_run(pkg):
    assert "flight_recorder" not in _run(pkg, "spam", 5)


# ------------------------------------------------------------ geo-soak ----

@both
def test_geo_soak_scenario_and_determinism(pkg):
    p = PKGS[pkg]
    art = _run(pkg, "geo_soak", 5)
    core = art["core"]
    for flag in ("bootstrap_converged", "waves_all_propagated",
                 "gossip_reached_all_but_victim", "churn_victim_caught_up",
                 "partition_diverged", "healed_converged",
                 "tx_reached_90pct_nodes", "push_tx_trace_crossed_3_nodes",
                 "blocks_covered_90pct", "final_converged"):
        assert core[flag], flag
    assert sorted(set(core["continents"].values())) == ["am", "ap", "eu"]
    prop = art["observed"]["propagation"]
    assert prop["blocks"]["covered"] >= 11
    assert prop["blocks"]["p50_ms"] > 0
    assert prop["blocks"]["p95_ms"] >= prop["blocks"]["p50_ms"]
    stitched = art["observed"]["stitched_push_tx"]
    assert len([x for x in stitched["nodes"] if x != "driver"]) >= 3
    assert stitched["hop_latencies_ms"]
    assert any(k.startswith("swarm.geo_soak.node")
               for k in art["slo"]["endpoints"])
    assert "flight_recorder" not in art
    again = p.sc.run_scenario("geo_soak", seed=5, **p.kw)
    assert again["fingerprint"] == art["fingerprint"]
    assert again["core"] == core
    assert art["core"] == _run("jax", "geo_soak", 5)["core"]
    assert art["fingerprint"] == _run("jax", "geo_soak", 5)["fingerprint"]


@both
def test_geo_soak_fleet_rows_shape(pkg):
    p = PKGS[pkg]
    art = _run(pkg, "geo_soak", 11)
    rows = p.geosoak.fleet_rows(art)
    k = rows["kernels"]
    assert k["fleet_core_ok"]["value"] == 1.0
    assert k["fleet_core_ok"]["direction"] == "higher"
    for name in ("fleet_block_prop_p50_ms", "fleet_block_prop_p95_ms",
                 "fleet_tx_prop_p50_ms", "fleet_tx_prop_p95_ms"):
        assert k[name]["direction"] == "lower"
        assert k[name]["value"] >= 0.0
    assert any(ep.startswith("fleet.geo_soak.node")
               for ep in rows["slo_endpoints"])
    assert "fleet.geo_soak.block_prop" in rows["slo_endpoints"]
    broken = {**art, "core": {**art["core"], "healed_converged": False}}
    assert p.geosoak.fleet_rows(broken)["kernels"]["fleet_core_ok"][
        "value"] == 0.0
    jart = _run("jax", "geo_soak", 11)
    assert art["fingerprint"] == jart["fingerprint"]
    # the same artifact shapes the same rows on both packages
    assert tgeosoak.fleet_rows(jart) == jgeosoak.fleet_rows(jart)
    assert set(rows["slo_endpoints"]) == \
        set(jgeosoak.fleet_rows(jart)["slo_endpoints"])


def test_geo_soak_constants_match_jax():
    assert tgeosoak.CONTINENTS == jgeosoak.CONTINENTS
    assert tgeosoak._LATENCY == jgeosoak._LATENCY
    assert (tgeosoak.GEO_NODES, tgeosoak.GEO_SEED, tgeosoak._JITTER) == \
        (jgeosoak.GEO_NODES, jgeosoak.GEO_SEED, jgeosoak._JITTER)
    assert [tgeosoak.continent_of(i) for i in range(9)] == \
        [jgeosoak.continent_of(i) for i in range(9)]


def test_observatory_section_and_merge(tmp_path):
    """The geo soak shaped for, and merged into, an observatory artifact
    on the port: the section and the merged rows, beside the JAX ones."""
    path = tmp_path / "observatory.json"
    path.write_text('{"kernels": {"kept": {"value": 1.0}}}')
    out = tgeosoak.merge_into_observatory(str(path), device="cpu")
    import json

    doc = json.loads(path.read_text())
    assert doc["kernels"]["kept"] == {"value": 1.0}
    assert doc["kernels"]["fleet_core_ok"]["value"] == 1.0
    assert doc["fleet"]["fingerprint"] == out["artifact"]["fingerprint"]
    jsec = jgeosoak.observatory_section()
    for key in ("scenario", "nodes", "seed", "fingerprint", "core_ok",
                "flight_recorder"):
        assert doc["fleet"][key] == jsec["section"][key], key
    assert set(doc["fleet"]) == set(jsec["section"])
    assert set(out["kernels"]) == set(jsec["kernels"])


# ----------------------------------------------- fleet exposition gate ----

@both
def test_render_fleet_validates_and_crafted_violations(pkg):
    p = PKGS[pkg]

    async def main():
        swarm = await p.swarm(3, seed=0).start()
        try:
            _, addr = p.sc._wallet(0, "fleet_render")
            assert (await swarm.mine(0, addr))["ok"]
            await swarm.wait_converged()
            await swarm.settle()
            return await p.scrape.scrape(swarm)
        finally:
            await swarm.close()

    with p.sc.deterministic_world(0):
        snapshot = asyncio.run(main())
    text = p.scrape.render_fleet(snapshot)
    for validate in (texposition.validate, jexposition.validate):
        assert validate(text) == []
        assert validate(text + '9bad_name 1\n')
        broken = re.sub(
            r'upow_fleet_block_propagation_seconds_bucket\{le="\+Inf"\} \d+',
            'upow_fleet_block_propagation_seconds_bucket{le="+Inf"} 0', text)
        assert validate(broken)
    for family in ("upow_fleet_nodes", "upow_fleet_height_spread",
                   "upow_fleet_block_propagation_p95_ms",
                   "upow_fleet_block_propagation_seconds_bucket",
                   "upow_fleet_tx_propagation_seconds_bucket"):
        assert family in text, family
    assert "upow_fleet_nodes 3" in text
    assert "upow_fleet_height_spread 0" in text


def test_render_fleet_matches_jax_on_one_snapshot():
    """The same scrape renders the same exposition text on both."""
    snap = {"nodes": {
        f"node{i}": {"metrics_text": f"upow_block_height {5 + i % 2}\n"
                                     f"upow_mempool_transactions {i}\n",
                     "events": [{"kind": "block_seen", "hash": "aa",
                                 "ts": 1.0 + i / 100}],
                     "traces": {"recent": [{}] * i}}
        for i in range(4)}}
    text = tscrape.render_fleet(snap)
    assert text == jscrape.render_fleet(snap)
    assert texposition.validate(text) == []
    assert tscrape.render_fleet({"nodes": {}}) == \
        jscrape.render_fleet({"nodes": {}})


@both
def test_render_fleet_empty_snapshot(pkg):
    p = PKGS[pkg]
    text = p.scrape.render_fleet({"nodes": {}})
    assert p.exposition.validate(text) == []
    assert "upow_fleet_nodes 0" in text


# ----------------------------------------------------------------- CLIs ----

_TIMES = re.compile(r"\d+\.\d+s fp=|\d+(\.\d+)?ms|\(\d+ exposition lines")
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="pins the no-card error")


def _cli(*runs) -> list:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in runs]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        out.append((p.returncode, stdout, stderr))
    return out


def _masked(stdout: str) -> list:
    """Lines with wall times and the single-node exposition line count
    masked (the port's node exports the port-only families)."""
    lines = []
    for ln in stdout.splitlines():
        if ln.startswith('{"fingerprint": '):
            ln = re.sub(r'"fleet_(block|tx)_prop_p(50|95)_ms": [\d.]+',
                        r'"fleet_\1_prop_p\2_ms": X', ln)
        lines.append(_TIMES.sub("X", ln))
    return lines


def test_cli_fleet_and_selfcheck_print_the_jax_lines():
    (jf_rc, jf_out, _), (tf_rc, tf_out, tf_err), (js_rc, js_out, _), \
        (ts_rc, ts_out, ts_err) = _cli(
            ["upow_tpu.fleet", "--check-determinism"],
            ["upow_tpu_torch.fleet", "--check-determinism", "--device",
             "cpu"],
            ["upow_tpu.telemetry.selfcheck"],
            ["upow_tpu_torch.telemetry.selfcheck", "--device", "cpu"])
    assert jf_rc == tf_rc == 0, tf_err
    assert _masked(tf_out) == _masked(jf_out)
    assert any(ln.startswith("ok   determinism: fp=")
               for ln in tf_out.splitlines())
    assert js_rc == ts_rc == 0, ts_err
    assert _masked(ts_out) == _masked(js_out)
    assert ts_out.splitlines()[1].startswith("metrics-check: OK fleet (3 ")


@NO_CARD
def test_selfcheck_without_device_fails_naming_the_card(monkeypatch,
                                                        capsys):
    """C5: the selfcheck built its node on ``device="cpu"`` whatever the
    machine; without a card the default now fails, naming it, and builds
    no node."""
    built = []

    class NoNode:
        def __init__(self, *a, **k):
            built.append((a, k))
            raise AssertionError("a node was built")
    monkeypatch.setattr(tapp, "Node", NoNode)
    assert tselfcheck.main([]) == 1
    out = capsys.readouterr().out
    assert out.startswith("metrics-check: FAIL no CUDA device is available")
    assert built == []


def test_selfcheck_fleet_families_match_jax():
    import upow_tpu.telemetry.selfcheck as jselfcheck

    assert tselfcheck.REQUIRED_FLEET == jselfcheck.REQUIRED_FLEET
    assert tselfcheck.REQUIRED == jselfcheck.REQUIRED
