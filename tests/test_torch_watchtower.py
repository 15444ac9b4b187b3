"""The port's watchtower against the JAX package's.

Each unit case of the JAX package's ``test_watchtower.py`` (the
streaming detectors, the burn-rate evaluator, the alert state machine,
the engine over scoped registries, the event ring's cursor and the
exposition's exemplars) runs once with each package's modules, as the
two cases of one parametrised test.  Then the node surfaces, a JAX node
and the port's node on the same requests: ``/debug/alerts`` (GET
read-only, POST silence and unsilence, the 400s of a bad body or
``seconds``), the ``alert_*`` and ``alert_rule_*`` families of
``/metrics`` and the ``/debug/events`` cursor with the watchtower on,
and ``{"enabled": false}`` with zero-valued families with it off.  The
flight recorder's trigger precedence (an alert that reached firing
outranks the fault and the SLO breach) runs on both packages' recorders.
The port's own: a failed device-runtime arm and a degrade trip emit the
event kinds the arm-flap rule counts.  The JAX cases that need the
swarm's scenarios (the ``watchtower_storm`` scenario and the clean
geo-soak) run on both packages with equal fingerprints, and the CLI
prints the JAX CLI's lines for all three legs with ``--device cpu``;
without it and without a card, leg 3 fails naming the missing card.
"""

import asyncio
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import aiohttp
import pytest
import torch
from aiohttp.test_utils import TestServer

import upow_tpu.config as jconfig
import upow_tpu.fleet.geosoak as jgeosoak
import upow_tpu.fleet.recorder as jrecorder
import upow_tpu.node.app as japp
import upow_tpu.swarm.scenarios as jsc
import upow_tpu.telemetry as jtelemetry
import upow_tpu.telemetry.events as jevents
import upow_tpu.telemetry.scope as jscope
import upow_tpu.watchtower as jwatchtower
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.fleet.geosoak as tgeosoak
import upow_tpu_torch.fleet.recorder as trecorder
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.swarm.scenarios as tsc
import upow_tpu_torch.telemetry as ttelemetry
import upow_tpu_torch.telemetry.events as tevents
import upow_tpu_torch.telemetry.scope as tscope
import upow_tpu_torch.watchtower as twatchtower
from test_torch_gossip import _jcfg, _tcfg


def _pkg(name, wt, tel, events, scope, config):
    return SimpleNamespace(
        name=name, wt=wt, WatchtowerConfig=config.WatchtowerConfig,
        TelemetryScope=scope.TelemetryScope, EventRing=events.EventRing,
        ROTATED_UNSEEN=events.ROTATED_UNSEEN, events=events,
        metrics=tel.metrics, tracing=tel.tracing,
        exposition=tel.exposition)


PKGS = {"jax": _pkg("jax", jwatchtower, jtelemetry, jevents, jscope,
                    jconfig),
        "port": _pkg("port", twatchtower, ttelemetry, tevents, tscope,
                     tconfig)}


@pytest.fixture(autouse=True)
def clean_telemetry():
    """The registries are process-global: each case starts clean."""
    for tel in (jtelemetry, ttelemetry):
        tel.reset()
    yield
    for tel in (jtelemetry, ttelemetry):
        tel.reset()
        tel.configure()


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


# ---------------------------------------------------------- detectors ----

def test_rate_tracker_first_sample_reset_and_recovery(P):
    r = P.wt.RateTracker()
    assert r.update(0.0, 100.0) is None           # no baseline yet
    assert r.update(10.0, 150.0) == 5.0           # 50 over 10s
    assert r.update(20.0, 40.0) is None           # counter reset
    assert r.update(30.0, 60.0) == 2.0            # re-primed after reset
    assert r.update(30.0, 70.0) is None           # dt <= 0 is unusable


def test_ewma_zscore_drop_direction_and_exact_fire_point(P):
    z = P.wt.EwmaZScore(alpha=0.3, z_threshold=6.0, min_samples=8,
                        direction="drop", min_sigma=0.25)
    for _ in range(10):
        out = z.update(10.0)
        assert not out["fire"], "steady series must stay quiet"
    out = z.update(0.0)
    assert out["fire"] and out["z"] <= -6.0
    assert out["mean"] == pytest.approx(10.0)


def test_ewma_zscore_spike_mode_ignores_drops_and_min_samples_gate(P):
    spike = P.wt.EwmaZScore(min_samples=2, direction="spike")
    out = None
    for v in (5.0, 5.0, 0.0):
        out = spike.update(v)
    assert not out["fire"], "a drop must not fire in spike mode"
    gated = P.wt.EwmaZScore(min_samples=8, direction="both")
    for v in (5.0, 5.0, 500.0):                   # only 3 samples seen
        out = gated.update(v)
    assert not out["fire"], "min_samples gates early wildness"


def test_stuck_gauge_arms_only_after_movement_and_deadline_boundary(P):
    g = P.wt.StuckGauge(deadline_s=60.0)
    assert not g.update(0.0, 5.0)                 # first sample
    assert not g.update(1000.0, 5.0)              # never moved != stuck
    assert not g.update(1010.0, 6.0)              # movement arms
    assert not g.update(1069.0, 6.0)              # 59s: inside deadline
    assert g.update(1070.0, 6.0)                  # 60s: stuck
    assert not g.update(1071.0, 7.0)              # movement resolves


def test_spike_detector_floor_ratio_and_allzero_series(P):
    s = P.wt.SpikeDetector(ratio=8.0, floor=100.0, min_samples=4)
    for v in (10.0, 10.0, 10.0, 10.0):
        assert not s.update(v)["fire"]
    assert not s.update(50.0)["fire"]             # 5x but under floor
    assert s.update(900.0)["fire"]                # >= 8x and >= floor
    idle = P.wt.SpikeDetector(ratio=8.0, floor=0.0, min_samples=4)
    out = None
    for _ in range(6):
        out = idle.update(0.0)
    assert not out["fire"], "an all-zero series is idle, not anomalous"


# ----------------------------------------------------------- burn rate ----

def _scaled_evaluator(P):
    # window_scale 1/300: fast pair (1s, 12s), slow pair (6s, 72s)
    return P.wt.BurnRateEvaluator(slo_target=0.999,
                                  window_scale=1.0 / 300.0)


def test_burnrate_error_burst_pages_fast_pair(P):
    ev = _scaled_evaluator(P)
    req = err = t = 0.0
    for _ in range(80):
        t += 1.0
        req += 100.0
        ev.record(t, {"push_tx": (req, err)})
    res = ev.evaluate(t)["push_tx"]
    assert res["fast_short"] == 0.0 and not res["page"]
    assert res["budget_remaining"] == 1.0
    for _ in range(13):                           # 50% errors: 500x burn
        t += 1.0
        req += 100.0
        err += 50.0
        ev.record(t, {"push_tx": (req, err)})
    res = ev.evaluate(t)["push_tx"]
    assert res["page"] and res["fast_short"] == pytest.approx(500.0)
    assert res["fast_long"] >= 14.4
    assert res["budget_remaining"] < 0.0, "burst overspends the budget"


def test_burnrate_drizzle_tickets_but_never_pages(P):
    ev = _scaled_evaluator(P)
    req = err = t = 0.0
    for _ in range(80):                           # 0.8% errors = 8x burn
        t += 1.0
        req += 1000.0
        err += 8.0
        ev.record(t, {"sync": (req, err)})
    res = ev.evaluate(t)["sync"]
    assert res["ticket"] and not res["page"]
    assert res["slow_short"] == pytest.approx(8.0)


def test_burnrate_none_without_baseline_or_traffic(P):
    ev = _scaled_evaluator(P)
    ev.record(0.0, {"idle": (100.0, 0.0)})
    assert ev.burn("idle", 12.0, 0.5) is None, "baseline too young"
    for tick in range(1, 40):                     # constant counters
        ev.record(float(tick), {"idle": (100.0, 0.0)})
    assert ev.burn("idle", 12.0, 39.0) is None, \
        "zero requests inside the window is idleness, not an outage"


def test_burnrate_production_windows_survive_retention(P):
    """At window_scale 1.0 and the 5 s cadence the 6 h baseline survives
    the snapshot retention."""
    ev = P.wt.BurnRateEvaluator(slo_target=0.999, window_scale=1.0)
    req = err = t = 0.0
    for _ in range(int(7 * 3600 / 5)):            # 7 h of 5 s ticks,
        t += 5.0                                  # 50% errors
        req += 100.0
        err += 50.0
        ev.record(t, {"push_tx": (req, err)})
    res = ev.evaluate(t)["push_tx"]
    assert res["fast_long"] is not None and res["slow_long"] is not None
    assert res["page"] and res["ticket"]
    assert len(ev._snaps) <= int(6 * 3600 / 5) + 2


def test_engine_sizes_burn_backstop_from_windows(P):
    cfg = P.WatchtowerConfig(enabled=True)        # 5 s, scale 1.0
    eng = P.wt.WatchtowerEngine(cfg, scope=P.TelemetryScope("bs"))
    assert eng._burn._snaps.maxlen >= int(6 * 3600 / 5)


# ------------------------------------------------- alert state machine ----

def test_alert_for_duration_exemplar_dedup_and_resolve(P):
    seen = []
    mgr = P.wt.AlertManager(history=8,
                            emit=lambda st, a: seen.append((st, a.key)))
    rule = P.wt.AlertRule("r", severity="critical", for_s=10.0)
    st = mgr.observe(rule, True, 100.0, value=1.0)
    assert st.state == "pending" and not seen
    mgr.observe(rule, True, 109.0)
    assert mgr.counts(109.0)["firing"] == 0, "9s < for-duration 10s"
    mgr.observe(rule, True, 110.0, exemplars=["t1", "t1", "t2"])
    c = mgr.counts(110.0)
    assert c["firing"] == 1 and c["firing_with_exemplars"] == 1
    assert seen == [("firing", "r")]
    assert mgr.active()[0].exemplars == ["t1", "t2"]
    assert mgr.ack("r") and mgr.active()[0].acked
    mgr.observe(rule, False, 120.0)
    assert seen[-1] == ("resolved", "r")
    assert mgr.fired_total == 1 and mgr.resolved_total == 1
    mgr.observe(rule, True, 200.0)
    mgr.observe(rule, False, 205.0)
    assert mgr.resolved_total == 1 and not mgr.active()


def test_alert_per_key_dedup_silence_and_expiry(P):
    seen = []
    mgr = P.wt.AlertManager(history=8,
                            emit=lambda st, a: seen.append((st, a.key)))
    burn = P.wt.AlertRule("burn", for_s=0.0)
    mgr.observe(burn, True, 300.0, key="burn:a")
    mgr.observe(burn, True, 300.0, key="burn:b")
    assert mgr.counts(300.0)["firing"] == 2
    assert [a.key for a in mgr.active()] == ["burn:a", "burn:b"]
    mgr.silence("burn:a", until=400.0)
    before = len(seen)
    mgr.observe(burn, False, 350.0, key="burn:a")
    assert len(seen) == before, "silenced transitions are not emitted"
    mgr.silence("burn:b", until=360.0)
    assert mgr.counts(355.0)["silenced"] == 1
    assert mgr.counts(365.0)["silenced"] == 0, "silence auto-expires"
    assert not mgr.ack("never-fired")


# --------------------------------------------------- event ring cursor ----

def test_event_ring_since_cursor_counts_rotated_records(P):
    ring = P.EventRing(maxlen=4)
    for i in range(6):
        ring.emit("k", i=i)
    got = ring.since(0)
    assert got["next_seq"] == 6 and got["missed"] == 2
    assert [e["seq"] for e in got["events"]] == [3, 4, 5, 6]
    again = ring.since(got["next_seq"])
    assert again["events"] == [] and again["missed"] == 0
    ring.emit("other")
    ring.emit("k", i=9)
    only_k = ring.since(6, kind="k")
    assert [e["seq"] for e in only_k["events"]] == [8]
    assert only_k["next_seq"] == 8


def test_scoped_since_bumps_rotated_unseen_counter(P):
    sc = P.TelemetryScope("t", events_buffer=4)
    with sc.activate():
        for i in range(6):
            P.events.emit("k", i=i)
        got = P.events.since(0)
        assert got["missed"] == 2
        assert sc.metrics.counters()[P.ROTATED_UNSEEN] == 2
        P.events.since(got["next_seq"])
        assert sc.metrics.counters()[P.ROTATED_UNSEEN] == 2


def test_event_ring_seq_monotonic_across_reset(P):
    ring = P.EventRing(maxlen=8)
    for i in range(5):
        ring.emit("k", i=i)
    cursor = ring.since(0)["next_seq"]
    assert cursor == 5
    ring.reset()
    ring.emit("k", i=99)
    got = ring.since(cursor)
    assert [e["i"] for e in got["events"]] == [99]
    assert got["events"][0]["seq"] == 6 and got["next_seq"] == 6


# -------------------------------------------------- exposition exemplars ----

def test_histogram_exemplar_renders_and_validates(P):
    name = "slo.http.push_tx.latency_seconds"
    m, x = P.metrics, P.exposition
    m.ensure_histogram(name, buckets=(0.1, 1.0))
    for value, tid in ((0.05, "aabbccdd11223344"), (0.06, "70e0d1e0020f44bc")):
        m.observe(name, value)
        m.observe_exemplar(name, value, tid)
        h = m.histograms()[name]
        assert h["exemplars"][0]["trace_id"] == tid
        e = x.Exposition()
        e.histogram(name, h["bounds"], h["counts"], h["count"], h["sum"],
                    exemplars=h.get("exemplars"))
        text = e.render()
        # a trace id that starts with a digit renders verbatim
        assert f'# {{trace_id="{tid}"}} {value:.6f}' in text
        assert x.validate(text) == []


def test_exemplar_prefers_slower_sample_within_bucket(P):
    P.metrics.ensure_histogram("h", buckets=(1.0,))
    P.metrics.observe("h", 0.9)
    P.metrics.observe_exemplar("h", 0.9, "slow0000slow0000")
    P.metrics.observe("h", 0.2)
    P.metrics.observe_exemplar("h", 0.2, "fast0000fast0000")
    ex = P.metrics.histograms()["h"]["exemplars"]
    assert ex[0]["trace_id"] == "slow0000slow0000"


def test_validator_rejects_exemplar_beyond_bucket_bound(P):
    bad = ('m_bucket{le="0.1"} 1 # {trace_id="x"} 5.0\n'
           'm_bucket{le="+Inf"} 1\n'
           'm_sum 0.050000\n'
           'm_count 1\n')
    assert any("exceeds bucket" in e for e in P.exposition.validate(bad))


def test_validator_exemplar_split_honors_quoted_labels(P):
    assert P.exposition.validate('m_total{route="a # {b"} 3\n') == []
    both = ('m_bucket{le="0.1",note="x # {y"} 1 '
            '# {trace_id="abc"} 0.05\n'
            'm_bucket{le="+Inf",note="x # {y"} 1\n'
            'm_sum 0.050000\n'
            'm_count 1\n')
    assert P.exposition.validate(both) == []
    bad = 'm_total 3 # {trace_id="abc" 0.05\n'      # unclosed label set
    assert any("malformed exemplar" in e
               for e in P.exposition.validate(bad))


# --------------------------------------------------------- engine unit ----

def _wt_cfg(P, **overrides):
    cfg = P.WatchtowerConfig()
    cfg.enabled = True
    cfg.for_fast = 0.0              # page on the evaluation tick
    cfg.breaker_storm_opens = 3
    cfg.breaker_storm_window = 60.0
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def test_engine_breaker_storm_fires_with_exemplar_then_resolves(P):
    async def main():
        sc = P.TelemetryScope("n0")
        eng = P.wt.WatchtowerEngine(_wt_cfg(P), scope=sc, name="n0")
        assert (await eng.evaluate_once(now=time.time()))["firing"] == 0
        with P.tracing.request_trace("http.push_tx") as root:
            tid = root.trace_id
            for i in range(4):
                sc.events.emit("breaker", peer=f"p{i}", state="open",
                               previous="closed", failures=3)
        assert (await eng.evaluate_once(now=time.time()))["firing"] == 1
        alert = {a.rule.name: a for a in eng.alerts.active()}[
            "breaker_flip_storm"]
        assert alert.state == "firing" and alert.value == 4.0
        assert tid in alert.exemplars
        fired = sc.events.snapshot(kind="alert")
        assert any(e["state"] == "firing" and e["node"] == "n0"
                   and e["exemplar"] == tid for e in fired)
        await eng.evaluate_once(
            now=time.time() + eng.cfg.breaker_storm_window + 1.0)
        assert not any(a.rule.name == "breaker_flip_storm"
                       for a in eng.alerts.active())
        st = eng.stats()
        assert st["fired_total"] == 1 and st["resolved_total"] == 1

    asyncio.run(main())


def test_engine_counts_rotated_events_and_survives_bad_probes(P):
    async def main():
        sc = P.TelemetryScope("n0", events_buffer=4)
        eng = P.wt.WatchtowerEngine(_wt_cfg(P), scope=sc, name="n0")
        for i in range(10):
            sc.events.emit("k", i=i)

        def bad_probe():
            raise RuntimeError("probe died")

        eng.register_probe("mempool_depth", bad_probe)
        eng.register_probe("sync_lag", lambda: 0.0)
        await eng.evaluate_once(now=time.time())
        assert sc.metrics.counters()[P.ROTATED_UNSEEN] == 6
        assert eng.probe_errors == 1
        assert eng.evaluations == 1 and eng.eval_errors == 0

    asyncio.run(main())


def test_engine_slo_burn_pages_route_and_records_bench_event(P, tmp_path):
    bench_path = tmp_path / "events.jsonl"

    async def main():
        sc = P.TelemetryScope("n0")
        eng = P.wt.WatchtowerEngine(
            _wt_cfg(P, window_scale=1.0 / 300.0,
                    bench_events=str(bench_path)), scope=sc, name="n0")
        fired = []
        eng.on_fire.append(lambda a: fired.append(a.rule.name))
        t = time.time()
        for _ in range(20):                       # clean baseline
            t += 1.0
            sc.metrics.inc("slo.http.push_tx.requests", 100)
            await eng.evaluate_once(now=t)
        assert not any(a.rule.name == "slo_burn_fast"
                       for a in eng.alerts.active())
        for _ in range(14):                       # 50% errors
            t += 1.0
            sc.metrics.inc("slo.http.push_tx.requests", 100)
            sc.metrics.inc("slo.http.push_tx.errors", 50)
            await eng.evaluate_once(now=t)
        assert "slo_burn_fast:push_tx" in [a.key for a in
                                           eng.alerts.active()]
        assert "slo_burn_fast" in fired

    asyncio.run(main())
    recs = [json.loads(ln) for ln in
            bench_path.read_text().strip().splitlines()]
    assert any(r["kind"] == "alert_fired" and r["rule"] == "slo_burn_fast"
               and r["source"] == "watchtower" for r in recs)


# ------------------------------------------------- recorder precedence ----

@pytest.mark.parametrize("recorder", [jrecorder, trecorder],
                         ids=["jax", "port"])
def test_recorder_trigger_alert_outranks_fault_and_slo_breach(recorder):
    evs = [{"kind": "fault_injected", "spec": "rpc:error"},
           {"kind": "alert", "state": "firing",
            "rule": "breaker_flip_storm"}]
    slow = {"swarm.x.node0": {"p99_ms": 900.0}}
    assert recorder.trigger_reason(True, evs, slo_rows=slow,
                                   p99_budget_ms=100.0) \
        == "alert:breaker_flip_storm"
    pending_only = [{"kind": "alert", "state": "pending", "rule": "r"},
                    {"kind": "fault_injected"}]
    assert recorder.trigger_reason(True, pending_only) == "fault_injected"
    assert recorder.trigger_reason(False, evs) == "core_assertion_failed"


# ------------------------------------------------- the port's emitters ----

def test_port_arm_failure_and_degrade_feed_the_arm_flap_rule(monkeypatch):
    """A failed device-runtime arm and a degrade trip on the port emit
    ``arm_failed`` and ``degrade``: with ``arm_flaps = 2`` the rule
    fires on the two."""
    from upow_tpu_torch.device import runtime as truntime
    from upow_tpu_torch.resilience.degrade import DegradeManager

    def no_card(self, info, timeout, t0):
        raise RuntimeError("nvcc: not found")

    async def main():
        eng = twatchtower.WatchtowerEngine(
            _wt_cfg(PKGS["port"], arm_flaps=2, for_slow=0.0))
        rt = truntime.DeviceRuntime(device="cpu")
        rt.device = torch.device("cuda")  # a card whose build fails
        monkeypatch.setattr(truntime.DeviceRuntime, "_arm_card", no_card)
        with pytest.raises(truntime.ArmError):
            rt.arm()
        degrade = DegradeManager(failure_limit=1, cooldown=60.0)
        degrade.record_failure(RuntimeError("launch failed"))
        kinds = [e["kind"] for e in ttelemetry.events.snapshot()]
        counts = await eng.evaluate_once(now=time.time())
        return kinds, counts, [a.rule.name for a in eng.alerts.active()]

    kinds, counts, active = asyncio.run(main())
    assert kinds.count("arm_failed") == 1 and "degrade" in kinds
    assert kinds.index("device_runtime_armed") < kinds.index("arm_failed")
    assert "arm_flaps" in active and counts["firing"] >= 1


# ------------------------------------------------------- node surfaces ----

def _node_cfgs(tmp_path, enabled):
    jcfg, tcfg = _jcfg(tmp_path, "j"), _tcfg(tmp_path, "p")
    for cfg in (jcfg, tcfg):
        cfg.node.db_path = ""
        cfg.watchtower.enabled = enabled
        cfg.watchtower.interval = 3600.0          # pumped by hand
    return jcfg, tcfg


async def _serve_both(jcfg, tcfg):
    jnode, tnode = japp.Node(jcfg), tapp.Node(tcfg, device="cpu")
    for node in (jnode, tnode):
        node.started = True
    server = TestServer(jnode.app)
    await server.start_server()
    tserver = await tnode.serve("127.0.0.1", 0)
    return jnode, tnode, server, {
        "jax": f"http://127.0.0.1:{server.port}",
        "port": f"http://127.0.0.1:{tserver.port}"}


async def _call(session, method, url, params=None, **kw):
    async with session.request(method, url, params=params or {},
                               **kw) as r:
        return r.status, await r.read()


def _strip(body: bytes) -> dict:
    """A /debug/alerts body without its wall-clock figures; the burn-rate
    readings of every route are compared (the archive routes' too)."""
    out = json.loads(body)
    out.get("result", {}).get("stats", {}).pop("eval_lag_seconds", None)
    return out


def test_debug_alerts_metrics_families_and_events_cursor(tmp_path):
    """The watchtower on: ``/debug/alerts`` serves the rule pack, a GET
    with knob parameters stays read-only, POST silences and unsilences
    (query or JSON body) and answers 400 to a bad body or ``seconds``;
    ``/metrics`` carries the alert families, the rules' and the SLO
    exemplars; ``/debug/events`` honours ``since``.  Both nodes alike."""
    jcfg, tcfg = _node_cfgs(tmp_path, True)
    for tel in (jtelemetry, ttelemetry):
        tel.configure()

    async def main():
        jnode, tnode, server, urls = await _serve_both(jcfg, tcfg)
        out = {"jax": [], "port": []}
        try:
            async with aiohttp.ClientSession() as session:
                for name in ("jax", "port"):
                    base = urls[name]
                    node = jnode if name == "jax" else tnode
                    for _ in range(3):
                        assert (await _call(session, "GET", base
                                            + "/get_supply_info"))[0] == 200
                    await node.watchtower.evaluate_once()
                    calls = [
                        ("GET", "/debug/alerts", None, None),
                        ("GET", "/debug/alerts",
                         {"silence": "stuck_height", "seconds": "60"}, None),
                        ("POST", "/debug/alerts",
                         {"silence": "stuck_height", "seconds": "60"}, None),
                        ("POST", "/debug/alerts", None,
                         {"unsilence": "stuck_height"}),
                        ("POST", "/debug/alerts", None, {"ack": "nope"}),
                        ("POST", "/debug/alerts",
                         {"silence": "x", "seconds": "soon"}, None),
                        ("POST", "/debug/alerts", None, [1, 2])]
                    for method, path, params, body in calls:
                        status, raw = await _call(session, method,
                                                  base + path, params,
                                                  json=body)
                        out[name].append((status, _strip(raw)))
                    status, raw = await _call(
                        session, "POST", base + "/debug/alerts",
                        data=b"{nope",
                        headers={"Content-Type": "application/json"})
                    out[name].append((status, json.loads(raw)))
                    status, raw = await _call(session, "GET",
                                              base + "/metrics")
                    out[name].append(raw.decode())
                    _s, raw = await _call(session, "GET",
                                          base + "/debug/events",
                                          {"since": "0"})
                    got = json.loads(raw)
                    cursor = got["next_seq"]
                    _s, raw = await _call(session, "GET",
                                          base + "/debug/events",
                                          {"since": str(cursor)})
                    again = json.loads(raw)
                    status, _raw = await _call(session, "GET",
                                               base + "/debug/events",
                                               {"since": "x"})
                    out[name].append((again["result"], again["missed"],
                                      status))
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()
        return out

    out = asyncio.run(main())
    texts = {n: out[n].pop(-2) for n in out}
    assert len(out["port"]) == len(out["jax"])
    for i, (want, got) in enumerate(zip(out["jax"], out["port"])):
        assert got == want, i
    got = out["port"]
    first = got[0][1]["result"]
    assert first["enabled"] and first["stats"]["evaluations"] >= 1
    assert {r["name"] for r in first["rules"]} >= {
        "verify_throughput_collapse", "breaker_flip_storm",
        "slo_burn_fast", "slo_burn_slow", "stuck_height"}
    assert "actions" not in got[1][1]["result"]
    assert got[2][1]["result"]["actions"] == {"silenced": "stuck_height"}
    assert got[3][1]["result"]["actions"] == {"unsilenced": "stuck_height"}
    assert got[4][1]["result"]["actions"] == {"acked": False}
    assert [g[0] for g in got[5:8]] == [400, 400, 400]
    assert got[5][1]["error"] == "seconds must be a number"
    assert got[6][1]["error"] == "body must be a JSON object"
    assert got[7][1]["error"] == "body must be JSON"
    assert got[8] == ([], 0, 400)
    for name, text in texts.items():
        for family in ("upow_alert_firing ", "upow_alert_pending ",
                       "upow_alert_silenced ",
                       "upow_alert_evaluations_total ",
                       "upow_alert_rule_stuck_height_critical_firing ",
                       "upow_telemetry_events_rotated_unseen_total "):
            assert family in text, (name, family)
        assert '# {trace_id="' in text, name
        assert ttelemetry.exposition.validate(text) == []
    fams = {n: sorted(line.split()[2] for line in t.splitlines()
                      if line.startswith("# TYPE upow_alert"))
            for n, t in texts.items()}
    assert fams["port"] == fams["jax"]


def test_debug_alerts_reports_disabled_but_families_still_export(tmp_path):
    jcfg, tcfg = _node_cfgs(tmp_path, False)

    async def main():
        jnode, tnode, server, urls = await _serve_both(jcfg, tcfg)
        out = {}
        try:
            assert jnode.watchtower is None and tnode.watchtower is None
            async with aiohttp.ClientSession() as session:
                for name, base in urls.items():
                    alerts = await _call(session, "GET",
                                         base + "/debug/alerts")
                    post = await _call(session, "POST",
                                       base + "/debug/alerts",
                                       {"silence": "x"})
                    _s, text = await _call(session, "GET",
                                           base + "/metrics")
                    out[name] = (alerts, post, sorted(
                        line for line in text.decode().splitlines()
                        if line.startswith("upow_alert")))
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()
        return out

    out = asyncio.run(main())
    assert out["port"] == out["jax"]
    alerts, post, lines = out["port"]
    disabled = (200, b'{"ok": true, "result": {"enabled": false}}')
    assert alerts == post == disabled
    assert "upow_alert_firing 0" in lines
    assert not any(line.startswith("upow_alert_rule_") for line in lines)


# ------------------------------------------------------------------ CLI ----

@pytest.mark.parametrize("args, rc", [(["--units-only"], 0), ([], 1)])
def test_cli_legs_one_and_two_and_no_silent_leg_three(args, rc):
    """Legs 1 and 2 alone exit 0; leg 3 is never skipped silently: with
    no ``--device`` it runs on the card, and without one it fails naming
    the missing card (it named ROADMAP A13f before the scenario came)."""
    if not args and torch.cuda.is_available():
        pytest.skip("pins the no-card error")
    run = subprocess.run(
        [sys.executable, "-m", "upow_tpu_torch.watchtower", *args],
        capture_output=True, text=True, timeout=120)
    assert run.returncode == rc, run.stderr
    lines = run.stdout.splitlines()
    assert lines[:3] == ["ok   detectors goldens", "ok   burnrate goldens",
                         "ok   state-machine goldens"]
    assert len(lines) == 3
    if rc:
        assert "no CUDA device is available" in run.stderr


def test_cli_three_legs_print_the_jax_lines():
    """``--check-determinism --device cpu``: the JAX CLI's lines, the
    scenario's wall time apart, and exit 0 on both."""
    procs = [subprocess.Popen([sys.executable, "-m", *argv],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in (["upow_tpu.watchtower", "--check-determinism"],
                          ["upow_tpu_torch.watchtower", "--check-determinism",
                           "--device", "cpu"])]
    outs = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    assert outs[0][2] == outs[1][2] == 0, outs[1][1]
    jlines, tlines = ([re.sub(r" \d+\.\d\ds fp=", " Xs fp=", ln)
                       for ln in o[0].splitlines()] for o in outs)
    assert tlines == jlines
    assert len(tlines) == 6
    assert tlines[3].startswith("ok   watchtower_storm n=3 seed=7 ")
    assert tlines[4].endswith("recorder=alert:breaker_flip_storm")
    assert tlines[5].startswith("ok   determinism fp1=")


# ----------------------------------------------------- scenario legs ----

SCENARIO_PKGS = {"jax": (jsc, jgeosoak, {}),
                 "port": (tsc, tgeosoak, {"device": "cpu"})}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchtower_storm_scenario_and_determinism(pkg):
    """Injected gossip faults page breaker_flip_storm with a cross-node
    exemplar, the flight recorder dumps with the alert as its trigger,
    the alert resolves once the fault lifts, and the same seed
    reproduces the core fingerprint, equal on both packages."""
    sc, _geo, kw = SCENARIO_PKGS[pkg]
    art = sc.run_scenario("watchtower_storm", seed=5, **kw)
    core = art["core"]
    assert core["baseline_clean"], "clean tick must not page"
    assert core["storm_alert_fired"]
    assert core["storm_rule"] == "breaker_flip_storm"
    assert core["storm_severity"] == "critical"
    assert core["exemplar_present"]
    assert core["exemplar_stitched"], "exemplar trace crosses >= 2 nodes"
    assert core["alert_event_emitted"]
    assert core["fault_events_seen"]
    assert core["alert_resolved"]
    assert core["converged"]
    assert len(art["observed"]["stitched_nodes"]) >= 2
    fr = art.get("flight_recorder")
    assert fr is not None, "alert must trip the black box"
    assert fr["reason"] == "alert:breaker_flip_storm"
    again = sc.run_scenario("watchtower_storm", seed=5, **kw)
    assert again["fingerprint"] == art["fingerprint"]
    assert again["core"] == core
    if pkg == "port":
        jart = jsc.run_scenario("watchtower_storm", seed=5)
        assert art["fingerprint"] == jart["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_geo_soak_clean_run_fires_zero_alerts(pkg):
    """The production rule pack armed on every geo-soak node stays
    silent through latency skew, churn and a partition/heal, and the
    enforced fleet kernel row zeroes if that ever regresses."""
    sc, geo, kw = SCENARIO_PKGS[pkg]
    art = sc.run_scenario("geo_soak", seed=5, **kw)
    core = art["core"]
    assert core["watchtower_armed_all_nodes"]
    assert core["watchtower_ticked"]
    assert core["watchtower_zero_alerts"]
    wt = art["observed"]["watchtower"]
    assert wt["ticks"] >= 1 and wt["fired"] == 0
    assert "flight_recorder" not in art
    rows = geo.fleet_rows(art)
    k = rows["kernels"]["watchtower_clean_ok"]
    assert k["value"] == 1.0 and k["direction"] == "higher"
    broken = {**art, "core": {**art["core"],
                              "watchtower_zero_alerts": False}}
    assert geo.fleet_rows(broken)["kernels"]["watchtower_clean_ok"][
        "value"] == 0.0
    if pkg == "port":
        jart = jsc.run_scenario("geo_soak", seed=5)
        assert art["fingerprint"] == jart["fingerprint"]
