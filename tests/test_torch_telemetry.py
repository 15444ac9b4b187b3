"""The port's telemetry package (``upow_tpu_torch/telemetry/``, ``trace``,
``logger``, ``profiling``) against the JAX package's, on the CPU.

* Every unit case of ``tests/test_telemetry.py`` and ``tests/test_trace.py``
  runs on both packages' modules, as one test parametrised by package:
  trees and the ring, id adoption, the span budget, cross-task
  attribution, the cardinality cap, histogram shapes, the events ring,
  the validator's catches, ``sanitize``, cumulative buckets, the JSONL
  formatter, span stats and ``block_accept``'s span.
* The same sequence of ``inc`` / ``observe`` / ``span`` / ``event`` /
  SLO and kernel-telemetry calls into each package's registries, on one
  fake clock, renders byte-for-byte equal exposition text (the
  port-only ``kernel.<k>.batches`` counter left out); each package's
  validator passes the other's rendering and gives the other's errors
  on broken text.
* The JSONL log line equals the JAX one apart from its time.
* The port's own parts: ``device_memory`` is empty without a card,
  ``profiling`` captures a Chrome trace with ``torch.profiler`` (and
  stops a capture left past ``max_capture_seconds``), ``analyze_cost``
  records a kernel's counted work and a node under
  ``profile.cost_analysis`` exports the txid batch's, and
  ``exposition.samples`` reads a scrape back; inside a capture the
  spans are user annotations in the trace, outside one they never
  build a ``record_function``.
"""

import asyncio
import itertools
import json
import logging
import os
import sys
import time
import types
from decimal import Decimal

import pytest

import upow_tpu.logger as jlogger
import upow_tpu.telemetry as jtelemetry
import upow_tpu.trace as jtrace
import upow_tpu_torch.logger as tlogger
import upow_tpu_torch.telemetry as ttelemetry
import upow_tpu_torch.trace as ttrace
from upow_tpu_torch import profiling


def _pkg(telemetry, trace, logger, name):
    return types.SimpleNamespace(
        name=name, telemetry=telemetry, trace=trace,
        tracing=telemetry.tracing, metrics=telemetry.metrics,
        events=telemetry.events, exposition=telemetry.exposition,
        slo=telemetry.slo, device=telemetry.device,
        JsonlFormatter=logger.JsonlFormatter)


PKGS = {"jax": _pkg(jtelemetry, jtrace, jlogger, "jax"),
        "port": _pkg(ttelemetry, ttrace, tlogger, "port")}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def clean_telemetry():
    """Registries are process-global: isolate each test (both packages),
    then restore the preregistered families."""
    for p in PKGS.values():
        p.telemetry.reset()
    yield
    for p in PKGS.values():
        p.telemetry.reset()
        p.telemetry.configure()


def _span_names(t: dict) -> list:
    out = []
    for child in t.get("spans", ()):
        out.append(child["name"])
        out.extend(_span_names(child))
    return out


# ------------------------------------------- the JAX unit cases, twice ---

def test_exposition_sanitize_and_render(pkg):
    e = pkg.exposition.Exposition()
    e.gauge("mempool.pool.bytes", 12, help_text="dotted name")
    e.counter("weird name!", 3)
    text = e.render()
    assert "upow_mempool_pool_bytes 12" in text
    assert "upow_weird_name__total 3" in text
    assert not pkg.exposition.validate(text)
    assert pkg.exposition.sanitize("9lives.x") == "_9lives_x"


BROKEN = {
    "illegal_name": "9bad_name 1\n",
    "not_monotone": ('x_bucket{le="0.1"} 5\n'
                     'x_bucket{le="0.5"} 3\n'
                     'x_bucket{le="+Inf"} 5\n'
                     "x_sum 1\n"
                     "x_count 5\n"),
    "no_inf": 'y_bucket{le="0.1"} 1\ny_sum 1\ny_count 1\n',
    "le_order": ('z_bucket{le="0.5"} 1\n'
                 'z_bucket{le="0.1"} 1\n'
                 'z_bucket{le="+Inf"} 2\n'
                 "z_sum 1\nz_count 2\n"),
    "count_mismatch": ('w_bucket{le="0.1"} 1\n'
                       'w_bucket{le="+Inf"} 2\n'
                       "w_sum 1\nw_count 5\n"),
    "bad_exemplar": ('v_bucket{le="0.1"} 1 # {trace_id="ab"} 0.5\n'
                     'v_bucket{le="+Inf"} 1\nv_sum 0.5\nv_count 1\n'),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_validator_catches_violations(pkg, case):
    errors = pkg.exposition.validate(BROKEN[case])
    assert errors
    other = PKGS["jax" if pkg.name == "port" else "port"]
    assert errors == other.exposition.validate(BROKEN[case])


def test_exposition_histogram_cumulative(pkg):
    e = pkg.exposition.Exposition()
    e.histogram("lat", bounds=(0.1, 0.5), counts=[2, 1, 4],
                total=7, summed=3.5)
    text = e.render()
    assert 'upow_lat_bucket{le="0.1"} 2' in text
    assert 'upow_lat_bucket{le="0.5"} 3' in text
    assert 'upow_lat_bucket{le="+Inf"} 7' in text
    assert "upow_lat_count 7" in text
    assert not pkg.exposition.validate(text)


def test_trace_tree_nesting_and_buffer(pkg):
    tracing = pkg.tracing
    tracing.configure(recent=2, slowest=2, max_spans=512)
    try:
        with tracing.request_trace("req.a"):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
        t = tracing.traces()["recent"][-1]
        assert t["name"] == "req.a" and tracing.valid_trace_id(t["trace_id"])
        assert t["spans"][0]["name"] == "outer"
        assert t["spans"][0]["spans"][0]["name"] == "inner"
        for i in range(5):
            with tracing.request_trace(f"req.{i}"):
                pass
        snap = tracing.traces()
        assert len(snap["recent"]) == 2
        assert len(snap["slowest"]) <= 2
    finally:
        tracing.configure()


def test_trace_id_adoption_and_validation(pkg):
    tracing = pkg.tracing
    assert tracing.valid_trace_id("ab" * 16)
    assert not tracing.valid_trace_id(None)
    assert not tracing.valid_trace_id("xyz")
    assert not tracing.valid_trace_id("AB" * 16)  # upper-case rejected
    with tracing.request_trace("r", trace_id="deadbeef" * 4):
        assert tracing.current_trace_id() == "deadbeef" * 4
    with tracing.request_trace("r", trace_id="not-hex!"):
        adopted = tracing.current_trace_id()
        assert adopted != "not-hex!" and tracing.valid_trace_id(adopted)


def test_span_budget_caps_tree_growth(pkg):
    tracing = pkg.tracing
    tracing.configure(recent=4, slowest=4, max_spans=3)
    try:
        with tracing.request_trace("budget"):
            for _ in range(10):
                with tracing.span("leaf"):
                    pass
        t = tracing.traces()["recent"][-1]
        assert len(t.get("spans", ())) == 3
        # the overflow spans still fed the flat aggregates
        assert pkg.metrics.stats()["leaf"]["count"] == 10
    finally:
        tracing.configure()


def test_cross_task_attribution(pkg):
    tracing = pkg.tracing

    async def main():
        with tracing.request_trace("xtask"):
            captured = tracing.current_span()
        with tracing.request_trace("xtask2"):
            parent = tracing.current_span()
            child = tracing.child_span(parent, "queue_wait")
            await asyncio.sleep(0)
            tracing.finish_child(child, batch=4)
            with tracing.attached(parent), tracing.span("journal"):
                pass
            t0 = time.perf_counter()
            tracing.add_span(parent, "shared", t0, t0 + 0.5, n=3)
        t = tracing.traces()["recent"][-1]
        names = _span_names(t)
        assert names == ["queue_wait", "journal", "shared"]
        assert t["spans"][2]["duration_ms"] == 500.0
        # late children of a recorded trace are refused
        assert tracing.child_span(captured, "late") is None

    asyncio.run(main())


def test_cardinality_cap_drops_and_counts(pkg):
    metrics = pkg.metrics
    metrics.set_max_names(4)
    try:
        for i in range(10):
            metrics.inc(f"dyn.counter.{i}")
        counts = metrics.counters()
        named = [k for k in counts if k.startswith("dyn.counter.")]
        assert len(named) == 4
        assert counts[metrics.DROPPED] == 6
        metrics.inc(metrics.DROPPED, 0)
        assert metrics.DROPPED in metrics.counters()
        for i in range(10):
            metrics.observe(f"dyn.hist.{i}", 1.0)
        hists = metrics.histograms()
        assert len([k for k in hists if k.startswith("dyn.hist.")]) == 4
    finally:
        metrics.set_max_names(1024)


def test_histogram_shape_and_buckets(pkg):
    metrics = pkg.metrics
    metrics.observe("h", 0.3, buckets=(0.1, 0.5, 1.0))
    metrics.observe("h", 0.05)
    metrics.observe("h", 99.0)
    h = metrics.histograms()["h"]
    assert h["bounds"] == (0.1, 0.5, 1.0)
    assert h["counts"] == [1, 1, 0, 1]  # +Inf overflow last
    assert h["count"] == 3


def test_events_ring_and_filter(pkg):
    events, tracing = pkg.events, pkg.tracing
    events.configure(maxlen=3)
    try:
        for i in range(5):
            events.emit("tick", i=i)
        events.emit("tock")
        snap = events.snapshot()
        assert len(snap) == 3
        assert snap[-1]["kind"] == "tock"
        assert events.snapshot(kind="tick")[-1]["i"] == 4
        assert len(events.snapshot(limit=1)) == 1
        with tracing.request_trace("ev", trace_id="cafe" * 8):
            events.emit("traced")
        assert events.snapshot(kind="traced")[-1]["trace_id"] == "cafe" * 8
        assert snap[0]["trace_id"] is None
        # the incremental cursor: what rotated away unseen is counted
        got = events.since(0)
        assert got["missed"] == got["next_seq"] - 3
        assert pkg.metrics.counters()[events.ROTATED_UNSEEN] == got["missed"]
    finally:
        events.configure(maxlen=256)


def test_jsonl_formatter_includes_trace_id(pkg):
    fmt = pkg.JsonlFormatter()
    rec = logging.LogRecord("upow.test", logging.INFO, __file__, 1,
                            "hello %s", ("world",), None)
    with pkg.tracing.request_trace("fmt", trace_id="beef" * 8):
        line = fmt.format(rec)
    d = json.loads(line)
    assert d["msg"] == "hello world"
    assert d["trace_id"] == "beef" * 8
    assert d["level"] == "INFO" and d["logger"] == "upow.test"
    try:
        raise ValueError("boom")
    except ValueError:
        rec = logging.LogRecord("upow.test", logging.ERROR, __file__, 1,
                                "bad", (), sys.exc_info())
    d = json.loads(fmt.format(rec))
    assert d["trace_id"] is None
    assert "boom" in d["exc"]


def test_span_stats_accumulate(pkg):
    trace = pkg.trace
    with trace.span("unit_test_section"):
        pass
    with trace.span("unit_test_section"):
        pass
    s = trace.stats()["unit_test_section"]
    assert s["count"] == 2
    assert s["total_s"] >= 0 and s["max_s"] >= 0
    trace.reset()
    assert "unit_test_section" not in trace.stats()


def test_span_records_on_exception(pkg):
    with pytest.raises(ValueError):
        with pkg.trace.span("boom"):
            raise ValueError("x")
    assert pkg.trace.stats()["boom"]["count"] == 1


def test_profile_noop_without_dir(pkg):
    with pkg.trace.profile(None):
        x = 1 + 1
    assert x == 2


def test_scope_isolates_registries(pkg):
    sc = pkg.telemetry.TelemetryScope("n1", max_metric_names=8)
    with sc.activate():
        pkg.trace.inc("scoped.only")
        pkg.trace.event("scoped_event")
        with pkg.trace.request_trace("scoped.req"):
            pass
        assert pkg.trace.counters() == {"scoped.only": 1}
    assert "scoped.only" not in pkg.trace.counters()
    assert sc.metrics.counters() == {"scoped.only": 1}
    assert [e["kind"] for e in sc.events.snapshot()] == ["scoped_event"]
    assert sc.traces.snapshot()["recent"][0]["name"] == "scoped.req"


def test_block_accept_span_fires(pkg):
    """create_block goes through the span (the reference logs every
    accept, manager.py:732-736)."""
    if pkg.name == "jax":
        from upow_tpu.core import curve, difficulty, point_to_string
        from upow_tpu.core.clock import timestamp
        from upow_tpu.core.header import BlockHeader
        from upow_tpu.core.merkle import merkle_root
        from upow_tpu.state import ChainState
        from upow_tpu.verify import BlockManager
        make = lambda st: BlockManager(st, sig_backend="host")  # noqa: E731
    else:
        from upow_tpu_torch.core import curve, difficulty, point_to_string
        from upow_tpu_torch.core.clock import timestamp
        from upow_tpu_torch.core.header import BlockHeader
        from upow_tpu_torch.core.merkle import merkle_root
        from upow_tpu_torch.state.storage import ChainState
        from upow_tpu_torch.verify.block import BlockManager
        make = lambda st: BlockManager(st, device="cpu")  # noqa: E731

    old = difficulty.START_DIFFICULTY
    difficulty.START_DIFFICULTY = Decimal("1.0")
    try:
        async def main():
            state = ChainState()
            manager = make(state)
            _, pub = curve.keygen(rng=77)
            header = BlockHeader(
                previous_hash=(18_884_643).to_bytes(32, "little").hex(),
                address=point_to_string(pub), merkle_root=merkle_root([]),
                timestamp=timestamp(), difficulty_x10=10, nonce=0)
            assert await manager.create_block(header.hex(), [], errors=[])
            state.close()

        asyncio.run(main())
        assert pkg.trace.stats()["block_accept"]["count"] == 1
        assert pkg.events.snapshot(kind="block_seen")[-1]["height"] == 1
    finally:
        difficulty.START_DIFFICULTY = old


# ------------------------------------------ the two packages side by side

def _drive(p) -> None:
    """One fixed sequence of registry, SLO and kernel-telemetry calls."""
    t, trace = p.tracing, p.trace
    trace.inc("resilience.propagate_timeouts")
    trace.inc("mempool.intake_txs", 7)
    trace.ensure_counter("never.bumped")
    trace.observe("mempool.intake_batch_size", 3,
                  buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
    trace.observe("mempool.admit_latency", 0.0042)
    trace.observe("mempool.admit_latency", 7.5)
    with t.request_trace("http.push_tx", trace_id="0123abcd" * 4):
        with trace.span("push_tx.verify", n=2):
            trace.event("tx_seen", hash="ab" * 32)
        with trace.span("push_tx.journal_write"):
            pass
        p.slo.observe_request("/push_tx", 0.0031, 200)
    p.slo.preregister({"/", "/push_tx", "/get_mining_info"})
    p.slo.observe_request("/get_mining_info", 0.2, 500,
                          trace_id="9" * 32)
    p.device.record_batch("p256_verify", real=1026, padded=1026,
                          seconds=0.012, compile_key=("jac", 4))
    p.device.record_batch("p256_verify", real=1, padded=1,
                          seconds=0.004, compile_key=("jac", 4))
    p.device.record_stage("block_decode", 0.3, items=1024, wall=0.9)
    p.device.record_runtime_dispatch(
        n_submissions=3, waits_by_source={"block": 0.002, "mempool": 0.01},
        depth=5, real=99, padded=99, seconds=0.02)
    p.device.record_index_probe(8160, 0, 0)
    p.device.record_mine_round([100, 50], 128, seconds=0.5,
                               compile_key=(128, 2, "spec"))
    p.device.record_mine_hit(3.25)
    p.device.record_cost("p256_verify", {"mul_ops_needed": 12345.0})
    p.events.since(0)


def _render(p) -> str:
    """Registries in the node's /metrics order (JAX app.py:985-994)."""
    e = p.exposition.Exposition()
    for kern, costs in sorted(p.device.cost_estimates().items()):
        for key, value in sorted(costs.items()):
            e.gauge(f"kernel_{kern}_cost_{key}", value, "cost")
    counters = {k: v for k, v in p.trace.counters().items()
                if not (k.startswith("kernel.") and k.endswith(".batches"))}
    for name, value in sorted(counters.items()):
        e.counter(name, value)
    for name, s in sorted(p.trace.stats().items()):
        e.span_stats(name, s)
    for name, h in sorted(p.trace.histograms().items()):
        e.histogram(name, h["bounds"], h["counts"], h["count"], h["sum"],
                    exemplars=h.get("exemplars"))
    return e.render()


def test_same_calls_render_byte_equal_exposition(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 0.125)
    texts = {}
    for name, p in PKGS.items():
        p.telemetry.configure()
        _drive(p)
        texts[name] = _render(p)
    assert texts["port"] == texts["jax"]
    assert "upow_kernel_p256_verify_lanes_real_total 1027" in texts["port"]
    assert 'trace_id="' + "9" * 32 in texts["port"]
    # the port-only launch counter, left out of the comparison above
    assert ttrace.counters()["kernel.p256_verify.batches"] == 2
    assert "kernel.p256_verify.batches" not in jtrace.counters()


def test_each_validator_passes_the_other_rendering():
    for p in PKGS.values():
        p.telemetry.configure()
        _drive(p)
    port_text, jax_text = _render(PKGS["port"]), _render(PKGS["jax"])
    assert jtelemetry.exposition.validate(port_text) == []
    assert ttelemetry.exposition.validate(jax_text) == []
    samples = ttelemetry.exposition.samples(jax_text)
    assert samples["upow_runtime_dispatches_total"] == 1
    assert samples['upow_kernel_p256_verify_occupancy_bucket{le="1.0"}'] == 2


def test_slo_quantiles_and_summary_agree():
    for p in PKGS.values():
        for seconds in (0.0002, 0.003, 0.003, 0.04, 0.9, 9.0):
            p.slo.observe_request("/get_block", seconds, 200)
    assert ttelemetry.slo.summary() == jtelemetry.slo.summary()
    assert ttelemetry.slo.summary()["get_block"]["requests"] == 6


def test_jsonl_line_equals_jax_apart_from_time():
    rec = logging.LogRecord("upow_tpu.node", logging.WARNING, __file__, 9,
                            "peer %s down", ("http://10.0.0.1:3006",), None)
    lines = []
    for p in (PKGS["jax"], PKGS["port"]):
        with p.tracing.request_trace("log", trace_id="feed" * 8):
            lines.append(json.loads(p.JsonlFormatter().format(rec)))
    assert lines[0] == lines[1]
    assert lines[1]["trace_id"] == "feed" * 8 and set(lines[1]) == {
        "ts", "level", "logger", "msg", "trace_id"}


# --------------------------------------------------- the port's own parts

def test_device_memory_is_empty_without_a_card():
    assert ttelemetry.device.device_memory() == {}


def test_profiling_capture_writes_a_chrome_trace(tmp_path):
    import torch

    profiling.reset()
    profiling.prime()
    started = profiling.start(str(tmp_path), max_seconds=60.0)
    assert started == {"active": True, "trace_dir": str(tmp_path)}
    assert profiling.start(str(tmp_path))["error"] == "capture already active"
    (torch.ones(64) * 3).sum()
    assert profiling.status()["active"]
    stopped = profiling.stop()
    assert "error" not in stopped and stopped["reason"] == "requested"
    with open(stopped["trace_file"]) as f:
        assert json.load(f)["traceEvents"]
    assert profiling.status() == {"active": False}
    assert profiling.stop() == {"error": "no capture active"}
    kinds = [e["kind"] for e in ttelemetry.events.snapshot()]
    assert kinds == ["profile_capture_started", "profile_capture_stopped"]


def test_profiling_capture_auto_stops(tmp_path, monkeypatch):
    profiling.reset()
    profiling.prime()
    assert profiling.start(str(tmp_path), max_seconds=5.0)["active"]
    later = time.monotonic() + 10.0
    monkeypatch.setattr(time, "monotonic", lambda: later)
    assert profiling.status() == {"active": False}
    stopped = ttelemetry.events.snapshot(kind="profile_capture_stopped")
    assert stopped[-1]["reason"] == "max_capture_seconds"
    assert os.path.exists(stopped[-1]["trace_file"])


def test_analyze_cost_records_the_kernels_counted_work():
    from upow_tpu_torch.crypto import sha256

    got = profiling.analyze_cost("sha256_txid", sha256.blocks_work_counts,
                                 10, 4)
    assert got == {"alu_ops_needed": 10.0 * sha256.BLOCK_ALU_OPS,
                   "add_ops_needed": 10.0 * sha256.BLOCK_ADD_OPS,
                   "bytes_needed": 10.0 * 64 + 4 * 40}
    assert ttelemetry.device.cost_estimates()["sha256_txid"] == got
    assert profiling.analyze_cost("bad", lambda: 1 / 0) is None


def test_cost_analysis_on_a_node_exports_the_txid_batchs_work(monkeypatch):
    """``profile.cost_analysis`` on a node: the txid batch's counted work
    (here on the plain version) lands on ``/metrics``."""
    import hashlib

    from upow_tpu_torch.config import Config
    from upow_tpu_torch.crypto import p256, sha256
    from upow_tpu_torch.node.app import Node

    monkeypatch.setattr(profiling, "COST_ANALYSIS", False)
    node = Node(Config.load(node__db_path="", node__seed_url="",
                            node__peers_file="", node__ip_config_file="",
                            log__path="", log__console=False,
                            profile__cost_analysis=True), device="cpu")
    try:
        assert profiling.COST_ANALYSIS
        payloads = [bytes([i]) * (7 * i) for i in range(40)]
        assert sha256.txid_batch(payloads, backend="device", min_batch=1,
                                 device="cpu") == [
            hashlib.sha256(m).hexdigest() for m in payloads]
        blocks = int(sum(sha256.n_blocks_of(len(m)) for m in payloads))
        scrape = ttelemetry.exposition.samples(
            asyncio.run(node.h_metrics(None)).body.decode())
        assert scrape["upow_kernel_sha256_txid_cost_alu_ops_needed"] == \
            blocks * sha256.BLOCK_ALU_OPS
        assert scrape["upow_kernel_sha256_txid_cost_bytes_needed"] == \
            blocks * 64 + 40 * 40
        # the P-256 batch's counts are the bound's own functions
        assert set(p256.work_counts([1], [2], [3], [0], [0])) == {
            "mul_ops_needed", "bytes_needed"}
    finally:
        asyncio.run(node.close())


def test_spans_in_a_profiling_session_are_user_annotations(tmp_path):
    """While the program's own capture with ``spans`` runs (the miner's
    endpoint's), a span (on any thread) and a trace root are
    ``record_function`` ranges of their names in the Chrome trace; the
    capture's end turns the bridge off."""
    import threading

    profiling.reset()
    profiling.prime()
    assert not ttelemetry.tracing.ANNOTATE
    assert profiling.start(str(tmp_path), max_seconds=60.0,
                           spans=True)["active"]
    assert ttelemetry.tracing.ANNOTATE
    with ttelemetry.request_trace("bridge.root"):
        with ttelemetry.span("bridge.span"):
            pass
    with ttelemetry.tracing.annotation("bridge.annotation"):
        pass

    def on_thread():
        with ttelemetry.span("bridge.thread"):
            pass

    worker = threading.Thread(target=on_thread)
    worker.start()
    worker.join(10)
    assert not worker.is_alive()
    stopped = profiling.stop()
    assert not ttelemetry.tracing.ANNOTATE
    with open(stopped["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    marked = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"bridge.root", "bridge.span", "bridge.thread",
            "bridge.annotation"} <= marked
    assert ttrace.stats()["bridge.span"]["count"] == 1


def test_a_session_without_spans_carries_none(tmp_path, monkeypatch):
    """A capture started as the node's ``/debug/profile`` starts it (no
    ``spans``) leaves the bridge off: its spans never build a
    ``record_function``, and the trace holds no annotation of them."""
    import torch

    profiling.reset()
    profiling.prime()
    assert profiling.start(str(tmp_path), max_seconds=60.0)["active"]
    assert not ttelemetry.tracing.ANNOTATE

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without spans")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        with ttelemetry.request_trace("plain.root"):
            with ttelemetry.span("plain.span"):
                pass
    stopped = profiling.stop()
    with open(stopped["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    assert not {"plain.root", "plain.span"} & {e["name"] for e in events}
    assert ttrace.stats()["plain.span"]["count"] == 1


def test_spans_outside_a_session_enter_no_record_function(monkeypatch):
    """With no capture of the program's running, a span, a trace root and
    an annotation never build a ``record_function``."""
    import torch

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    assert not ttelemetry.tracing.ANNOTATE
    with ttelemetry.request_trace("quiet.root"):
        with ttelemetry.span("quiet.span"):
            pass
    with ttelemetry.tracing.annotation("quiet.annotation"):
        pass
    assert ttrace.stats()["quiet.span"]["count"] == 1
