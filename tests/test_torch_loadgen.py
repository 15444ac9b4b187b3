"""The port's ``loadgen/`` (population, runner, gate, the artifact
writer) against the JAX package's.

JAX ``tests/test_loadgen.py``'s pure cases run once with each package's
modules, as the two cases of one parametrised test, and the port's
outputs must equal the JAX ones on the same inputs: the schedules and
their fingerprints over several ``PopulationSpec``s, the mock runner's
summaries, ``summarize_latencies`` on seeded values, and the gate's
``flatten``/``compare``/``trend_report`` and ``main``'s exit codes and
output lines on the same artifacts.  (Its cases that boot a JAX test
cluster or read JAX's XLA cost analysis have no port counterpart here.)
"""

import asyncio
import json
import random
from types import SimpleNamespace

import pytest

import upow_tpu.loadgen.gate as jgate
import upow_tpu.loadgen.observatory as jobservatory
import upow_tpu.loadgen.population as jpopulation
import upow_tpu.loadgen.runner as jrunner
import upow_tpu.telemetry as jtelemetry
import upow_tpu.telemetry.exposition as jexposition
import upow_tpu_torch.loadgen.gate as tgate
import upow_tpu_torch.loadgen.observatory as tobservatory
import upow_tpu_torch.loadgen.population as tpopulation
import upow_tpu_torch.loadgen.runner as trunner
import upow_tpu_torch.telemetry as ttelemetry
import upow_tpu_torch.telemetry.exposition as texposition

PKGS = {
    "jax": SimpleNamespace(gate=jgate, population=jpopulation,
                           runner=jrunner, observatory=jobservatory,
                           telemetry=jtelemetry, exposition=jexposition),
    "port": SimpleNamespace(gate=tgate, population=tpopulation,
                            runner=trunner, observatory=tobservatory,
                            telemetry=ttelemetry, exposition=texposition),
}
both = pytest.mark.parametrize("pkg", ["jax", "port"])


@pytest.fixture(autouse=True)
def clean_telemetry():
    for p in PKGS.values():
        p.telemetry.reset()
    yield
    for p in PKGS.values():
        p.telemetry.reset()
        p.telemetry.configure()


def _specs(population):
    spec = population.PopulationSpec
    return [spec.smoke(), spec.smoke(seed=0xDEAD), spec(),
            spec(seed=3, duration=4.0, n_readers=8, zipf_s=2.0),
            spec(seed=11, n_ws=0, push_bursts=1, burst_size=3,
                 n_miners=0)]


def _events(events):
    return [(e.at, e.seq, e.kind, e.params, e.endpoint) for e in events]


# ------------------------------------------------------ determinism ----

def test_schedules_and_fingerprints_match_jax():
    for jspec, tspec in zip(_specs(jpopulation), _specs(tpopulation)):
        assert tspec.to_dict() == jspec.to_dict()
        jev = jpopulation.build_schedule(jspec)
        tev = tpopulation.build_schedule(tspec)
        assert _events(tev) == _events(jev)
        assert tpopulation.schedule_fingerprint(tev) == \
            jpopulation.schedule_fingerprint(jev)
        assert tpopulation.wallet_universe(tspec) == \
            jpopulation.wallet_universe(jspec)
    assert tpopulation.zipf_cdf(64, 1.3) == jpopulation.zipf_cdf(64, 1.3)
    assert tpopulation.ENDPOINTS == jpopulation.ENDPOINTS


@both
def test_schedule_deterministic(pkg):
    pop = PKGS[pkg].population
    a = pop.build_schedule(pop.PopulationSpec.smoke())
    b = pop.build_schedule(pop.PopulationSpec.smoke())
    assert pop.schedule_fingerprint(a) == pop.schedule_fingerprint(b)
    assert [e.at for e in a] == sorted(e.at for e in a)
    c = pop.build_schedule(pop.PopulationSpec.smoke(seed=0xDEAD))
    assert pop.schedule_fingerprint(a) != pop.schedule_fingerprint(c)


@both
def test_schedule_covers_all_actor_streams(pkg):
    pop = PKGS[pkg].population
    kinds = {e.kind for e in pop.build_schedule(pop.PopulationSpec.smoke())}
    assert {"balance", "mining_info", "push_tx",
            "ws_connect", "ws_ping", "ws_close"} <= kinds


@both
def test_push_bursts_share_timestamp(pkg):
    pop = PKGS[pkg].population
    spec = pop.PopulationSpec.smoke()
    bursts = {}
    for e in pop.build_schedule(spec):
        if e.kind == "push_tx":
            bursts.setdefault(e.at, []).append(e)
    assert len(bursts) == spec.push_bursts
    assert all(len(v) == spec.burst_size for v in bursts.values())


@both
def test_zipf_read_skew(pkg):
    pop = PKGS[pkg].population
    spec = pop.PopulationSpec(duration=4.0, n_readers=8)
    hits = {}
    for e in pop.build_schedule(spec):
        w = e.param("wallet")
        if w is not None:
            hits[w] = hits.get(w, 0) + 1
    assert hits.get(0, 0) > hits.get(spec.n_wallets - 1, 0)
    assert hits.get(0, 0) >= max(hits.values()) * 0.5


def test_mock_summaries_match_jax():
    """The mock backend's summary is a pure function of the spec: equal
    on both packages (wall time apart), with the SLO histograms fed."""
    for jspec, tspec in zip(_specs(jpopulation), _specs(tpopulation)):
        jsum = jrunner.run_mock(jspec, record_slo=False)
        tsum = trunner.run_mock(tspec, record_slo=False)
        jsum.pop("wall_s"), tsum.pop("wall_s")
        assert tsum == jsum
    trunner.run_mock(tpopulation.PopulationSpec.smoke(), record_slo=True)
    jrunner.run_mock(jpopulation.PopulationSpec.smoke(), record_slo=True)
    assert ttelemetry.metrics.histograms() == jtelemetry.metrics.histograms()


@both
def test_mock_summary_deterministic(pkg):
    run = PKGS[pkg].runner.run_mock
    spec = PKGS[pkg].population.PopulationSpec.smoke()
    s1, s2 = run(spec, record_slo=False), run(spec, record_slo=False)
    s1.pop("wall_s"), s2.pop("wall_s")
    assert s1 == s2
    assert s1["endpoints"]["push_tx"]["requests"] == 16


@both
def test_runner_survives_executor_crash(pkg):
    p = PKGS[pkg]
    events = p.population.build_schedule(p.population.PopulationSpec.smoke())

    async def boom(ev):
        raise RuntimeError("injected")

    results = asyncio.run(p.runner.run_schedule(events, boom))
    assert len(results) == len(events)
    assert all(r.status == 599 and not r.ok for r in results)


@pytest.mark.parametrize("seed", [0, 5, 17])
def test_summarize_latencies_matches_jax(seed):
    rng = random.Random(seed)
    for n in (1, 2, 7, 100, 1000):
        vals = [rng.expovariate(50.0) for _ in range(n)]
        assert trunner.summarize_latencies(vals) == \
            jrunner.summarize_latencies(vals)


@both
def test_slo_exposition_valid(pkg):
    p = PKGS[pkg]
    p.runner.run_mock(p.population.PopulationSpec.smoke(), record_slo=True)
    e = p.exposition.Exposition()
    for name, h in p.telemetry.metrics.histograms().items():
        e.histogram(name, h["bounds"], h["counts"], h["count"], h["sum"])
    text = e.render()
    assert "upow_slo_http_push_tx_latency_seconds_bucket" in text
    assert p.exposition.validate(text) == []
    lines = [ln for ln in text.splitlines() if "push_tx" in ln]
    inf = next(ln for ln in lines if 'le="+Inf"' in ln)
    count = next(ln for ln in lines if ln.startswith(
        "upow_slo_http_push_tx_latency_seconds_count"))
    assert inf.rsplit(" ", 1)[1] == count.rsplit(" ", 1)[1] != "0"


@both
def test_mock_backend_feeds_slo_registry(pkg):
    p = PKGS[pkg]
    asyncio.run(p.runner.MockBackend(seed=7)(
        p.population.build_schedule(p.population.PopulationSpec.smoke())[0]))
    assert any(n.startswith("slo.http.")
               for n in p.telemetry.metrics.histograms())


# -------------------------------------------------- regression gate ----

def _artifact(p95=10.0, req_s=100.0, kernel=5.0):
    return {"kind": "perf_observatory",
            "slo": {"endpoints": {"push_tx": {
                "req_s": req_s, "p50_ms": p95 / 2, "p95_ms": p95,
                "p99_ms": p95 * 1.2}}},
            "kernels": {"search_python_loop":
                        {"value": kernel, "unit": "MH/s"}}}


def _write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def _gate_runs(tmp_path):
    """Every gate invocation of JAX test_loadgen.py's gate cases, on the
    artifacts they write."""
    base = _write(tmp_path, "base.json", _artifact())
    slow = _write(tmp_path, "slow.json", _artifact(p95=20.0))
    weak = _write(tmp_path, "weak.json", _artifact(kernel=1.0))
    near = _write(tmp_path, "near.json", _artifact(p95=11.0))
    fast = _write(tmp_path, "fast.json",
                  _artifact(p95=1.0, req_s=900.0, kernel=50.0))
    both_bad = _write(tmp_path, "both.json", _artifact(p95=20.0, kernel=1.0))
    tight = _write(tmp_path, "tight.json", _artifact(kernel=4.5))
    wrapper = {"n": 5, "cmd": "python bench.py", "rc": 0, "tail": "...",
               "parsed": {"metric": "sha256_pow_search_native_cpu",
                          "value": 16.5, "unit": "MH/s",
                          "verify": {"metric": "verify_batch_native_cpu",
                                     "value": 3531.0}}}
    wb = _write(tmp_path, "wb.json", wrapper)
    wc = _write(tmp_path, "wc.json",
                dict(wrapper, parsed=dict(wrapper["parsed"], value=1.0)))
    empty = _write(tmp_path, "empty.json", {"kind": "nothing"})
    return [
        (["--against", base, "--current", slow], 1),
        (["--against", base, "--current", weak], 1),
        (["--against", base, "--current", near], 0),
        (["--against", base, "--current", fast], 0),
        (["--against", base, "--current", slow, "--report-only"], 0),
        (["--against", base, "--current", slow, "--tolerance", "2.0"], 0),
        (["--against", base, "--current", both_bad, "--report-only"], 0),
        (["--against", base, "--current", both_bad, "--report-only",
          "--enforce", "kernel.search_"], 1),
        (["--against", base, "--current", both_bad, "--report-only",
          "--enforce", "kernel.search_", "--metric-tolerance",
          "kernel.search_python_loop=0.9"], 0),
        (["--against", base, "--current", tight, "--report-only",
          "--enforce", "kernel.search_", "--metric-tolerance",
          "kernel.search_python_loop=0.05"], 1),
        (["--against", base, "--current", slow, "--metric-tolerance",
          "oops"], 2),
        (["--against", base, "--current", slow, "--metric-tolerance",
          "x=nan?"], 2),
        (["--against", wb, "--current", wc], 1),
        (["--against", str(tmp_path / "nope.json"), "--current", base], 2),
        (["--against", base, "--current", empty], 2),
    ]


def test_gate_main_matches_jax(tmp_path, capsys):
    """Exit codes and both streams of every invocation, equal."""
    for argv, rc in _gate_runs(tmp_path):
        got = {}
        for pkg in ("jax", "port"):
            code = PKGS[pkg].gate.main(argv)
            got[pkg] = (code,) + tuple(capsys.readouterr())
        assert got["port"] == got["jax"], argv
        assert got["port"][0] == rc, (argv, got["port"])


@both
def test_gate_verdicts(pkg, tmp_path, capsys):
    gate = PKGS[pkg].gate
    base = _write(tmp_path, "base.json", _artifact())
    cur = _write(tmp_path, "cur.json", _artifact(p95=20.0))
    assert gate.main(["--against", base, "--current", cur]) == 1
    report = json.loads(capsys.readouterr().out)
    regressed = {r["metric"] for r in report["verdicts"] if r["regressed"]}
    assert "slo.push_tx.p95_ms" in regressed
    assert "slo.push_tx.req_s" not in regressed


def test_gate_flatten_and_compare_match_jax(tmp_path):
    docs = [_artifact(), _artifact(p95=20.0, kernel=1.0),
            {"parsed": {"metric": "a_rate", "value": 3,
                        "direction": "lower",
                        "native_cpu_allcores": {"value": 9.0}}},
            {"kernels": {"last_good_tpu": {"value": 1.0},
                         "x_ms": {"value": 2.0, "direction": "higher"},
                         "flag": True, "plain": 4}},
            {"metric": "b", "value": True}, []]
    for doc in docs:
        jd, td = {}, {}
        assert tgate.flatten(doc, directions=td) == \
            jgate.flatten(doc, directions=jd)
        assert td == jd
    base, cur = (tgate.flatten(_artifact()),
                 tgate.flatten(_artifact(p95=20.0, req_s=10.0, kernel=0.0)))
    for tol, over in ((0.25, None), (2.0, {"slo.push_tx.p95_ms": 0.1})):
        assert tgate.compare(base, cur, tol, {"kernel.x": "lower"}, over) \
            == jgate.compare(base, cur, tol, {"kernel.x": "lower"}, over)
    zero = {"a_ms": 0.0, "b_rate": 0.0}
    assert tgate.compare(zero, {"a_ms": 1.0, "b_rate": 1.0}, 0.25) == \
        jgate.compare(zero, {"a_ms": 1.0, "b_rate": 1.0}, 0.25)
    path = tmp_path / "suite.jsonl"
    path.write_text('noise line\n'
                    '{"metric": "a_rate", "value": 10, "unit": "x"}\n'
                    '{"metric": "b_ms", "value": 5, "unit": "ms"}\n')
    assert tgate.load_metrics(str(path)) == jgate.load_metrics(str(path)) \
        == {"a_rate": 10.0, "b_ms": 5.0}
    for name in ("slo.push_tx.p95_ms", "intake_latency_seconds",
                 "sha256_pow_search_native_cpu", "kernel.verify_python",
                 "dispatch_errors"):
        assert tgate.lower_is_better(name) == jgate.lower_is_better(name)


def test_gate_trend_matches_jax(tmp_path, capsys):
    """JAX test_fleet.py's trend case: only perf_observatory lines,
    direction-aware trends; equal reports and equal stderr lines."""
    lines = [
        {"ts": 1, "kind": "driver", "round": 1, "loc": 10},
        {"kind": "perf_observatory",
         "slo": {"push_tx": {"req_s": 100.0, "p95_ms": 20.0}},
         "kernels": {"fleet_core_ok": 1.0, "verify_python": 100.0}},
        "not json at all",
        {"kind": "perf_observatory",
         "slo": {"push_tx": {"req_s": 150.0, "p95_ms": 30.0}},
         "kernels": {"fleet_core_ok": 1.0, "verify_python": 50.0,
                     "zero_ms": 0.0}},
        {"kind": "perf_observatory",
         "slo": {"push_tx": {"req_s": 151.0, "p95_ms": 30.1}},
         "kernels": {"zero_ms": 2.0, "last_good_tpu": 9.0}},
    ]
    path = tmp_path / "PROGRESS.jsonl"
    path.write_text("".join(
        (ln if isinstance(ln, str) else json.dumps(ln)) + "\n"
        for ln in lines))
    report = tgate.trend_report(str(path))
    assert report == jgate.trend_report(str(path))
    rows = {r["metric"]: r for r in report["metrics"]}
    assert "kernel.loc" not in rows
    assert rows["slo.push_tx.req_s"]["trend"] == "improving"
    assert rows["slo.push_tx.p95_ms"]["trend"] == "regressing"
    assert rows["kernel.verify_python"]["trend"] == "regressing"
    assert rows["kernel.fleet_core_ok"]["trend"] == "flat"
    outs = []
    for gate in (jgate, tgate):
        assert gate.main(["--trend", str(path)]) == 0
        outs.append(capsys.readouterr())
    assert outs[1] == outs[0]
    assert tgate.main(["--trend", str(tmp_path / "missing.jsonl")]) == 2


# ----------------------------------------------------------- artifacts ----

def test_write_artifact_and_progress_line_match_jax(tmp_path):
    art = {"kind": "perf_observatory",
           "slo": {"endpoints": {"push_tx": {"req_s": 3.0, "p50_ms": 1.0,
                                             "p95_ms": 2.0, "p99_ms": 3.0,
                                             "errors": 0}}},
           "kernels": {"a": {"value": 1.5, "unit": "x"}, "b": "skip"},
           "provenance": {"backend": "cpu"}}
    for name, pkg in PKGS.items():
        pkg.observatory.write_artifact(art, str(tmp_path / f"{name}.json"))
        pkg.observatory.append_progress(art, str(tmp_path / f"{name}.jsonl"))
        pkg.observatory.append_progress(art, str(tmp_path / f"{name}.jsonl"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text()) == art
    got = [[{k: v for k, v in json.loads(ln).items() if k != "ts"}
            for ln in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
           for n in ("jax", "port")]
    assert got[1] == got[0] and len(got[1]) == 2
    assert got[1][0]["kernels"] == {"a": 1.5}
    assert tgate.trend_report(str(tmp_path / "port.jsonl"))[
        "observatory_lines"] == 2
