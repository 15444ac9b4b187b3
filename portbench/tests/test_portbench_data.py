"""The benchmark is driven by data: a cell's configuration, traffic and
per-layer metrics are files found by name, and BENCHMARK.json keeps to
its contract."""

import json
import re

import pytest

from portbench import harness, registry
from portbench.tests import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "new_rig_d1.0.json").write_text(
        json.dumps({"kind": "solo_miner", "difficulty": "1.0"}))
    (tmp_path / "traffic" / "bursts.json").write_text(
        json.dumps({"on_s": 2, "off_s": 8}))
    (tmp_path / "metrics" / "twice_busy.py").write_text(
        "def read(obs):\n    return 2 * obs.extra['busy_s']\n")
    assert registry.config("new_rig_d1.0", tmp_path)["difficulty"] == "1.0"
    assert registry.traffic("bursts", tmp_path)["off_s"] == 8
    bench = {"per_layer": [
        {"name": "twice_busy", "unit": "s", "workloads": ["a.b"]},
        {"name": "elsewhere", "unit": "s", "workloads": ["c.d"]}]}
    obs = harness.Obs(extra={"busy_s": 1.5})
    assert harness.per_layer_values(bench, "a.b", obs, tmp_path) == {
        "twice_busy": {"value": 3.0, "unit": "s"}}


def test_a_driver_is_found_by_its_kind():
    from portbench.drivers import mining_rig, solo_miner

    assert harness.driver("solo_miner") is solo_miner.run
    assert harness.driver("mining_rig") is mining_rig.run
    with pytest.raises(ValueError):
        harness.driver("../x")
    with pytest.raises(ModuleNotFoundError):
        harness.driver("no_such_kind")


def test_a_reader_with_nothing_to_read_leaves_its_metric_out(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "silent.py").write_text(
        "def read(obs):\n    return None\n")
    bench = {"per_layer": [{"name": "silent", "unit": "%"}]}
    assert harness.per_layer_values(bench, "x.y", harness.Obs(), tmp_path) == {}


@pytest.mark.parametrize("bad", ["../x", "a/b", "", "a b", "é"])
def test_names_outside_the_alphabet_are_refused(bad):
    with pytest.raises(ValueError):
        registry.config(bad)


def test_benchmark_json_keeps_to_its_contract():
    bench = cells.bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (cells.ROOT / c["file"]).exists()
        assert callable(harness.driver(registry.config(c["name"])["kind"]))
    names = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        registry.traffic(w["traffic"])
        names.add(w["name"])
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", names)) <= names
        registry.metric_reader(m["name"])
    assert len(json.dumps(bench)) < 64 * 1024

