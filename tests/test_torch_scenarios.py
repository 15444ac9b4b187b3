"""The port's swarm scenarios, registry and runner against the JAX
package's.

Every registered scenario runs at seed 7 on both packages (the port's
nodes on ``device="cpu"``): the fingerprints and cores must be equal (an
exact sha256, no tolerance), and so must the flight recorder's reason and
the keys of the ``slo`` endpoint rows (their values are wall time); the
fast matrices' chained fingerprints must be equal too.  JAX
``tests/test_swarm.py``'s scenario cases (and its two wide ones, which
take seconds here) run on both packages with equal fingerprints.  (The
device backends on the CPU are ``test_torch_scenarios_device.py``.)
Last, the swarm's device (C6):
with no ``device`` a swarm, ``run_scenario`` and ``run_matrix`` resolve
the card and raise without one, and ``python -m upow_tpu_torch.swarm
--device cpu`` prints the JAX CLI's lines.
"""

import functools
import os
import re
import subprocess
import sys

import pytest
import torch

import upow_tpu.swarm.scenarios as jsc
import upow_tpu_torch.swarm.scenarios as tsc
from upow_tpu_torch.swarm import Swarm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jsc, {}), "port": (tsc, {"device": "cpu"})}
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="pins the no-card error")


@functools.lru_cache(maxsize=None)
def _run(pkg: str, name: str, seed: int, nodes=None) -> dict:
    """One scenario artifact of one package, run once in this process."""
    mod, kw = PKGS[pkg]
    return mod.run_scenario(name, nodes=nodes, seed=seed, **kw)


@pytest.fixture(scope="module")
def matrices():
    return {pkg: mod.run_matrix("fast", seed=7, **kw)
            for pkg, (mod, kw) in PKGS.items()}


def _recorder_reason(art: dict):
    return art.get("flight_recorder", {}).get("reason")


# ------------------------------------------------------------ registry ----

def test_registry_matches_jax():
    assert sorted(tsc.SCENARIOS) == sorted(jsc.SCENARIOS)
    assert len(tsc.SCENARIOS) == 10
    for name, jspec in jsc.SCENARIOS.items():
        tspec = tsc.SCENARIOS[name]
        assert tspec.fn.__name__ == jspec.fn.__name__
        assert (tspec.nodes, tspec.fast, tspec.topology,
                tspec.p99_budget_ms) == (jspec.nodes, jspec.fast,
                                         jspec.topology, jspec.p99_budget_ms)
        assert set(tspec.swarm_kwargs) == set(jspec.swarm_kwargs)
        hook = jspec.swarm_kwargs.get("cfg_hook")
        if hook is not None:
            assert tspec.swarm_kwargs["cfg_hook"].__name__ == hook.__name__
    assert tsc.BREAKER_REOPEN_PAUSE == jsc.BREAKER_REOPEN_PAUSE
    assert tsc.GENESIS_EPOCH == jsc.GENESIS_EPOCH


# ------------------------------------------------------------- seed 7 ----

@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_scenario_matches_jax_at_seed_7(matrices, name):
    jart, tart = ({r["scenario"]: r for r in matrices[p]["runs"]}[name]
                  for p in ("jax", "port"))
    assert tsc.core_ok(tart["core"]), {
        k: v for k, v in tart["core"].items()
        if isinstance(v, bool) and not v}
    assert tart["core"] == jart["core"]
    assert tart["fingerprint"] == jart["fingerprint"]
    assert tart["fingerprint"] == tsc.artifact_fingerprint(tart["core"])
    assert _recorder_reason(tart) == _recorder_reason(jart)
    assert set(tart["slo"]["endpoints"]) == set(jart["slo"]["endpoints"])
    for row in tart["slo"]["endpoints"].values():
        assert set(row) == {"requests", "p50_ms", "p95_ms", "p99_ms"}
    assert (tart["kind"], tart["nodes"], tart["seed"]) == \
        (jart["kind"], jart["nodes"], jart["seed"])


def test_fast_matrix_chain_matches_jax(matrices):
    jm, tm = matrices["jax"], matrices["port"]
    assert tm["scenarios"] == jm["scenarios"] == sorted(jsc.SCENARIOS)
    assert tm["fingerprint"] == jm["fingerprint"]
    assert {k: v for k, v in tm.items() if k != "runs"} == \
        {k: v for k, v in jm.items() if k != "runs"}


# ------------------------------------------ JAX test_swarm.py's cases ----

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_partition_heal_scenario(pkg):
    art = _run(pkg, "partition_heal", 5)
    core = art["core"]
    assert core["diverged_during_partition"]
    assert core["converged_after_heal"]
    assert core["final_height"] == 7
    assert core["losers_reorged"]
    assert core["loser_caches_invalidated"]
    assert core["reorgs_share_heal_trace"]
    assert core["trace_spans_nodes"]
    assert core["breakers_flipped_during_partition"]
    assert any(k.startswith("swarm.partition_heal.node")
               for k in art["slo"]["endpoints"])
    assert art["fingerprint"] == _run("jax", "partition_heal", 5)[
        "fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_eclipse_scenario_recovers_via_health_ranking(pkg):
    art = _run(pkg, "eclipse", 5)
    core = art["core"]
    assert core["eclipsed"]
    assert core["adversary_served_calls"]
    assert core["recovered"]
    assert core["honest_ranked_first"]
    assert core["adversaries_scored_below_honest"]
    assert art["fingerprint"] == _run("jax", "eclipse", 5)["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ws_churn_scenario_sheds_only_the_stalled_client(pkg):
    art = _run(pkg, "ws_churn", 5)
    core = art["core"]
    assert core["live_client_delivered"] == 8
    assert core["dropped_messages"] == 3
    assert core["slow_client_delivered"] == 5
    assert core["metrics_export_dropped"]
    assert art["fingerprint"] == _run("jax", "ws_churn", 5)["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_spam_scenario_pools_stay_clean(pkg):
    art = _run(pkg, "spam", 5)
    core = art["core"]
    assert core["spam_accepted"] == 0
    assert core["pools_clean"]
    assert core["tx_confirmed_everywhere"]
    assert core["converged"]
    assert art["fingerprint"] == _run("jax", "spam", 5)["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_artifact_fingerprint_determinism(pkg):
    """Same seed: the same fingerprint (a fresh run, not the cached
    one); another seed: another chain, another fingerprint."""
    mod, kw = PKGS[pkg]
    first = _run(pkg, "spam", 9)
    again = mod.run_scenario("spam", seed=9, **kw)
    other = _run(pkg, "spam", 10)
    assert first["fingerprint"] == again["fingerprint"]
    assert first["core"] == again["core"]
    assert first["fingerprint"] != other["fingerprint"]
    assert first["core"]["final_tip"] != other["core"]["final_tip"]
    assert other["fingerprint"] == _run("jax", "spam", 10)["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_wallets_are_seed_deterministic(pkg):
    mod = PKGS[pkg][0]
    assert mod._wallet(7, "x") == mod._wallet(7, "x")
    assert mod._wallet(7, "x") != mod._wallet(8, "x")
    assert mod._wallet(7, "x") != mod._wallet(7, "y")
    assert mod._wallet(7, "x") == jsc._wallet(7, "x")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_partition_heal_50_nodes(pkg):
    """The upper end of the 10-50 node envelope (a slow case of the JAX
    suite; a few seconds on either package here)."""
    art = _run(pkg, "partition_heal", 3, nodes=50)
    core = art["core"]
    assert core["converged_after_heal"]
    assert core["losers_reorged"]
    assert core["trace_spans_nodes"]
    assert art["fingerprint"] == _run("jax", "partition_heal", 3,
                                      nodes=50)["fingerprint"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reorg_storm_long_partition(pkg):
    art = _run(pkg, "reorg_storm", 3, nodes=12)
    assert art["core"]["all_converged"]
    assert art["core"]["reorged_every_cycle"]
    assert art["fingerprint"] == _run("jax", "reorg_storm", 3,
                                      nodes=12)["fingerprint"]


# ------------------------------------------------- the swarm's device ----

@NO_CARD
def test_swarm_resolves_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        Swarm(3)
    assert Swarm(3, device="cpu").device == torch.device("cpu")


@NO_CARD
def test_run_scenario_with_no_device_raises_without_a_card():
    """C6: the swarm's nodes were built on ``device="cpu"`` whatever the
    caller asked; ``run_scenario("ws_churn")`` ran on the host."""
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tsc.run_scenario("ws_churn")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tsc.run_matrix("fast")


def test_swarm_nodes_run_on_the_swarm_device():
    import asyncio

    async def main():
        swarm = await Swarm(2, device="cpu").start()
        try:
            return [node.device for node in swarm.nodes]
        finally:
            await swarm.close()

    with tsc.deterministic_world(0):
        assert asyncio.run(main()) == [torch.device("cpu")] * 2


# ----------------------------------------------------------------- CLI ----

_ELAPSED = re.compile(r" \d+\.\d\ds fp=")


def _cli(*runs) -> list:
    """Run each ``[module, *args]`` as ``python -m`` at once; their
    (returncode, stdout, stderr) in order."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in runs]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        out.append(subprocess.CompletedProcess(p.args, p.returncode,
                                               stdout, stderr))
    return out


def test_cli_matrix_prints_the_jax_lines():
    """``--matrix fast --device cpu`` exits 0 with the JAX CLI's lines
    (each scenario's wall time apart) and its matrix fingerprint."""
    jax_run, port = _cli(
        ["upow_tpu.swarm", "--matrix", "fast"],
        ["upow_tpu_torch.swarm", "--matrix", "fast", "--device", "cpu"])
    assert jax_run.returncode == port.returncode == 0, port.stderr
    lines = [_ELAPSED.sub(" Xs fp=", out.stdout).splitlines()
             for out in (jax_run, port)]
    assert lines[1] == lines[0]
    assert len(lines[1]) == 11 and lines[1][-1].startswith(
        '{"kind": "swarm_matrix", "fingerprint": ')


@NO_CARD
def test_cli_without_device_names_the_missing_card():
    out, = _cli(["upow_tpu_torch.swarm", "--scenario", "ws_churn"])
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert out.stdout == ""
