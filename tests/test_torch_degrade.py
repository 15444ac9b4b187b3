"""The port's degrade of the verify device path
(``upow_tpu_torch/resilience/degrade.py``, ``verify/txverify.py``)
against the JAX package's, on the CPU.

* The state machine: the cases of ``tests/test_resilience.py`` (error,
  cooldown and recovery; a failed re-probe benching again; a poison that
  lasts), each step run on both packages' managers with one fake clock,
  their states, gates and snapshots compared, and the JAX counter names
  in the port's ``trace``.
* A hang: ``device.verify:hang`` past the boxed call's deadline poisons
  the device path in both packages, the batch is served on the host with
  the JAX verdicts, and later batches never reach the device.
* The chaos case of ``tests/test_chaos.py``: the port's node and the JAX
  node, each under ``device.verify:error:times=2`` with
  ``device_failure_limit = 2``, give the same HTTP bodies to the same
  ``push_tx`` and ``push_block`` sequence (two failures served on the
  host, the degraded state serving a third, the cooldown's re-probe
  recovering, a bad signature still rejected) and end on the same UTXO
  hash; the port's ``/metrics`` shows the degrade
  (``device_verify_health``, ``resilience_device_error_total``).  The JAX node's device
  kernel is its host math (as in the JAX chaos test: its XLA compile
  would take minutes here); the port's re-probe runs the plain PyTorch
  verify.
* The departures, on a card: a device batch that fails is recorded and
  raised, a dispatch the degrade blocks raises ``DeviceBlocked``, and the
  cooldown's re-probe launches the kernel again; nothing is served on
  the host (the card's rule run on the plain version, ``host_may_serve``
  answering as for a card).  A CUDA runtime whose kernel build fails
  raises ``ArmError`` with the reason recorded, and no signature batch
  is served on the host in its place.
"""

import asyncio
import hashlib
import shutil
import time

import aiohttp
import pytest
import torch
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu_torch.node.app as tapp
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_node import (Pair, _build_chain, _configs, _corrupt,  # noqa: F401
                             easy_chain)
from upow_tpu import trace as jtrace
from upow_tpu.crypto import p256 as jp256
from upow_tpu.device import runtime as jruntime
from upow_tpu.resilience import faultinject as jfaultinject
from upow_tpu.resilience.degrade import DegradeManager as JDegradeManager
from upow_tpu.verify import txverify as jtxverify
from upow_tpu_torch import _build, trace
from upow_tpu_torch.core import curve
from upow_tpu_torch.device import runtime as truntime
from upow_tpu_torch.resilience import faultinject
from upow_tpu_torch.resilience.degrade import DegradeManager, DeviceBlocked
from upow_tpu_torch.telemetry import exposition
from upow_tpu_torch.verify import txverify

COMMON = ("state", "consecutive_failures", "cooldown", "failure_limit")


@pytest.fixture(autouse=True)
def clean_degrade(monkeypatch):
    """Fresh managers in both packages, no injector, fresh runtimes."""
    monkeypatch.setattr(jtxverify, "DEGRADE", JDegradeManager())
    txverify.DEGRADE.reset()
    txverify.DEGRADE.configure(3, 60.0)
    txverify.clear_sig_verdicts()
    jtxverify.clear_sig_verdicts()
    yield
    faultinject.uninstall()
    jfaultinject.uninstall()
    txverify.DEGRADE.reset()
    txverify.DEGRADE.configure(3, 60.0)
    txverify.clear_sig_verdicts()
    jtxverify.clear_sig_verdicts()
    truntime.reset_runtime()
    jruntime.reset_runtime()


class Twins:
    """One call on the port's manager and the JAX one, with one clock."""

    def __init__(self, failure_limit, cooldown):
        self.t = [0.0]
        clock = lambda: self.t[0]  # noqa: E731
        self.port = DegradeManager(failure_limit, cooldown, clock=clock)
        self.jax = JDegradeManager(failure_limit, cooldown, clock=clock)

    def __call__(self, name, *args):
        got = getattr(self.port, name)(*args)
        want = getattr(self.jax, name)(*args)
        assert got == want, name
        snap = self.port.snapshot()
        assert {k: snap[k] for k in COMMON} == self.jax.snapshot()
        return got


def test_degrade_cycle_error_cooldown_recovery():
    m = Twins(failure_limit=2, cooldown=60.0)
    trace.reset()
    jtrace.reset()
    assert m("allow") and m.port.state == "ok"
    m("record_failure", RuntimeError("launch"))
    assert m.port.state == "ok"                   # below the limit
    m("record_failure", RuntimeError("launch"))
    assert m.port.state == "degraded"
    assert not m("allow")                         # benched: host serves
    m.t[0] = 59.0
    assert not m("allow")
    m.t[0] = 61.0
    assert m("allow")                             # cooldown: re-probe
    assert m("allow")                             # in-flight probe flows
    m("record_success")
    assert m.port.state == "ok" and m("state_gauge") == 0
    counters = trace.counters()
    for name, value in (("resilience.device_degraded", 1),
                        ("resilience.device_reprobe", 1),
                        ("resilience.device_recovered", 1),
                        ("resilience.device_error", 2)):
        assert counters[name] == jtrace.counters()[name] == value, name
    assert counters["resilience.device_fallback"] == \
        jtrace.counters()["resilience.device_fallback"] >= 2
    snap = m.port.snapshot()
    assert snap["errors"] == 2 and "launch" in snap["last_error"]


def test_degrade_failed_probe_rebenches():
    m = Twins(failure_limit=1, cooldown=10.0)
    m("record_failure")
    assert m.port.state == "degraded"
    m.t[0] = 11.0
    assert m("allow")
    m("record_failure")                           # the probe failed
    assert m.port.state == "degraded"
    assert not m("allow")                         # a new cooldown from 11
    m.t[0] = 20.0
    assert not m("allow")
    m.t[0] = 21.5
    assert m("allow")


def test_degrade_poison_is_permanent():
    m = Twins(failure_limit=3, cooldown=1.0)
    m("poison", "hang")
    assert m.port.state == "poisoned" and m("state_gauge") == 2
    m.t[0] = 1e9
    assert not m("allow")                         # no cooldown out of it
    m("record_success")
    assert m.port.state == "poisoned"
    assert m.port.snapshot()["last_error"] == "hang"
    m.port.reset()
    assert m.port.state == "ok" and m.port.snapshot()["errors"] == 0


def _checks(n: int = 6):
    d, pub = curve.keygen(rng=4711)
    out = []
    for i in range(n):
        m = bytes([i]) * 9
        r, s = curve.sign(m, d)
        if i == 2:
            s += 1
        out.append((hashlib.sha256(m).digest(),
                    hashlib.sha256(m.hex().encode()).digest(), (r, s), pub))
    return out


def test_device_hang_poisons_and_the_host_serves(monkeypatch):
    checks = _checks()
    monkeypatch.setattr(
        jp256, "verify_batch_prehashed",
        lambda digests, sigs, pubs, **kw: [
            jtxverify._host_verify_digest(*c) for c in zip(digests, sigs,
                                                            pubs)])
    spec = "device.verify:hang:times=1,delay=1.5"
    faultinject.install(spec, seed=3)
    jfaultinject.install(spec, seed=3)
    trace.reset()
    got = txverify.run_sig_checks(checks, backend="device", device="cpu",
                                  use_cache=False, device_timeout=0.2)
    want = jtxverify.run_sig_checks(checks, backend="device",
                                    use_cache=False, device_timeout=0.2)
    assert got == want == [True, True, False, True, True, True]
    assert txverify.DEGRADE.state == jtxverify.DEGRADE.state == "poisoned"
    assert trace.counters()["resilience.device_poisoned"] == 1

    def no_device(*_a, **_k):
        raise AssertionError("a poisoned path reached the device")

    monkeypatch.setattr(txverify, "_device_batch", no_device)
    assert txverify.run_sig_checks(checks, backend="device", device="cpu",
                                   use_cache=False) == want


def test_device_failure_host_fallback_then_recovery_like_jax(
        tmp_path, monkeypatch):
    leaves = _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    jcfg, tcfg = _configs(tmp_path, "jac")
    for cfg in (jcfg, tcfg):
        cfg.device.sig_backend = "device"
        cfg.resilience.device_failure_limit = 2
        cfg.resilience.device_cooldown = 0.5
        cfg.resilience.faults = "device.verify:error:times=2"
        cfg.resilience.faults_seed = 11
    monkeypatch.setattr(
        jp256, "verify_batch_prehashed",
        lambda digests, sigs, pubs, **kw: [
            jtxverify._host_verify_digest(*c) for c in zip(digests, sigs,
                                                            pubs)])
    states = []

    async def main():
        jnode = japp.Node(jcfg)
        jnode.started = True
        tnode = tapp.Node(tcfg, device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        chain = Chain(PORT, tnode.state)
        txs = [chain.spend([leaf]) for leaf in leaves[:5]]
        trace.reset()
        jtrace.reset()
        try:
            async with aiohttp.ClientSession() as session:
                pair = Pair(session, f"http://127.0.0.1:{server.port}",
                            f"http://127.0.0.1:{tserver.port}")
                replies = []
                for i, tx in enumerate(txs[:3]):
                    replies.append(await pair.both(
                        "POST", "/push_tx", {"tx_hex": tx.hex()}))
                    states.append((txverify.DEGRADE.state,
                                   jtxverify.DEGRADE.state))
                await asyncio.sleep(0.6)                    # the cooldown
                replies.append(await pair.both(
                    "POST", "/push_tx", {"tx_hex": txs[3].hex()}))
                states.append((txverify.DEGRADE.state,
                               jtxverify.DEGRADE.state))
                replies.append(await pair.both(
                    "POST", "/push_tx", {"tx_hex": _corrupt(txs[4]).hex()}))
                async with session.get(pair.turl + "/metrics") as r:
                    scrape = exposition.samples(await r.text())
                health = {**txverify.DEGRADE.snapshot(),
                          "gauge": scrape["upow_device_verify_health"],
                          "errors_total": scrape[
                              "upow_resilience_device_error_total"]}
                PORT.clock.advance(60)
                JAX.clock.advance(60)
                info = (await pair.both("GET", "/get_mining_info"))["result"]
                from upow_tpu_torch.mine import engine as tengine
                from upow_tpu_torch.mine import miner as tminer

                job, hashes, block_no = tminer.build_job(info, chain.addr)
                mined = tengine.mine(job, "native", batch=1 << 14)
                replies.append(await pair.both("POST", "/push_block", {
                    "block_content": job.block_content(mined.nonce),
                    "txs": hashes, "block_no": block_no}))
                utxo = (await tnode.state.get_unspent_outputs_hash(),
                        await jnode.state.get_unspent_outputs_hash())
            return replies, health, utxo
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()

    replies, health, utxo = asyncio.run(main())
    assert [r["ok"] for r in replies] == [True] * 4 + [False, True]
    assert states == [("ok", "ok"), ("degraded", "degraded"),
                      ("degraded", "degraded"), ("ok", "ok")]
    assert utxo[0] == utxo[1]
    counters, jcounters = trace.counters(), jtrace.counters()
    for name in ("resilience.device_error", "resilience.device_degraded",
                 "resilience.device_reprobe", "resilience.device_recovered",
                 "resilience.faults_injected"):
        assert counters.get(name) == jcounters.get(name), name
    assert counters["resilience.device_error"] == 2
    assert counters["resilience.device_fallback"] >= 1
    assert health["state"] == "ok" and health["errors"] == 2
    assert health["gauge"] == 0 and health["errors_total"] == 2
    assert health["failure_limit"] == 2 and health["cooldown"] == 0.5


def test_cuda_arm_build_failure_raises_and_records(monkeypatch):
    """The departure from the JAX runtime: an arm that fails on a card
    raises ArmError with the build's error as its recorded reason, and a
    signature batch for that card fails with it, never served on the
    host."""
    def broken(*_a, **_k):
        raise RuntimeError("nvcc failed for p256_verify: error: bad opcode")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build_all", broken)
    monkeypatch.setattr(txverify, "_host_batch", lambda *a: pytest.fail(
        "a failed arm was served on the host"))
    rt = truntime.get_runtime("cuda")
    with pytest.raises(truntime.ArmError, match="nvcc failed"):
        rt.arm()
    reason = rt.stats()["arm"]["arm_failure_reason"]
    assert reason.startswith("RuntimeError: nvcc failed for p256_verify")
    assert truntime.arm_failure_reason() == reason
    with pytest.raises(truntime.ArmError, match="nvcc failed"):
        txverify.run_sig_checks(_checks(8), backend="auto", device="cuda")
    with pytest.raises(truntime.ArmError, match="nvcc failed"):
        rt.submit_sig_checks(_checks(8), source="block").result(timeout=30)
    assert txverify.DEGRADE.snapshot()["errors"] == 0


def test_card_failure_raises_blocks_then_reprobes(monkeypatch):
    """The degrade round trip of ``chip_smoke.py``'s runtime phase under
    the card's rule: three injected ``device.verify`` errors fail three
    groups and degrade the path, a fourth group and the fused scan's gate
    raise ``DeviceBlocked`` without reaching the device, and after the
    cooldown one re-probe reaches it and restores ``ok`` with the JAX
    verdicts.  The host serves nothing."""
    monkeypatch.setattr(txverify, "host_may_serve", lambda device=None: False)
    monkeypatch.setattr(txverify, "_host_batch", lambda *a: pytest.fail(
        "a card's failure was served on the host"))
    reached = []
    real = txverify._device_batch

    def spy(*a, **k):
        reached.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(txverify, "_device_batch", spy)
    txverify.DEGRADE.configure(3, 0.5)
    checks = _checks(8)
    want = jtxverify.run_sig_checks(checks, backend="host", use_cache=False)
    faultinject.install("device.verify:error:times=3", seed=12)
    trace.reset()
    rt = truntime.get_runtime("cpu")
    states = []
    for _ in range(3):
        fut = rt.submit_sig_checks(checks, backend="device", source="block")
        with pytest.raises(faultinject.FaultInjected):
            fut.result(timeout=60)
        states.append(txverify.DEGRADE.state)
    assert states == ["ok", "ok", "degraded"] and len(reached) == 3
    fut = rt.submit_sig_checks(checks, backend="device", source="block")
    with pytest.raises(DeviceBlocked, match="degraded after"):
        fut.result(timeout=60)
    with pytest.raises(DeviceBlocked):
        txverify.device_verify_allowed("cpu")
    assert len(reached) == 3
    faultinject.uninstall()
    time.sleep(0.6)  # the cooldown
    got = rt.submit_sig_checks(checks, backend="device",
                               source="block").result(timeout=60)
    assert got == want and txverify.DEGRADE.state == "ok"
    assert len(reached) >= 4
    counters = trace.counters()
    assert counters["resilience.device_error"] == 3
    assert counters["resilience.device_fallback"] >= 2
    assert counters["resilience.device_reprobe"] == 1
    assert counters["resilience.device_recovered"] == 1
    snap = txverify.DEGRADE.snapshot()
    assert snap["errors"] == 3 and "injected fault" in snap["last_error"]


def test_card_runtime_fault_fails_the_group(monkeypatch):
    """An injected ``device.runtime`` fault on a card's signature group
    is recorded on the degrade and fails every submitter of the group;
    the next group is served by the device."""
    monkeypatch.setattr(txverify, "host_may_serve", lambda device=None: False)
    monkeypatch.setattr(txverify, "_host_batch", lambda *a: pytest.fail(
        "a card's failure was served on the host"))
    checks = _checks(8)
    faultinject.install("device.runtime:error:times=1", seed=5)
    rt = truntime.get_runtime("cpu")
    with rt.hold():
        futs = [rt.submit_sig_checks(checks[:4], backend="device",
                                     source="block"),
                rt.submit_sig_checks(checks[4:], backend="device",
                                     source="mempool")]
    for fut in futs:
        with pytest.raises(faultinject.FaultInjected, match="sig:block,"
                                                            "mempool"):
            fut.result(timeout=60)
    assert txverify.DEGRADE.snapshot()["consecutive_failures"] == 1
    got = rt.submit_sig_checks(checks, backend="device",
                               source="block").result(timeout=60)
    assert got == jtxverify.run_sig_checks(checks, backend="host",
                                           use_cache=False)
