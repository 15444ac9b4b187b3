"""The port's device runtime (``upow_tpu_torch/device/runtime.py``) against
the JAX package's (``upow_tpu/device/runtime.py``), on the CPU.

The cases of ``tests/test_device_runtime.py``, each on the port's
runtime with ``device="cpu"``: cross-source coalescing, the coalescing
key and its cap, weighted fair share under a miner flood, no banked
credit for an idle source, the degrade choke point (a flip while items
are queued, the ``device.runtime`` fault site on a signature group and
on a boxed call), the boxed-call contract, nested submission from the
drainer, the submitter's context, the empty batch, close, the queue cap,
the trace counters, the weights' parsing and many submitting threads.
One case departs by design: where the JAX runtime serves every source on
the CPU after a failed arm, the port's CUDA runtime raises and fails
every submission with its ``ArmError``
(:func:`test_arm_failure_fails_every_submission`).

Then a scheduling differential: the same items, queued from the same
sources into a held runtime of each package, must be served in the same
order, in the same groups, in the same number of dispatches, with the
verdicts of the JAX ``run_sig_checks``.  Checks are signed from seeded
keys and numpy-seeded messages.
"""

import contextvars
import hashlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from upow_tpu.config import DeviceRuntimeConfig as JRuntimeConfig
from upow_tpu.device import runtime as jruntime
from upow_tpu.verify import txverify as jtxverify
from upow_tpu_torch import trace
from upow_tpu_torch.config import DeviceRuntimeConfig
from upow_tpu_torch.core import curve
from upow_tpu_torch.device import runtime as truntime
from upow_tpu_torch.device.runtime import ArmError, DeviceRuntime, boxed_call
from upow_tpu_torch.resilience import faultinject
from upow_tpu_torch.resilience.degrade import DegradeManager
from upow_tpu_torch.verify import txverify

SEED = 0x12A7


def make_checks(n: int, seed: int = SEED, invalid_every: int = 5) -> list:
    """``n`` distinct signature checks (the txverify shape), every
    ``invalid_every``-th with a corrupted ``s`` (fails both passes); every
    seventh signs the hex form, so its verdict needs pass 2."""
    rng = np.random.default_rng(seed)
    keys = [curve.keygen(rng=seed + i) for i in range(4)]
    checks = []
    for i in range(n):
        d, pub = keys[i % len(keys)]
        m = rng.bytes(40)
        hexform = hashlib.sha256(m.hex().encode()).digest()
        r, s = curve.sign(m.hex().encode() if i % 7 == 3 else m, d)
        if invalid_every and i % invalid_every == 0:
            s = s - 1 if s > 1 else s + 1
        checks.append((hashlib.sha256(m).digest(), hexform, (r, s), pub))
    return checks


CHECKS = make_checks(64)


def jax_verdicts(checks) -> list:
    """The JAX package's verdicts through its host path."""
    return jtxverify.run_sig_checks(list(checks), backend="host",
                                    use_cache=False)


@pytest.fixture(autouse=True)
def clean_state():
    trace.reset()
    txverify.clear_sig_verdicts()
    txverify.DEGRADE.reset()
    faultinject.uninstall()
    yield
    faultinject.uninstall()
    txverify.clear_sig_verdicts()
    txverify.DEGRADE.reset()
    truntime.reset_runtime()
    trace.reset()


@pytest.fixture
def rt():
    runtime = DeviceRuntime(device="cpu")
    yield runtime
    runtime.close()


# ---------------------------------------------- coalescing differential ----

def test_32_source_coalescing_differential(rt):
    """32 sources submit compatible batches while the runtime is held;
    one dispatch serves them all, each with the JAX host verdicts."""
    slices = [CHECKS[i * 2: i * 2 + 2] for i in range(32)]
    with rt.hold():
        futs = [rt.submit_sig_checks(s, backend="host", device_timeout=30.0,
                                     source="src%02d" % i)
                for i, s in enumerate(slices)]
        assert rt.dispatches == 0 and rt.submissions == 32
    got = [f.result(timeout=60.0) for f in futs]
    assert got == [jax_verdicts(s) for s in slices]
    assert rt.dispatches == 1
    st = rt.stats()
    assert len(st["per_source"]) == 32
    assert all(v == 1 for v in st["per_source"].values())


def test_incompatible_keys_do_not_coalesce(rt):
    with rt.hold():
        f1 = rt.submit_sig_checks(CHECKS[:4], backend="host", pad_block=128,
                                  source="a")
        f2 = rt.submit_sig_checks(CHECKS[4:8], backend="host", pad_block=64,
                                  source="b")
    assert f1.result(60.0) == jax_verdicts(CHECKS[:4])
    assert f2.result(60.0) == jax_verdicts(CHECKS[4:8])
    assert rt.dispatches == 2


def test_max_coalesce_caps_group_size():
    rt = DeviceRuntime(DeviceRuntimeConfig(max_coalesce=4), device="cpu")
    try:
        with rt.hold():
            futs = [rt.submit_sig_checks([c], backend="host",
                                         source="s%d" % i)
                    for i, c in enumerate(CHECKS[:16])]
        got = [f.result(60.0) for f in futs]
        assert got == [[v] for v in jax_verdicts(CHECKS[:16])]
        assert rt.dispatches == 4  # 16 submissions / cap 4
    finally:
        rt.close()


# ------------------------------------------------------------- fairness ----

def test_miner_flood_cannot_starve_block_verify(rt):
    served = []

    def work(tag):
        def fn():
            served.append(tag)
            time.sleep(0.002)
        return fn

    with rt.hold():
        mine = [rt.submit_call(work("mine"), kernel="sha256_search",
                               source="mine") for _ in range(120)]
        block = [rt.submit_call(work("block"), kernel="p256_verify",
                                source="block") for _ in range(5)]
    for f in block + mine:
        f.result(timeout=60.0)
    block_pos = [i for i, tag in enumerate(served) if tag == "block"]
    assert len(block_pos) == 5
    assert max(block_pos) < 12, served[:16]
    waits = rt.stats()["queue_waits"]
    assert max(waits["block"]) < max(waits["mine"]) / 4


def test_idle_source_cannot_bank_credit(rt):
    with rt.hold():
        for _ in range(10):
            rt.submit_call(lambda: None, source="mine")
    assert rt.submit_call(lambda: "x", source="mine").result(30.0) == "x"
    with rt._cv:
        vtime = rt._vtime
    assert vtime > 0
    with rt.hold():
        fut = rt.submit_call(lambda: "y", source="late")
        with rt._cv:
            assert rt._passes["late"] >= vtime
    assert fut.result(30.0) == "y"


# ------------------------------------------------------ degrade choke ----

def test_degrade_flip_mid_flight_drains_host_byte_identical(rt, monkeypatch):
    """Items queued before a degrade flip execute after it on the host
    path (the backend is resolved when the item runs)."""
    mgr = DegradeManager(failure_limit=1, cooldown=3600.0)
    monkeypatch.setattr(txverify, "DEGRADE", mgr)
    checks = CHECKS[:24]
    states = []
    real = txverify.run_sig_checks

    def spy(cks, **kw):
        states.append(txverify.DEGRADE.state)
        return real(cks, **kw)

    monkeypatch.setattr(txverify, "run_sig_checks", spy)
    with rt.hold():
        fut = rt.submit_sig_checks(checks, backend="auto",
                                   device_timeout=30.0, source="block")
        mgr.record_failure(RuntimeError("device went sick"))
        assert mgr.state == "degraded"
    assert fut.result(60.0) == jax_verdicts(checks)
    assert states and set(states) == {"degraded"}
    assert trace.counters()["resilience.device_fallback"] >= 1


def test_degrade_runtime_fault_site_drains_host(rt, monkeypatch):
    mgr = DegradeManager(failure_limit=1, cooldown=3600.0)
    monkeypatch.setattr(txverify, "DEGRADE", mgr)
    checks = CHECKS[:16]
    faultinject.install("device.runtime:error:times=1", seed=1337)
    fut = rt.submit_sig_checks(checks, backend="host", device_timeout=30.0,
                               source="mempool")
    assert fut.result(60.0) == jax_verdicts(checks)
    assert mgr.state == "degraded"
    assert mgr.snapshot()["consecutive_failures"] == 1
    assert trace.counters().get("runtime.faults", 0) == 1


def test_fault_site_on_boxed_call_surfaces_as_status(rt):
    faultinject.install("device.runtime:error:times=1", seed=7)
    status, value = rt.run_boxed(lambda: 42, timeout=10.0,
                                 kernel="probe", source="bench")
    assert status == "err"
    assert isinstance(value, faultinject.FaultInjected)
    assert rt.run_boxed(lambda: 42, timeout=10.0) == ("ok", 42)


# ----------------------------------------------------- arm failure ----

def test_arm_failure_fails_every_submission(monkeypatch):
    """The departure: a CUDA runtime that cannot arm raises ArmError, its
    platform raises, and every sig and call submission from every source
    fails with the arm's error; nothing is served on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = DeviceRuntime(DeviceRuntimeConfig(arm_timeout=5.0), device="cuda")
    try:
        with pytest.raises(ArmError, match="no CUDA device"):
            rt.platform()
        arm = rt.stats()["arm"]
        assert arm["armed"] and arm["platform"] is None
        assert "no CUDA device" in arm["arm_failure_reason"]
        futs = [rt.submit_sig_checks(CHECKS[:12], backend="auto",
                                     device_timeout=10.0, source=s)
                for s in ("block", "mempool", "verify")]
        futs += [rt.submit_call(lambda i=i: i * i, source=s)
                 for i, s in enumerate(("mine", "index", "bench"))]
        for f in futs:
            with pytest.raises(ArmError):
                f.result(timeout=30.0)
        with pytest.raises(ArmError):
            rt.arm()
    finally:
        rt.close()


def test_arm_failure_reason_in_structured_info(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = DeviceRuntime(DeviceRuntimeConfig(arm_timeout=3.0), device="cuda")
    try:
        with pytest.raises(ArmError):
            rt.arm(attempt="test-attempt")
        info = rt.stats()["arm"]
        assert info["platform"] is None and info["attempt"] == "test-attempt"
        assert info["arm_failure_reason"].startswith("RuntimeError: no CUDA")
        with truntime._RUNTIME_LOCK:
            truntime._RUNTIMES["cuda:0"] = rt
        assert truntime.arm_failure_reason() == info["arm_failure_reason"]
    finally:
        truntime.reset_runtime()


# -------------------------------------------------- service plumbing ----

def test_run_boxed_matches_boxed_call_contract(rt):
    assert rt.run_boxed(lambda: "v", timeout=10.0) == ("ok", "v")
    status, exc = rt.run_boxed(
        lambda: (_ for _ in ()).throw(ValueError("boom")), timeout=10.0)
    assert status == "err" and isinstance(exc, ValueError)
    assert rt.run_boxed(lambda: time.sleep(5), timeout=0.1) \
        == ("timeout", None)


def test_boxed_call_contract_matches_jax():
    def boom():
        raise KeyError("x")

    for fn, timeout in ((lambda: 1, 5.0), (boom, 5.0),
                        (lambda: time.sleep(2), 0.05)):
        got, want = boxed_call(fn, timeout), jruntime.boxed_call(fn, timeout)
        assert got[0] == want[0]
        assert type(got[1]) is type(want[1])


def test_inline_execution_from_drainer_thread(rt):
    def outer():
        inner = rt.submit_call(lambda: "nested", source="verify")
        return inner.result(timeout=1.0)

    assert rt.submit_call(outer, source="block").result(timeout=30.0) \
        == "nested"


def test_dispatch_runs_in_submitter_context(rt, monkeypatch):
    var = contextvars.ContextVar("rt_test_trace", default=None)
    var.set("submitter-context")
    assert rt.submit_call(lambda: var.get(), source="verify").result(30.0) \
        == "submitter-context"
    assert rt.submit_call(lambda: var.get(), source="verify",
                          timeout=10.0).result(30.0) \
        == ("ok", "submitter-context")
    seen = []
    real = txverify.run_sig_checks

    def spy(checks, **kw):
        seen.append(var.get())
        return real(checks, **kw)

    monkeypatch.setattr(txverify, "run_sig_checks", spy)
    rt.submit_sig_checks(CHECKS[:4], backend="host",
                         source="block").result(timeout=60.0)
    assert seen and seen[0] == "submitter-context"


def test_platform_and_devices_on_the_cpu(rt):
    assert rt.platform() == "cpu"
    assert rt.devices() == [torch.device("cpu")]
    assert truntime.runtime_key(None) == truntime.runtime_key("cuda:0") \
        == "cuda:0"
    assert truntime.get_runtime("cpu") is truntime.get_runtime("cpu")
    assert truntime.get_runtime("cpu").device == torch.device("cpu")


def test_empty_checks_resolve_immediately(rt):
    assert rt.submit_sig_checks([]).result(timeout=1.0) == []


def test_close_fails_pending_and_rejects_new(rt):
    with rt.hold():
        fut = rt.submit_call(lambda: 1, source="bench")
        rt.close()
    with pytest.raises(RuntimeError):
        fut.result(timeout=5.0)
    with pytest.raises(RuntimeError):
        rt.submit_call(lambda: 2)


def test_queue_overflow_rejects():
    rt = DeviceRuntime(DeviceRuntimeConfig(queue_max=3), device="cpu")
    try:
        with rt.hold():
            for _ in range(3):
                rt.submit_call(lambda: None, source="bench")
            with pytest.raises(RuntimeError, match="overflow"):
                rt.submit_call(lambda: None, source="bench")
    finally:
        rt.close()


def test_runtime_trace_counters(rt):
    rt.submit_sig_checks(CHECKS[:8], backend="host",
                         source="block").result(60.0)
    counters, hists = trace.counters(), trace.histograms()
    assert counters["runtime.submissions"] >= 1
    assert counters["runtime.dispatches"] >= 1
    assert counters["runtime.source.block"] >= 1
    for name in ("runtime.queue_depth", "runtime.coalesced",
                 "runtime.queue_wait.block"):
        assert hists[name]["count"], name


def test_weights_config_parsing():
    for text in ("block=4, mine = 1,bad", DeviceRuntimeConfig.weights):
        got = DeviceRuntimeConfig(weights=text).parsed_weights()
        assert got == JRuntimeConfig(weights=text).parsed_weights()
    w = DeviceRuntimeConfig(weights="block=4, mine = 1,bad").parsed_weights()
    assert w["block"] == 4 and w["mine"] == 1 and "bad" not in w


def test_concurrent_submitters_thread_safe(rt):
    results = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submitter(i):
            fut = rt.submit_call(lambda i=i: i * 3, source="s%d" % (i % 4))
            results[i] = fut.result(timeout=30.0)

        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == {i: i * 3 for i in range(48)}
    assert rt.submissions == rt.dispatches == 48


# -------------------------------------------- scheduling differential ----

# (source, kind, argument): a sig item's argument is (first check, count,
# pad_block), a call item's a tag
PLAN = [("mine", "call", "m0"), ("mine", "call", "m1"),
        ("block", "sig", (0, 6, 128)), ("mempool", "sig", (6, 2, 128)),
        ("mine", "call", "m2"), ("index", "call", "i0"),
        ("mempool", "sig", (8, 3, 64)), ("block", "sig", (11, 9, 128)),
        ("verify", "sig", (20, 1, 128)), ("mine", "call", "m3"),
        ("index", "call", "i1"), ("bench", "call", "b0"),
        ("mempool", "sig", (21, 4, 64)), ("block", "sig", (25, 2, 128)),
        ("mine", "call", "m4"), ("mine", "call", "m5"),
        ("other", "sig", (27, 5, 128)), ("index", "call", "i2")]


def _drive(make_runtime, pkg_txverify, monkeypatch):
    """Queue PLAN into a held runtime, release it, and return (the serve
    order: a call's tag or a sig group's item numbers, the dispatch
    count, each sig item's verdicts)."""
    order = []
    owner = {}
    real = pkg_txverify.run_sig_checks

    def spy(checks, **kw):
        if kw.get("use_cache", True):  # the dispatch, not its inner call
            order.append(tuple(sorted({owner[c] for c in checks})))
        return real(checks, **kw)

    monkeypatch.setattr(pkg_txverify, "run_sig_checks", spy)
    rt = make_runtime()
    futs = {}
    try:
        with rt.hold():
            for n, (source, kind, arg) in enumerate(PLAN):
                if kind == "call":
                    futs[n] = rt.submit_call(
                        lambda tag=arg: order.append(tag), source=source)
                    continue
                lo, count, pad = arg
                part = CHECKS[lo:lo + count]
                for c in part:
                    owner[c] = n
                futs[n] = rt.submit_sig_checks(part, backend="host",
                                               pad_block=pad, source=source)
        got = {n: f.result(timeout=60.0) for n, f in futs.items()}
        return order, rt.dispatches, {
            n: v for n, v in got.items() if PLAN[n][1] == "sig"}
    finally:
        rt.close()
        monkeypatch.setattr(pkg_txverify, "run_sig_checks", real)


def test_scheduling_differential_against_jax(monkeypatch):
    jax_order, jax_n, jax_v = _drive(jruntime.DeviceRuntime, jtxverify,
                                     monkeypatch)
    port_order, port_n, port_v = _drive(
        lambda: DeviceRuntime(device="cpu"), txverify, monkeypatch)
    assert port_order == jax_order
    assert port_n == jax_n == len(jax_order)
    assert any(isinstance(g, tuple) and len(g) > 1 for g in port_order)
    for n, verdicts in port_v.items():
        lo, count, _pad = PLAN[n][2]
        assert verdicts == jax_v[n] == jax_verdicts(CHECKS[lo:lo + count])
