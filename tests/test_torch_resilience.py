"""The port's resilience package and peer book against the JAX package's.

Each case drives the port's module and the JAX package's with the same
inputs, seeds and fake clocks, and requires the same outputs:

* ``RetryPolicy.delay_for`` sequences from one seed;
* ``call_with_retry``: success after transient errors, giving up, the
  deadline, and an error outside ``retry_on``, with the same backoff
  sleeps and retry callbacks;
* a circuit breaker's full cycle and a half-open failure, with equal
  ``snapshot()`` dicts and ``available()`` answers at every step, and a
  registry's ``snapshot`` and ``state_counts``;
* the fault spec parser on the JAX tests' specs (the same rules, matches
  and errors) and a seeded ``p`` schedule;
* ``NodeInterface`` under a ``ResilienceContext`` with an injected
  ``rpc`` fault: retried, then the breaker opens and refuses locally
  (no connection is made);
* ``PeerBook``: add, the peer cap, ``update_last_message``,
  ``recent_nodes``, ``propagate_nodes`` and ``ranked`` with breakers in
  every state, and ``prune``, under one fake clock and one sampling
  seed; then each package reading the other's ``nodes.json``.
"""

import asyncio
import json
import random
import time

import pytest

import upow_tpu.config as jconfig
import upow_tpu.node.peers as jpeers
import upow_tpu.resilience as jres
import upow_tpu.resilience.faultinject as jfault
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.node.peers as tpeers
import upow_tpu_torch.resilience as tres
import upow_tpu_torch.resilience.faultinject as tfault
from upow_tpu import trace as jtrace
from upow_tpu_torch import trace as ttrace

PKGS = {"jax": (jres, jfault, jpeers, jconfig),
        "port": (tres, tfault, tpeers, tconfig)}


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
def test_delay_for_sequence(seed, jitter):
    out = []
    for res, *_ in PKGS.values():
        policy = res.RetryPolicy(base_delay=0.25, multiplier=2.0,
                                 max_delay=2.0, jitter=jitter)
        rng = random.Random(seed)
        out.append([policy.delay_for(n, rng) for n in range(1, 9)])
    assert out[0] == out[1]


class _Fake:
    """A clock the sleeps advance, and the record of what happened."""

    def __init__(self, fail: int, exc=ConnectionError, step: float = 0.0):
        self.t, self.fail, self.exc, self.step = 0.0, fail, exc, step
        self.calls, self.sleeps, self.retries = 0, [], []

    def clock(self):
        return self.t

    async def sleep(self, delay):
        self.sleeps.append(delay)
        self.t += delay

    async def fn(self):
        self.calls += 1
        self.t += self.step
        if self.calls <= self.fail:
            raise self.exc(f"down {self.calls}")
        return "ok"


def _retry_run(res, fake, policy_kw, retry_on=(ConnectionError,)):
    policy = res.RetryPolicy(**policy_kw)

    async def main():
        try:
            return await res.call_with_retry(
                fake.fn, policy, retry_on=retry_on, rng=random.Random(5),
                on_retry=lambda e, n: fake.retries.append((str(e), n)),
                clock=fake.clock, sleep=fake.sleep)
        except Exception as e:
            return type(e).__name__, str(e)
    return (asyncio.run(main()), fake.calls, fake.sleeps, fake.retries)


@pytest.mark.parametrize("case", ["success", "give_up", "deadline",
                                  "not_retried"])
def test_call_with_retry(case):
    fail, exc, step = {"success": (2, ConnectionError, 0.0),
                       "give_up": (99, ConnectionError, 0.0),
                       "deadline": (99, ConnectionError, 1.5),
                       "not_retried": (99, ValueError, 0.0)}[case]
    kw = dict(attempts=4, base_delay=0.5, max_delay=2.0, multiplier=2.0,
              jitter=0.5, deadline=4.0 if case == "deadline" else 45.0)
    got = [_retry_run(res, _Fake(fail, exc, step), kw)
           for res, *_ in PKGS.values()]
    assert got[0] == got[1]
    result, calls, _sleeps, _retries = got[1]
    assert {"success": (result == "ok" and calls == 3),
            "give_up": (result[0] == "ConnectionError" and calls == 4),
            "deadline": (result[0] in ("DeadlineExceeded",
                                       "ConnectionError") and calls < 4),
            "not_retried": (result[0] == "ValueError" and calls == 1),
            }[case], got[1]


def _breaker_steps(res):
    t = [0.0]
    b = res.CircuitBreaker(failure_threshold=3, open_secs=10.0,
                           half_open_max=1, clock=lambda: t[0], key="peer")
    log = [b.snapshot()]

    def step(action):
        if action == "fail":
            b.record_failure()
            out = None
        elif action == "ok":
            b.record_success()
            out = None
        elif action == "avail":
            out = b.available()
        elif action == "usable":
            out = b.usable()
        else:  # advance the clock
            t[0] += float(action)
            out = b.state
        log.append((action, out, b.snapshot()))

    for action in ["ok", "fail", "fail", "avail", "fail", "avail", "usable",
                   "5", "avail", "5", "usable", "avail", "avail", "fail",
                   "avail", "10", "avail", "ok", "avail", "fail", "ok",
                   "fail", "fail", "fail", "10.0", "avail", "avail", "ok"]:
        step(action)
    return log, b.transitions


def test_breaker_cycle_and_half_open_failure():
    got = [_breaker_steps(res) for res, *_ in PKGS.values()]
    assert got[0] == got[1]
    log, transitions = got[1]
    assert transitions == ["closed", "open", "half_open", "open",
                           "half_open", "closed", "open", "half_open",
                           "closed"]


def test_registry_snapshot_and_state_counts():
    out = []
    for res, *_ in PKGS.values():
        t = [0.0]
        reg = res.BreakerRegistry(failure_threshold=2, open_secs=5.0,
                                  clock=lambda: t[0])
        for key, fails in (("http://a", 0), ("http://b", 1),
                           ("http://c", 2), ("http://d", 3)):
            reg.record_success(key)
            for _ in range(fails):
                reg.record_failure(key)
        views = [reg.snapshot(), reg.state_counts(),
                 [reg.usable(k) for k in ("http://c", "http://x")],
                 [reg.score(k) for k in ("http://b", "http://x")]]
        t[0] = 6.0
        views += [reg.snapshot(), reg.state_counts(),
                  reg.available("http://c"), reg.available("http://c")]
        out.append(views)
    assert out[0] == out[1]
    assert out[1][1] == {"closed": 2, "open": 2, "half_open": 0}


SPECS = ["rpc:error:p=0.5,key=9001;device.verify:hang:times=1;"
         "ws.send:latency:delay=0.25",
         "rpc:error:times=2,key=127.0.0.1:9001",
         "rpc.push_tx:latency:delay=0.1;rpc:error",
         "snapshot.serve:corrupt", "", " ; rpc:hang ;",
         "rpc", "rpc:explode", "rpc:error:zap=1", "rpc:error:p=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parser(spec):
    out = []
    for _res, fault, *_ in PKGS.values():
        try:
            rules = [(f.site, f.kind, f.p, f.times, f.delay, f.key)
                     for f in fault.parse_spec(spec)]
            matches = [[f.matches(site, key) for f in fault.parse_spec(spec)]
                       for site, key in (
                           ("rpc.get_blocks", "http://127.0.0.1:9001"),
                           ("rpcx", "http://127.0.0.1:9001"),
                           ("rpc.push_tx", "http://127.0.0.1:9002"),
                           ("device.verify", ""), ("ws.send", "c"))]
            out.append((rules, matches))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_schedule_is_seeded(seed):
    out = []
    for _res, fault, *_ in PKGS.values():
        inj = fault.FaultInjector("rpc:error:p=0.5;rpc:latency:times=3",
                                  seed=seed)

        async def run():
            hits = []
            for _ in range(32):
                try:
                    await inj.fire("rpc.get_nodes", "k")
                    hits.append(0)
                except fault.FaultInjected:
                    hits.append(1)
            return hits
        out.append((asyncio.run(run()), inj.snapshot()))
    assert out[0] == out[1] and 0 < sum(out[1][0]) < 32


def test_node_interface_retries_then_breaks():
    """An injected ``rpc`` error is retried, then trips the breaker, which
    refuses the next call locally: the same counters, states and fires
    in both packages, and no connection made."""
    out = []
    for name, (res, fault, peers, config) in PKGS.items():
        trace = jtrace if name == "jax" else ttrace
        rcfg = config.ResilienceConfig(
            rpc_attempts=2, rpc_backoff_base=0.0, rpc_jitter=0.0,
            rpc_deadline=5.0, breaker_failure_threshold=2,
            breaker_open_secs=60.0)
        ctx = res.ResilienceContext.from_config(rcfg)
        iface = peers.NodeInterface("http://127.0.0.1:1",
                                    config.NodeConfig(seed_url=""),
                                    resilience=ctx)

        async def main():
            errors = []
            fault.install("rpc:error", seed=0)
            trace.reset()
            try:
                for _ in range(3):
                    try:
                        await iface.get("get_nodes")
                    except ConnectionError as e:
                        errors.append(type(e).__name__)
                snap = fault.get_injector().snapshot()
            finally:
                fault.uninstall()
            counters = trace.counters()
            return (errors, ctx.breakers.snapshot(), snap,
                    {k: v for k, v in counters.items()
                     if k.startswith("resilience.")})
        out.append(asyncio.run(main()))
    assert out[0] == out[1]
    errors, breakers, snap, counters = out[1]
    assert errors == ["FaultInjected", "FaultInjected", "CircuitOpenError"]
    assert breakers["http://127.0.0.1:1"]["state"] == "open"
    assert snap[0]["fired"] == 4 and counters == {
        "resilience.faults_injected": 4, "resilience.rpc_retries": 2,
        "resilience.breaker_rejected": 1}


def _book_run(name, tmp_path, monkeypatch, seed):
    """One fixed sequence of peer-book operations; every read on the
    way, and the saved file."""
    _res, _fault, peers, config = PKGS[name]
    now = [1_760_000_000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    random.seed(seed)  # the JAX book samples from the global generator
    cfg = config.NodeConfig(seed_url="http://seed:3006",
                            peers_file=str(tmp_path / f"{name}.json"),
                            max_peers=8, active_within=100,
                            prune_after=1000, propagate_sample=2)
    t = [0.0]
    breakers = _res.BreakerRegistry(failure_threshold=2, open_secs=30.0,
                                    clock=lambda: t[0])
    kw = {} if name == "jax" else {"rng": random.Random(seed)}
    book = peers.PeerBook(cfg, breakers=breakers, **kw)
    urls = [f"10.0.0.{i}:3006" for i in range(10)]
    views = []

    def read():
        views.append((book.all_nodes(), book.recent_nodes(),
                      book.propagate_nodes(), book.propagate_nodes(),
                      book.ranked(book.all_nodes()),
                      [book.contains(u) for u in urls[:3]]))

    read()
    for i, u in enumerate(urls):
        now[0] += 10
        views.append(book.add(u))
        if i % 3 == 0:
            book.update_last_message(u)
    read()
    for _ in range(2):
        breakers.record_failure("http://" + urls[3])      # open
    breakers.record_failure("http://" + urls[4])          # weak score
    breakers.record_failure("http://" + urls[4])
    breakers.record_success("http://" + urls[4])
    breakers.record_failure("http://" + urls[1])
    read()
    now[0] += 95          # some active peers age out of the window
    read()
    t[0] += 31            # the open circuit goes half-open
    read()
    now[0] += 2000        # everyone is silent past prune_after
    book.add("http://late:3006")
    book.prune()
    book.remove("http://late:3006")
    book.remove("http://never:3006")
    read()
    return views, json.loads((tmp_path / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, 5])
def test_peer_book_matches_jax(tmp_path, monkeypatch, seed):
    got = [_book_run(name, tmp_path, monkeypatch, seed) for name in PKGS]
    assert got[0] == got[1]
    views, saved = got[1]
    assert views[0][0] == ["http://seed:3006"]  # a fresh book on its seed
    assert saved == {"nodes": {}}


@pytest.mark.parametrize("writer, reader", [("jax", "port"),
                                            ("port", "jax")])
def test_each_package_reads_the_others_peer_file(tmp_path, writer, reader):
    path = str(tmp_path / "nodes.json")

    def book(name):
        config = PKGS[name][3]
        return PKGS[name][2].PeerBook(config.NodeConfig(
            seed_url="", peers_file=path))

    first = book(writer)
    for i in range(5):
        first.add(f"http://10.0.1.{i}:3006")
    first.update_last_message("http://10.0.1.2:3006")
    second = book(reader)
    assert second.all_nodes() == first.all_nodes()
    assert second.recent_nodes() == first.recent_nodes() == [
        "http://10.0.1.2:3006"]
    assert second._data == first._data
