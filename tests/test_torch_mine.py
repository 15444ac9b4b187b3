"""The port's miner against the JAX package's.

* ``mine(job, "torch")`` (the plain PyTorch search, CPU) against JAX
  ``mine(job, "jnp")``: the same first hit and ``hashes_tried`` through the
  same depth-2 pipelined rounds;
* ``build_job``, ``plan_nonce_ranges`` and ``Config.load`` parity;
* the port's backend names, its supervisor's child command, its loud
  failure on a multi-host coordinator it cannot join and its refusal of
  a card it does not have;
* end to end: ``miner.run(..., device="cpu", once=True)`` against a
  stdlib stub node over the port's ``ChainState`` pushes the same bytes
  as JAX ``run(..., device="jnp", once=True)`` against a twin stub over a
  JAX-built chain, and both nodes accept the block;
* the miner's telemetry: its counters against what ``mine()`` and
  ``run`` report, the dry hand-offs of fake rounds, its endpoint's
  ``/metrics``, ``/debug/traces`` and ``/debug/profile`` (the spans in
  the capture), no endpoint without ``--metrics-port``, and on the card
  the gaps between rounds on the device clock.
"""

import asyncio
import json
import threading
from decimal import Decimal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import upow_tpu.config as jconfig
import upow_tpu.core as jcore
import upow_tpu.core.clock as jclock
import upow_tpu.core.curve as jcurve
import upow_tpu.core.difficulty as jdifficulty
import upow_tpu.core.tx as jtx
import upow_tpu.mine.engine as jengine
import upow_tpu.mine.miner as jminer
import upow_tpu.parallel.multihost as jmultihost
import upow_tpu.state as jstate
import upow_tpu.verify as jverify
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.core as tcore
import upow_tpu_torch.core.clock as tclock
import upow_tpu_torch.core.curve as tcurve
import upow_tpu_torch.core.difficulty as tdifficulty
import upow_tpu_torch.core.tx as ttx
import upow_tpu_torch.mine.engine as tengine
import upow_tpu_torch.mine.miner as tminer
import upow_tpu_torch.state as tstate
import upow_tpu_torch.verify as tverify
from upow_tpu_torch.crypto import sha256 as tsha
from upow_tpu_torch.parallel import multihost as tmultihost
from upow_tpu_torch.telemetry import counters as tcounters
from upow_tpu_torch.telemetry import histograms as thistograms
from upow_tpu_torch.telemetry import stats as tstats
from upow_tpu_torch.telemetry import traces as ttraces

T0 = 1_760_000_000
RNG = np.random.default_rng(0x313E)
PREV = RNG.bytes(32).hex()
MERKLE = RNG.bytes(32).hex()
KEY_SEED = 0x313E  # the miner's key: early blocks must pay the genesis address
_KEY, _PUB = tcurve.keygen(rng=KEY_SEED)
ADDR = tcore.point_to_string(_PUB)

JAX = SimpleNamespace(
    core=jcore, clock=jclock, curve=jcurve, tx=jtx, difficulty=jdifficulty,
    ChainState=jstate.ChainState, manager=jverify.BlockManager,
    miner=jminer, device="jnp")
PORT = SimpleNamespace(
    core=tcore, clock=tclock, curve=tcurve, tx=ttx, difficulty=tdifficulty,
    ChainState=tstate.ChainState,
    manager=lambda st: tverify.BlockManager(st, device="cpu"),
    miner=tminer, device="cpu")


@pytest.fixture
def frozen():
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0)
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()


def _jobs(diff):
    fields = dict(previous_hash=PREV, address=ADDR, merkle_root=MERKLE,
                  timestamp=T0, difficulty=diff)
    return (jengine.MiningJob.from_header_fields(**fields),
            tengine.MiningJob.from_header_fields(**fields))


@pytest.mark.parametrize("diff", ["1.3", "2", "2.6"])
def test_mine_torch_matches_jax_jnp(diff):
    jjob, tjob = _jobs(diff)
    assert tjob.prefix == jjob.prefix
    want = jengine.mine(jjob, "jnp", batch=4096, stride_end=1 << 16)
    got = tengine.mine(tjob, "torch", batch=4096, stride_end=1 << 16)
    assert got.nonce == want.nonce is not None
    assert got.hashes_tried == want.hashes_tried
    assert tjob.check(got.nonce)
    assert tengine.mine(tjob, "python", batch=4096,
                        stride_end=1 << 16).nonce == got.nonce


def test_mine_ragged_miss_matches_jax_jnp():
    """A miss over a range that is no multiple of the batch: every nonce
    is tried once, in the same rounds."""
    jjob, tjob = _jobs("9")
    kw = dict(start=1000, stride_end=1000 + 3 * 4096 + 17, batch=4096)
    want = jengine.mine(jjob, "jnp", **kw)
    got = tengine.mine(tjob, "torch", **kw)
    assert got.nonce is None and want.nonce is None
    assert got.hashes_tried == want.hashes_tried == 3 * 4096 + 17


@pytest.mark.cuda
def test_mine_cuda_matches_torch_on_card():
    """The engine's rounds on the card (kernel, then the read-back of each
    round) against the plain version's rounds (runs on a machine with a
    card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for diff, kw in (("1.3", {}), ("2.6", {}),
                     ("9", dict(start=1000, stride_end=1000 + 3 * 4096 + 17))):
        _jjob, tjob = _jobs(diff)
        kw = dict(dict(batch=4096, stride_end=1 << 16), **kw)
        want = tengine.mine(tjob, "torch", **kw)
        got = tengine.mine(tjob, "cuda", **kw)
        assert (got.nonce, got.hashes_tried) == (want.nonce, want.hashes_tried)


def test_mine_checks_every_device_hit(monkeypatch):
    """A wrong hit from the search is an AssertionError, not a block."""
    _jjob, tjob = _jobs("2")
    monkeypatch.setattr(tsha, "pow_search",
                        lambda *a, **k: torch.tensor(12345))
    with pytest.raises(AssertionError, match="failing host check"):
        tengine.mine(tjob, "torch", batch=4096, stride_end=1 << 16)


def test_mine_stops_at_the_ttl():
    _jjob, tjob = _jobs("9")
    res = tengine.mine(tjob, "torch", batch=256, stride_end=1 << 20, ttl=0.0)
    # the depth-2 pipeline reads one round, finds the TTL spent, stops
    assert res.nonce is None and res.hashes_tried == 256
    assert tengine.MAX_SEARCH_END == jengine.MAX_SEARCH_END == (1 << 32) - 1


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jjob, tjob = _jobs("2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.mine(tjob, "cuda", batch=4096)
    template = tsha.make_template(tjob.prefix)
    target = tsha.pack_target(tsha.target_spec(PREV, "2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsha.pow_search(template, target, 0, 16)


@pytest.mark.parametrize("last_block", [
    {},
    {"id": 41, "hash": RNG.bytes(32).hex(), "difficulty": 6.3,
     "timestamp": T0 - 60},
])
def test_build_job_matches_jax(frozen, last_block):
    hashes = [RNG.bytes(32).hex() for _ in range(3)]
    info = {"difficulty": 6.3, "last_block": last_block,
            "pending_transactions": [], "pending_transactions_hashes": hashes,
            "merkle_root": MERKLE}
    jjob, jhashes, jno = jminer.build_job(info, ADDR)
    tjob, thashes, tno = tminer.build_job(info, ADDR)
    assert (tjob.prefix, tjob.previous_hash, tjob.difficulty) == \
        (jjob.prefix, jjob.previous_hash, jjob.difficulty)
    assert (thashes, tno) == (jhashes, jno)
    assert tno == last_block.get("id", 0) + 1


@pytest.mark.parametrize("k", [1, 2, 3, 7, 8])
def test_nonce_plans_match_jax(k):
    assert tmultihost.plan_nonce_ranges(k) == jmultihost.plan_nonce_ranges(k)
    lo, hi = 1000, tengine.MAX_SEARCH_END
    bounds = tmultihost.plan_nonce_ranges(k, lo, hi)
    assert bounds == jmultihost.plan_nonce_ranges(k, lo, hi)
    # exact cover: contiguous, disjoint, nothing left out
    assert bounds[0][0] == lo and bounds[-1][1] == hi
    assert all(b == c for (_a, b), (c, _d) in zip(bounds, bounds[1:]))


def test_select_backend_names():
    # --device cpu takes the native C++ loop where it builds, as the JAX
    # miner does (g++ is on this machine and on the card's)
    assert tminer.select_backend("cpu") == jminer.select_backend("cpu") \
        == "native"
    assert tminer.select_backend("cuda") == "cuda"
    assert tminer.select_backend("gpu") == "cuda"
    assert tminer.select_backend("torch") == "torch"
    assert tminer.select_backend("python") == "python"
    assert tminer.select_backend("native") == "native"
    assert tminer.select_backend("mesh") == "mesh"
    for name in ("tpu", "pallas", "jnp"):  # the JAX package's, not ours
        with pytest.raises(SystemExit):
            tminer.select_backend(name)
    assert tminer._runtime_arm_reason() is None


def test_config_reads_the_jax_environment(monkeypatch):
    assert tconfig.DeviceConfig().search_batch == \
        jconfig.DeviceConfig().search_batch == 1 << 24
    monkeypatch.setenv("UPOW_DEVICE_SEARCH_BATCH", "4096")
    got, want = tconfig.Config.load().device, jconfig.Config.load().device
    assert got.search_batch == want.search_batch == 4096
    # the CLI's --batch 0 takes it
    seen = {}
    monkeypatch.setattr(tminer, "run", lambda *a, **k: seen.setdefault("a", a))
    tminer.main([ADDR, "--device", "cpu", "--once",
                 "--node", "http://127.0.0.1:1/"])
    assert seen["a"][3] == 4096


def _args(**kw):
    base = dict(address=ADDR, node="http://127.0.0.1:1/", device="cuda",
                batch=4096, ttl=5.0, workers=2, once=True, shard="0/1")
    base.update(kw)
    return SimpleNamespace(**base)


def test_child_command_runs_the_port():
    cmd = tminer._child_cmd(_args())
    assert cmd[1:3] == ["-m", "upow_tpu_torch.mine.miner"]
    assert jminer._child_cmd(_args())[2] == "upow_tpu.mine.miner"


def test_workers_refuse_the_card():
    for device in ("cuda", "gpu"):
        assert tminer._run_workers(_args(device=device)) == 2


def test_coordinator_address_raises(monkeypatch):
    """A configured coordinator the process cannot join (here: no
    WORLD_SIZE or RANK) fails loudly, as the JAX bring-up does, instead
    of every host mining the whole nonce space."""
    monkeypatch.setenv("UPOW_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="bring-up failed"):
        tminer.main([ADDR, "--device", "cpu", "--once",
                     "--node", "http://127.0.0.1:1/"])
    monkeypatch.delenv("UPOW_COORDINATOR_ADDRESS")
    assert tmultihost.initialize() is False


def test_hang_watchdog_trips_on_stale_heartbeat():
    import time

    fired = threading.Event()
    hb = {"t": time.monotonic()}
    tminer._start_hang_watchdog(hb, limit=1.2, _exit=lambda code: fired.set())
    for _ in range(3):
        time.sleep(0.4)
        hb["t"] = time.monotonic()
    assert not fired.is_set()
    assert fired.wait(timeout=4.0)


# --- end to end: the CLI's run() against a stub node -----------------------

class StubNode:
    """``get_mining_info`` and ``push_block`` over one package's chain,
    served by a stdlib HTTP server thread.  The chain lives on its own
    event-loop thread (a sqlite connection stays on its thread)."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.loop = asyncio.new_event_loop()
        self.loop_thread = threading.Thread(target=self.loop.run_forever,
                                            daemon=True)
        self.loop_thread.start()
        self.pushed = []
        self.call(self._genesis())
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):
                pass

            def _reply(self, body: dict):
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._reply({"ok": True,
                             "result": stub.call(stub._mining_info())})

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                stub.pushed.append(body)
                self._reply(stub.call(stub._push(json.loads(body))))

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.http_thread = threading.Thread(target=self.server.serve_forever,
                                            daemon=True)
        self.http_thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    def call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(120)

    async def _genesis(self):
        pkg = self.pkg
        self.state = pkg.ChainState()
        self.manager = pkg.manager(self.state)
        self.d, self.pub = pkg.curve.keygen(rng=KEY_SEED)
        self.addr = pkg.core.point_to_string(self.pub)
        job = pkg.miner.build_job(
            {"difficulty": 2.0, "last_block": {},
             "pending_transactions_hashes": []}, self.addr)[0]
        assert await self.manager.create_block(job.block_content(0), [])
        coin = (await self.state.get_spendable_outputs(self.addr))[0]
        T = pkg.tx
        tx = T.Tx([T.TxInput(coin.tx_hash, coin.index)],
                  [T.TxOutput(self.addr, coin.amount)]
                  ).sign([self.d], lambda _i: self.pub)
        self.pending = {tx.hash(): tx}

    async def _mining_info(self):
        diff, last = await self.manager.calculate_difficulty()
        last = dict(last)
        if "difficulty" in last:
            last["difficulty"] = float(last["difficulty"])
        pending = sorted(tx.hex() for tx in self.pending.values())
        import hashlib

        return {"difficulty": float(diff), "last_block": last,
                "pending_transactions": pending[:10],
                "pending_transactions_hashes": [
                    hashlib.sha256(bytes.fromhex(t)).hexdigest()
                    for t in pending]}

    async def _push(self, body):
        txs = [self.pending[h] for h in body["txs"]]
        errors = []
        ok = await self.manager.create_block(body["block_content"], txs,
                                             errors=errors)
        tip = await self.state.get_last_block()
        return {"ok": ok, "errors": errors, "tip": tip["id"]}

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.loop.call_soon_threadsafe(self.state.close)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.http_thread.join(10)
        self.loop_thread.join(10)
        assert not self.http_thread.is_alive()
        assert not self.loop_thread.is_alive()
        self.loop.close()


def test_run_once_pushes_the_same_block_as_jax(frozen, monkeypatch, capsys):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("2.0"))
    stubs = {}
    try:
        for name, pkg in (("jax", JAX), ("port", PORT)):
            pkg.clock.advance(60)
            stubs[name] = StubNode(pkg)
            pkg.clock.advance(60)
        assert stubs["jax"].pending.keys() == stubs["port"].pending.keys()
        rc_j = jminer.run(ADDR, stubs["jax"].url, "jnp", 4096, 60.0,
                          once=True)
        rc_t = tminer.run(ADDR, stubs["port"].url, "cpu", 4096, 60.0,
                          once=True)
        assert rc_t == rc_j == 0
        out = capsys.readouterr().out
        # --device cpu is the native C++ loop, as in the JAX miner
        assert "backend=native" in out and "BLOCK MINED" in out
        assert len(stubs["port"].pushed) == len(stubs["jax"].pushed) == 1
        assert stubs["port"].pushed[0] == stubs["jax"].pushed[0]
        body = json.loads(stubs["port"].pushed[0])
        assert body["block_no"] == 2 and len(body["txs"]) == 1
        for stub in stubs.values():
            assert stub.call(stub.state.get_last_block())["id"] == 2
    finally:
        for stub in stubs.values():
            stub.close()


# --- the miner's telemetry: counters, gaps, its endpoint ---------------------

def _counts():
    return dict(tcounters())


def _delta(before: dict, name: str) -> int:
    return tcounters().get(name, 0) - before.get(name, 0)


def _hist_count(name: str) -> int:
    return thistograms().get(name, {}).get("count", 0)


@pytest.mark.parametrize("backend", ["torch", "python"])
@pytest.mark.parametrize("diff,kw", [
    ("2", dict(stride_end=1 << 16)),
    ("9", dict(start=1000, stride_end=1000 + 3 * 4096 + 17)),
])
def test_engine_counts_the_nonces_and_rounds_it_reports(backend, diff, kw):
    """``mine.hashes`` and ``mine.rounds`` move by the nonces and rounds
    that ``mine()`` reports, a hit or a ragged miss, device and host
    backends alike."""
    _jjob, tjob = _jobs(diff)
    before = _counts()
    res = tengine.mine(tjob, backend, batch=4096, **kw)
    assert _delta(before, "mine.hashes") == res.hashes_tried > 0
    assert _delta(before, "mine.rounds") == -(-res.hashes_tried // 4096)
    assert _delta(before, "mine.rounds_dry") == 0


def test_engine_records_the_kernel_launches_by_path(monkeypatch):
    """``mine.search_launches.*`` take the ``cuda`` backend's rounds, one
    kernel launch each, under the path of the job's template, once a
    ``mine()`` call; the other backends launch no kernel and add none."""
    real = tengine._make_dispatcher
    # the cuda backend's rounds, run by the plain search on the CPU
    monkeypatch.setattr(tengine, "_make_dispatcher",
                        lambda job, backend, **kw: real(job, "torch", **kw))
    _jjob, tjob = _jobs("9")
    v1job = tengine.MiningJob(prefix=b"\x01" * 134, previous_hash=PREV,
                              difficulty=Decimal("9"))
    before = _counts()
    tengine.mine(tjob, "torch", batch=4096, stride_end=4096)
    tengine.mine(tjob, "python", batch=4096, stride_end=4096)
    assert _delta(before, "mine.search_launches.aligned") == 0
    tengine.mine(tjob, "cuda", batch=4096, stride_end=3 * 4096)
    tengine.mine(v1job, "cuda", batch=4096, stride_end=2 * 4096)
    assert _delta(before, "mine.search_launches.aligned") == 3
    assert _delta(before, "mine.search_launches.generic") == 2


class _FakeEvent:
    def __init__(self, finished: bool):
        self.finished = finished

    def query(self) -> bool:
        return self.finished


class _FakeHandle:
    """A round whose result is a miss and whose ``done`` event reports
    ``finished`` whenever asked."""

    def __init__(self, finished: bool):
        self.done = _FakeEvent(finished)

    def __int__(self) -> int:
        return int(tsha.SENTINEL)


@pytest.mark.parametrize("finished", [True, False])
def test_rounds_dry_counts_the_handoffs_that_found_the_round_done(
        monkeypatch, finished):
    """A hand-off (queuing a round while one is in flight) at which the
    round queued last has already finished counts as dry: every hand-off
    for handles that are always done, none for handles that stay
    pending.  Each dispatch is timed on the host."""
    monkeypatch.setattr(tengine, "_make_dispatcher",
                        lambda *a, **k: lambda start, count:
                        _FakeHandle(finished))
    _jjob, tjob = _jobs("9")
    before, timed = _counts(), _hist_count(tengine.ROUND_DISPATCH)
    res = tengine.mine(tjob, "torch", batch=4096, stride_end=5 * 4096)
    assert res.nonce is None and _delta(before, "mine.rounds") == 5
    # five rounds, the first queued with nothing in flight
    assert _delta(before, "mine.rounds_dry") == (4 if finished else 0)
    assert _hist_count(tengine.ROUND_DISPATCH) - timed == 5


def _info(diff: float) -> dict:
    return {"difficulty": diff, "last_block": {},
            "pending_transactions_hashes": []}


def test_cli_counts_templates_expiries_and_pushes_once(monkeypatch):
    """``run`` counts a template when it mines one, an expiry when the
    TTL ends it, and a push and an accept for a found block; its fetch
    and build are spans of a ``mine.template`` trace, a push is a
    ``mine.push_block`` trace, and the rounds belong to neither.  (The
    node is faked: a port node in this process would write events that
    the JAX package's ring never sees.)"""
    pushed = []
    monkeypatch.setattr(tminer, "push_block",
                        lambda node, *block: pushed.append(block)
                        or {"ok": True})
    for diff, ttl, rc, want in (
            (9.0, 0.0, 1, {"mine.templates": 1, "mine.templates_expired": 1,
                           "mine.blocks_pushed": 0,
                           "mine.blocks_accepted": 0}),
            (2.0, 60.0, 0, {"mine.templates": 1, "mine.templates_expired": 0,
                            "mine.blocks_pushed": 1,
                            "mine.blocks_accepted": 1})):
        monkeypatch.setattr(tminer, "fetch_mining_info",
                            lambda node, diff=diff: _info(diff))
        before, spans = _counts(), tstats()
        assert tminer.run(ADDR, "http://127.0.0.1:1/", "torch", 4096, ttl,
                          once=True) == rc
        assert {k: _delta(before, k) for k in tengine.COUNTERS[3:]} == want
    assert len(pushed) == 1
    names = ("mine.template_fetch", "mine.template_build", "mine.push_block")
    for name in names:
        assert tstats()[name]["count"] - spans.get(name, {"count": 0})[
            "count"] == 1
    template, push = ttraces()["recent"][-2:]
    assert template["name"] == "mine.template"
    assert [c["name"] for c in template["spans"]] == list(names[:2])
    assert push["name"] == "mine.push_block" and "spans" not in push


def test_no_metrics_port_opens_no_socket_and_no_thread(monkeypatch):
    """Without ``--metrics-port`` the miner builds no endpoint; with one
    it serves on that port and closes it when ``run`` returns."""
    from upow_tpu_torch.mine import endpoint

    made = []

    class Recorder:
        def __init__(self, port, tcfg, pcfg):
            made.append(port)

        def close(self):
            made.append("closed")

    monkeypatch.setattr(endpoint, "MinerEndpoint", Recorder)
    monkeypatch.setattr(tminer, "fetch_mining_info", lambda node: _info(9.0))
    threads = {t.name for t in threading.enumerate()}
    assert tminer.run(ADDR, "http://127.0.0.1:1/", "torch", 4096, 0.0,
                      once=True) == 1
    assert made == []
    # at most the device runtime's drainer, which the rounds arm
    new = {t.name for t in threading.enumerate()} - threads
    assert all(name.startswith("upow-device-runtime-") for name in new), new
    assert tminer.run(ADDR, "http://127.0.0.1:1/", "torch", 4096, 0.0,
                      once=True, metrics_port=9123) == 1
    assert made == [9123, "closed"]


def test_cli_passes_the_metrics_port(monkeypatch):
    seen = {}
    monkeypatch.setattr(tminer, "run",
                        lambda *a, **k: seen.setdefault("k", k))
    tminer.main([ADDR, "--device", "cpu", "--once",
                 "--node", "http://127.0.0.1:1/", "--metrics-port", "9123"])
    assert seen["k"]["metrics_port"] == 9123
    assert "--metrics-port" not in tminer._child_cmd(_args())
    assert tminer._child_cmd(_args(), 9124)[-2:] == ["--metrics-port", "9124"]


def _get(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers["Content-Type"]


class _FakeNode:
    """``get_mining_info`` at difficulty 2.0 on the genesis tip, and a
    ``push_block`` that accepts, on a loopback port."""

    def __init__(self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *_a):
                pass

            def _reply(self, body: dict):
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._reply({"ok": True, "result": _info(2.0)})

            def do_POST(self):
                self.rfile.read(int(self.headers["Content-Length"]))
                self._reply({"ok": True})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def test_miner_cli_serves_metrics_traces_and_profile(tmp_path):
    """``python -m upow_tpu_torch.mine.miner ... --metrics-port N`` as a
    process of its own: ``/metrics`` carries the miner's families from
    its first scrape; ``/debug/profile`` start, templates mined, then
    stop writes a Chrome trace holding the template's spans as user
    annotations; ``/debug/traces`` holds the templates' trees."""
    import os
    import socket
    import subprocess
    import sys
    import time

    from upow_tpu_torch.telemetry import exposition

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    node = _FakeNode()
    env = dict(os.environ, UPOW_MINER_CHILD="1", UPOW_PROFILE_ENABLED="1",
               UPOW_PROFILE_TRACE_DIR=str(tmp_path), UPOW_LOG_PATH="",
               UPOW_LOG_CONSOLE="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "upow_tpu_torch.mine.miner", ADDR,
         "--node", node.url, "--device", "torch", "--batch", "4096",
         "--metrics-port", str(port)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                status, text, ctype = _get(url + "/metrics")
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert status == 200 and ctype == exposition.CONTENT_TYPE
        assert exposition.validate(text) == []
        samples = exposition.samples(text)
        for name in tengine.COUNTERS + tengine.SEARCH_LAUNCHES:
            assert "upow_" + name.replace(".", "_") + "_total" in samples
        for name in (tengine.GAP_HANDOFF, tengine.GAP_REFRESH,
                     tengine.ROUND_DISPATCH):
            assert "upow_" + name.replace(".", "_") + "_count" in samples
        started = json.loads(_get(url + "/debug/profile?action=start")[1])
        assert started["ok"] and started["result"]["active"]

        def accepted() -> float:
            return exposition.samples(_get(url + "/metrics")[1])[
                "upow_mine_blocks_accepted_total"]

        first = accepted()
        while accepted() < first + 2:
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.1)
        stopped = json.loads(_get(url + "/debug/profile?action=stop")[1])
        assert stopped["ok"], stopped
        with open(stopped["result"]["trace_file"]) as f:
            events = json.load(f)["traceEvents"]
        marked = {e["name"] for e in events
                  if e.get("cat") == "user_annotation"}
        assert {"mine.template", "mine.template_fetch", "mine.template_build",
                "mine.push_block"} <= marked
        traces = json.loads(_get(url + "/debug/traces")[1])["result"]
        assert {t["name"] for t in traces["recent"]} == {
            "mine.template", "mine.push_block"}
        assert _get(url + "/debug/profile?action=nope")[0] == 400
        assert _get(url + "/nope")[0] == 404
    finally:
        proc.terminate()
        proc.wait(30)
        node.close()


@pytest.mark.cuda
@pytest.mark.parametrize("search", ["plain", "wrapped"])
def test_round_gaps_on_card(monkeypatch, search):
    """On the card: one ``mine.round_gap.*`` sample at each round
    boundary of two templates (the first template's first round has no
    round before it), every gap non-negative on the device clock.
    ``wrapped`` replaces ``pow_search`` by a wrapper that forwards only
    its own arguments, as a harness's variant of the search does: the
    engine's mark reaches the launch through ``sha256.before_launch``,
    not through an argument, so every boundary is still timed (runs on
    a machine with a card; skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if search == "wrapped":
        plain = tsha.pow_search

        def wrapped(template, target, start, count, device=None):
            return plain(template, target, start, count, device=device)

        monkeypatch.setattr(tsha, "pow_search", wrapped)
    gaps = []
    gap = tengine._ReadBack.gap

    def spy(self):
        seconds = gap(self)
        gaps.append(seconds)
        return seconds

    monkeypatch.setattr(tengine._ReadBack, "gap", spy)
    tengine._clocks.clear()
    _jjob, tjob = _jobs("9")
    counts = {n: _hist_count(n)
              for n in (tengine.GAP_HANDOFF, tengine.GAP_REFRESH)}
    for _ in range(2):
        res = tengine.mine(tjob, "cuda", batch=4096, stride_end=16 * 4096)
        assert res.nonce is None and res.hashes_tried == 16 * 4096
    assert gaps[0] is None and len(gaps) == 32
    assert all(g is not None and g >= 0 for g in gaps[1:])
    assert _hist_count(tengine.GAP_HANDOFF) - counts[tengine.GAP_HANDOFF] == 30
    assert _hist_count(tengine.GAP_REFRESH) - counts[tengine.GAP_REFRESH] == 1
