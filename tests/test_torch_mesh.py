"""The port's mesh variants (``parallel/mesh.py``, ``mine/mesh_engine.py``,
the ``mesh`` search backend, the sharded verify on the node's path) and
its ``torch.distributed`` bring-up, against the JAX package's.

The JAX side runs on its 8-device virtual CPU mesh (``conftest.py``);
the port's meshes here are explicit, eight shards of the plain versions
on the CPU (``plan_devices(8, "cpu")``):

* ``shard_bounds`` and the engine's ``plan_round`` equal to JAX's, and
  their coverage exact and disjoint (hypothesis);
* ``pow_search_resident`` against JAX ``_pow_search_mesh_resident`` on
  the same bases, limits and targets, with ragged, empty and wrapping
  shards, and ``pow_search_sharded`` against JAX ``pow_search_sharded``;
* ``mine(backend="mesh")`` against JAX ``mine(backend="jnp")`` on three
  seeded jobs, and the engine's accounting, reuse and refusals as in
  ``tests/test_mesh_engine.py``;
* ``verify_packed_sharded``, ``verify_batch_prehashed(mesh=)`` and
  ``run_sig_checks(mesh_devices=8)`` against JAX
  ``verify_batch_prehashed(mesh=, backend="jnp")``, and
  ``BlockManager(verify_mesh_devices=8)`` against the JAX manager on the
  block scenario of ``test_torch_block.py``;
* two processes rendezvous over gloo (``multihost.initialize``), each
  searches its planned range, and an ``all_reduce(MIN)`` agrees on the
  winner of one search over the whole range.

No tolerance: every compared value is a nonce, a bit or a string.
"""

import asyncio
import os
import random
import socket
import subprocess
import sys
from decimal import Decimal
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import upow_tpu.mine.engine as jengine
import upow_tpu.mine.mesh_engine as jmesh_engine
import upow_tpu.parallel.mesh as jmesh
import upow_tpu.verify as jverify
import upow_tpu.verify.txverify as jtxverify
from upow_tpu.crypto import p256 as jp256, sha256 as jsha
import upow_tpu_torch.mine.engine as tengine
import upow_tpu_torch.mine.mesh_engine as tmesh_engine
import upow_tpu_torch.parallel.mesh as tmesh
import upow_tpu_torch.verify as tverify
import upow_tpu_torch.verify.txverify as ttxverify
from upow_tpu_torch.crypto import p256, sha256 as tsha
from test_torch_block import JAX as JBLOCK, PORT as TBLOCK, scenario
from test_torch_p256 import _mix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTINEL = int(tsha.SENTINEL)
CPU8 = tmesh.make_mesh(tmesh.plan_devices(8, "cpu"))


def _seeded_job(seed: int, difficulty="1.5"):
    """The same job in both packages (``test_mesh_engine.py``'s jobs)."""
    r = random.Random(seed)
    prefix = bytes(r.randrange(256) for _ in range(104))
    prev_hash = bytes(r.randrange(256) for _ in range(32)).hex()
    return (jengine.MiningJob(prefix, prev_hash, Decimal(difficulty)),
            tengine.MiningJob(prefix, prev_hash, Decimal(difficulty)))


@pytest.fixture(autouse=True)
def fresh_engines():
    jmesh_engine.reset_mesh_engine()
    tmesh_engine.reset_mesh_engine()
    yield
    jmesh_engine.reset_mesh_engine()
    tmesh_engine.reset_mesh_engine()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jax.devices())


# ------------------------------------------------------ plans ----

def test_cpu_mesh_and_card_plans():
    assert CPU8 == (torch.device("cpu"),) * 8
    assert tmesh.plan_devices(0, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        tmesh.plan_devices(-1, "cpu")
    with pytest.raises(RuntimeError):
        tmesh.make_mesh([])


def test_card_plans_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.plan_devices(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


@settings(max_examples=200, deadline=None)
@given(lo=st.integers(0, (1 << 32) - 2), span=st.integers(1, 1 << 32),
       count=st.integers(1, 64))
def test_shard_bounds_match_jax_and_tile_exactly(lo, span, count):
    hi = min(lo + span, 1 << 32)
    got = [tmesh.shard_bounds(lo, hi, i, count) for i in range(count)]
    assert got == [jmesh.shard_bounds(lo, hi, i, count)
                   for i in range(count)]
    assert got[0][0] == lo and got[-1][1] == hi
    assert all(b == c for (_a, b), (c, _d) in zip(got, got[1:]))
    assert all(a <= b for a, b in got)
    sizes = [b - a for a, b in got]
    assert max(sizes) - min(sizes) <= 1


@settings(max_examples=100, deadline=None)
@given(start=st.integers(0, (1 << 32) - 1 - 8 * 4096),
       count=st.integers(1, 8 * 4096), n_dev=st.integers(1, 8))
def test_plan_round_matches_jax(start, count, n_dev):
    jeng, teng = jmesh_engine.MeshEngine(), tmesh_engine.MeshEngine()
    jeng._n_dev = teng._n_dev = n_dev
    plan = teng.plan_round(start, count)
    assert plan == jeng.plan_round(start, count)
    assert plan[0][0] == start and plan[-1][1] == start + count
    assert sum(b - a for a, b in plan) == count


# ------------------------------------------------------ search ----

# (bases, limits) of eight shards at 512 nonces a shard: full, ragged,
# empty (base == limit), a limit below its base, and one that would wrap
# past 2^32 (its lanes past 2^32 drop out)
BATCH = 512
W = (1 << 32) - 100
SHARDS = [
    ([i * BATCH for i in range(8)], [(i + 1) * BATCH for i in range(8)]),
    ([1000 + i * 700 for i in range(8)],
     [1000 + i * 700 + (i * 97) % 600 for i in range(8)]),
    ([0, 512, 512, 9000, 7 << 20, 20000, 30000, W],
     [300, 512, 1024, 8000, (7 << 20) + 512, 20001, 30300, (1 << 32) - 1]),
]


@pytest.mark.parametrize("diff", ["1", "1.5", "3", "9"])
@pytest.mark.parametrize("shards", range(len(SHARDS)))
def test_pow_search_resident_matches_jax(jax_mesh, diff, shards):
    jjob, tjob = _seeded_job(11 + shards, diff)
    bases, limits = SHARDS[shards]
    template = tsha.make_template(tjob.prefix)
    target = tsha.pack_target(tsha.target_spec(tjob.previous_hash, diff))
    got = int(tmesh.pow_search_resident(
        template.midstate, template.tail_words, bases, limits, target,
        BATCH, template.nonce_spec, CPU8))
    jt = jsha.make_template(jjob.prefix)
    want = int(jmesh.pow_search_resident(
        jax.numpy.asarray(jt.midstate), jax.numpy.asarray(jt.tail_words),
        np.asarray(bases, np.uint32), np.asarray(limits, np.uint32),
        jax.numpy.asarray(jsha.pack_target(
            jsha.target_spec(jjob.previous_hash, diff))),
        BATCH, jt.nonce_spec, jax_mesh))
    assert got == want
    if got != SENTINEL:
        assert tjob.check(got)
        # the least over every shard's own range, nonce for nonce
        assert got == min(
            n for b, lim in zip(bases, limits)
            for n in range(b, min(lim, b + BATCH, (1 << 32) - 1))
            if tjob.check(n))
    if diff == "9":
        assert got == SENTINEL


def test_pow_search_sharded_matches_jax(jax_mesh):
    for seed, diff, base in ((5, "1.5", 0), (6, "2", 1 << 20),
                             (7, "9", (1 << 32) - 8 * BATCH)):
        jjob, tjob = _seeded_job(seed, diff)
        template = tsha.make_template(tjob.prefix)
        target = tsha.pack_target(tsha.target_spec(tjob.previous_hash, diff))
        got = int(tmesh.pow_search_sharded(template, target, base, BATCH,
                                           CPU8))
        want = int(jmesh.pow_search_sharded(
            jsha.make_template(jjob.prefix),
            jsha.target_spec(jjob.previous_hash, diff), base, BATCH,
            jax_mesh))
        assert got == want, (seed, diff)
    with pytest.raises(ValueError, match="nonce space"):
        tmesh.pow_search_sharded(template, target, (1 << 32) - BATCH, BATCH,
                                 CPU8)


@pytest.mark.parametrize("seed", [55, 56, 57])
def test_mine_mesh_backend_matches_jax_jnp(seed):
    """The whole mine() loop through backend='mesh' (eight shards on the
    CPU) finds the same nonce in the same rounds as JAX backend='jnp'."""
    jjob, tjob = _seeded_job(seed, difficulty="2")
    kw = dict(start=0, stride_end=1 << 15, batch=1 << 12, ttl=60.0)
    want = jengine.mine(jjob, backend="jnp", **kw)
    got = tengine.mine(tjob, backend="mesh", mesh_devices=8, device="cpu",
                       **kw)
    assert (got.nonce, got.hashes_tried) == (want.nonce, want.hashes_tried)
    assert got.nonce is not None and tjob.check(got.nonce)
    eng = tmesh_engine.get_mesh_engine(mesh_devices=8, device="cpu")
    st_ = eng.stats()
    assert (st_["devices"], st_["batch_per_device"]) == (8, 512)
    assert st_["nonces_planned"] >= got.hashes_tried


def _armed_engine(batch_per_device=512):
    eng = tmesh_engine.get_mesh_engine(mesh_devices=8, device="cpu",
                                       batch_per_device=batch_per_device)
    info = eng.arm()
    assert info["armed"] and eng.n_devices == 8
    rung, = eng.arm_ladder
    assert set(rung) >= {"attempt", "ok", "seconds", "error"} and rung["ok"]
    return eng


def test_partial_and_tiny_rounds_match_jnp():
    """Tail rounds (count < capacity, even count < n_devices) leave the
    idle shards out; the result is the serial search's."""
    eng = _armed_engine(batch_per_device=512)
    jjob, tjob = _seeded_job(7, difficulty="1")
    eng.set_job(tjob)
    jt = jsha.make_template(jjob.prefix)
    spec = jsha.target_spec(jjob.previous_hash, jjob.difficulty)
    for start, count in ((0, 3), (1 << 16, 100), (5, eng.capacity - 1)):
        got = int(eng.dispatch(start, count))
        want = int(jsha.pow_search_jnp(jt, spec, nonce_base=start,
                                       batch=count))
        assert got == want, (start, count)


def test_dispatch_accounting_proves_disjoint_exact_coverage():
    eng = _armed_engine(batch_per_device=64)
    eng.set_job(_seeded_job(9, difficulty="1")[1])
    start, total, rounds = 1000, eng.capacity * 3 + 17, 0
    cursor = start
    while cursor < start + total:
        count = min(eng.capacity, start + total - cursor)
        eng.dispatch(cursor, count)
        cursor += count
        rounds += 1
    st_ = eng.stats()
    assert st_["dispatches"] == rounds
    assert st_["nonces_planned"] == total
    covered = []
    for rec in st_["rounds"]:
        shards = rec["shards"]
        assert shards[0][0] == rec["lo"] and shards[-1][1] == rec["hi"]
        assert all(b == c for (_a, b), (c, _d) in zip(shards, shards[1:]))
        covered.extend(s for s in shards if s[0] < s[1])
    covered.sort()
    assert covered[0][0] == start and covered[-1][1] == start + total
    assert all(b == c for (_a, b), (c, _d) in zip(covered, covered[1:]))
    assert sum(b - a for a, b in covered) == total
    assert tmesh_engine.ACCOUNTING_WINDOW == jmesh_engine.ACCOUNTING_WINDOW


def test_accounting_keeps_the_window(monkeypatch):
    monkeypatch.setattr(tmesh_engine, "ACCOUNTING_WINDOW", 3)
    eng = _armed_engine(batch_per_device=8)
    eng.set_job(_seeded_job(9, difficulty="9")[1])
    for i in range(5):
        eng.dispatch(i * eng.capacity, eng.capacity)
    st_ = eng.stats()
    assert [r["round"] for r in st_["rounds"]] == [3, 4, 5]
    assert st_["dispatches"] == 5 and st_["nonces_planned"] == 5 * 64


def test_dispatch_rejects_oversized_and_early_rounds():
    eng = tmesh_engine.get_mesh_engine(mesh_devices=8, device="cpu",
                                       batch_per_device=64)
    with pytest.raises(RuntimeError, match="before arm"):
        eng.dispatch(0, 1)
    eng.arm()
    with pytest.raises(RuntimeError, match="before set_job"):
        eng.dispatch(0, 1)
    eng.set_job(_seeded_job(3)[1])
    with pytest.raises(ValueError):
        eng.dispatch(0, eng.capacity + 1)
    with pytest.raises(ValueError):
        eng.dispatch(0, 0)


def test_engine_reuse_and_replacement_semantics():
    """An armed engine is reused while the round fits its capacity; a
    larger round, another batch, mesh size or device replaces it; an
    unarmed one takes the batch and the larger hint."""
    eng = _armed_engine(batch_per_device=128)
    get = tmesh_engine.get_mesh_engine
    assert get(mesh_devices=8, device="cpu", round_hint=eng.capacity) is eng
    assert get(mesh_devices=8, device="cpu",
               round_hint=eng.capacity // 2) is eng
    assert get(mesh_devices=8, device="cpu", batch_per_device=128) is eng
    bigger = get(mesh_devices=8, device="cpu", round_hint=eng.capacity * 2)
    assert bigger is not eng and not bigger.armed
    assert get(mesh_devices=8, device="cpu", round_hint=100) is bigger
    assert bigger._round_hint == eng.capacity * 2
    bigger.arm()
    assert bigger.batch_per_device == 256 and bigger.capacity == 2048
    other = get(mesh_devices=8, device="cpu", batch_per_device=64)
    assert other is not bigger and other.batch_per_device == 64
    assert get(mesh_devices=4, device="cpu") is not other
    assert get(mesh_devices=4) is not get(mesh_devices=4, device="cpu")
    assert tmesh_engine.engine_stats()["devices"] == 0  # not armed yet


def test_arm_failure_raises_with_its_rung(monkeypatch):
    def broken(*_a, **_k):
        raise OSError("nvcc: not found")

    monkeypatch.setattr(tsha, "pow_search", broken)
    eng = tmesh_engine.get_mesh_engine(mesh_devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="failed to arm.*nvcc"):
        eng.dispatcher(_seeded_job(1)[1])
    rung, = eng.arm_ladder
    assert (rung["attempt"], rung["ok"]) == ("build-and-warm", False)
    assert "nvcc" in rung["error"] and not eng.armed
    assert "nvcc" in eng.stats()["arm_failure_reason"]


def test_mesh_backend_names_and_device_argument():
    assert tengine.check_search_backend("mesh") == "mesh"
    _j, tjob = _seeded_job(1)
    with pytest.raises(ValueError, match="mesh backend"):
        tengine.mine(tjob, "torch", device="cpu", stride_end=16)
    assert tmesh_engine.planned_range() == (0, 1 << 32)
    assert tmesh_engine.planned_range(10, 20) == (10, 20)


# ------------------------------------------------------ verify ----

@pytest.fixture(scope="module")
def verify_case(jax_mesh):
    digests, sigs, pubs = _mix()
    want = np.asarray(jp256.verify_batch_prehashed(
        digests, sigs, pubs, mesh=jax_mesh, backend="jnp"))
    return digests, sigs, pubs, want


def test_sharded_verify_matches_jax_and_the_unsharded_kernel(verify_case,
                                                            monkeypatch):
    """Lane for lane: the eight shards' bits equal one unsharded plain
    verify (verdict and exception bits), and the entry point's verdicts
    (exception lanes on the host oracle) equal JAX's sharded verify."""
    digests, sigs, pubs, want = verify_case
    fused = p256._pack_device_inputs(digests, sigs, pubs, len(digests))[0]
    packed = p256.packed_tensor(fused, "cpu")
    shards, = tmesh.shard_batch_arrays(CPU8, packed)
    assert [s.shape[1] for s in shards] == [2, 3, 3, 3, 2, 3, 3, 3]
    assert torch.equal(torch.cat(shards, dim=1), packed)
    seen = []
    real = tmesh.verify_packed_sharded

    def spy(packed_, mesh=None, window=None):
        seen.append(real(packed_, mesh, window))
        return seen[-1]

    monkeypatch.setattr(tmesh, "verify_packed_sharded", spy)
    got = p256.verify_batch_prehashed(digests, sigs, pubs, mesh=CPU8)
    assert list(got) == list(want)
    bits, = seen
    assert torch.equal(bits, p256.verify_packed(packed))
    assert int((bits & 2).count_nonzero()) == 5  # the crafted collisions
    assert tmesh.VERIFY_LAUNCHES == 0  # the CPU runs the plain version
    # fewer lanes than shards: the empty shards launch nothing
    few = real(packed[:, :2], CPU8)
    assert torch.equal(few, bits[:2])


def test_run_sig_checks_with_a_mesh_matches_jax(verify_case, monkeypatch):
    digests, sigs, pubs, want = verify_case
    calls = []
    real = tmesh.verify_packed_sharded

    def spy(packed, mesh=None, window=None):
        calls.append((packed.shape[1], len(mesh)))
        return real(packed, mesh, window)

    monkeypatch.setattr(tmesh, "verify_packed_sharded", spy)
    # the raw digest doubles as the hex form: a failed lane's pass 2
    # asks the same question again
    checks = [(d, d, s, p) for d, s, p in zip(digests, sigs, pubs)]
    # two shards (the eight-shard split is held above): the verdicts do
    # not depend on the split
    ttxverify.clear_sig_verdicts()
    got = ttxverify.run_sig_checks(checks, backend="device", device="cpu",
                                   mesh_devices=2)
    ttxverify.clear_sig_verdicts()
    assert got == [bool(v) for v in want]
    assert calls and all(n_dev == 2 for _n, n_dev in calls)
    assert calls[0][0] == len(checks) + 2  # the canary pair rides along
    assert ttxverify._verify_mesh(1, "cpu") is None
    assert ttxverify._verify_mesh(0, "cpu") is None  # one host device
    monkeypatch.setattr(p256, "VERIFY_KERNEL", "complete")
    assert ttxverify._verify_mesh(8, "cpu") is None  # jac only


@pytest.fixture
def easy_chains(monkeypatch):
    """Difficulty 1.0 and a frozen clock in both packages (the block
    scenario's own fixture)."""
    for pkg in (JBLOCK, TBLOCK):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
        pkg.clock.freeze(1_760_000_000)
    yield
    for pkg in (JBLOCK, TBLOCK):
        pkg.clock.reset()
        pkg.clear()


def test_block_manager_on_a_mesh_matches_jax(easy_chains, monkeypatch):
    """The block scenario through BlockManager(verify_mesh_devices=8):
    the port's signature batches sharded eight ways on the CPU, the JAX
    manager on its 8-device mesh; verdicts, error strings and UTXO
    fingerprints equal, attempt for attempt."""
    calls = []
    real = tmesh.verify_packed_sharded

    def spy(packed, mesh=None, window=None):
        calls.append(len(mesh))
        return real(packed, mesh, window)

    monkeypatch.setattr(tmesh, "verify_packed_sharded", spy)
    port = SimpleNamespace(**dict(vars(TBLOCK), manager=lambda s: (
        tverify.BlockManager(s, device="cpu", verify_mesh_devices=8))))
    jax_ = SimpleNamespace(**dict(vars(JBLOCK), manager=lambda s: (
        jverify.BlockManager(s, verify_mesh_devices=8))))
    got = asyncio.run(scenario(port))
    want = asyncio.run(scenario(jax_))
    assert got == want
    assert [ok for ok, _e, _h in got] == [True] * 3 + [False] * 3 + [True]
    assert calls and set(calls) == {8}
    jtxverify.clear_sig_verdicts()


# --------------------------------------------------- multi-host ----

_CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from upow_tpu_torch.core import curve, point_to_string
from upow_tpu_torch.core.header import BlockHeader
from upow_tpu_torch.crypto import sha256 as tsha
from upow_tpu_torch.parallel import multihost

assert multihost.initialize({coord!r}, num_processes=2, process_id={pid},
                            timeout=60.0)
assert multihost.process_slot() == ({pid}, 2)
lo, hi = multihost.my_nonce_range(0, 1 << 13)
assert (lo, hi) == multihost.plan_nonce_ranges(2, 0, 1 << 13)[{pid}]
header = BlockHeader(previous_hash=bytes(range(32)).hex(),
                     address=point_to_string(curve.keygen(rng=0xD15)[1]),
                     merkle_root="00" * 32, timestamp=1_753_791_000,
                     difficulty_x10=25, nonce=0)
template = tsha.make_template(header.prefix_bytes())
target = tsha.pack_target(tsha.target_spec(header.previous_hash, "1.5"))
local = int(tsha.pow_search(template, target, lo, hi - lo, device="cpu"))
best = torch.tensor([local], dtype=torch.int64)
dist.all_reduce(best, op=dist.ReduceOp.MIN)
whole = int(tsha.pow_search(template, target, 0, 1 << 13, device="cpu"))
print("RESULT " + json.dumps({{"local": local, "global": int(best),
                               "whole": whole, "range": [lo, hi]}}))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_rendezvous_and_agree_on_the_winner():
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("UPOW_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(root=ROOT, coord=coord, pid=i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            line, = [x for x in out.splitlines() if x.startswith("RESULT ")]
            results.append(__import__("json").loads(line[7:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [r["range"] for r in results] == [[0, 1 << 12], [1 << 12, 1 << 13]]
    whole = results[0]["whole"]
    assert whole != SENTINEL
    assert all(r["global"] == whole for r in results)
    assert min(r["local"] for r in results) == whole


def test_miner_takes_its_slot_in_the_plan(monkeypatch):
    """With a coordinator the miner's default 0/1 shard becomes this
    process's slot of the plan, and its mesh size comes from the config
    (the JAX miner's main)."""
    from upow_tpu_torch.mine import miner
    from upow_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "initialize", lambda: True)
    monkeypatch.setattr(multihost, "process_slot", lambda: (1, 3))
    monkeypatch.setenv("UPOW_DEVICE_MESH_DEVICES", "2")
    seen = {}
    monkeypatch.setattr(miner, "run", lambda *a, **k: seen.update(k))
    miner.main(["addr", "--device", "mesh", "--once",
                "--node", "http://127.0.0.1:1/"])
    assert seen["shard"] == (1, 3) and seen["mesh_devices"] == 2
    assert miner.select_backend("mesh") == "mesh"
    assert miner._run_workers(SimpleNamespace(device="mesh")) == 2


def test_initialize_is_a_noop_without_a_coordinator(monkeypatch):
    from upow_tpu_torch.parallel import multihost

    monkeypatch.delenv("UPOW_COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize() is False
    assert multihost.process_slot() == (0, 1)
    assert multihost.my_nonce_range() == (0, 1 << 32)
