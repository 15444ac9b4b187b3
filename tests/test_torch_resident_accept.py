"""The resident accept path: the port's fused accept scan over its UTXO
index against the JAX package's.

The small chain of ``test_torch_block.py`` (a coinbase fanned out 4 x 3)
is grown by ``BlockManager(device="cpu")`` over
``ChainState(device_index=True, device="cpu")`` and by the JAX
``BlockManager`` (``fused_accept``, its default) over a JAX ``ChainState``
with ``enable_device_index()``, both armed from genesis so every UTXO
write goes through the index hooks.  Then, block for block with the same
clock, keys and nonces: a block spending an outpoint that does not
exist, a block spending one leaf twice, the 12-tx block accepted, a
reorg of it (``remove_blocks(4)``) and the same txs accepted again in a
new block.  Verdicts, error strings and UTXO fingerprints must be equal,
and after the accept, the reorg and the second accept the resident
probe, the shadow map and SQL must agree on the spends, the creations
and 16 absent outpoints.

Beside it: the probes counted and no shadow consult; no index without a
card unless the CPU is named; a probe that fails raises out of the
accept, never answered by SQL, and through the node gives the 500
envelope; the node arms the index from ``device.utxo_index`` (from the
environment and from a JAX config file) and its intake probes through
it.
"""

import asyncio
import json

import pytest
import torch

import upow_tpu.config as jconfig
import upow_tpu.state as jstate
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.state as tstate
import upow_tpu_torch.state.device_index as tdi
import upow_tpu_torch.verify.block as tblock
from test_torch_block import JAX, PORT, Chain, easy_chain, grow  # noqa: F401
from upow_tpu_torch import trace
from upow_tpu_torch.node.http import fetch

ABSENT = [("ff" * 32, i) for i in range(16)]


def _armed_jax():
    state = jstate.ChainState()
    state.enable_device_index()
    assert state.resident_indexes()
    return state


def _armed_port(path=None):
    state = tstate.ChainState(path, device_index=True, device="cpu")
    assert state.resident_indexes()
    return state


def _parity(state, sample):
    """(resident == shadow == SQL, the SQL answer) on ``sample``."""
    idx = state.resident_indexes()["unspent_outputs"]
    dev = [bool(v) for v in idx.contains_batch(sample)]
    shadow = [bool(v) for v in idx.shadow_contains_batch(sample)]
    rows = {(r[0], r[1]) for r in state.db.execute(
        "SELECT tx_hash, idx FROM unspent_outputs")}
    sql = [tuple(o) in rows for o in sample]
    return dev == shadow == sql, sql


async def resident_scenario(pkg, state):
    chain = Chain(pkg, state)
    log, leaves = await grow(chain)
    pkg.clock.advance(60)
    txs = [chain.spend([leaf]) for leaf in leaves]
    sample = [(h, i) for h, i, _a in leaves] \
        + [(t.hash(), 0) for t in txs] + ABSENT
    # an outpoint that does not exist, then one leaf spent twice
    ghost = chain.spend([("ab" * 32, 0, leaves[0][2])])
    log.append(await chain.submit(txs[:6] + [ghost] + txs[6:]))
    twin = chain.spend([leaves[0]], 2)
    log.append(await chain.submit(txs + [twin]))
    pre_hash = await state.get_unspent_outputs_hash()
    pkg.clear()
    log.append(await chain.submit(txs))
    log.append(_parity(state, sample))
    await state.remove_blocks(4)
    log.append(await state.get_unspent_outputs_hash() == pre_hash)
    log.append(_parity(state, sample))
    pkg.clock.advance(60)
    log.append(await chain.submit(txs))
    log.append(_parity(state, sample))
    log.append(state.index_stats())
    state.close()
    return log


def test_resident_accept_matches_jax():
    trace.reset()
    got = asyncio.run(resident_scenario(PORT, _armed_port()))
    counters = trace.counters()
    want = asyncio.run(resident_scenario(JAX, _armed_jax()))
    # the indexes' stats apart: entries and consults must agree
    got_stats, want_stats = got.pop(), want.pop()
    assert got == want
    verdicts = [entry[0] for entry in got[:6]]
    assert verdicts == [True] * 3 + [False, False, True]
    assert got[3][1] == ["double spend in block: 4 (unspent_outputs)"]
    assert got[4][1] == ["double spend in block: 4 (unspent_outputs)"]
    assert got[6][0] and got[8][0] and got[10][0]   # three-way parity
    assert got[7] is True                            # the reorg's UTXO hash
    assert got[9][2] != got[5][2]                    # a new coinbase
    for stats in (got_stats, want_stats):
        assert stats["shadow_consults"] == stats["twin_fingerprints"] == 0
    assert got_stats["entries"] == want_stats["entries"]
    assert counters.get("index.probes", 0) > 0
    assert counters.get("index.shadow_consults", 0) == 0
    assert counters.get("kernel.utxo_probe.batches", 0) > 0


def test_fused_scan_is_taken_and_hashes_once(monkeypatch):
    """With the index armed, check_block answers the double-spend scan
    from the probes (never the serial SQL scan) and digests each
    micro-batch once, in the probe's call."""
    calls = {"prep": 0, "probe": 0}
    real_prep, real_probe = tblock._fused_digest_prep, tdi.launch

    def prep(*a, **k):
        calls["prep"] += 1
        return real_prep(*a, **k)

    def probe(*a, **k):
        calls["probe"] += 1
        return real_probe(*a, **k)

    async def serial(*_a, **_k):
        raise AssertionError("the serial SQL scan ran with the index armed")

    async def run():
        chain = Chain(PORT, _armed_port())
        _log, leaves = await grow(chain)
        PORT.clock.advance(60)
        txs = [chain.spend([leaf]) for leaf in leaves]
        chain.manager.verify_microbatch = 5   # 12 txs: 3 micro-batches
        monkeypatch.setattr(tblock, "_fused_digest_prep", prep)
        monkeypatch.setattr(tdi, "launch", probe)
        monkeypatch.setattr(chain.manager, "_check_block_double_spends",
                            serial)
        return await chain.submit(txs)

    ok, errors, _h = asyncio.run(run())
    assert ok, errors
    assert calls == {"prep": 3, "probe": 3}


def test_chain_state_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.ChainState(device_index=True)
    state = tstate.ChainState()   # no index asked: no card needed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state.enable_device_index()
    assert state.resident_indexes() is None


def _broken_probe(*_a, **_k):
    raise RuntimeError("utxo_probe launch failed: CUDA error 719")


def test_failing_probe_fails_the_accept_without_sql(monkeypatch):
    async def run():
        state = _armed_port()
        chain = Chain(PORT, state)
        _log, leaves = await grow(chain)
        PORT.clock.advance(60)
        txs = [chain.spend([leaf]) for leaf in leaves]
        before = (await state.get_last_block(),
                  await state.get_unspent_outputs_hash())
        sql = []
        real_execute = state.db.execute

        class Spy:
            def execute(self, query, *args):
                if "IN (VALUES" in query:
                    sql.append(query)
                return real_execute(query, *args)

            def __getattr__(self, name):
                return getattr(real_execute.__self__, name)

        monkeypatch.setattr(tdi, "launch", _broken_probe)
        state.db = Spy()
        with pytest.raises(RuntimeError, match="utxo_probe launch failed"):
            await chain.submit(txs)
        state.db = real_execute.__self__
        after = (await state.get_last_block(),
                 await state.get_unspent_outputs_hash())
        return before, after, sql

    before, after, sql = asyncio.run(run())
    assert before == after and sql == []


def _node_config(tmp_path, monkeypatch, how):
    """A port node config with ``device.utxo_index`` from the environment
    or from a JAX config file, as the JAX package reads it."""
    path = tmp_path / "cfg.json"
    if how == "env":
        monkeypatch.setenv("UPOW_DEVICE_UTXO_INDEX", "1")
        path.write_text("{}")
    else:
        path.write_text(json.dumps({"device": {"utxo_index": True}}))
    got = tconfig.Config.load(str(path), node__db_path=str(
        tmp_path / "port.db"), node__ip_config_file="",
        node__seed_url="", node__peers_file="",
        node__rate_limits_enabled=False)
    want = jconfig.Config.load(str(path))
    assert got.device.utxo_index is True and want.device.utxo_index is True
    return got


@pytest.mark.parametrize("how", ["env", "file"])
def test_config_arms_the_node_index(tmp_path, monkeypatch, how):
    assert tconfig.Config().device.utxo_index is False
    cfg = _node_config(tmp_path, monkeypatch, how)

    async def run():
        node = tapp.Node(cfg, device="cpu")
        try:
            return node.state.index_stats()
        finally:
            await node.close()

    stats = asyncio.run(run())
    assert stats is not None and stats["entries"] == 0


def test_node_probes_and_a_failing_probe_is_a_500(tmp_path, monkeypatch):
    """The node's intake probes through the index; a push_block whose
    probe fails answers the 500 envelope, and once the probe works the
    same block is accepted."""
    async def build():
        state = tstate.ChainState(str(tmp_path / "port.db"))
        chain = Chain(PORT, state)
        _log, leaves = await grow(chain)
        state.close()
        return leaves

    leaves = asyncio.run(build())
    cfg = _node_config(tmp_path, monkeypatch, "env")

    async def run():
        node = tapp.Node(cfg, device="cpu")
        server = await node.serve("127.0.0.1", 0)
        url = f"http://127.0.0.1:{server.port}/"
        try:
            chain = Chain(PORT, node.state)
            trace.reset()
            pushed = chain.spend([leaves[0]])
            status, body = await fetch(url + "push_tx", "POST", json.dumps(
                {"tx_hex": pushed.hex()}).encode())
            admitted = (status, json.loads(body))
            probes = trace.counters().get("index.probes", 0)
            PORT.clock.advance(60)
            txs = [pushed] + [chain.spend([leaf]) for leaf in leaves[1:]]
            block = json.dumps({"block_content": await chain.header(txs),
                                "txs": [t.hex() for t in txs]}).encode()
            real_launch = tdi.launch
            monkeypatch.setattr(tdi, "launch", _broken_probe)
            failed = await fetch(url + "push_block", "POST", block)
            monkeypatch.setattr(tdi, "launch", real_launch)
            accepted = await fetch(url + "push_block", "POST", block)
            tip = await node.state.get_last_block()
            return admitted, probes, failed, accepted, tip["id"]
        finally:
            await node.close()

    admitted, probes, failed, accepted, tip = asyncio.run(run())
    assert admitted[0] == 200 and admitted[1]["result"] == \
        "Transaction has been accepted", admitted
    assert probes > 0
    assert (failed[0], json.loads(failed[1])) == (
        500, {"ok": False, "error": "Uncaught RuntimeError exception"})
    assert (accepted[0], json.loads(accepted[1])) == (200, {"ok": True})
    assert tip == 4
