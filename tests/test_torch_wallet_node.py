"""The wallet's node surfaces on the port's node against the JAX node's:
``/send_to_address`` and replace-by-fee under ``mempool.allow_rbf``.

``/send_to_address``: a JAX node and the port's node on copies of one
chain, both in a working directory whose ``key_pair_list.json`` holds
the chain's key, answer each request byte for byte alike: a send by GET
and one by POST (the same RFC 6979 tx in both, admitted through the
intake), missing params (422), an unknown ``Authorization`` key
("Unauthorized"), an amount the key cannot cover, one that is not a
number, and a non-local client behind ``trust_proxy_headers`` (403); the
pending journals and pools end alike.

Replace-by-fee: the port's ``Mempool`` against the JAX one on JAX
``test_pool_conflict_and_rbf``'s scenario and on seeded random
sequences with ``allow_rbf`` on and off (return codes, ``ordered()``,
``spender_of`` and the ``mempool.rbf`` count after every add), and on a
node pair: a higher-fee spend of a pooled outpoint written straight
into the journal (the wallet CLI's local path) reaches each node's pool
on its journal sync, replacing the pooled tx only under ``allow_rbf``.
"""

import asyncio
import json
import random
import shutil
import time

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu.trace as jtrace
import upow_tpu_torch.node.app as tapp
from test_mempool import _synthetic
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_mempool import _entries
from test_torch_node import _build_chain, _configs, easy_chain  # noqa: F401
from upow_tpu import mempool as jmempool
from upow_tpu_torch import mempool as tmempool
from upow_tpu_torch import trace as ttrace


def _rbf_count(pkg) -> int:
    trace = jtrace if pkg is jmempool else ttrace
    return trace.counters().get("mempool.rbf", 0)


# ------------------------------------------------------------------ pool --

def test_pool_conflict_and_rbf_matches_jax():
    """JAX test_pool_conflict_and_rbf, on both pools side by side."""
    got = {}
    for pkg in (jmempool, tmempool):
        rng = random.Random(9)
        op = ("ab" * 32, 0)

        def entry(**kw):
            e = _synthetic(rng, **kw)
            return pkg.MempoolEntry(tx_hash=e.tx_hash, tx_hex=e.tx_hex,
                                    fees=e.fees, outpoints=e.outpoints)
        low = entry(fees=10, size=100, outpoints=(op,))
        high = entry(fees=10 ** 6, size=100, outpoints=(op,))
        same = entry(fees=10 ** 6, size=100, outpoints=(op,))
        pool = pkg.Mempool()
        out = [pool.add(low), pool.add(low), pool.add(high),
               pool.spender_of(op)]
        rbf = pkg.Mempool(allow_rbf=True)
        before = _rbf_count(pkg)
        out += [rbf.add(low), rbf.add(high), rbf.spender_of(op),
                low.tx_hash in rbf, rbf.add(same), rbf.spender_of(op),
                _rbf_count(pkg) - before]
        got[pkg] = out
    assert got[tmempool] == got[jmempool]
    assert got[tmempool][:3] == ["added", "duplicate", "conflict"]
    assert got[tmempool][5:] == ["replaced", got[tmempool][6], False,
                                 "conflict", got[tmempool][6], 1]


@pytest.mark.parametrize("allow_rbf", [False, True])
@pytest.mark.parametrize("seed", [4, 5])
def test_rbf_sequence_matches_jax(seed, allow_rbf):
    """Seeded adds with many outpoint conflicts (a shared outpoint pool),
    some removals: every return code, the priority order, each
    outpoint's spender and the rbf count are equal after every step."""
    rng = random.Random(seed)
    raw = _entries(rng, 80)
    shared = [("%064x" % rng.getrandbits(256), k) for k in range(12)]
    raw = [(h, body, rng.choice([0, 5, 50, 500, 5000, fees]),
            ops + tuple(rng.sample(shared, rng.randrange(0, 3))))
           for h, body, fees, ops in raw]
    pools = {pkg: pkg.Mempool(allow_rbf=allow_rbf)
             for pkg in (jmempool, tmempool)}
    base = {pkg: _rbf_count(pkg) for pkg in pools}
    codes = set()
    for i, (h, body, fees, ops) in enumerate(raw):
        step = {}
        for pkg, pool in pools.items():
            r = pool.add(pkg.MempoolEntry(tx_hash=h, tx_hex=body, fees=fees,
                                          outpoints=ops))
            if i % 9 == 8:
                pool.remove([raw[i - 3][0]])
            step[pkg] = (r, [(e.tx_hash, e.fees) for e in pool.ordered()],
                         [pool.spender_of(op) for op in shared],
                         _rbf_count(pkg) - base[pkg], pool.generation)
        assert step[tmempool] == step[jmempool], i
        codes.add(step[tmempool][0])
    assert "conflict" in codes
    assert ("replaced" in codes) == allow_rbf


# ------------------------------------------------------------------ nodes --

async def _serve(jcfg, tcfg):
    jnode = japp.Node(jcfg)
    jnode.started = True  # no first-request bootstrap
    tnode = tapp.Node(tcfg, device="cpu")
    server = TestServer(jnode.app, host="127.0.0.1")
    await server.start_server()
    tserver = await tnode.serve("127.0.0.1", 0)
    return jnode, tnode, server, {
        "jax": f"http://127.0.0.1:{server.port}",
        "port": f"http://127.0.0.1:{tserver.port}"}


async def _close(jnode, tnode, server):
    await tnode.close()
    await server.close()
    await jnode.close()


async def _both(session, urls, method, path, params=None, body=None,
                headers=None):
    """(status, body) from both nodes, asserted equal."""
    out = []
    for name in ("jax", "port"):
        async with session.request(method, urls[name] + path,
                                   params=params or {}, json=body,
                                   headers=headers or {}) as resp:
            out.append((resp.status, await resp.read()))
    assert out[1] == out[0], (path, params, body, out)
    return out[1][0], json.loads(out[1][1])


def _pair_on_chain(tmp_path):
    """Copies of one JAX-written chain for a JAX and a port node; the
    chain's key; both clocks after the chain."""
    _build_chain(tmp_path / "chain.db")
    for pkg in (JAX, PORT):
        pkg.clock.freeze(T0 + 600)
    for name in ("jax", "port"):
        shutil.copyfile(tmp_path / "chain.db", tmp_path / f"{name}.db")
    return Chain(PORT)


def test_send_to_address_matches_jax(tmp_path, monkeypatch):
    chain = _pair_on_chain(tmp_path)
    (tmp_path / "key_pair_list.json").write_text(json.dumps(
        {"keys": [{"private_key": chain.d, "public_key": chain.addr}]}))
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _configs(tmp_path, "")
    for cfg in (jcfg, tcfg):
        cfg.node.trust_proxy_headers = True
    dest = PORT.core.point_to_string(PORT.curve.keygen(rng=0x5E7D)[1])
    auth = {"Authorization": chain.addr}

    async def main():
        jnode, tnode, server, urls = await _serve(jcfg, tcfg)
        replies = []
        try:
            async with aiohttp.ClientSession() as s:
                for method, params, body, headers in [
                        ("GET", {"to_address": dest, "amount": "1.5"}, None,
                         auth),
                        ("POST", None, {"to_address": dest, "amount": "2"},
                         auth),
                        ("POST", {"to_address": dest},
                         {"amount": "0.25"}, auth),
                        ("GET", {"to_address": dest}, None, auth),
                        ("POST", None, {"amount": "1"}, auth),
                        ("GET", {"to_address": dest, "amount": "1"}, None,
                         {"Authorization": dest}),
                        ("GET", {"to_address": dest, "amount": "1"}, None,
                         None),
                        ("GET", {"to_address": dest, "amount": "9999999"},
                         None, auth),
                        ("GET", {"to_address": dest, "amount": "lots"},
                         None, auth),
                        ("GET", {"to_address": dest, "amount": "1"}, None,
                         dict(auth, **{"X-Forwarded-For": "8.8.8.8"})),
                        ("POST", None, {"to_address": dest, "amount": "1"},
                         dict(auth, **{"X-Forwarded-For": "10.1.2.3"})),
                        ("GET", {"to_address": dest, "amount": "1"}, None,
                         dict(auth, **{"X-Real-IP": "127.0.0.1"}))]:
                    replies.append(await _both(s, urls, method,
                                               "/send_to_address", params,
                                               body, headers))
                pending = await _both(s, urls, "GET",
                                      "/get_pending_transactions")
                metrics = {}
                for name in ("jax", "port"):
                    async with s.get(urls[name] + "/metrics") as resp:
                        metrics[name] = await resp.text()
            pools = [[e.tx_hash for e in n.pool.ordered()]
                     for n in (jnode, tnode)]
        finally:
            await _close(jnode, tnode, server)
        return replies, pending, pools, metrics

    replies, pending, pools, metrics = asyncio.run(main())
    statuses = [st for st, _b in replies]
    assert statuses == [200, 200, 200, 422, 422, 200, 200, 200, 200, 403,
                        200, 200]
    bodies = [b for _s, b in replies]
    assert [b["ok"] for b in bodies[:3]] == [True] * 3
    assert bodies[3] == {"ok": False, "error": "Missing required params."}
    assert bodies[5] == bodies[6] == {"ok": False, "error": "Unauthorized"}
    assert "enough funds" in bodies[7]["error"]
    assert bodies[9]["error"].startswith("Access forbidden. This endpoint")
    assert bodies[10]["ok"] and bodies[11]["ok"]
    assert len(pending[1]["result"]) == 5
    assert pools[0] == pools[1] and len(pools[1]) == 5
    for name in ("jax", "port"):
        assert "upow_slo_http_send_to_address_requests_total" in \
            metrics[name]


@pytest.mark.parametrize("allow_rbf", [False, True])
def test_journal_rbf_on_nodes_matches_jax(tmp_path, allow_rbf):
    """A pooled push_tx, then a spend of the same outpoint paying a fee
    written into each node's journal behind its back (as the wallet
    CLI's local path does): the next journal sync replaces the pooled tx
    under ``allow_rbf`` and keeps it otherwise, on both nodes alike."""
    chain = _pair_on_chain(tmp_path)
    jcfg, tcfg = _configs(tmp_path, "")
    for cfg in (jcfg, tcfg):
        cfg.mempool.allow_rbf = allow_rbf
        cfg.cache.revalidate_interval = 0
    T = PORT.tx
    leaves = asyncio.run(_leaves(tmp_path / "chain.db", chain.addr))
    h, i, amount = leaves[0]
    low = chain.spend([(h, i, amount)])
    high = T.Tx([T.TxInput(h, i)], [T.TxOutput(chain.addr, amount - 5000)]
                ).sign([chain.d], lambda _i: chain.pub)

    async def main():
        jnode, tnode, server, urls = await _serve(jcfg, tcfg)
        for node in (jnode, tnode):
            # no mempool GC in the window: it would drop both spenders
            node._last_mempool_clean = time.monotonic()
        base = {"jax": jtrace.counters().get("mempool.rbf", 0),
                "port": ttrace.counters().get("mempool.rbf", 0)}
        try:
            async with aiohttp.ClientSession() as s:
                assert (await _both(s, urls, "POST", "/push_tx",
                                    body={"tx_hex": low.hex()}))[1]["ok"]
                await jnode.state.add_pending_transaction(
                    JAX.tx.tx_from_hex(high.hex()))
                await tnode.state.add_pending_transaction(high)
                info = await _both(s, urls, "GET", "/get_mining_info")
            pools = [[e.tx_hash for e in n.pool.ordered()]
                     for n in (jnode, tnode)]
            spenders = [n.pool.spender_of((h, i)) for n in (jnode, tnode)]
        finally:
            await _close(jnode, tnode, server)
        rbf = [jtrace.counters().get("mempool.rbf", 0) - base["jax"],
               ttrace.counters().get("mempool.rbf", 0) - base["port"]]
        return info[1]["result"], pools, spenders, rbf

    info, pools, spenders, rbf = asyncio.run(main())
    want = high.hash() if allow_rbf else low.hash()
    assert pools[0] == pools[1] == [want]
    assert spenders == [want, want]
    assert rbf == [int(allow_rbf)] * 2
    assert info["pending_transactions_hashes"] == [want]


async def _leaves(path, addr):
    state = PORT.ChainState(str(path))
    try:
        return [(o.tx_hash, o.index, o.amount)
                for o in await state.get_spendable_outputs(addr)]
    finally:
        state.close()
