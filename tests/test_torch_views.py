"""The explorer, address and governance reads of the port's node against
the JAX node's, byte for byte.

One chain is written by the JAX package (difficulty 1.0, frozen clocks):
coinbases to a validator key, its stake and validator registration, a
delegate funded, staked and voting for the validator, an inode funded,
staked, registered and voted for by the validator, and two txs left in
the pending journal.  A JAX node and the port's node, both with the
hot read cache and ``/ws`` at their defaults (on), open copies of it,
and each request goes to both: ``get_address_info`` with no flag, each flag and every flag,
for each role, an unknown and a missing address;
``get_address_transactions`` over pages and the ``_page_param`` 400s;
``get_block_details`` by id, by hash and unknown; ``get_blocks_details``;
``get_validators_info`` and ``get_delegates_info`` with and without a
recipient and with ``_int_q``'s 422; ``dobby_info`` and
``get_supply_info``.  The views behind them are then held directly
against the JAX ``ChainState``'s on the same file.
"""

import asyncio
import json
import shutil
from decimal import Decimal

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu_torch.node.app as tapp
from test_torch_block import JAX, PORT, T0, Chain
from test_torch_gossip import _jcfg, _tcfg
from upow_tpu.core import curve, point_to_string
from upow_tpu.wallet.builders import WalletBuilder

FLAGS = ("show_pending", "verify", "stake_outputs", "delegate_spent_votes",
         "delegate_unspent_votes", "inode_registration_outputs",
         "validator_unspent_votes", "validator_spent_votes", "address_state")
UNKNOWN = "Dz" + "1" * 43


@pytest.fixture(scope="module")
def gov_chain(tmp_path_factory):
    """The governance chain's file, the three roles' addresses and a tip
    hash; clocks frozen after it for the module."""
    saved = [(pkg, pkg.difficulty.START_DIFFICULTY) for pkg in (JAX, PORT)]
    for pkg, _ in saved:
        pkg.difficulty.START_DIFFICULTY = Decimal("1.0")
        pkg.clock.freeze(T0)
    path = tmp_path_factory.mktemp("gov") / "chain.db"

    async def build():
        chain = Chain(JAX, JAX.ChainState(str(path)))
        b = WalletBuilder(chain.state)
        g = chain.d
        d_o, p_o = curve.keygen(rng=0x0DE1)
        d_i, p_i = curve.keygen(rng=0x1DE)
        a_o, a_i = point_to_string(p_o), point_to_string(p_i)

        async def block(txs=()):
            JAX.clock.advance(60)
            ok, errors, _ = await chain.submit(list(txs))
            assert ok, errors

        for _ in range(20):
            await block()
        await block([await b.create_stake_transaction(g, "3")])
        await block([await b.create_validator_registration_transaction(g)])
        await block([await b.create_transaction(g, a_o, "20")])
        await block([await b.create_stake_transaction(d_o, "1")])
        await block([await b.vote_as_delegate(d_o, 10, chain.addr)])
        for _ in range(170):  # an inode registers with 1,000 coins
            await block()
        for chunk in ("400", "400", "210"):
            await block([await b.create_transaction(g, a_i, chunk)])
        await block([await b.create_stake_transaction(d_i, "1")])
        await block([await b.create_inode_registration_transaction(d_i)])
        await block([await b.vote_as_validator(g, 10, a_i)])
        for tx in (await b.create_transaction(g, a_o, "5"),
                   await b.create_transaction(d_i, a_o, "1.5")):
            await chain.state.add_pending_transaction(tx)
        tip = await chain.state.get_last_block()
        chain.state.close()
        return {"validator": chain.addr, "delegate": a_o, "inode": a_i,
                "tip": tip["hash"], "height": tip["id"]}

    roles = asyncio.run(build())
    for pkg, _ in saved:
        pkg.clock.freeze(T0 + 400 * 60)
    yield path, roles
    for pkg, start in saved:
        pkg.difficulty.START_DIFFICULTY = start
        pkg.clock.reset()
        pkg.clear()


def _queries(roles):
    out = []
    for role in ("validator", "delegate", "inode"):
        addr = roles[role]
        out.append(f"/get_address_info?address={addr}")
        out.append(f"/get_address_info?address={addr}&"
                   + "&".join(f"{f}=true" for f in FLAGS))
        out += [f"/get_address_info?address={addr}&{f}=1" for f in FLAGS]
        out += [f"/get_address_transactions?address={addr}",
                f"/get_address_transactions?address={addr}&page=2&limit=3",
                f"/get_address_transactions?address={addr}&page=-4&limit=9999"]
    out += [f"/get_address_info?address={UNKNOWN}&show_pending=true"
            "&address_state=true",
            "/get_address_info", "/get_address_info?address=",
            f"/get_address_transactions?address={UNKNOWN}",
            "/get_address_transactions",
            "/get_address_transactions?address=x&page=one",
            "/get_address_transactions?address=x&limit=1.5",
            "/get_block_details?block=1", "/get_block_details?block=22",
            f"/get_block_details?block={roles['height']}",
            f"/get_block_details?block={roles['tip']}",
            "/get_block_details?block=99999", "/get_block_details?block=ab",
            "/get_block_details",
            "/get_blocks_details?offset=0&limit=3",
            f"/get_blocks_details?offset={roles['height'] - 7}&limit=10",
            "/get_blocks_details?offset=-5&limit=2",
            "/get_blocks_details?offset=zz",
            "/get_validators_info", f"/get_validators_info?inode={roles['inode']}",
            f"/get_validators_info?inode={UNKNOWN}",
            "/get_validators_info?offset=1", "/get_validators_info?limit=5000",
            "/get_validators_info?offset=abc", "/get_validators_info?limit=2.5",
            "/get_delegates_info",
            f"/get_delegates_info?validator={roles['validator']}",
            "/get_delegates_info?validator=nobody",
            "/get_delegates_info?offset=-1&limit=-1",
            "/get_delegates_info?offset=x",
            "/dobby_info", "/get_supply_info"]
    return out


def test_read_routes_match_jax(tmp_path, gov_chain):
    path, roles = gov_chain
    for name in ("jax", "port"):
        shutil.copyfile(path, tmp_path / f"{name}.db")
    queries = _queries(roles)

    async def main():
        jnode = japp.Node(_jcfg(tmp_path, "jax"))
        tnode = tapp.Node(_tcfg(tmp_path, "port"), device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        bases = (f"http://127.0.0.1:{server.port}",
                 f"http://127.0.0.1:{tserver.port}")
        out = []
        try:
            async with aiohttp.ClientSession() as session:
                for q in queries:
                    got = []
                    for base in bases:
                        async with session.get(base + q) as r:
                            got.append((r.status, await r.read()))
                    out.append((q, got))
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()
        return out

    out = asyncio.run(main())
    for q, (want, got) in out:
        assert got == want, q
    bodies = dict((q, got) for q, (_w, got) in out)
    # the chain really holds what the routes read
    status, body = bodies["/dobby_info"]
    assert status == 200 and roles["inode"].encode() in body
    assert b"%" in body
    status, body = bodies[f"/get_validators_info?inode={roles['inode']}"]
    assert roles["validator"].encode() in body
    status, body = bodies[f"/get_delegates_info?validator={roles['validator']}"]
    assert roles["delegate"].encode() in body
    all_flags = f"/get_address_info?address={roles['inode']}&" + "&".join(
        f"{f}=true" for f in FLAGS)
    assert b'"is_inode": true, "is_inode_active": true' in bodies[all_flags][1]
    assert bodies["/get_validators_info?offset=abc"] == (
        422, b'{"ok": false, "error": "Invalid integer parameter offset"}')
    assert bodies["/get_address_transactions?address=x&page=one"] == (
        400, b'{"ok": false, "error": "page must be an integer"}')
    assert bodies["/get_address_info"][0] == 422


@pytest.mark.parametrize("view", [
    "get_transactions_info", "get_address_stake", "get_validators_stake",
    "get_inode_vote_ratio_by_address", "get_validators_spent_votes",
    "get_delegates_spent_votes", "get_ballots", "get_ballot_by_recipient",
    "get_outputs_by_address", "get_address_transactions",
    "get_address_pending_transactions",
    "get_address_pending_spent_outpoints", "get_active_inodes",
    "get_nice_transaction", "get_blocks"])
def test_views_match_jax(gov_chain, view):
    path, roles = gov_chain

    async def calls(state):
        g, o, i = roles["validator"], roles["delegate"], roles["inode"]
        hashes = [r["tx_hash"] for r in
                  await state.get_address_transactions(o, limit=50)]
        pending = [t.hash() for t in
                   await state.get_address_pending_transactions(o)]
        args = {
            "get_transactions_info": [(hashes + ["00" * 32],)],
            "get_address_stake": [(a,) for a in (g, o, i, UNKNOWN)]
            + [(a, True) for a in (g, o, i)],
            "get_validators_stake": [(g,), (g, True), (o,), (UNKNOWN,)],
            "get_inode_vote_ratio_by_address": [(i,), (i, True), (g,)],
            "get_validators_spent_votes": [(g,), (o,), (g, True)],
            "get_delegates_spent_votes": [(o,), (g,), (o, True)],
            "get_ballots": [("inodes_ballot",), ("validators_ballot",),
                            ("validators_ballot", g), ("inodes_ballot", o),
                            ("validators_ballot", None, 1, 5)],
            "get_ballot_by_recipient": [("validators_ballot", g),
                                        ("inodes_ballot", i),
                                        ("inodes_ballot", i, True)],
            "get_outputs_by_address": [
                ("unspent_outputs", g), ("unspent_outputs", g, False, True),
                ("unspent_outputs", o, True, False),
                ("delegates_voting_power", o), ("validators_voting_power", g),
                ("inode_registration_output", i)],
            "get_address_transactions": [(g,), (o, 2, 1), (i, 50, 0),
                                         (UNKNOWN,)],
            "get_address_pending_transactions": [(o,), (g,), (i,),
                                                 (UNKNOWN,)],
            "get_address_pending_spent_outpoints": [(g,), (i,), (o,)],
            "get_active_inodes": [(), (True,)],
            "get_nice_transaction": [(h, a) for h in hashes[:3] + pending
                                     for a in (None, g, o, i)],
            "get_blocks": [(0, 4, True), (roles["height"] - 6, 8, True),
                           (5, 3, False, True)],
        }[view]
        out = []
        for a in args:
            value = await getattr(state, view)(*a)
            if view in ("get_address_pending_transactions",):
                value = [t.hex() for t in value]
            out.append(value)
        return out

    got = []
    for pkg in (JAX, PORT):
        state = pkg.ChainState(str(path))
        try:
            got.append(asyncio.run(calls(state)))
        finally:
            state.close()
    assert got[0] == got[1]
    assert any(got[1])


def test_dobby_info_follows_an_accept_after_a_read(tmp_path, gov_chain):
    """C3: the accept refreshes the read routes' active-inode cache from
    the list its rewards read (JAX ``verify/block.py:546-549``).  After a
    first ``/dobby_info`` read, a second delegate is funded, stakes and
    votes for the validator (the inode's power doubles), then an empty
    block, each pushed to both nodes: the two ``/dobby_info`` bodies,
    and ``get_address_info``'s ``is_inode_active``, stay equal, and the
    power moved.  Before the repair the port's node served the first
    read's list for 300 s."""
    path, roles = gov_chain
    for name in ("jax", "port", "build"):
        shutil.copyfile(path, tmp_path / f"{name}.db")
    t_read = JAX.clock.timestamp()

    async def build():
        chain = Chain(JAX, JAX.ChainState(str(tmp_path / "build.db")))
        b = WalletBuilder(chain.state)
        d_n, p_n = curve.keygen(rng=0x2DE1)
        blocks = []
        for make in (
                lambda: b.create_transaction(chain.d, point_to_string(p_n),
                                             "3"),
                lambda: b.create_stake_transaction(d_n, "1"),
                lambda: b.vote_as_delegate(d_n, 10, chain.addr), None):
            txs = [await make()] if make else []
            JAX.clock.advance(60)
            content = await chain.header(txs)
            errors = []
            assert await chain.manager.create_block(content, txs,
                                                    errors=errors), errors
            tip = await chain.state.get_last_block()
            blocks.append({"block_content": content,
                           "txs": [t.hex() for t in txs],
                           "block_no": tip["id"]})
        chain.state.close()
        return blocks

    blocks = asyncio.run(build())
    PORT.clock.freeze(JAX.clock.timestamp())
    info = (f"/get_address_info?address={roles['inode']}"
            "&address_state=true")

    async def main():
        jnode = japp.Node(_jcfg(tmp_path, "jax"))
        tnode = tapp.Node(_tcfg(tmp_path, "port"), device="cpu")
        server = TestServer(jnode.app)
        await server.start_server()
        tserver = await tnode.serve("127.0.0.1", 0)
        bases = (f"http://127.0.0.1:{server.port}",
                 f"http://127.0.0.1:{tserver.port}")
        out = []
        try:
            async with aiohttp.ClientSession() as session:
                async def both(method, q, body=None):
                    got = []
                    for base in bases:
                        async with session.request(method, base + q,
                                                   json=body) as r:
                            got.append((r.status, await r.read()))
                    assert got[1] == got[0], q
                    return got[1]

                out.append(await both("GET", "/dobby_info"))
                out.append(await both("GET", info))
                for body in blocks:
                    assert await both("POST", "/push_block", body) == \
                        (200, b'{"ok": true}')
                out.append(await both("GET", "/dobby_info"))
                out.append(await both("GET", info))
        finally:
            await server.close()
            await jnode.close()
            await tnode.close()
        return out

    try:
        first, first_info, after, after_info = asyncio.run(main())
    finally:
        for pkg in (JAX, PORT):
            pkg.clock.freeze(t_read)
    assert first[0] == after[0] == 200
    before = json.loads(first[1])["result"]
    now = json.loads(after[1])["result"]
    assert [e["wallet"] for e in before] == [e["wallet"] for e in now] \
        == [roles["inode"]]
    assert now[0]["power"] != before[0]["power"]
    assert b'"is_inode_active": true' in after_info[1]
