"""The port's wallet (``upow_tpu_torch.wallet``) against the JAX package's.

JAX ``tests/test_wallet.py``'s scenarios run once on each package, with
the same seeded keys, the same frozen clocks and the same order of
calls: each package builds its own chain with its own ``BlockManager``
(the port's on ``device="cpu"``) and its own ``WalletBuilder``.  Signing
is RFC 6979 in both, so every built tx must be the same bytes.  Each run
logs every built ``tx.hex()``, every builder refusal's text, the UTXO
fingerprint after each block, the balances the JAX test asserts and,
where txs wait in the journal, every state view the builders read (with
and without ``check_pending_txs``); the two logs must be equal.  The
scenarios that reach all ten builders also run on the pg backend over
each package's ``MockPgDriver``.

Besides: the keystore's file text after seeded ``create_key`` calls, the
CLI's two scenarios with both CLIs printing the same lines and returning
the same codes, the nodeless wallet against a JAX and a port node (the
same tx hex from all four pairings), and a subprocess that imports and
runs the wallet with CUDA's initialisation made to raise:
``torch.cuda.is_initialized()`` stays False.
"""

import asyncio
import json
import os
import random
import subprocess
import sys
from decimal import Decimal
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestServer

import upow_tpu.node.app as japp
import upow_tpu.state.pg as jpg
import upow_tpu.state.pgdriver as jdrv
import upow_tpu.verify as jverify
import upow_tpu.verify.txverify as jtxverify
import upow_tpu.wallet.builders as jbuilders
import upow_tpu.wallet.cli as jcli
import upow_tpu.wallet.keystore as jkeystore
import upow_tpu.wallet.nodeless as jnodeless
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.pgdriver as tdrv
import upow_tpu_torch.verify as tverify
import upow_tpu_torch.verify.txverify as ttxverify
import upow_tpu_torch.wallet.builders as tbuilders
import upow_tpu_torch.wallet.cli as tcli
import upow_tpu_torch.wallet.keystore as tkeystore
import upow_tpu_torch.wallet.nodeless as tnodeless
from test_torch_block import GENESIS_PREV, JAX, PORT, T0
from test_torch_gossip import _jcfg, _tcfg
from test_wallet import make_actors
from upow_tpu.core import curve, point_to_string
from upow_tpu.core.constants import SMALLEST

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


async def _jax_intake_ok(state, tx) -> bool:
    return await jtxverify.TxVerifier(state).verify_pending(
        tx, sig_backend="host")


async def _port_intake_ok(state, tx) -> bool:
    checks = await ttxverify.TxVerifier(state).prepare_pending(tx)
    return checks is not None and all(await ttxverify.run_sig_checks_async(
        checks, backend="host", device="cpu"))


W = {
    "jax": SimpleNamespace(
        pg=jpg, drv=jdrv, builders=jbuilders, cli=jcli, keystore=jkeystore,
        nodeless=jnodeless, intake_ok=_jax_intake_ok,
        manager=lambda st: jverify.BlockManager(st, sig_backend="host")),
    "port": SimpleNamespace(
        pg=tpg, drv=tdrv, builders=tbuilders, cli=tcli, keystore=tkeystore,
        nodeless=tnodeless, intake_ok=_port_intake_ok,
        manager=lambda st: tverify.BlockManager(st, device="cpu")),
}


@pytest.fixture(autouse=True)
def easy_chain(monkeypatch):
    """Difficulty 1.0 and a frozen clock in both packages."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()


def _plain(value):
    """A logged value in plain, exactly comparable form."""
    if hasattr(value, "outputs") and hasattr(value, "hex"):
        return ("tx", value.hex())
    if hasattr(value, "tx_hash") and hasattr(value, "index") \
            and not isinstance(value, dict):
        return ("input", value.tx_hash, value.index,
                getattr(value, "amount", None))
    if isinstance(value, Decimal):
        return ("decimal", str(value))
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple, set)):
        items = sorted(value) if isinstance(value, set) else value
        return [_plain(v) for v in items]
    return value


class Run:
    """One package's run of a scenario on one backend: its chain, its
    builder and the log of everything the scenario observed."""

    def __init__(self, pkg, backend: str = "sqlite", path=None, state=None):
        """A fresh chain from ``T0`` (in memory, or on the pg mock), or
        the sqlite file at ``path``, or ``state``, on the package's
        running clock."""
        self.pkg, self.w = pkg, W[pkg.name]
        if state is not None:
            self.state = state
        elif path is not None:
            self.state = pkg.ChainState(path)
        elif backend == "sqlite":
            pkg.clock.freeze(T0)
            self.state = pkg.ChainState()
        else:
            pkg.clock.freeze(T0)
            self.state = self.w.pg.PgChainState(
                driver=self.w.drv.MockPgDriver())
        self.manager = self.w.manager(self.state)
        self.builder = self.w.builders.WalletBuilder(self.state)
        self.log = []

    def note(self, *values):
        self.log.append(_plain(values))

    async def mine(self, address, include_pending=False):
        """Mine and accept one block 60 s after the last; log its UTXO
        fingerprint."""
        pkg = self.pkg
        pkg.clock.advance(60)
        txs = []
        if include_pending:
            txs = await self.state.get_pending_transactions_limit(
                hex_only=False)
        diff, last = await self.manager.calculate_difficulty()
        prev = last["hash"] if last else GENESIS_PREV
        h = pkg.header.BlockHeader(
            previous_hash=prev, address=address,
            merkle_root=pkg.merkle.merkle_root(txs),
            timestamp=pkg.clock.timestamp(),
            difficulty_x10=int(diff * 10), nonce=0)
        while last and not pkg.difficulty.check_pow(h.hex(), prev, diff):
            h.nonce += 1
        errors = []
        assert await self.manager.create_block(h.hex(), txs, errors=errors), \
            errors
        self.note("block", len(txs),
                  await self.state.get_unspent_outputs_hash())

    async def push(self, build):
        """Await a builder; log the tx and add it to the journal."""
        tx = await build
        self.note("tx", tx)
        await self.state.add_pending_transaction(tx)
        return tx

    async def refused(self, build, match: str):
        """Await a builder that must refuse; log the refusal's text."""
        with pytest.raises(ValueError, match=match) as e:
            await build
        self.note("refused", str(e.value))

    async def views(self, addresses):
        """Log every state view the builders read, for each address,
        with and without the pending overlay."""
        st = self.state
        for cp in (False, True):
            self.note("active", await st.get_active_inodes(
                check_pending_txs=cp))
            for a in addresses:
                for table in ("inode_registration_output",
                              "validators_voting_power",
                              "delegates_voting_power"):
                    self.note(table, a, await st.get_outputs_by_address(
                        table, a, check_pending_txs=cp))
                for table in ("inodes_ballot", "validators_ballot"):
                    votes = await st.get_votes_by_voter(
                        table, a, check_pending_txs=cp)
                    self.note(table, a, votes, [
                        await st.is_revoke_valid(v["tx_hash"])
                        for v in votes])
                self.note("roles", a, await st.is_inode_registered(
                    a, check_pending_txs=cp), await st.is_validator_registered(
                    a, check_pending_txs=cp))
                self.note("outputs", a, await st.get_spendable_outputs(
                    a, check_pending_txs=cp), await st.get_stake_outputs(
                    a, check_pending_txs=cp))
                self.note("power", a, await st.get_delegates_all_power(
                    a, check_pending_txs=cp),
                    await st.get_delegates_spent_votes(
                        a, check_pending_txs=cp))
        for a in addresses:
            self.note("pending", a,
                      await st.get_pending_stake_transactions(a),
                      await st.get_pending_vote_as_delegate_transactions(a))


def _both(scenario, backend="sqlite"):
    """Run ``scenario`` on each package; the two logs must be equal."""
    logs = {}
    for pkg in (JAX, PORT):
        run = Run(pkg, backend)
        try:
            asyncio.run(scenario(run))
        finally:
            run.state.close()
            pkg.clear()
        logs[pkg.name] = run.log
    assert len(logs["port"]) > 5
    assert logs["port"] == logs["jax"]
    return logs["port"]


# --------------------------------------------------------------- scenarios --

async def send_and_sendmany(r):
    a = make_actors()
    d_g, a_g = a["genesis"]
    d_o, a_o = a["outsider"]
    d_i, a_i = a["inode"]
    for _ in range(3):
        await r.mine(a_g)
    await r.push(r.builder.create_transaction(d_g, a_o, "2.5"))
    await r.views([a_g, a_o])
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_address_balance(a_o) == \
        int(Decimal("2.5") * SMALLEST)
    await r.push(r.builder.create_transaction_to_send_multiple_wallet(
        d_g, [a_o, a_i], ["1", "3"]))
    await r.mine(a_g, include_pending=True)
    r.note("balances", await r.state.get_address_balance(a_o),
           await r.state.get_address_balance(a_i))
    assert await r.state.get_address_balance(a_i) == 3 * SMALLEST
    await r.refused(r.builder.create_transaction(d_o, a_g, "1000000"),
                    "enough funds")
    await r.refused(r.builder.create_transaction_to_send_multiple_wallet(
        d_g, [a_o], ["1", "2"]), "length is different")
    await r.refused(r.builder.create_transaction(d_g, a_o, "0.000000001"),
                    "more than 8 decimals")


async def governance_end_to_end(r):
    a = make_actors()
    d_g, a_g = a["genesis"]
    d_i, a_i = a["inode"]
    d_v, a_v = a["validator"]
    d_d, a_d = a["delegate"]
    everyone = [a_g, a_i, a_v, a_d]
    b = r.builder
    for _ in range(360):
        await r.mine(a_g)
    await r.push(b.create_transaction_to_send_multiple_wallet(
        d_g, [a_i, a_d], ["1011", "21"]))
    await r.push(b.create_transaction(d_g, a_v, "1111"))
    await r.mine(a_g, include_pending=True)
    for d in (d_i, d_v, d_d):
        await r.push(b.create_stake_transaction(d, "10"))
    await r.views(everyone)
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_address_stake(a_d) == 10
    await r.refused(b.create_stake_transaction(d_d, "1"), "Already staked")
    await r.push(b.create_validator_registration_transaction(d_v))
    await r.views(everyone)
    await r.mine(a_g, include_pending=True)
    await r.refused(b.create_validator_registration_transaction(d_v),
                    "already registered as validator")
    await r.refused(b.create_inode_registration_transaction(d_v),
                    "cannot be an inode")
    await r.push(b.create_inode_registration_transaction(d_i))
    await r.mine(a_g, include_pending=True)
    await r.refused(b.vote_as_delegate(d_d, 10, a_i),
                    "not registered as a validator")
    await r.refused(b.create_voting_transaction(d_d, 11, a_v), "range of 10")
    await r.refused(b.create_voting_transaction(d_d, "x", a_v),
                    "Invalid voting range")
    await r.push(b.create_voting_transaction(d_d, 10, a_v))
    await r.views(everyone)
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_validators_stake(a_v) == 10
    await r.push(b.create_voting_transaction(d_v, 10, a_i))
    await r.mine(a_g, include_pending=True)
    active = await r.state.get_active_inodes()
    assert [i["wallet"] for i in active] == [a_i]
    d_o, a_o = a["outsider"]
    await r.mine(a_o)  # the emission gate is open: a 50/50 coinbase
    r.note("coinbase split", await r.state.get_address_balance(a_o),
           await r.state.get_address_balance(a_i))
    await r.refused(b.create_revoke_transaction(d_d, a_v), "48 hrs")
    await r.refused(b.create_unstake_transaction(d_d), "release the votes")
    r.pkg.clock.advance(48 * 3600)
    await r.push(b.create_revoke_transaction(d_d, a_v))
    await r.views(everyone)
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_unstake_transaction(d_d))
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_address_stake(a_d) == 0
    assert await r.state.get_address_balance(a_d) == 21 * SMALLEST
    await r.refused(b.create_unstake_transaction(d_d), "nothing staked")
    await r.refused(b.create_revoke_transaction(d_o, a_v),
                    "Not eligible to revoke")
    await r.refused(b.create_voting_transaction(d_o, 5, a_v),
                    "Not eligible to vote")
    fingerprint = await r.state.get_unspent_outputs_hash()
    await r.state.rebuild_utxos()
    assert await r.state.get_unspent_outputs_hash() == fingerprint


async def inode_deregistration_and_validator_revoke(r):
    a = make_actors()
    d_g, a_g = a["genesis"]
    d_i, a_i = a["inode"]
    d_v, a_v = a["validator"]
    d_d, a_d = a["delegate"]
    b = r.builder
    for _ in range(195):
        await r.mine(a_g)
    await r.push(b.create_transaction_to_send_multiple_wallet(
        d_g, [a_i, a_v, a_d], ["1011", "111", "21"]))
    await r.mine(a_g, include_pending=True)
    for d in (d_i, d_v, d_d):
        await r.push(b.create_stake_transaction(d, "10"))
    await r.mine(a_g, include_pending=True)
    await r.refused(b.create_inode_de_registration_transaction(d_i),
                    "not registered as an inode")
    await r.push(b.create_validator_registration_transaction(d_v))
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_inode_registration_transaction(d_i))
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_voting_transaction(d_v, 10, a_i))
    await r.mine(a_g, include_pending=True)
    await r.refused(b.create_inode_de_registration_transaction(d_i),
                    "active inode")
    await r.refused(b.create_voting_transaction(d_i, 1, a_v),
                    "registered as inode. Cannot vote")
    r.pkg.clock.advance(48 * 3600 + 60)
    await r.push(b.create_revoke_transaction(d_v, a_i))
    await r.views([a_i, a_v])
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_active_inodes() == []
    before = await r.state.get_address_balance(a_i)
    await r.push(b.create_inode_de_registration_transaction(d_i))
    await r.views([a_i, a_v])
    await r.mine(a_g, include_pending=True)
    assert not await r.state.is_inode_registered(a_i)
    assert await r.state.get_address_balance(a_i) == before + 1000 * SMALLEST


async def active_inodes_batch_matches_cascade(r):
    keys = {}
    for j, nm in enumerate(["g", "i1", "i2", "v1", "v2", "d1", "d2", "d3"]):
        d, pub = curve.keygen(rng=7700 + j)
        keys[nm] = (d, point_to_string(pub))
    d_g, a_g = keys["g"]
    b = r.builder
    for _ in range(420):
        await r.mine(a_g)
    await r.push(b.create_transaction_to_send_multiple_wallet(
        d_g, [keys["i1"][1], keys["d1"][1], keys["d2"][1], keys["d3"][1]],
        ["1011", "41", "31", "21"]))
    await r.push(b.create_transaction(d_g, keys["i2"][1], "1011"))
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_transaction_to_send_multiple_wallet(
        d_g, [keys["v1"][1], keys["v2"][1]], ["131", "121"]))
    await r.mine(a_g, include_pending=True)
    for nm, amt in (("i1", "10"), ("i2", "10"), ("v1", "20"), ("v2", "10"),
                    ("d1", "30"), ("d2", "20"), ("d3", "10")):
        await r.push(b.create_stake_transaction(keys[nm][0], amt))
    await r.mine(a_g, include_pending=True)
    for nm in ("v1", "v2"):
        await r.push(b.create_validator_registration_transaction(
            keys[nm][0]))
    await r.mine(a_g, include_pending=True)
    for nm in ("i1", "i2"):
        await r.push(b.create_inode_registration_transaction(keys[nm][0]))
    await r.mine(a_g, include_pending=True)
    for voter, rng_, to in (("d1", 6, "v1"), ("d2", 10, "v2"),
                            ("d3", 5, "v1")):
        await r.push(b.create_voting_transaction(keys[voter][0], rng_,
                                                 keys[to][1]))
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_voting_transaction(keys["v1"][0], 7, keys["i1"][1]))
    await r.push(b.create_voting_transaction(keys["v2"][0], 10,
                                             keys["i2"][1]))
    await r.mine(a_g, include_pending=True)

    async def compare(cp: bool):
        active = await r.state.get_active_inodes(check_pending_txs=cp)
        registered = await r.state.get_registered(
            "inode_registration_output", check_pending_txs=cp)
        for address, _ in registered:
            oracle = await r.state.get_inode_vote_ratio_by_address(
                address, check_pending_txs=cp)
            got = [d["power"] for d in active if d["wallet"] == address]
            if got:
                assert got == [oracle], (address, got, oracle)
        r.note("active", cp, active, registered)
        return active

    assert len(await compare(False)) == 2
    r.pkg.clock.advance(48 * 3600 + 60)
    await r.push(b.create_revoke_transaction(keys["d2"][0], keys["v2"][1]))
    d_o, pub_o = curve.keygen(rng=7799)
    await r.push(b.create_transaction(d_g, point_to_string(pub_o), "15"))
    await compare(True)
    await r.views([keys[nm][1] for nm in ("v1", "v2", "d2", "i2")])


async def governance_reorg_rollback(r):
    a = make_actors()
    d_g, a_g = a["genesis"]
    d_v, a_v = a["validator"]
    d_d, a_d = a["delegate"]
    b = r.builder
    for _ in range(40):
        await r.mine(a_g)
    await r.push(b.create_transaction_to_send_multiple_wallet(
        d_g, [a_v, a_d], ["111", "21"]))
    await r.mine(a_g, include_pending=True)
    for d in (d_v, d_d):
        await r.push(b.create_stake_transaction(d, "10"))
    await r.mine(a_g, include_pending=True)
    await r.push(b.create_validator_registration_transaction(d_v))
    await r.mine(a_g, include_pending=True)
    pre_vote_fp = await r.state.get_full_state_hash()
    pre_power = await r.state.get_delegates_voting_power(a_d)
    vote_block_id = await r.state.get_next_block_id()
    await r.push(b.create_voting_transaction(d_d, 10, a_v))
    await r.mine(a_g, include_pending=True)
    assert await r.state.get_delegates_voting_power(a_d) == []
    await r.state.remove_blocks(vote_block_id)
    r.note("after reorg", await r.state.get_full_state_hash(),
           await r.state.get_delegates_voting_power(a_d))
    assert await r.state.get_full_state_hash() == pre_vote_fp
    assert await r.state.get_delegates_voting_power(a_d) == pre_power
    await r.views([a_v, a_d])
    await r.state.rebuild_utxos()
    assert await r.state.get_full_state_hash() == pre_vote_fp


async def governance_randomized_churn(r):
    """JAX test_governance_randomized_churn's 10 rounds, the retarget
    pinned to 1.0 (the 49 h clock jumps)."""
    rng = random.Random(777)
    a = make_actors()
    d_g, a_g = a["genesis"]
    roles = {k: a[k] for k in ("inode", "validator", "delegate", "outsider")}
    b = r.builder
    for _ in range(250):
        await r.mine(a_g)
    funding = {"inode": "1100", "validator": "160", "delegate": "80",
               "outsider": "40"}
    for name, (_d, addr) in roles.items():
        await r.push(b.create_transaction(d_g, addr, Decimal(funding[name])))
        await r.mine(a_g, include_pending=True)
    for d_x in (roles["inode"][0], roles["validator"][0]):
        await r.push(b.create_stake_transaction(d_x, Decimal("50")))
        await r.mine(a_g, include_pending=True)
    d_i, a_i = roles["inode"]
    d_v, a_v = roles["validator"]
    d_d, a_d = roles["delegate"]
    d_o, a_o = roles["outsider"]
    ops = [
        ("send", lambda: b.create_transaction(
            d_g, a_o, Decimal(rng.randrange(1, 30)) / 10)),
        ("stake_d", lambda: b.create_stake_transaction(
            d_d, Decimal(rng.randrange(10, 60)))),
        ("unstake_d", lambda: b.create_unstake_transaction(d_d)),
        ("reg_inode", lambda: b.create_inode_registration_transaction(d_i)),
        ("dereg_inode",
         lambda: b.create_inode_de_registration_transaction(d_i)),
        ("reg_val", lambda: b.create_validator_registration_transaction(d_v)),
        ("vote_v", lambda: b.vote_as_validator(d_v, rng.randrange(1, 11),
                                               a_i)),
        ("vote_d", lambda: b.vote_as_delegate(d_d, rng.randrange(1, 11),
                                              a_v)),
        ("revoke_v", lambda: b.revoke_vote_as_validator(d_v, a_i)),
        ("revoke_d", lambda: b.create_revoke_transaction(d_d, a_v)),
        ("stake_o", lambda: b.create_stake_transaction(
            d_o, Decimal(rng.randrange(5, 25)))),
        ("unstake_o", lambda: b.create_unstake_transaction(d_o)),
    ]
    applied = set()
    for rnd in range(10):
        name, fn = ops[rng.randrange(len(ops))]
        if "revoke" in name and rng.random() < 0.5:
            r.pkg.clock.advance(49 * 3600)
        try:
            tx = await fn()
            if not await r.w.intake_ok(r.state, tx):
                raise ValueError("rejected at intake")
            r.note("applied", name, tx)
            await r.state.add_pending_transaction(tx)
            applied.add(name)
        except ValueError as e:
            r.note("rejected", name, str(e))
        await r.mine(a_g, include_pending=True)
        if rng.random() < 0.25:
            tip = await r.state.get_next_block_id()
            depth = rng.randrange(1, 4)
            if tip - depth > 8:
                await r.state.remove_blocks(tip - depth)
                r.manager.invalidate_difficulty()
                await r.manager.clear_pending_transactions()
                for _ in range(depth):
                    await r.mine(a_g, include_pending=True)
        live = await r.state.get_unspent_outputs_hash()
        await r.state.rebuild_utxos()
        assert await r.state.get_unspent_outputs_hash() == live, rnd
        for table in ("inodes_ballot", "validators_ballot"):
            rows = await r.state._all_ballot_rows(table, False)
            r.note(table, rows)
            assert all(row["voter"] is not None for row in rows)
    assert applied


SCENARIOS = {f.__name__: f for f in (
    send_and_sendmany, governance_end_to_end,
    inode_deregistration_and_validator_revoke,
    active_inodes_batch_matches_cascade, governance_reorg_rollback,
    governance_randomized_churn)}

#: the scenarios that between them reach all ten builders, run on pg too
PG_SCENARIOS = ("send_and_sendmany", "governance_end_to_end",
                "inode_deregistration_and_validator_revoke")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax_on_sqlite(name, monkeypatch):
    if name == "governance_randomized_churn":
        for pkg in (JAX, PORT):
            monkeypatch.setattr(pkg.difficulty, "next_difficulty",
                                lambda *_a, **_k: Decimal("1.0"))
    log = _both(SCENARIOS[name])
    assert any(entry[0] == "tx" for entry in log)


@pytest.mark.parametrize("name", PG_SCENARIOS)
def test_scenario_matches_jax_on_pg(name):
    log = _both(SCENARIOS[name], backend="pg")
    assert any(entry[0] == "tx" for entry in log)


def test_ten_builders_reached(monkeypatch):
    """The pg scenarios call every builder of the port's WalletBuilder
    (the ten of the reference, and the role dispatches' targets), and
    the JAX package's has the same ones."""
    names = {n for n in dir(jbuilders.WalletBuilder)
             if n.startswith(("create_", "vote_", "revoke_"))}
    assert names == {n for n in dir(tbuilders.WalletBuilder)
                     if n.startswith(("create_", "vote_", "revoke_"))}
    called = set()
    for n in names:
        real = getattr(tbuilders.WalletBuilder, n)

        async def spy(self, *a, _n=n, _real=real, **k):
            called.add(_n)
            return await _real(self, *a, **k)
        monkeypatch.setattr(tbuilders.WalletBuilder, n, spy)
    for name in PG_SCENARIOS:
        run = Run(PORT, "pg")
        try:
            asyncio.run(SCENARIOS[name](run))
        finally:
            run.state.close()
            PORT.clear()
    assert called == names


@pytest.mark.parametrize("inputs, amount", [
    ([5, 1, 9, 3], 4), ([5, 1, 9, 3], 12), ([5, 1, 9, 3], 30), ([], 1),
    ([2, 2, 2], 2), ([7], 7)])
def test_select_inputs_and_units_match_jax(inputs, amount):
    picks = []
    for pkg, builders in ((JAX, jbuilders), (PORT, tbuilders)):
        ins = []
        for k, a in enumerate(inputs):
            i = pkg.tx.TxInput("%064x" % k, k)
            i.amount = a
            ins.append(i)
        picks.append([(i.index, i.amount) for i in
                      builders.select_transaction_inputs(ins, amount)])
    assert picks[0] == picks[1]
    for text in ("1", "2.5", "0.00000001", "21000000"):
        assert tbuilders._to_units(text) == jbuilders._to_units(text)


# ---------------------------------------------------------------- keystore --

def test_keystore_file_text_matches_jax(tmp_path, monkeypatch):
    texts = {}
    _seeded_keygen(monkeypatch, 31)
    for name in ("jax", "port"):
        ks = W[name].keystore
        path = tmp_path / f"{name}.json"
        store = ks.KeyStore(str(path))
        made = [store.create_key() for _ in range(3)]
        again = ks.KeyStore(str(path))
        assert again.keys() == store.keys()
        assert again.addresses() == [m[1] for m in made]
        assert [again.private_key_for_public(m[1]) for m in made] == \
            [m[0] for m in made]
        assert again.private_key_for_public("bogus") is None
        texts[name] = path.read_text()
    assert texts["port"] == texts["jax"]
    doc = json.loads(texts["port"])
    assert sorted(doc) == ["keys"] and all(
        sorted(k) == ["private_key", "public_key"] and
        isinstance(k["private_key"], int) for k in doc["keys"])
    monkeypatch.chdir(tmp_path)
    assert tkeystore.KeyStore().path == str(tmp_path / "key_pair_list.json")


# --------------------------------------------------------------------- CLI --

def _seeded_keygen(monkeypatch, seed):
    """Each package's ``curve.keygen()`` draws its keys from its own
    ``random.Random(seed)``; an explicit ``rng`` is honoured."""
    for name in ("jax", "port"):
        ks = W[name].keystore
        draw = random.Random(seed)
        real = ks.curve.keygen
        monkeypatch.setattr(
            ks.curve, "keygen", lambda rng=None, real=real, draw=draw: real(
                rng=draw.getrandbits(255) if rng is None else rng))


async def _mine_file(pkg, path, address, blocks, include_pending=False):
    """Mine ``blocks`` blocks to ``address`` on the chain file at ``path``
    with the package's own code."""
    run = Run(pkg, path=path)
    try:
        for _ in range(blocks):
            await run.mine(address, include_pending=include_pending)
    finally:
        run.state.close()


def _cli_lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


def test_cli_end_to_end_matches_jax(tmp_path, capsys, monkeypatch):
    """createwallet, balance, send with the node unreachable (the local
    mempool path), the mined send, and a missing key file: both CLIs print
    the same lines and return the same codes."""
    _seeded_keygen(monkeypatch, 5)
    out = {}
    for pkg in (JAX, PORT):
        cli = W[pkg.name].cli
        pkg.clock.freeze(T0)
        wallet = str(tmp_path / f"{pkg.name}.keys.json")
        db = str(tmp_path / f"{pkg.name}.chain.db")
        lines, codes = [], []

        async def scenario():
            codes.append(await cli.amain(["createwallet", "--wallet", wallet,
                                          "--db", db, "--node", ""]))
            lines.extend(_cli_lines(capsys))
            d = int(W[pkg.name].keystore.KeyStore(wallet).keys()[0][
                "private_key"])
            addr = point_to_string(curve.point_mul(d, curve.G))
            await _mine_file(pkg, db, addr, 2)
            codes.append(await cli.amain(["balance", "--wallet", wallet,
                                          "--db", db, "--node", ""]))
            lines.extend(_cli_lines(capsys))
            dest = point_to_string(curve.keygen(rng=31337)[1])
            codes.append(await cli.amain([
                "send", "-to", dest, "-a", "2.5", "-m", "cli e2e",
                "--wallet", wallet, "--db", db,
                "--node", "http://127.0.0.1:9"]))
            lines.extend(_cli_lines(capsys))
            await _mine_file(pkg, db, addr, 1, include_pending=True)
            codes.append(await cli.amain(["balance", "--wallet", wallet,
                                          "--db", db, "--node", ""]))
            lines.extend(_cli_lines(capsys))
            codes.append(await cli.amain([
                "send", "-to", dest, "-a", "1", "--wallet",
                str(tmp_path / "none.json"), "--db", db, "--node", ""]))
            codes.append(await cli.amain([
                "send", "-to", dest, "-a", "99999", "--wallet", wallet,
                "--db", db, "--node", ""]))
            codes.append(await cli.amain(["stake", "-a", "1", "--wallet",
                                          wallet, "--node", "", "--db", ""]))
            lines.extend(_cli_lines(capsys))
        asyncio.run(scenario())
        out[pkg.name] = (codes, lines)
    assert out["port"] == out["jax"]
    codes, lines = out["port"]
    assert codes == [0, 0, 0, 0, 1, 1, 1]
    assert any("local mempool" in ln for ln in lines)
    assert any("Cannot connect to host 127.0.0.1:9" in ln for ln in lines)
    assert "Total Balance: 12" in lines


def test_cli_governance_lifecycle_matches_jax(tmp_path, capsys, monkeypatch):
    """JAX test_wallet_cli_governance_lifecycle through both CLIs: stake,
    register_validator, send, stake, vote, an early revoke refused, the
    revoke after 48 h, unstake, balance; same lines, same codes."""
    _seeded_keygen(monkeypatch, 7)
    out = {}
    for pkg in (JAX, PORT):
        cli = W[pkg.name].cli
        pkg.clock.freeze(T0)
        db = str(tmp_path / f"{pkg.name}.gov.db")
        w_a = str(tmp_path / f"{pkg.name}.a.json")
        w_b = str(tmp_path / f"{pkg.name}.b.json")
        lines, codes = [], []

        async def run_cli(*argv):
            codes.append(await cli.amain([*argv, "--db", db, "--node", ""]))
            lines.extend(_cli_lines(capsys))

        async def scenario():
            await run_cli("createwallet", "--wallet", w_a)
            await run_cli("createwallet", "--wallet", w_b)
            ks = W[pkg.name].keystore
            d_a = int(ks.KeyStore(w_a).keys()[0]["private_key"])
            d_b = int(ks.KeyStore(w_b).keys()[0]["private_key"])
            addr_a = point_to_string(curve.point_mul(d_a, curve.G))
            addr_b = point_to_string(curve.point_mul(d_b, curve.G))
            await _mine_file(pkg, db, addr_a, 19)

            async def mined():
                await _mine_file(pkg, db, addr_a, 1, include_pending=True)
            await run_cli("stake", "-a", "3", "--wallet", w_a)
            await mined()
            await run_cli("register_validator", "--wallet", w_a)
            await mined()
            await run_cli("register_inode", "--wallet", w_a)
            await run_cli("send", "-to", addr_b, "-a", "2", "--wallet", w_a)
            await mined()
            await run_cli("stake", "-a", "1", "--wallet", w_b)
            await mined()
            await run_cli("vote", "-r", "10", "-to", addr_a, "--wallet", w_b)
            await mined()
            await run_cli("revoke", "-from", addr_a, "--wallet", w_b)
            pkg.clock.advance(48 * 3600 + 60)
            await run_cli("revoke", "-from", addr_a, "--wallet", w_b)
            await mined()
            await run_cli("unstake", "--wallet", w_b)
            await mined()
            await run_cli("de_register_inode", "--wallet", w_b)
            await run_cli("sendmany", "-to", f"{addr_b},{addr_a}", "-a",
                          "0.5,0.25", "--wallet", w_a)
            await run_cli("balance", "--wallet", w_b)
        asyncio.run(scenario())
        out[pkg.name] = (codes, lines)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0]


# ---------------------------------------------------------------- nodeless --

def test_nodeless_wallet_against_both_nodes(tmp_path):
    """Both nodeless wallets build against a JAX node and a port node on
    copies of one chain: the same tx hex from all four pairings; then
    each sends to its own package's node and the balance moves alike."""
    d, pub = curve.keygen(rng=0xC0FFEE)
    addr = point_to_string(pub)
    dest = point_to_string(curve.keygen(rng=0xD357)[1])
    JAX.clock.freeze(T0)
    asyncio.run(_mine_file(JAX, str(tmp_path / "base.db"), addr, 4))
    for name in ("jax", "port"):
        (tmp_path / f"{name}.db").write_bytes(
            (tmp_path / "base.db").read_bytes())
    JAX.clock.freeze(T0 + 300)
    PORT.clock.freeze(T0 + 300)

    async def main():
        jnode = japp.Node(_jcfg(tmp_path, "jax"))
        jnode.config.device.sig_backend = "host"
        server = TestServer(jnode.app, host="127.0.0.1")
        await server.start_server()
        tnode = tapp.Node(_tcfg(tmp_path, "port"), device="cpu")
        tserver = await tnode.serve("127.0.0.1", 0)
        urls = {"jax": f"http://127.0.0.1:{server.port}",
                "port": f"http://127.0.0.1:{tserver.port}"}
        try:
            built = {}
            for wallet in ("jax", "port"):
                for node in ("jax", "port"):
                    w = W[wallet].nodeless.NodelessWallet(urls[node])
                    tx = await w.create_transaction(d, dest, "1.25", b"hi")
                    built[(wallet, node)] = tx.hex()
                    assert await w.get_balance(addr) == \
                        (Decimal(24), Decimal(0))
            assert len(set(built.values())) == 1, built
            sent = {}
            for name in ("jax", "port"):
                w = W[name].nodeless.NodelessWallet(urls[name])
                sent[name] = await w.send(d, dest, "1.25", b"hi")
                with pytest.raises(ValueError, match="enough funds"):
                    await w.create_transaction(d, dest, "1000")
                info = await w.get_address_info(dest, show_pending=True)
                sent[name + " pending"] = info["pending_transactions"]
            assert sent["jax"] == sent["port"]
            assert sent["jax pending"] == sent["port pending"]
        finally:
            await tnode.close()
            await server.close()
            await jnode.close()
    asyncio.run(main())


# ------------------------------------------------------------ no CUDA init --

_NO_CUDA = r"""
import asyncio, sys, torch
def refuse(*a, **k):
    raise AssertionError("the wallet initialised CUDA")
torch.cuda._lazy_init = refuse
torch.cuda.init = refuse
from upow_tpu_torch.core import curve, point_to_string
from upow_tpu_torch.wallet import KeyStore, WalletBuilder, cli, nodeless
rc = [asyncio.run(cli.amain(["createwallet", "--wallet", "w.json",
                             "--db", "c.db", "--node", ""])),
      asyncio.run(cli.amain(["balance", "--wallet", "w.json",
                             "--db", "c.db", "--node", ""])),
      asyncio.run(cli.amain(["send", "-to", "x", "-a", "1", "--wallet",
                             "w.json", "--db", "c.db", "--node", ""]))]
try:
    asyncio.run(nodeless.NodelessWallet("http://127.0.0.1:9").get_balance(
        point_to_string(curve.keygen(rng=3)[1])))
except OSError:
    pass
assert rc == [0, 0, 1], rc
assert not torch.cuda.is_initialized()
print("no cuda")
"""


def test_wallet_never_initialises_cuda(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, UPOW_NODE_SEED_URL="")
    out = subprocess.run([sys.executable, "-c", _NO_CUDA], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.rstrip().endswith("no cuda")
