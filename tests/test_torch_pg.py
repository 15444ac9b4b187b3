"""The port's PostgreSQL chain-state backend against the JAX package's.

JAX ``tests/test_pg_backend.py``'s scenarios, each run once on the JAX
``PgChainState`` (over the JAX ``MockPgDriver``) and once on the port's
``PgChainState``, over the port's ``MockPgDriver`` (``mock``) or over the
port's real ``AsyncpgDriver`` with ``tests/fake_asyncpg.py`` injected as
``sys.modules["asyncpg"]`` (``asyncpg``: its loop thread, per-statement
lock and SQLSTATE mapping run).  The same keys, the same frozen clocks
and deterministic signatures give both runs the same inputs: the txs are
built by the JAX ``WalletBuilder`` (over the port's state through
:class:`JaxView`), the headers are mined by each package's own code.
Every value a scenario reads is logged, and the two logs must be equal:
fingerprints, rows, balances, error strings and return values.

Besides: the cross-backend fingerprint (port pg = port sqlite = JAX pg),
the port's ``PG_SCHEMA`` and mock DDL against the JAX package's, text
for text (JAX ``test_schema_matches_reference`` reads the absent
reference tree), the value lanes a bulk load seeds (zeros on pg, as in
the JAX package), and a resident accept on pg and on sqlite.
"""

import asyncio
import contextlib
import datetime
import random
import sys
from decimal import Decimal

import pytest

import fake_asyncpg
import upow_tpu.config as jconfig
import upow_tpu.core.header as jheader
import upow_tpu.core.merkle as jmerkle
import upow_tpu.core.tx as jtx
import upow_tpu.node.app as japp
import upow_tpu.state.pg as jpg
import upow_tpu.state.pgdriver as jdrv
import upow_tpu.state.reindex as jreindex
import upow_tpu.verify as jverify
import upow_tpu_torch.config as tconfig
import upow_tpu_torch.core.header as theader
import upow_tpu_torch.core.merkle as tmerkle
import upow_tpu_torch.node.app as tapp
import upow_tpu_torch.state.pg as tpg
import upow_tpu_torch.state.pgdriver as tdrv
import upow_tpu_torch.state.reindex as treindex
import upow_tpu_torch.state.storage as tstorage
import upow_tpu_torch.verify as tverify
from upow_tpu_torch import trace
from test_torch_block import GENESIS_PREV, JAX, PORT, T0, Chain
from test_wallet import make_actors
from upow_tpu.core import curve
from upow_tpu.core.constants import SMALLEST
from upow_tpu.wallet.builders import WalletBuilder

JAX.pg, JAX.drv, JAX.reindex = jpg, jdrv, jreindex
JAX.headers, JAX.merkles = jheader, jmerkle
PORT.pg, PORT.drv, PORT.reindex = tpg, tdrv, treindex
PORT.headers, PORT.merkles = theader, tmerkle
DRIVERS = ["mock", "asyncpg"]


@pytest.fixture(autouse=True)
def easy_chain(monkeypatch):
    """Difficulty 1.0 in both packages, and no fake server left over."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.difficulty, "START_DIFFICULTY",
                            Decimal("1.0"))
    yield
    for pkg in (JAX, PORT):
        pkg.clock.reset()
        pkg.clear()
    fake_asyncpg.reset()


def _to_jax(value):
    """A port value in the JAX package's types (txs and inputs)."""
    if isinstance(value, PORT.tx.TxInput):
        out = jtx.TxInput(value.tx_hash, value.index)
        if hasattr(value, "amount"):
            out.amount = value.amount
        return out
    if isinstance(value, (PORT.tx.Tx, PORT.tx.CoinbaseTx)):
        return jtx.tx_from_hex(value.hex(), check_signatures=False)
    if isinstance(value, dict):
        return {k: _to_jax(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_jax(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_to_jax(v) for v in value)
    return value


class JaxView:
    """The port's state seen through the JAX package's types, for the
    JAX ``WalletBuilder``."""

    def __init__(self, state):
        self._state = state

    def __getattr__(self, name):
        fn = getattr(self._state, name)

        async def call(*args, **kw):
            return _to_jax(await fn(*args, **kw))
        return call


def obs(value):
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
        return {k: obs(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [obs(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(obs(v) for v in value)
    return value


def pg_state(pkg, kind="mock", dsn="postgresql://fake/upow"):
    """A fresh pg state of ``pkg``: over its mock driver, or (port only)
    over its AsyncpgDriver on a fake asyncpg server."""
    if kind == "mock":
        return pkg.pg.PgChainState(driver=pkg.drv.MockPgDriver())
    sys.modules["asyncpg"] = fake_asyncpg
    fake_asyncpg.FakeServer(dsn)
    return pkg.pg.PgChainState(dsn)


@pytest.fixture
def asyncpg_module(monkeypatch):
    """Keep ``sys.modules["asyncpg"]`` as it was after the test."""
    monkeypatch.setitem(sys.modules, "asyncpg", fake_asyncpg)


class Run:
    """One package's run of a scenario on one state: its manager, the
    JAX wallet builder over it, the actors, and the log."""

    def __init__(self, pkg, state):
        self.pkg, self.state = pkg, state
        if pkg is JAX:
            self.manager = jverify.BlockManager(state, sig_backend="host")
            self.view = state
        else:
            self.manager = tverify.BlockManager(state, device="cpu")
            self.view = JaxView(state)
        self.builder = WalletBuilder(self.view)
        self.actors = make_actors()
        self.log = []

    def tx(self, tx):
        """A JAX-built tx in this package's types."""
        if self.pkg is JAX:
            return tx
        return PORT.tx.tx_from_hex(tx.hex(), check_signatures=False)

    async def see(self, label, coro):
        value = await coro
        self.log.append((label, obs(value)))
        return value

    async def push(self, tx):
        seq = await self.state.add_pending_transaction(self.tx(tx))
        self.log.append(("push", tx.hash(), seq))
        return seq

    async def mine(self, address, include_pending=False):
        """Mine and accept one block on the tip 60 s on; the block hash."""
        pkg = self.pkg
        for p in (JAX, PORT):
            p.clock.advance(60)
        txs = []
        if include_pending:
            txs = await self.state.get_pending_transactions_limit(
                hex_only=False)
        diff, last = await self.manager.calculate_difficulty()
        prev = last["hash"] if last else GENESIS_PREV
        header = pkg.headers.BlockHeader(
            previous_hash=prev, address=address,
            merkle_root=pkg.merkles.merkle_root(txs),
            timestamp=pkg.clock.timestamp(),
            difficulty_x10=int(diff * 10), nonce=0)
        while last and not pkg.difficulty.check_pow(header.hex(), prev,
                                                    diff):
            header.nonce += 1
        errors = []
        ok = await self.manager.create_block(header.hex(), txs,
                                             errors=errors)
        assert ok, errors
        self.log.append(("mined", header.hex(), [t.hash() for t in txs]))
        return header.hex()


def run_on(pkg, state, scenario, *args):
    """``scenario(run, *args)`` on ``state`` from a frozen T0; the log."""
    for p in (JAX, PORT):
        p.clock.freeze(T0)
        p.clear()
    run = Run(pkg, state)

    async def main():
        try:
            await scenario(run, *args)
        finally:
            state.close()
    asyncio.run(main())
    return run.log


def held(scenario, kind, *args):
    """The scenario on the JAX pg state and on the port's; equal logs."""
    want = run_on(JAX, pg_state(JAX), scenario, *args)
    got = run_on(PORT, pg_state(PORT, kind), scenario, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    return got


# --- the scenarios of JAX tests/test_pg_backend.py ---------------------------

async def mining_and_send_flow(r):
    state, builder = r.state, r.builder
    _d_g, a_g = r.actors["genesis"]
    d_g = r.actors["genesis"][0]
    _d_o, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    assert await r.see("next_id", state.get_next_block_id()) == 4
    tip = await r.see("tip", state.get_last_block())
    assert tip["id"] == 3 and tip["difficulty"] == Decimal("1.0")

    tx = await builder.create_transaction(d_g, a_o, "2.5")
    await r.push(tx)
    assert await r.see("exists", state.pending_transaction_exists(tx.hash()))
    assert (tx.inputs[0].tx_hash, tx.inputs[0].index) in \
        await r.see("spent", state.get_pending_spent_outpoints())
    await r.mine(a_g, include_pending=True)
    assert await r.see("balance", state.get_address_balance(a_o)) == \
        int(Decimal("2.5") * SMALLEST)
    assert not await r.see("exists",
                           state.pending_transaction_exists(tx.hash()))

    tx = await builder.create_transaction_to_send_multiple_wallet(
        d_g, [a_o], ["1"])
    await r.push(tx)
    await r.mine(a_g, include_pending=True)
    assert await r.see("balance", state.get_address_balance(a_o)) == \
        int(Decimal("3.5") * SMALLEST)

    page = await r.see("page", state.get_blocks(1, 10))
    assert len(page) == 5
    assert sum(len(b["transactions"]) for b in page) == 7
    nice = await r.see("nice", state.get_nice_transaction(tx.hash(), a_o))
    assert nice["is_confirm"] and nice["delta"] == 1.0
    assert await r.see("history", state.get_address_transactions(a_o))
    await r.see("full", state.get_full_state_hash())


async def governance_flow(r):
    state, builder = r.state, r.builder
    d_g, a_g = r.actors["genesis"]
    d_i, a_i = r.actors["inode"]
    d_v, a_v = r.actors["validator"]
    d_d, a_d = r.actors["delegate"]

    for _ in range(360):
        await r.mine(a_g)
    await r.push(await builder.create_transaction_to_send_multiple_wallet(
        d_g, [a_i, a_d], ["1011", "21"]))
    await r.push(await builder.create_transaction(d_g, a_v, "1111"))
    await r.mine(a_g, include_pending=True)

    for d in (d_i, d_v, d_d):
        await r.push(await builder.create_stake_transaction(d, "10"))
    await r.mine(a_g, include_pending=True)
    assert await r.see("stake", state.get_address_stake(a_d)) == 10
    assert len(await r.see("power",
                           state.get_delegates_voting_power(a_d))) == 1
    await r.see("vpower", state.get_validators_voting_power(a_v))

    await r.push(await builder.create_validator_registration_transaction(d_v))
    await r.mine(a_g, include_pending=True)
    assert await r.see("is_validator", state.is_validator_registered(a_v))

    await r.push(await builder.create_inode_registration_transaction(d_i))
    await r.mine(a_g, include_pending=True)
    assert await r.see("is_inode", state.is_inode_registered(a_i))

    await r.push(await builder.create_voting_transaction(d_d, 10, a_v))
    await r.mine(a_g, include_pending=True)
    assert await r.see("vstake", state.get_validators_stake(a_v)) == 10

    await r.push(await builder.create_voting_transaction(d_v, 10, a_i))
    await r.mine(a_g, include_pending=True)
    active = await r.see("active", state.get_active_inodes())
    assert [i["wallet"] for i in active] == [a_i]
    assert active[0]["emission"] == 100
    await r.see("ballots", state.get_ballots("validators_ballot"))
    await r.see("ballot", state.get_ballot_by_recipient("inodes_ballot", a_i))

    await r.mine(a_g)
    assert await r.see("balance", state.get_address_balance(a_i)) == \
        3 * SMALLEST + (1011 - 1000 - 10) * SMALLEST

    for p in (JAX, PORT):
        p.clock.advance(48 * 3600)
    await r.push(await builder.create_revoke_transaction(d_d, a_v))
    await r.mine(a_g, include_pending=True)
    assert await r.see("spent_votes",
                       state.get_delegates_spent_votes(a_d)) == []
    await r.push(await builder.create_unstake_transaction(d_d))
    await r.mine(a_g, include_pending=True)
    assert await r.see("stake", state.get_address_stake(a_d)) == 0

    fingerprint = await r.see("full", state.get_full_state_hash())
    await state.rebuild_utxos()
    assert await r.see("replayed", state.get_full_state_hash()) == \
        fingerprint


async def reorg_restores_state(r):
    state, builder = r.state, r.builder
    d_g, a_g = r.actors["genesis"]
    d_o, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    fingerprint3 = await r.see("full", state.get_full_state_hash())
    balance3 = await r.see("balance", state.get_address_balance(a_g))

    await r.push(await builder.create_transaction(d_g, a_o, "4"))
    await r.mine(a_g, include_pending=True)
    await r.push(await builder.create_transaction(d_o, a_g, "1"))
    await r.mine(a_g, include_pending=True)
    assert await r.see("full", state.get_full_state_hash()) != fingerprint3

    removed = []
    state.on_blocks_removed = removed.append
    await state.remove_blocks(4)
    r.log.append(("removed", removed))
    assert (await r.see("tip", state.get_last_block()))["id"] == 3
    assert await r.see("full", state.get_full_state_hash()) == fingerprint3
    assert await r.see("balance", state.get_address_balance(a_g)) == balance3
    assert await r.see("balance", state.get_address_balance(a_o)) == 0


async def mempool_ordering_and_propagation(r):
    state, builder = r.state, r.builder
    d_g, a_g = r.actors["genesis"]
    d_o, a_o = r.actors["outsider"]
    for _ in range(4):
        await r.mine(a_g)

    free = await builder.create_transaction(d_g, a_o, "1")
    await r.push(free)
    pub_g = curve.point_mul(d_g, curve.G)
    inputs = await r.view.get_spendable_outputs(a_g, check_pending_txs=True)
    r.log.append(("inputs", obs(inputs)))
    assert inputs and inputs[0].amount == 6 * SMALLEST
    paid = jtx.Tx([inputs[0]], [
        jtx.TxOutput(a_o, 1 * SMALLEST),
        jtx.TxOutput(a_g, int(Decimal("4.5") * SMALLEST)),
    ]).sign([d_g], lambda i: pub_g)
    await r.push(paid)
    # a larger fee on two inputs: a lower fee rate than ``paid``'s, so
    # the fee-rate order differs from the fee order
    both = await r.view.get_spendable_outputs(a_g, check_pending_txs=True)
    assert len(both) == 2
    wide = jtx.Tx(both, [
        jtx.TxOutput(a_o, 1 * SMALLEST),
        jtx.TxOutput(a_g, int(Decimal("10.49") * SMALLEST)),
    ]).sign([d_g], lambda i: pub_g)
    await r.push(wide)
    ordered = await r.see("ordered", state.get_pending_transactions_limit(
        hex_only=False))
    assert [t.hash() for t in ordered] == [paid.hash(), wide.hash(),
                                           free.hash()]
    assert await r.see("count", state.get_pending_transactions_count()) == 3
    await r.see("by_hash", state.get_pending_transactions_by_hash(
        [paid.hash(), "ab" * 32, free.hash(), paid.hash()]))
    await r.see("journal", state.load_pending_journal())

    assert await r.see("propagate", state.get_need_propagate_transactions(
        older_than=300)) == []
    for p in (JAX, PORT):
        p.clock.advance(301)
    assert len(await r.see("propagate",
                           state.get_need_propagate_transactions(300))) == 3
    await state.update_pending_transaction_propagation(free.hash())
    assert len(await r.see("propagate",
                           state.get_need_propagate_transactions(300))) == 2

    await state.remove_pending_transactions_by_hash([paid.hash()])
    assert await r.see("count", state.get_pending_transactions_count()) == 2
    assert all(o[0] != paid.inputs[0].tx_hash or o[1] != paid.inputs[0].index
               for o in await r.see("spent",
                                    state.get_pending_spent_outpoints()))
    await state.remove_pending_transactions()
    assert await r.see("count", state.get_pending_transactions_count()) == 0
    assert await r.see("spent", state.get_pending_spent_outpoints()) == set()


async def journal_stamp_detects_count_preserving_rewrite(r):
    pkg, state = r.pkg, r.state
    now = pkg.clock.timestamp

    async def raw_insert(tx_hash):
        await state.drv.aexecute(
            "INSERT INTO pending_transactions (tx_hash, tx_hex,"
            " inputs_addresses, fees, propagation_time)"
            " VALUES ($1,$2,$3,$4,$5)",
            (tx_hash, "00", [], Decimal("0"), pkg.drv._utc(now())))

    async def raw_delete(tx_hash):
        await state.drv.aexecute(
            "DELETE FROM pending_transactions WHERE tx_hash = $1",
            (tx_hash,))

    d_g, a_g = r.actors["genesis"]
    for _ in range(4):
        await r.mine(a_g)
    tx = await r.builder.create_transaction(d_g, r.actors["outsider"][1], "1")
    seq = await r.push(tx)
    assert isinstance(seq, int)
    assert (await r.see("stamp", state.pending_journal_stamp()))[1] == seq
    for h in ("aa" * 32, "bb" * 32, "cc" * 32):
        await raw_insert(h)
    stamp0 = await r.see("stamp", state.pending_journal_stamp())
    await raw_delete("aa" * 32)
    await raw_insert("ab" * 32)
    stamp1 = await r.see("stamp", state.pending_journal_stamp())
    assert stamp1[0] == stamp0[0] and stamp1[2] == stamp0[2]
    assert stamp1[1] > stamp0[1]


async def get_blocks_single_query_page(r, monkeypatch):
    state, builder = r.state, r.builder
    d_g, a_g = r.actors["genesis"]
    _, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    tx = await builder.create_transaction(d_g, a_o, "2")
    await r.push(tx)
    await r.mine(a_g, include_pending=True)

    page = await r.see("page", state.get_blocks(2, 10))
    assert [p["block"]["id"] for p in page] == [2, 3, 4]
    assert len(page[-1]["transactions"]) == 2
    assert tx.hex() in page[-1]["transactions"]
    assert await r.see("past_tip", state.get_blocks(99, 10)) == []
    detail = await r.see("details", state.get_blocks(4, 1, tx_details=True))
    nice = detail[0]["transactions"]
    assert len(nice) == 2 and all(isinstance(t, dict) for t in nice)
    assert any(t["hash"] == tx.hash() for t in nice)
    block = await state.get_block_by_id(4)
    await r.see("block_nice",
                state.get_block_nice_transactions(block["hash"]))
    await r.see("block_txs", state.get_block_transactions(block["hash"],
                                                          hex_only=True))
    await r.see("info", state.get_transaction_info(tx.hash()))
    await r.see("ts", state.get_transaction_block_timestamp(tx.hash()))
    with monkeypatch.context() as m:
        m.setattr(r.pkg.pg, "MAX_BLOCK_SIZE_HEX", 1)
        assert await r.see("capped", state.get_blocks(
            1, 10, size_capped=True)) == []
        assert len(await r.see("uncapped", state.get_blocks(1, 10))) == 4


async def reindex_check_detects_corruption(r):
    state = r.state
    d_g, a_g = r.actors["genesis"]
    _, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    tx = await r.builder.create_transaction(d_g, a_o, "1.5")
    await r.push(tx)
    await r.mine(a_g, include_pending=True)

    live = await r.see("live", state.get_full_state_hash())
    before, after = await r.see("check", r.pkg.reindex.check_replay_pg(state))
    assert before == after == live
    assert await r.see("live", state.get_full_state_hash()) == live
    await state.drv.aexecute(
        'DELETE FROM unspent_outputs WHERE tx_hash = $1 AND "index" = $2',
        (tx.hash(), 0))
    corrupted = await r.see("corrupted", state.get_full_state_hash())
    assert corrupted != live
    before, after = await r.see("check", r.pkg.reindex.check_replay_pg(state))
    assert before == corrupted and after != before
    assert await r.see("kept", state.get_full_state_hash()) == corrupted


async def concurrent_writer_isolated_from_atomic_rollback(r):
    state = r.state
    d_g, a_g = r.actors["genesis"]
    _, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    tx = await r.builder.create_transaction(d_g, a_o, "1")
    entered, release = asyncio.Event(), asyncio.Event()

    async def failing_accept():
        try:
            async with state.atomic():
                await state.add_block(
                    99, "aa" * 32, "", a_g, 0, Decimal("1.0"), 0,
                    r.pkg.clock.timestamp())
                entered.set()
                await release.wait()
                raise RuntimeError("validation failed")
        except RuntimeError as e:
            r.log.append(("rolled_back", str(e)))

    async def concurrent_intake():
        await entered.wait()
        release.set()
        await r.push(tx)

    await asyncio.gather(failing_accept(), concurrent_intake())
    assert await r.see("block99", state.get_block_by_id(99)) is None
    assert await r.see("pending", state.pending_transaction_exists(tx.hash()))


async def reorg_snapshot_shares_writer_lock_with_deletes(r):
    state = r.state
    d_g, a_g = r.actors["genesis"]
    _, a_o = r.actors["outsider"]
    for _ in range(3):
        await r.mine(a_g)
    fp3 = await r.see("full", state.get_full_state_hash())
    bal3 = await r.see("balance", state.get_address_balance(a_g))
    await r.mine(a_g)

    release = asyncio.Event()
    gated, reorg_task = [], []
    orig_writer = state._writer

    def gating_writer():
        if (asyncio.current_task() is (reorg_task[0] if reorg_task
                                       else None) and not gated):
            gated.append(True)

            @contextlib.asynccontextmanager
            async def g():
                await release.wait()
                async with orig_writer():
                    yield
            return g()
        return orig_writer()

    state._writer = gating_writer
    reorg_task.append(asyncio.ensure_future(state.remove_blocks(4)))
    for _ in range(2000):
        if gated:
            break
        await asyncio.sleep(0)
    assert gated, "reorg task never reached its writer-lock acquire"
    await r.push(await r.builder.create_transaction(d_g, a_o, "4"))
    await r.mine(a_g, include_pending=True)
    release.set()
    await reorg_task[0]
    state._writer = orig_writer
    assert (await r.see("tip", state.get_last_block()))["id"] == 3
    assert await r.see("full", state.get_full_state_hash()) == fp3
    assert await r.see("balance", state.get_address_balance(a_g)) == bal3


SCENARIOS = {f.__name__: f for f in (
    mining_and_send_flow, governance_flow, reorg_restores_state,
    mempool_ordering_and_propagation,
    journal_stamp_detects_count_preserving_rewrite,
    reindex_check_detects_corruption,
    concurrent_writer_isolated_from_atomic_rollback,
    reorg_snapshot_shares_writer_lock_with_deletes)}


@pytest.mark.parametrize("kind", DRIVERS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, kind, asyncpg_module):
    log = held(SCENARIOS[name], kind)
    assert any(label == "mined" for label, *_ in log)


@pytest.mark.parametrize("kind", DRIVERS)
def test_get_blocks_single_query_page_matches_jax(kind, asyncpg_module,
                                                  monkeypatch):
    held(get_blocks_single_query_page, kind, monkeypatch)


def test_cross_backend_fingerprint(asyncpg_module):
    """The same chain gives one fingerprint and the same balances on the
    port's pg (both drivers), the port's sqlite and the JAX pg."""
    async def build(r):
        d_g, a_g = r.actors["genesis"]
        d_o, a_o = r.actors["outsider"]
        for _ in range(3):
            await r.mine(a_g)
        await r.push(await r.builder.create_transaction(d_g, a_o, "2"))
        await r.mine(a_g, include_pending=True)
        await r.see("full", r.state.get_full_state_hash())
        await r.see("utxo", r.state.get_unspent_outputs_hash())
        await r.see("balances", r.state.get_address_balance(a_g))
        await r.see("balances", r.state.get_address_balance(a_o))

    def result(log):
        return [entry for entry in log if entry[0] != "push"]

    want = run_on(JAX, pg_state(JAX), build)
    for state in (pg_state(PORT), pg_state(PORT, "asyncpg"),
                  tstorage.ChainState()):
        # the push log's journal sequence is backend-specific (pg
        # journal_seq, sqlite rowid); everything else is equal
        assert result(run_on(PORT, state, build)) == result(want)


@pytest.mark.parametrize("kind", DRIVERS)
def test_sync_page_ingest_matches_jax(tmp_path, kind, asyncpg_module):
    """The node's page ingest (create_blocks) on a pg-backed JAX node and
    a pg-backed port node, from a JAX sqlite chain: the same verdicts,
    tip and fingerprints, and the source's UTXO hash."""
    async def source(r):
        d_g, a_g = r.actors["genesis"]
        _, a_o = r.actors["outsider"]
        for _ in range(3):
            await r.mine(a_g)
        await r.push(await r.builder.create_transaction(d_g, a_o, "2"))
        await r.mine(a_g, include_pending=True)
        r.log.append(("page", await r.state.get_blocks(1, 100)))
        r.log.append(("utxo", await r.state.get_unspent_outputs_hash()))

    log = run_on(JAX, JAX.ChainState(), source)
    page, utxo = log[-2][1], log[-1][1]

    async def ingest(pkg, state):
        if pkg is JAX:
            cfg = jconfig.Config()
            cfg.node.db_path = ""
            cfg.node.seed_url = ""
            cfg.node.peers_file = str(tmp_path / "j.nodes.json")
            cfg.node.ip_config_file = ""
            cfg.device.sig_backend = "host"
            cfg.log.path = ""
            cfg.log.console = False
            node = japp.Node(cfg, state=state)
        else:
            cfg = tconfig.Config.load(
                node__db_path="", node__seed_url="",
                node__peers_file=str(tmp_path / "t.nodes.json"),
                node__ip_config_file="", log__path="", log__console=False)
            node = tapp.Node(cfg, state=state, device="cpu")
        try:
            errors = []
            ok = await node.create_blocks(page, errors)
            return (ok, errors, await state.get_last_block(),
                    await state.get_unspent_outputs_hash(),
                    await state.get_full_state_hash())
        finally:
            await node.close()

    want = asyncio.run(ingest(JAX, pg_state(JAX)))
    got = asyncio.run(ingest(PORT, pg_state(PORT, kind)))
    assert obs(got) == obs(want)
    assert got[0] and got[3] == utxo and got[2]["id"] == 4


@pytest.mark.parametrize("kind", DRIVERS)
def test_device_index_matches_sql(kind, asyncpg_module):
    """The resident index on the port's pg backend (device ``cpu``): the
    same membership answers with it armed and not, through a reorg, as
    the JAX pg backend's with and without its index."""
    async def scenario(r, armed):
        state = r.state
        if armed:
            state.enable_device_index()
            assert state.resident_indexes() is not None
        d_g, a_g = r.actors["genesis"]
        _, a_o = r.actors["outsider"]
        for _ in range(3):
            await r.mine(a_g)
        tx = await r.builder.create_transaction(d_g, a_o, "2")
        await r.push(tx)
        await r.mine(a_g, include_pending=True)
        probe = [tx.inputs[0].outpoint, (tx.hash(), 0), ("ff" * 32, 0)]
        assert await r.see("exists", state.outpoints_exist(probe)) == \
            [False, True, False]
        await state.remove_blocks(4)
        assert await r.see("exists", state.outpoints_exist(probe)) == \
            [True, False, False]
        await r.see("utxo", state.get_unspent_outputs_hash())
        if armed:
            r.log.append(("entries", state.index_stats()["entries"]))

    def jax_state():
        return pg_state(JAX)

    def port_state():
        state = pg_state(PORT, kind)
        state.device = "cpu"
        return state

    want = run_on(JAX, jax_state(), scenario, True)
    assert run_on(JAX, jax_state(), scenario, False) == [
        e for e in want if e[0] != "entries"]
    assert run_on(PORT, port_state(), scenario, True) == want
    assert run_on(PORT, port_state(), scenario, False) == [
        e for e in want if e[0] != "entries"]


@pytest.mark.parametrize("kind", DRIVERS)
def test_concurrent_churn_replays_and_matches_jax(kind, asyncpg_module):
    """JAX ``test_pg_concurrent_churn`` on the port's pg backend: a miner,
    a mempool intake, a propagation updater and readers interleave at
    every driver yield point.  The chain replays to its live fingerprint,
    the pending overlay is consistent, and a JAX pg node that ingests
    the chain the churn produced reaches the same fingerprints.  The
    port's accept verifies on the device runtime's thread, so the other
    tasks yield for a millisecond a turn (with ``sleep(0)`` they would
    spin the loop and starve that thread of the GIL)."""
    rng = random.Random(0xC0C0)
    turn = 0.001

    async def churn(r):
        state, builder = r.state, r.builder
        d_g, a_g = r.actors["genesis"]
        _, a_o = r.actors["outsider"]
        for _ in range(6):
            await r.mine(a_g)
        stop = asyncio.Event()
        errors = []

        async def miner_task():
            try:
                for _ in range(6):
                    await r.mine(a_g, include_pending=rng.random() < 0.7)
                    await asyncio.sleep(0)
            except Exception as e:
                errors.append(f"miner: {e!r}")
            finally:
                stop.set()

        async def intake_task():
            try:
                while not stop.is_set():
                    try:
                        tx = await builder.create_transaction(d_g, a_o, "0.5")
                        await state.add_pending_transaction(r.tx(tx))
                    except ValueError:
                        pass  # funds tied up in pending
                    await asyncio.sleep(turn)
            except Exception as e:
                errors.append(f"intake: {e!r}")

        async def propagation_task():
            try:
                while not stop.is_set():
                    for t in (await state.get_pending_transactions_limit(
                            hex_only=False))[:2]:
                        await state.update_pending_transaction_propagation(
                            t.hash())
                    await asyncio.sleep(turn)
            except Exception as e:
                errors.append(f"propagation: {e!r}")

        async def reader_task():
            try:
                while not stop.is_set():
                    await state.get_address_balance(a_o,
                                                    check_pending_txs=True)
                    await state.get_unspent_outputs_hash()
                    await asyncio.sleep(turn)
            except Exception as e:
                errors.append(f"reader: {e!r}")

        await asyncio.gather(miner_task(), intake_task(),
                             propagation_task(), reader_task())
        assert not errors, errors
        fingerprint = await state.get_full_state_hash()
        await state.rebuild_utxos()
        assert await state.get_full_state_hash() == fingerprint
        pending = await state.get_pending_transactions_limit(hex_only=False)
        assert pending and {i.tx_hash for t in pending for i in t.inputs}
        r.log.append(("page", await state.get_blocks(1, 100)))
        r.log.append(("fingerprints", fingerprint,
                      await state.get_unspent_outputs_hash()))

    log = run_on(PORT, pg_state(PORT, kind), churn)
    page, fingerprints = (e[1:] for e in log[-2:])

    async def replay():
        state = pg_state(JAX)
        manager = jverify.BlockManager(state, sig_backend="host")
        for entry in page[0]:
            txs = [jtx.tx_from_hex(h, check_signatures=False)
                   for h in entry["transactions"]]
            errors = []
            assert await manager.create_block(
                entry["block"]["content"],
                [t for t in txs if not t.is_coinbase], errors=errors), errors
        out = (await state.get_full_state_hash(),
               await state.get_unspent_outputs_hash())
        state.close()
        return out

    JAX.clock.freeze(T0 + 100 * 60)
    assert len(page[0]) == 12
    assert asyncio.run(replay()) == tuple(fingerprints)


# --- the driver and the schema ------------------------------------------------

def _driver_cases(pkg):
    """JAX ``test_mock_pg_write_side_type_fidelity`` and
    ``test_mock_executemany_is_atomic_like_asyncpg`` on ``pkg``'s mock:
    every outcome, errors as (class name, sqlstate, message)."""
    out = []

    def attempt(fn, *args):
        try:
            fn(*args)
            out.append(("ok",))
        except pkg.drv.PgDriverError as e:
            out.append((type(e).__name__, e.sqlstate, str(e),
                        isinstance(e, pkg.drv.IntegrityViolation)))

    drv = pkg.drv.MockPgDriver()
    now = datetime.datetime(2026, 8, 1, 12, 0, 0)
    ins = ("INSERT INTO pending_transactions (tx_hash, tx_hex,"
           " inputs_addresses, fees, propagation_time)"
           " VALUES ($1, $2, $3, $4, $5)")
    attempt(drv.execute, ins, ("aa" * 32, "00", ["x"], Decimal("0.00000050"),
                               now))
    out.append(drv.fetch("SELECT * FROM pending_transactions"))
    attempt(drv.execute, ins, ("bb" * 32, "00", [], Decimal("123456789"), now))
    attempt(drv.execute, ins, ("aa" * 32, "00", [], Decimal("0"), now))
    ts = datetime.datetime(2026, 8, 1, 12, 0, 0, 700_000)
    attempt(drv.execute,
            "INSERT INTO blocks (id, hash, content, address, random,"
            " difficulty, reward, timestamp)"
            " VALUES ($1, $2, $3, $4, $5, $6, $7, $8)",
            (1, "cc" * 32, "", "addr", 0, Decimal("1.0"), Decimal("1"), ts))
    out.append(drv.fetch("SELECT * FROM blocks"))
    out.append(drv.fetch("SELECT 1 AS x FROM pending_transactions"
                         " WHERE $1 = ANY(inputs_addresses)", ("x",)))
    out.append(drv.fetch("SELECT tx_hash FROM pending_transactions"
                         " WHERE tx_hash = ANY($1)", (["aa" * 32, "dd"],)))
    drv.execute("CREATE TABLE t (k TEXT PRIMARY KEY)")
    attempt(drv.executemany, "INSERT INTO t (k) VALUES ($1)",
            [("a",), ("b",), ("a",)])
    out.append(drv.fetch("SELECT k FROM t"))
    drv.begin()
    attempt(drv.executemany, "INSERT INTO t (k) VALUES ($1)",
            [("c",), ("c",)])
    drv.commit()
    out.append(drv.fetch("SELECT k FROM t"))
    drv.close()
    return out


def test_mock_driver_matches_jax():
    got, want = _driver_cases(PORT), _driver_cases(JAX)
    assert got == want
    assert got[1][0]["fees"] == Decimal("0.000001")
    assert got[2][0] == "NumericValueOutOfRange"
    assert got[3][:2] == ("UniqueViolation", "23505") and got[3][3]
    assert got[5][0]["timestamp"] == datetime.datetime(2026, 8, 1, 12, 0, 1)
    assert got[9] == [] and got[11] == [{"k": "c"}]


def test_schema_and_mock_ddl_match_jax():
    """The reference schema (``PG_SCHEMA``), the mock's sqlite DDL, the
    column maps and the error taxonomy, text for text."""
    assert tpg.PG_SCHEMA == jpg.PG_SCHEMA
    assert tdrv._MOCK_DDL == jdrv._MOCK_DDL
    for name in ("_ARRAY_COLS", "_NUMERIC_COLS", "_TIMESTAMP_COLS",
                 "_BOOL_COLS", "_NUMERIC_SPEC", "_TS0_COLS"):
        assert getattr(tdrv, name) == getattr(jdrv, name), name
    for name in ("PgDriverError", "IntegrityViolation", "UniqueViolation",
                 "ForeignKeyViolation", "NumericValueOutOfRange"):
        assert getattr(tdrv, name).sqlstate == getattr(jdrv, name).sqlstate
    for code in ("23505", "23503", "23514", "22003", "08003"):
        e = fake_asyncpg.PostgresError("x")
        e.sqlstate = code
        got, want = tdrv._map_asyncpg_error(e), jdrv._map_asyncpg_error(e)
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "sqlstate", None) == getattr(want, "sqlstate",
                                                         None)
    for when in (0, T0, datetime.datetime(2026, 1, 2, 3, 4, 5)):
        assert tdrv._utc(when) == jdrv._utc(when)
        assert tdrv._epoch(tdrv._utc(when)) == jdrv._epoch(jdrv._utc(when))
    for units in (0, 49, 50, 51, SMALLEST // 2, 10 ** 15):
        assert tpg._coins(units) == jpg._coins(units)
        assert tpg._units(tpg._coins(units)) == jpg._units(jpg._coins(units))


def test_bulk_load_seeds_zero_value_lanes():
    """On pg the index's value lanes are zeros after a bulk load (the
    schema has no amount column), real amounts after an incremental add;
    on sqlite they are real amounts either way."""
    async def build(r):
        _d_g, a_g = r.actors["genesis"]
        for _ in range(2):
            await r.mine(a_g)

    states = {"pg": tpg.PgChainState(driver=tdrv.MockPgDriver(),
                                     device="cpu"),
              "sqlite": tstorage.ChainState(device="cpu")}
    lanes = {}
    for name, state in states.items():
        state.close = lambda: None  # read the index after the run
        run_on(PORT, state, build)
        state.enable_device_index()
        lanes[name] = state.resident_indexes()["unspent_outputs"]._host_amount
    assert len(lanes["pg"]) == len(lanes["sqlite"]) == 2
    assert not lanes["pg"].any() and lanes["sqlite"].all()


def test_resident_accept_on_pg_matches_sqlite():
    """The accept's fused resident scan (device ``cpu``) on the pg backend,
    whose value lanes are zeros, and on sqlite, whose lanes hold the
    amounts: the same verdicts, error strings and fingerprints, equal to
    pg's SQL scan without the index (the accept reads presence only)."""
    async def attempts(state, armed):
        if armed:
            state.enable_device_index()
        chain = Chain(PORT, state)
        log = []
        PORT.clock.advance(60)
        log.append(await chain.submit([]))
        coin = (await state.get_spendable_outputs(chain.addr))[0]
        fan = chain.spend([(coin.tx_hash, coin.index, coin.amount)], 4)
        PORT.clock.advance(60)
        log.append(await chain.submit([fan]))
        leaves = [(fan.hash(), j, o.amount) for j, o in enumerate(fan.outputs)]
        txs = [chain.spend([leaf]) for leaf in leaves]
        PORT.clock.advance(60)
        trace.reset()
        log.append(await chain.submit(txs + [chain.spend([leaves[0]], 2)]))
        log.append(await chain.submit([chain.spend([("ee" * 32, 0, 5)])]))
        log.append(await chain.submit(txs, merkle="ab" * 32))
        log.append(await chain.submit(txs))
        probes = trace.counters().get("index.probes", 0)
        log.append(await state.get_full_state_hash())
        state.close()
        return log, probes

    def run(state, armed):
        PORT.clock.freeze(T0)
        PORT.clear()
        return asyncio.run(attempts(state, armed))

    pg, pg_probes = run(tpg.PgChainState(driver=tdrv.MockPgDriver(),
                                         device="cpu"), True)
    sqlite, sqlite_probes = run(tstorage.ChainState(device="cpu"), True)
    sql, sql_probes = run(tpg.PgChainState(driver=tdrv.MockPgDriver()),
                          False)
    assert pg == sqlite == sql
    assert pg_probes > 0 and sqlite_probes > 0 and sql_probes == 0
    verdicts = [entry[0] for entry in pg[:-1]]
    assert verdicts == [True, True, False, False, False, True]
    assert pg[2][1] == ["double spend in block: 3 (unspent_outputs)"]
    assert pg[4][1] == ["merkle tree does not match"]
