"""PostgreSQL chain-state backend: the port's copy of the JAX package's
``state/pg.py``, for drop-in interop with a reference uPow database.

Implements the same storage seam as :class:`.storage.ChainState` (the
consensus views are shared through :class:`.views.StateViews`) against
the reference's exact ``schema.sql`` (``database.py:33-91``): an
operator can point the port's node at an existing uPow PostgreSQL
database (``node.db_backend = "postgres"``, ``node.pg_dsn``), or create
a fresh one with :meth:`PgChainState.ensure_schema`, and reuse the
reference ecosystem's tooling (db_setup.sh, create_unspent_outputs.py).

Representation differences from the sqlite backend, all absorbed here so
the rest of the port sees one API (int smallest-units, epoch ints):

* output tables carry NO amount column — amounts resolve through
  ``transactions.outputs_amounts`` (schema.sql:12-20), so every
  amount-bearing read is a JOIN with the array indexed host-side,
* ``fees``/``reward`` are NUMERIC(14,6) **coins** (quantized to 6 dp by
  the column type — a reference-inherited representation limit; the
  consensus-critical fee path recomputes from tx amounts and never
  round-trips through these columns),
* ``timestamp``/``propagation_time`` are TIMESTAMP(0) (naive UTC),
* address arrays are TEXT[] (the sqlite backend stores JSON),
* the outpoint index column is ``"index"`` (quoted — reserved-adjacent).

The driver seam (``state/pgdriver.py``) keeps the SQL here runnable both
on asyncpg (production) and on the sqlite-backed mock (tests, and the
card's smoke run, with no server); see that module for the SQL-subset
discipline.  The async storage methods await the driver's awaitable
facade, so database round trips never block the node's event loop; only
CLI tooling uses the blocking facade.

The JAX package's behaviour kept on purpose:

* ``remove_blocks`` never re-injects the removed blocks' txs into the
  pending journal: the JAX pg backend does not read
  ``reinject_reorg_txs`` (the sqlite backend does);
* the resident index's value lanes are zeros on a bulk load (the schema
  has no amount column); the accept reads presence only.

The port's departures: ``enable_device_index`` raises where the JAX
package logs a warning and carries on with SQL (the device-platform
probe); an index on a card that cannot arm stops the node, as on the
sqlite backend.  ``_restore_spent_outputs`` adds to the index once a
table and decodes each source tx once, where the JAX package does both
once an input; the answers are the same.

The snapshot methods (``export_snapshot_*``, ``restore_snapshot``) give
and take the payload of the sqlite backend, row for row; a restore
rebuilds an armed index inside its transaction (zero value lanes, as
every bulk load here).  The archive seam (``archive_export_span``,
``archive_prune_span``, ``archive_hot_row_counts``) gives the sqlite
backend's canonical rows, and with ``self.archive`` attached every block
and transaction read that misses the hot tables falls through to the
archive's segments, as on sqlite.  Not supported on this backend (as in
the JAX package): the sqlite memo caches and WAL-specific behaviours.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from contextlib import asynccontextmanager
from decimal import Decimal
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .. import trace
from ..core.clock import timestamp as now_ts
from ..core.constants import MAX_BLOCK_SIZE_HEX, SMALLEST
from ..core.tx import CoinbaseTx, Tx, TxInput, tx_from_hex
from ..device import DeviceLike, resolve
from .device_index import DeviceUtxoIndex, IndexRearmError
from .pgdriver import AsyncpgDriver, _epoch, _utc
from .storage import _GOV_TABLES, _INPUT_TABLE, _OUTPUT_TABLE
from .views import StateViews

AnyTx = Union[Tx, CoinbaseTx]

log = logging.getLogger("upow_tpu_torch.state.pg")

_COIN_Q = Decimal("0.000001")  # NUMERIC(14,6) quantum (schema.sql)

# Reference schema.sql statements (schema.sql:1-84), one per entry so
# ensure_schema can tolerate partially-created databases.
PG_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS blocks (
        id SERIAL PRIMARY KEY,
        hash CHAR(64) UNIQUE,
        content TEXT NOT NULL,
        address VARCHAR(128) NOT NULL,
        random BIGINT NOT NULL,
        difficulty NUMERIC(3, 1) NOT NULL,
        reward NUMERIC(14, 6) NOT NULL,
        timestamp TIMESTAMP(0)
    )""",
    """CREATE TABLE IF NOT EXISTS transactions (
        block_hash CHAR(64) NOT NULL REFERENCES blocks(hash) ON DELETE CASCADE,
        tx_hash CHAR(64) UNIQUE,
        tx_hex TEXT,
        inputs_addresses TEXT[],
        outputs_addresses TEXT[],
        outputs_amounts BIGINT[],
        fees NUMERIC(14, 6) NOT NULL
    )""",
    """CREATE TABLE IF NOT EXISTS unspent_outputs (
        tx_hash CHAR(64) REFERENCES transactions(tx_hash) ON DELETE CASCADE,
        index SMALLINT NOT NULL,
        address TEXT NULL,
        is_stake BOOLEAN
    )""",
    """CREATE TABLE IF NOT EXISTS pending_transactions (
        tx_hash CHAR(64) UNIQUE,
        tx_hex TEXT,
        inputs_addresses TEXT[],
        fees NUMERIC(14, 6) NOT NULL,
        propagation_time TIMESTAMP(0) NOT NULL DEFAULT NOW()
    )""",
    """CREATE TABLE IF NOT EXISTS pending_spent_outputs (
        tx_hash CHAR(64) REFERENCES transactions(tx_hash) ON DELETE CASCADE,
        index SMALLINT NOT NULL
    )""",
] + [
    f"""CREATE TABLE IF NOT EXISTS {t} (
        tx_hash CHAR(64) REFERENCES transactions(tx_hash) ON DELETE CASCADE,
        index SMALLINT NOT NULL,
        address TEXT NULL
    )"""
    for t in _GOV_TABLES
] + [
    "CREATE INDEX IF NOT EXISTS tx_hash_idx ON unspent_outputs (tx_hash)",
    "CREATE INDEX IF NOT EXISTS block_hash_idx ON transactions (block_hash)",
] + [
    # Beyond-reference migration (both statements idempotent, and a
    # pre-existing uPow database picks the column up on first boot): a
    # monotonic journal sequence for the mempool's change stamp.  pg has
    # no rowid, and (COUNT, MAX(tx_hash)) is blind to a delete+insert
    # that replaces a non-max row at the same count — MAX(journal_seq)
    # moves on every insert because the sequence never hands a value
    # out twice.  Reference writers that INSERT without naming the
    # column draw the default, so wallet-CLI interop is unchanged.
    "CREATE SEQUENCE IF NOT EXISTS pending_journal_seq",
    "ALTER TABLE pending_transactions ADD COLUMN IF NOT EXISTS"
    " journal_seq BIGINT DEFAULT nextval('pending_journal_seq')",
]


def _coins(units: int) -> Decimal:
    """int smallest-units -> NUMERIC(14,6) coin value, quantized the way
    the column would: PostgreSQL numeric rounds half AWAY FROM ZERO
    (Decimal's default half-even would store 0.0000005 coins as 0 where
    the reference's server stores 0.000001)."""
    from decimal import ROUND_HALF_UP

    return (Decimal(units) / SMALLEST).quantize(_COIN_Q,
                                                rounding=ROUND_HALF_UP)


def _units(coins: Optional[Decimal]) -> int:
    return int(Decimal(coins or 0) * SMALLEST)


class PgChainState(StateViews):
    """ChainState-compatible storage over the reference PostgreSQL schema.

    ``driver`` defaults to asyncpg on ``dsn``; tests inject
    :class:`.pgdriver.MockPgDriver`.  ``device`` is where
    :meth:`enable_device_index` puts the resident index: the card unless
    ``"cpu"``.
    """

    def __init__(self, dsn: str = "", driver=None,
                 emission_path: Optional[str] = None,
                 device: DeviceLike = None):
        self.drv = driver if driver is not None else AsyncpgDriver(dsn)
        self.path = dsn
        self.emission_path = emission_path
        self.device = device
        self._dev_index: Optional[Dict[str, DeviceUtxoIndex]] = None
        self._in_atomic = False
        # transaction-scope exclusivity: every DB call is a yield point
        # now (awaitable driver), so without this a concurrent writer's
        # statements would land INSIDE another task's open BEGIN and get
        # committed/rolled back with it.  Lazy: asyncio.Lock binds to
        # the running loop on first acquire.  _txn_owner distinguishes
        # the task that opened the transaction (its nested writes join
        # it) from foreign tasks (which must wait on the lock).
        self._write_lock = None
        self._txn_owner = None
        self._index_mutations = 0  # dirty counter: rollback only pays
        # the full index resync if the transaction actually touched it
        self._pending_gen = 0  # bumped on every LOCAL mempool mutation
        # the node sets it from mempool.reinject_on_reorg; as in the JAX
        # pg backend, remove_blocks does not read it
        self.reinject_reorg_txs = False
        # reorg notification for the hot-state read cache — same hook
        # as the sqlite backend (ChainState.on_blocks_removed)
        self.on_blocks_removed = None
        # cold-block archive fallthrough (archive/) — same seam as the
        # sqlite backend
        self.archive = None

    def _writer(self):
        if self._write_lock is None:
            self._write_lock = asyncio.Lock()
        return self._write_lock

    def _owns_txn(self) -> bool:
        return self._in_atomic and self._txn_owner is asyncio.current_task()

    @asynccontextmanager
    async def _open_txn(self, commit: bool = True):
        """The single home of writer-lock + transaction bookkeeping:
        acquire the lock, mark this task as owner (its nested writes
        join the transaction), BEGIN, then COMMIT — or ROLLBACK on
        error or when ``commit=False`` (replay).  Any rollback resyncs
        the device index (in-memory mutations from the discarded
        transaction would otherwise turn into definitive false
        negatives in the membership prefilter), still under the lock."""
        async with self._writer():
            self._in_atomic = True
            self._txn_owner = asyncio.current_task()
            rolled_back = False
            mutations_at_entry = self._index_mutations
            try:
                await self.drv.abegin()
                yield
                if commit:
                    await self.drv.acommit()
                else:
                    rolled_back = True
                    await self.drv.arollback()
            except BaseException:
                rolled_back = True
                await self.drv.arollback()
                raise
            finally:
                # also covers a failed BEGIN: leaking the owner flags
                # would let this task's later writes bypass the lock
                self._in_atomic = False
                self._txn_owner = None
                if rolled_back:
                    self._bump_fees_gen()  # memos may hold discarded rows
                if rolled_back and \
                        self._index_mutations != mutations_at_entry:
                    # in-memory index mutations from the discarded
                    # transaction would otherwise become definitive
                    # false negatives in the membership prefilter
                    await self._aindex_rebuild()

    @asynccontextmanager
    async def _txn(self):
        """Group a multi-statement mutation into one transaction unless
        this task already holds one (nested _txn — e.g. rebuild_utxos →
        add_transaction_outputs — joins it).  The sqlite backend gets
        transactionality implicitly (sqlite3 defers commit until
        _commit()); with per-statement autocommit a crash mid-reorg
        would otherwise leave torn chain state."""
        if self._owns_txn():
            yield
            return
        async with self._open_txn():
            yield

    @asynccontextmanager
    async def _write_guard(self):
        """Exclusivity without a transaction wrapper, for writes that
        are a single (auto-committed) statement — BEGIN/COMMIT would be
        two extra round trips for no additional guarantee."""
        if self._owns_txn():
            yield
            return
        async with self._writer():
            yield

    @asynccontextmanager
    async def replay_transaction(self):
        """Open a transaction, run the body joined to it, and ALWAYS
        roll back at exit — the reindex --check primitive."""
        async with self._open_txn(commit=False):
            yield

    def ensure_schema(self) -> None:
        """Create any missing tables (idempotent; a pre-existing uPow
        database passes through untouched)."""
        if getattr(self.drv, "schema_preinstalled", False):
            return  # the mock creates its sqlite-dialect schema itself
        for stmt in PG_SCHEMA:
            self.drv.execute(stmt)
        # the reference schema also declares a composite type
        # (schema.sql:22-25).  CREATE TYPE has no IF NOT EXISTS, so guard
        # server-side (locale-independent, unlike matching the error
        # text); the sqlite mock has no composite types — skip there.
        if getattr(self.drv, "supports_composite_types", True):
            self.drv.execute(
                "DO $$ BEGIN"
                " CREATE TYPE tx_output AS (tx_hash CHAR(64), index SMALLINT);"
                " EXCEPTION WHEN duplicate_object THEN NULL;"
                " END $$")

    def close(self):
        self.drv.close()

    @asynccontextmanager
    async def atomic(self):
        """One transaction around a whole block acceptance (the driver
        autocommits individual statements outside of this).  Holds the
        writer lock for the duration: reads may interleave between the
        transaction's statements (same semantics as the sqlite backend's
        shared connection), foreign writes may not."""
        async with self._open_txn():
            yield

    # ------------------------------------------------------ device index --

    def enable_device_index(self) -> None:
        """Mirror every UTXO-class table into a :class:`DeviceUtxoIndex`
        on this state's device, as the sqlite backend does.  Sync
        (blocking) — called once at node boot; runtime resyncs go through
        :meth:`_aindex_rebuild`.  The reference pg schema carries no
        amount column on unspent_outputs, so bulk loads seed the resident
        value lanes with zeros; incremental adds (which decode the tx)
        thread real amounts.  Membership never depends on the value
        lanes.  Raises without a card (unless the device is the CPU) or
        when the index cannot be built."""
        device = resolve(self.device)
        index = {}
        for table in ("unspent_outputs",) + _GOV_TABLES:
            rows = self.drv.fetch(f'SELECT tx_hash, "index" FROM {table}')
            index[table] = DeviceUtxoIndex(
                [(r["tx_hash"], r["index"]) for r in rows], device=device)
        self._dev_index = index

    def _index_add(self, table, outpoints, values=None):
        if self._dev_index is not None:
            self._index_mutations += 1
            self._dev_index[table].add(outpoints, values)

    def _index_remove(self, table, outpoints):
        if self._dev_index is not None:
            self._index_mutations += 1
            self._dev_index[table].remove(outpoints)

    def resident_indexes(self):
        """Per-table DeviceUtxoIndex map when enabled, else None — the
        accept path's gate for the fused resident probe."""
        return self._dev_index

    def index_stats(self):
        """Aggregate resident-index telemetry (same shape as the sqlite
        backend's); None when the index is disabled."""
        if not self._dev_index:
            return None
        agg = {"entries": 0, "resident_bytes": 0, "probes": 0,
               "shadow_consults": 0, "twin_fingerprints": 0}
        for index in self._dev_index.values():
            s = index.stats()
            for k in agg:
                agg[k] += s[k]
        return agg

    async def _aindex_rebuild(self):
        """Resync the device index from the live tables without blocking
        the event loop (reorg rollback / replay paths)."""
        if self._dev_index is None:
            return
        self._dev_index = await self._aindex_fresh()

    async def _aindex_fresh(self) -> Dict[str, DeviceUtxoIndex]:
        """One index per UTXO-class table from the tables as the driver's
        connection sees them (a restore's uncommitted rows included)."""
        device = resolve(self.device)
        fresh = {}
        for table in ("unspent_outputs",) + _GOV_TABLES:
            rows = await self.drv.afetch(
                f'SELECT tx_hash, "index" FROM {table}')
            fresh[table] = DeviceUtxoIndex(
                [(r["tx_hash"], r["index"]) for r in rows], device=device)
        return fresh

    # ------------------------------------------------------------- blocks --

    async def add_block(self, block_id: int, block_hash: str, content: str,
                        address: str, nonce: int, difficulty, reward: int,
                        ts: int) -> None:
        async with self._write_guard():
            await self.drv.aexecute(
                "INSERT INTO blocks (id, hash, content, address, random,"
                " difficulty, reward, timestamp)"
                " VALUES ($1,$2,$3,$4,$5,$6,$7,$8)",
                (block_id, block_hash, content, address, nonce,
                 Decimal(str(difficulty)), _coins(reward), _utc(ts)),
            )

    @staticmethod
    def _block_dict(r) -> dict:
        return {
            "id": r["id"],
            "hash": r["hash"],
            "content": r["content"],
            "address": r["address"],
            "random": r["random"],
            "difficulty": Decimal(r["difficulty"]),
            "reward": Decimal(r["reward"]),
            "timestamp": _epoch(r["timestamp"]),
        }

    @staticmethod
    def _archive_block_dict(b: list) -> dict:
        """Canonical archive block row -> the hot _block_dict shape
        (reward int smallest-units -> NUMERIC-coin Decimal, matching
        what the column would have held)."""
        return {
            "id": b[0],
            "hash": b[1],
            "content": b[2],
            "address": b[3],
            "random": b[4],
            "difficulty": Decimal(b[5]),
            "reward": _coins(b[6]),
            "timestamp": b[7],
        }

    async def get_block(self, block_hash: str) -> Optional[dict]:
        rows = await self.drv.afetch(
            "SELECT * FROM blocks WHERE hash = $1", (block_hash,))
        if not rows and self.archive is not None:
            b = await self.archive.block_by_hash(block_hash)
            return self._archive_block_dict(b) if b else None
        return self._block_dict(rows[0]) if rows else None

    async def get_block_by_id(self, block_id: int) -> Optional[dict]:
        rows = await self.drv.afetch(
            "SELECT * FROM blocks WHERE id = $1", (block_id,))
        if not rows and self.archive is not None:
            b = await self.archive.block_by_height(block_id)
            return self._archive_block_dict(b) if b else None
        return self._block_dict(rows[0]) if rows else None

    async def get_last_block(self) -> Optional[dict]:
        rows = await self.drv.afetch("SELECT * FROM blocks ORDER BY id DESC LIMIT 1")
        return self._block_dict(rows[0]) if rows else None

    async def get_next_block_id(self) -> int:
        rows = await self.drv.afetch("SELECT MAX(id) AS m FROM blocks")
        return (rows[0]["m"] or 0) + 1

    async def get_blocks(self, offset: int, limit: int,
                         tx_details: bool = False,
                         size_capped: bool = False) -> List[dict]:
        """Blocks with embedded full transactions (database.py:380-408).

        One transactions query for the whole page (grouped host-side) —
        a 1000-block sync page is 2 round trips on the network-attached
        driver, not 1001 (``tx_details`` swaps tx hex for
        explorer-shaped dicts at the reference's per-tx lookup cost).
        ``size_capped`` truncates the page at 8 full blocks' worth of
        hex — passed by the HTTP serving layer only, so internal
        callers (the reorg-window scan) always see the full window
        (divergence note in the sqlite twin's docstring)."""
        rows = await self.drv.afetch(
            "SELECT * FROM blocks WHERE id >= $1 ORDER BY id LIMIT $2",
            (offset, limit))
        by_hash: dict = {r["hash"]: [] for r in rows}
        if rows:
            txs = await self.drv.afetch(
                "SELECT block_hash, tx_hash, tx_hex FROM transactions"
                " WHERE block_hash = ANY($1)", (list(by_hash),))
            for t in txs:
                by_hash[t["block_hash"]].append((t["tx_hash"], t["tx_hex"]))
        entries = [(r["id"], self._block_dict(r), by_hash[r["hash"]])
                   for r in rows]
        if self.archive is not None:
            cov = await self.archive.coverage()
            if cov is not None and offset <= cov[1]:
                # overlay archived blocks into the page (hot wins on
                # overlap; see the sqlite twin's note)
                hot_ids = {e[0] for e in entries}
                for b, atxs in await self.archive.span(
                        offset, offset + limit - 1):
                    if b[0] not in hot_ids:
                        entries.append((b[0], self._archive_block_dict(b),
                                        [(t[1], t[2]) for t in atxs]))
                entries.sort(key=lambda e: e[0])
                entries = entries[:limit]
        out = []
        size = 0
        for _bid, block, txs_b in entries:
            size += sum(len(h) for _th, h in txs_b)
            if size_capped and size > MAX_BLOCK_SIZE_HEX * 8:
                break
            block = dict(block)
            block["difficulty"] = float(block["difficulty"])
            block["reward"] = str(block["reward"])
            if tx_details:
                # per-tx lookups are inherent to the explorer shape
                # (see the sqlite twin's note); drop reorg-raced Nones
                nice = [await self.get_nice_transaction(th)
                        for th, _h in txs_b]
                tx_list = [t for t in nice if t is not None]
            else:
                tx_list = [h for _th, h in txs_b]
            out.append({"block": block, "transactions": tx_list})
        return out

    async def remove_blocks(self, from_block_id: int) -> None:
        """Reorg rollback (database.py:146-169), same dependent-tx filter
        as the sqlite backend."""
        async with self._txn():
            # the doomed-tx snapshot must share the writer-lock scope
            # with the deletes: every driver call yields, so a snapshot
            # taken outside could miss a block accepted concurrently at
            # >= from_block_id — DELETE FROM blocks would then cascade
            # its transactions without restoring their spent UTXOs
            rows = await self.drv.afetch(
                "SELECT t.tx_hex FROM transactions t JOIN blocks b"
                " ON t.block_hash = b.hash WHERE b.id >= $1",
                (from_block_id,))
            txs = [tx_from_hex(r["tx_hex"], check_signatures=False)
                   for r in rows]
            trace.event("reorg", from_block=from_block_id,
                        removed_txs=len(txs))
            created = [tx.hash() for tx in txs]
            for table in ("unspent_outputs",) + _GOV_TABLES:
                await self.drv.aexecutemany(
                    f"DELETE FROM {table} WHERE tx_hash = $1",
                    [(h,) for h in created])
            # the index as a delta: remove the removed txs' outputs by
            # class (absent = no-op), as the sqlite backend does; the
            # restores below add back, and the _open_txn rollback
            # rebuild covers a failure
            if self._dev_index is not None:
                doomed_by_table: Dict[str, list] = {}
                for tx in txs:
                    h = tx.hash()
                    for index, out in enumerate(tx.outputs):
                        doomed_by_table.setdefault(
                            _OUTPUT_TABLE[out.output_type], []).append(
                                (h, index))
                for table, outpoints in doomed_by_table.items():
                    self._index_remove(table, outpoints)
            created_set = set(created)
            restore = [
                tx_input for tx in txs if not tx.is_coinbase
                for tx_input in tx.inputs
                if tx_input.tx_hash not in created_set
            ]
            await self._restore_spent_outputs(restore)
            await self.drv.aexecutemany(
                "DELETE FROM transactions WHERE tx_hash = $1",
                [(h,) for h in created])
            await self.drv.aexecute(
                "DELETE FROM blocks WHERE id >= $1", (from_block_id,))
            self._bump_fees_gen()
        if self.on_blocks_removed is not None:
            self.on_blocks_removed(from_block_id)

    async def _restore_spent_outputs(self, inputs: List[TxInput]) -> None:
        """Re-materialize spent outputs by decoding their source txs,
        skipping an outpoint that is already there (a whitelisted
        historical double-spend may restore one outpoint twice).  The
        index adds an outpoint only when its INSERT ran, in one splice
        per table at the end (the JAX package splices once an input),
        and each source tx is read and decoded once a call (the JAX
        package decodes it once an input)."""
        restored: Dict[str, list] = {}
        sources: Dict[str, Optional[AnyTx]] = {}
        for tx_input in inputs:
            if tx_input.tx_hash not in sources:
                sources[tx_input.tx_hash] = await self.get_transaction(
                    tx_input.tx_hash, include_pending=False)
            src = sources[tx_input.tx_hash]
            if src is None:
                continue
            out = src.outputs[tx_input.index]
            table = _OUTPUT_TABLE[out.output_type]
            exists = await self.drv.afetch(
                f'SELECT 1 AS x FROM {table} WHERE tx_hash = $1'
                f' AND "index" = $2', (tx_input.tx_hash, tx_input.index))
            if exists:
                continue
            if table == "unspent_outputs":
                await self.drv.aexecute(
                    'INSERT INTO unspent_outputs (tx_hash, "index", address,'
                    " is_stake) VALUES ($1,$2,$3,$4)",
                    (tx_input.tx_hash, tx_input.index, out.address,
                     bool(out.is_stake)))
            else:
                await self.drv.aexecute(
                    f'INSERT INTO {table} (tx_hash, "index", address)'
                    " VALUES ($1,$2,$3)",
                    (tx_input.tx_hash, tx_input.index, out.address))
            restored.setdefault(table, []).append(
                ((tx_input.tx_hash, tx_input.index),
                 (out.amount, out.address or "", 0)))
        for table, rows in restored.items():
            self._index_add(table, [o for o, _v in rows],
                            values=[v for _o, v in rows])

    # ------------------------------------------------------- transactions --

    async def add_transactions(self, txs: Sequence[AnyTx],
                               block_hash: str) -> None:
        rows = []
        for tx in txs:
            inputs_addresses = [] if tx.is_coinbase else [
                await self.resolve_output_address(i.tx_hash, i.index) or ""
                for i in tx.inputs
            ]
            fees = 0 if tx.is_coinbase else await self.tx_fees(tx)
            rows.append((
                block_hash, tx.hash(), tx.hex(),
                inputs_addresses,
                [o.address for o in tx.outputs],
                [o.amount for o in tx.outputs],
                _coins(fees),
            ))
        async with self._write_guard():  # executemany is implicitly
            # transactional in asyncpg; only exclusivity is needed
            await self.drv.aexecutemany(
                "INSERT INTO transactions (block_hash, tx_hash, tx_hex,"
                " inputs_addresses, outputs_addresses, outputs_amounts, fees)"
                " VALUES ($1,$2,$3,$4,$5,$6,$7)"
                " ON CONFLICT (tx_hash) DO UPDATE SET block_hash ="
                " EXCLUDED.block_hash", rows)

    async def get_transaction(self, tx_hash: str,
                              include_pending: bool = False) -> Optional[AnyTx]:
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM transactions WHERE tx_hash = $1", (tx_hash,))
        if not rows and include_pending:
            rows = await self.drv.afetch(
                "SELECT tx_hex FROM pending_transactions WHERE tx_hash = $1",
                (tx_hash,))
        if not rows and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                return tx_from_hex(hit[0][2], check_signatures=False)
        return tx_from_hex(rows[0]["tx_hex"], check_signatures=False) \
            if rows else None

    async def get_transaction_info(self, tx_hash: str) -> Optional[dict]:
        rows = await self.drv.afetch(
            "SELECT * FROM transactions WHERE tx_hash = $1", (tx_hash,))
        if not rows:
            if self.archive is not None:
                hit = await self.archive.tx_by_hash(tx_hash)
                if hit is not None:
                    t = hit[0]
                    return {
                        "block_hash": t[0], "tx_hash": t[1],
                        "tx_hex": t[2], "inputs_addresses": t[3],
                        "outputs_addresses": t[4],
                        "outputs_amounts": t[5], "fees": t[6],
                    }
            return None
        r = rows[0]
        return {
            "block_hash": r["block_hash"],
            "tx_hash": r["tx_hash"],
            "tx_hex": r["tx_hex"],
            "inputs_addresses": list(r["inputs_addresses"]),
            "outputs_addresses": list(r["outputs_addresses"]),
            "outputs_amounts": list(r["outputs_amounts"]),
            "fees": _units(r["fees"]),
        }

    async def get_block_transactions(self, block_hash: str,
                                     hex_only: bool = False) -> List:
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM transactions WHERE block_hash = $1",
            (block_hash,))
        if not rows and self.archive is not None:
            # pruned blocks lose their ENTIRE tx set (never split)
            atxs = await self.archive.txs_for_block(block_hash)
            if atxs:
                if hex_only:
                    return [t[2] for t in atxs]
                return [tx_from_hex(t[2], check_signatures=False)
                        for t in atxs]
        if hex_only:
            return [r["tx_hex"] for r in rows]
        return [tx_from_hex(r["tx_hex"], check_signatures=False) for r in rows]

    async def resolve_output_address(self, tx_hash: str,
                                     index: int) -> Optional[str]:
        rows = await self.drv.afetch(
            "SELECT outputs_addresses FROM transactions WHERE tx_hash = $1",
            (tx_hash,))
        if rows:
            addresses = list(rows[0]["outputs_addresses"])
            return addresses[index] if index < len(addresses) else None
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM pending_transactions WHERE tx_hash = $1",
            (tx_hash,))
        if not rows:
            if self.archive is not None:
                hit = await self.archive.tx_by_hash(tx_hash)
                if hit is not None:
                    addresses = hit[0][4]
                    return (addresses[index]
                            if index < len(addresses) else None)
            return None
        tx = tx_from_hex(rows[0]["tx_hex"], check_signatures=False)
        return tx.outputs[index].address if index < len(tx.outputs) else None

    async def get_output_amount(self, tx_hash: str,
                                index: int) -> Optional[int]:
        rows = await self.drv.afetch(
            "SELECT outputs_amounts FROM transactions WHERE tx_hash = $1",
            (tx_hash,))
        if rows:
            amounts = list(rows[0]["outputs_amounts"])
            return amounts[index] if index < len(amounts) else None
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM pending_transactions WHERE tx_hash = $1",
            (tx_hash,))
        if not rows:
            if self.archive is not None:
                hit = await self.archive.tx_by_hash(tx_hash)
                if hit is not None:
                    amounts = hit[0][5]
                    return (amounts[index]
                            if index < len(amounts) else None)
            return None
        tx = tx_from_hex(rows[0]["tx_hex"], check_signatures=False)
        return tx.outputs[index].amount if index < len(tx.outputs) else None

    # ------------------------------------------------------------ mempool --

    async def add_pending_transaction(self, tx: Tx) -> Optional[int]:
        """Insert one journal row; returns its journal_seq (see the
        sqlite twin — the value the stamp's MAX(journal_seq) takes when
        no foreign writer interleaved, used by Mempool.reconcile's
        delta prediction).  Read back by tx_hash inside the same
        transaction: a row's sequence is immutable once assigned, so
        the read cannot be corrupted by concurrent writers."""
        inputs_addresses = [
            await self.resolve_output_address(i.tx_hash, i.index) or ""
            for i in tx.inputs
        ]
        fees = await self.tx_fees(tx)
        async with self._txn():
            await self.drv.aexecute(
                "INSERT INTO pending_transactions (tx_hash, tx_hex,"
                " inputs_addresses, fees, propagation_time)"
                " VALUES ($1,$2,$3,$4,$5)",
                (tx.hash(), tx.hex(), inputs_addresses, _coins(fees),
                 _utc(now_ts())))
            await self.drv.aexecutemany(
                'INSERT INTO pending_spent_outputs (tx_hash, "index")'
                " VALUES ($1,$2)",
                [(i.tx_hash, i.index) for i in tx.inputs])
            rows = await self.drv.afetch(
                "SELECT journal_seq AS s FROM pending_transactions"
                " WHERE tx_hash = $1", (tx.hash(),))
        self._pending_gen += 1
        return rows[0]["s"] if rows else None

    async def _pending_decoded(self) -> Dict[str, Tx]:
        rows = await self.drv.afetch(
            "SELECT tx_hash, tx_hex FROM pending_transactions")
        return {
            r["tx_hash"]: tx_from_hex(r["tx_hex"], check_signatures=False)
            for r in rows
        }

    async def pending_transaction_exists(self, tx_hash: str) -> bool:
        return bool(await self.drv.afetch(
            "SELECT 1 AS x FROM pending_transactions WHERE tx_hash = $1",
            (tx_hash,)))

    async def get_pending_transactions_limit(
        self, limit_hex_chars: int = 4096 * 1024, hex_only: bool = False
    ) -> List:
        """Fee-rate-ordered mempool slice capped by total hex size
        (database.py:171-186).

        Ordering reads the NUMERIC(14,6) fees column, so fee rates are
        quantized to 100-smallest-unit granularity — EXACTLY what the
        reference node does with this schema (its ORDER BY reads the
        same lossy column).  The sqlite backend orders by exact integer
        fees; a pg-backed node reproduces the reference's block-building
        choices instead.  Consensus is unaffected (fees in accepted
        blocks are recomputed from tx amounts)."""
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM pending_transactions ORDER BY"
            " fees / LENGTH(tx_hex) DESC, tx_hash")
        out, total = [], 0
        for r in rows:
            if total + len(r["tx_hex"]) > limit_hex_chars:
                break
            total += len(r["tx_hex"])
            out.append(r["tx_hex"])
        if hex_only:
            return out
        return [tx_from_hex(h, check_signatures=False) for h in out]

    async def get_pending_transactions_by_hash(self,
                                               hashes: List[str]) -> List[str]:
        # chunked IN (...) — one round trip per 500 hashes instead of
        # one per hash; request order (and duplicates) preserved
        found: Dict[str, str] = {}
        for i in range(0, len(hashes), 500):
            chunk = list(dict.fromkeys(hashes[i:i + 500]))
            ph = ",".join(f"${j + 1}" for j in range(len(chunk)))
            rows = await self.drv.afetch(
                "SELECT tx_hash, tx_hex FROM pending_transactions"
                f" WHERE tx_hash IN ({ph})", chunk)
            for r in rows:
                found[r["tx_hash"]] = r["tx_hex"]
        return [found[h] for h in hashes if h in found]

    async def pending_journal_stamp(self) -> tuple:
        """Cheap change stamp over the pending journal (see the sqlite
        twin).  MAX(journal_seq) plays the rowid's role, and is
        strictly stronger: the sequence never reissues a value, so a
        delete+insert rewrite always moves the max (sqlite rowid can be
        reused when the max row is deleted).  The local generation
        counter still covers same-process rewrites.  Rows predating the
        journal_seq migration carry NULL and are masked by COALESCE
        until the first post-migration insert."""
        rows = await self.drv.afetch(
            "SELECT COUNT(*) AS c, COALESCE(MAX(journal_seq), 0) AS m"
            " FROM pending_transactions")
        return (rows[0]["c"], rows[0]["m"], self._pending_gen)

    async def load_pending_journal(self) -> List[dict]:
        """Full journal rows for pool recovery/reconcile; NUMERIC fees
        come back in coins and are converted to integer units."""
        rows = await self.drv.afetch(
            "SELECT tx_hash, tx_hex, fees FROM pending_transactions")
        return [{"tx_hash": r["tx_hash"], "tx_hex": r["tx_hex"],
                 "fees": _units(r["fees"])} for r in rows]

    async def get_pending_spent_outpoints(self, outpoints=None) -> set:
        """Pending-spent overlay; ``outpoints`` narrows the fetch to one
        tx's inputs (see the sqlite twin's rationale — full scans per
        intake tx are quadratic in mempool depth)."""
        if outpoints is None:
            rows = await self.drv.afetch(
                'SELECT tx_hash, "index" FROM pending_spent_outputs')
            return {(r["tx_hash"], r["index"]) for r in rows}
        want = {tuple(o) for o in outpoints}
        if not want:
            return set()
        rows = await self.drv.afetch(
            'SELECT tx_hash, "index" FROM pending_spent_outputs'
            " WHERE tx_hash = ANY($1)", (list({h for h, _ in want}),))
        return {(r["tx_hash"], r["index"]) for r in rows} & want

    async def remove_pending_transactions_by_hash(self,
                                                  hashes: List[str]) -> None:
        async with self._txn():
            await self._remove_pending_by_hash_locked(hashes)
        self._pending_gen += 1

    async def _remove_pending_by_hash_locked(self, hashes: List[str]) -> None:
        for i in range(0, len(hashes), 500):
            chunk = hashes[i:i + 500]
            ph = ",".join(f"${j + 1}" for j in range(len(chunk)))
            rows = await self.drv.afetch(
                "SELECT tx_hex FROM pending_transactions"
                f" WHERE tx_hash IN ({ph})", chunk)
            spent = []
            for r in rows:
                tx = tx_from_hex(r["tx_hex"], check_signatures=False)
                if not tx.is_coinbase:
                    spent.extend((inp.tx_hash, inp.index) for inp in tx.inputs)
            if spent:
                await self.drv.aexecutemany(
                    "DELETE FROM pending_spent_outputs"
                    ' WHERE tx_hash = $1 AND "index" = $2', spent)
            await self.drv.aexecute(
                f"DELETE FROM pending_transactions WHERE tx_hash IN ({ph})",
                chunk)

    async def remove_pending_transactions(self) -> None:
        async with self._txn():
            await self.drv.aexecute("DELETE FROM pending_transactions")
            await self.drv.aexecute("DELETE FROM pending_spent_outputs")
        self._pending_gen += 1

    async def get_pending_transactions_count(self) -> int:
        rows = await self.drv.afetch(
            "SELECT COUNT(*) AS c FROM pending_transactions")
        return rows[0]["c"]

    async def get_need_propagate_transactions(self,
                                              older_than: int = 300) -> List[str]:
        """Piggyback re-propagation queue (database.py:188-207)."""
        rows = await self.drv.afetch(
            "SELECT tx_hex FROM pending_transactions"
            " WHERE propagation_time < $1",
            (_utc(now_ts() - older_than),))
        return [r["tx_hex"] for r in rows]

    async def update_pending_transaction_propagation(self,
                                                     tx_hash: str) -> None:
        async with self._write_guard():
            await self.drv.aexecute(
                "UPDATE pending_transactions SET propagation_time = $1"
                " WHERE tx_hash = $2", (_utc(now_ts()), tx_hash))

    # --------------------------------------------------------------- UTXO --

    async def add_transaction_outputs(self, txs: Sequence[AnyTx]) -> None:
        """Route outputs into their UTXO-class table (database.py:524-580).
        Delete-then-insert emulates the sqlite backend's REPLACE — the
        reference tables have no outpoint uniqueness constraint.  Grouped
        into one executemany per table so an 8k-tx block costs a handful
        of driver round trips, not one per output."""
        by_table: Dict[str, list] = {}
        for tx in txs:
            h = tx.hash()
            for index, out in enumerate(tx.outputs):
                table = _OUTPUT_TABLE[out.output_type]
                by_table.setdefault(table, []).append((h, index, out))
        async with self._txn():
            for table, entries in by_table.items():
                await self.drv.aexecutemany(
                    f'DELETE FROM {table} WHERE tx_hash = $1'
                    ' AND "index" = $2',
                    [(h, i) for h, i, _ in entries])
                if table == "unspent_outputs":
                    await self.drv.aexecutemany(
                        'INSERT INTO unspent_outputs (tx_hash, "index",'
                        " address, is_stake) VALUES ($1,$2,$3,$4)",
                        [(h, i, o.address, bool(o.is_stake))
                         for h, i, o in entries])
                else:
                    await self.drv.aexecutemany(
                        f'INSERT INTO {table} (tx_hash, "index", address)'
                        " VALUES ($1,$2,$3)",
                        [(h, i, o.address) for h, i, o in entries])
                self._index_add(table, [(h, i) for h, i, _ in entries],
                                values=[(o.amount, o.address or "", 0)
                                        for _h, _i, o in entries])

    async def remove_outputs(self, txs: Sequence[AnyTx]) -> None:
        """Spend inputs from the table their tx type targets
        (database.py:589-622).  Grouped per table: one DELETE
        executemany + one batched index apply per UTXO class."""
        by_table: Dict[str, list] = {}
        for tx in txs:
            if tx.is_coinbase:
                continue
            table = _INPUT_TABLE.get(tx.transaction_type, "unspent_outputs")
            by_table.setdefault(table, []).extend(
                (i.tx_hash, i.index) for i in tx.inputs)
        async with self._txn():
            for table, outpoints in by_table.items():
                await self.drv.aexecutemany(
                    f'DELETE FROM {table} WHERE tx_hash = $1'
                    ' AND "index" = $2',
                    outpoints)
                self._index_remove(table, outpoints)

    async def get_unspent_outpoints(self,
                                    table: str = "unspent_outputs") -> set:
        rows = await self.drv.afetch(f'SELECT tx_hash, "index" FROM {table}')
        return {(r["tx_hash"], r["index"]) for r in rows}

    async def outpoints_exist(self, outpoints: List[Tuple[str, int]],
                              table: str = "unspent_outputs") -> List[bool]:
        """Batched membership test, same shape as the sqlite backend's
        (storage.py outpoints_exist).  With the device index enabled the
        answer is exact and SQL-free (the index's host map resolves
        fingerprint twins); the index assumes this node is the sole
        writer of the UTXO tables — the same assumption the journal and
        block-accept paths already make."""
        if not outpoints:
            return []
        if self._dev_index is not None and table in self._dev_index:
            present = self._dev_index[table].contains_batch(
                [tuple(o) for o in outpoints])
            return [bool(p) for p in present]
        return await self._outpoints_exist_sql(outpoints, table)

    async def _outpoints_exist_sql(self, outpoints, table) -> List[bool]:
        if not outpoints:
            return []
        found: set = set()
        CHUNK = 400
        for off in range(0, len(outpoints), CHUNK):
            chunk = outpoints[off:off + CHUNK]
            placeholders = ",".join(
                f"(${2 * j + 1},${2 * j + 2})" for j in range(len(chunk)))
            params = [v for o in chunk for v in o]
            rows = await self.drv.afetch(
                f'SELECT tx_hash, "index" FROM {table} WHERE'
                f' (tx_hash, "index") IN (VALUES {placeholders})', params)
            found.update((r["tx_hash"], r["index"]) for r in rows)
        return [tuple(o) in found for o in outpoints]

    async def get_table_outpoints_hash(self, table: str) -> str:
        rows = await self.drv.afetch(
            f'SELECT tx_hash, "index" FROM {table}'
            ' ORDER BY tx_hash, "index"')
        h = hashlib.sha256()
        for r in rows:
            h.update(f"{r['tx_hash']}{r['index']}".encode())
        return h.hexdigest()

    # ------------------------------------------------------ address views --

    async def _amounts_for(self, rows) -> List[dict]:
        """Attach amounts to outpoint rows carrying outputs_amounts
        arrays (the reference's join-based amount resolution)."""
        out = []
        for r in rows:
            amounts = list(r["outputs_amounts"] or [])
            idx = r["index"]
            out.append({
                "tx_hash": r["tx_hash"], "index": idx,
                "address": r["address"],
                "amount": amounts[idx] if idx < len(amounts) else 0,
            })
        return out

    async def _pending_filter(self, rows, check_pending_txs: bool) -> set:
        """Pending-spent overlay narrowed to these rows' outpoints (see
        the sqlite twin — full scans per lookup are quadratic under
        mempool load)."""
        if not check_pending_txs:
            return set()
        # threshold: narrowing wins when the row set is small (intake,
        # per-address lookups); full-table views (registrations,
        # ballots) would ship one bind param per row and invert the
        # cost model — there the one O(overlay) fetch stays cheaper,
        # and the cap also bounds the IN-clause parameter count
        if not rows:
            return set()
        if len(rows) > 256:
            return await self.get_pending_spent_outpoints()
        return await self.get_pending_spent_outpoints(
            [(r["tx_hash"], r["index"]) for r in rows])

    async def get_spendable_outputs(self, address: str,
                                    check_pending_txs: bool = False) -> List[TxInput]:
        rows = await self.drv.afetch(
            'SELECT u.tx_hash, u."index", u.address, u.is_stake,'
            " t.outputs_amounts FROM unspent_outputs u"
            " JOIN transactions t ON t.tx_hash = u.tx_hash"
            " WHERE u.address = $1 AND u.is_stake = $2", (address, False))
        pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in await self._amounts_for(rows):
            if (r["tx_hash"], r["index"]) in pending:
                continue
            i = TxInput(r["tx_hash"], r["index"])
            i.amount = r["amount"]
            out.append(i)
        return out

    async def get_stake_outputs(self, address: str,
                                check_pending_txs: bool = False) -> List[TxInput]:
        rows = await self.drv.afetch(
            'SELECT u.tx_hash, u."index", u.address, u.is_stake,'
            " t.outputs_amounts FROM unspent_outputs u"
            " JOIN transactions t ON t.tx_hash = u.tx_hash"
            " WHERE u.address = $1 AND u.is_stake = $2", (address, True))
        pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in await self._amounts_for(rows):
            if (r["tx_hash"], r["index"]) in pending:
                continue
            i = TxInput(r["tx_hash"], r["index"])
            i.amount = r["amount"]
            out.append(i)
        return out

    async def get_address_transactions(self, address: str, limit: int = 50,
                                       offset: int = 0) -> List[dict]:
        if self.archive is None:
            rows = await self.drv.afetch(
                "SELECT t.tx_hash, b.id AS block_id FROM transactions t"
                " JOIN blocks b ON b.hash = t.block_hash"
                " WHERE $1 = ANY(inputs_addresses)"
                " OR $1 = ANY(outputs_addresses)"
                " ORDER BY b.id DESC LIMIT $2 OFFSET $3",
                (address, limit, offset))
            return [dict(r) for r in rows]
        # merge archived matches before paginating (see the sqlite
        # twin's note on why the hot prefix of offset+limit suffices)
        rows = await self.drv.afetch(
            "SELECT t.tx_hash, b.id AS block_id FROM transactions t"
            " JOIN blocks b ON b.hash = t.block_hash"
            " WHERE $1 = ANY(inputs_addresses)"
            " OR $1 = ANY(outputs_addresses)"
            " ORDER BY b.id DESC LIMIT $2",
            (address, offset + limit))
        merged = [dict(r) for r in rows]
        seen = {r["tx_hash"] for r in merged}
        for b, t in await self.archive.address_history(address):
            if t[1] not in seen:
                merged.append({"tx_hash": t[1], "block_id": b[0]})
        merged.sort(key=lambda r: -r["block_id"])
        return merged[offset:offset + limit]

    # --------------------------------------------------------- governance --

    async def get_registered(self, table: str,
                             check_pending_txs: bool = False,
                             pending: Optional[set] = None) -> List[Tuple[str, int]]:
        """(address, registered_at block timestamp) per registration
        output (same contract as storage.py get_registered)."""
        rows = await self.drv.afetch(
            f'SELECT g.tx_hash, g."index", g.address, b.timestamp AS ts'
            f" FROM {table} g"
            " LEFT JOIN transactions t ON t.tx_hash = g.tx_hash"
            " LEFT JOIN blocks b ON b.hash = t.block_hash")
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["index"]) in pending:
                continue
            out.append((r["address"],
                        _epoch(r["ts"]) if r["ts"] is not None else now_ts()))
        return out

    async def get_ballot_by_recipient(self, table: str, recipient: str,
                                      check_pending_txs: bool = False) -> List[dict]:
        """Standing votes FOR ``recipient`` (storage.py
        get_ballot_by_recipient contract; reference database.py:939-1063)."""
        rows = await self.drv.afetch(
            f'SELECT g.tx_hash, g."index", t.outputs_amounts,'
            f" t.inputs_addresses FROM {table} g"
            f" JOIN transactions t ON t.tx_hash = g.tx_hash"
            f" WHERE g.address = $1", (recipient,))
        pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["index"]) in pending:
                continue
            addrs = list(r["inputs_addresses"])
            amounts = list(r["outputs_amounts"])
            idx = r["index"]
            out.append({
                "tx_hash": r["tx_hash"], "index": idx,
                "voter": addrs[idx] if idx < len(addrs) else None,
                "vote": Decimal(amounts[idx] if idx < len(amounts) else 0)
                / SMALLEST,
            })
        return out

    async def _all_ballot_rows(self, table: str,
                               check_pending_txs: bool = False,
                               pending: Optional[set] = None) -> List[dict]:
        rows = await self.drv.afetch(
            f'SELECT g.tx_hash, g."index", g.address AS recipient,'
            f" t.outputs_amounts, t.inputs_addresses FROM {table} g"
            f" JOIN transactions t ON t.tx_hash = g.tx_hash")
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["index"]) in pending:
                continue
            addrs = list(r["inputs_addresses"])
            amounts = list(r["outputs_amounts"])
            idx = r["index"]
            out.append({
                "tx_hash": r["tx_hash"], "index": idx,
                "recipient": r["recipient"],
                "voter": addrs[idx] if idx < len(addrs) else None,
                "vote": Decimal(amounts[idx] if idx < len(amounts) else 0)
                / SMALLEST,
            })
        return out

    async def _outpoint_listing(self, table: str, address: str,
                                check_pending_txs: bool) -> List[Tuple[str, int]]:
        rows = await self.drv.afetch(
            f'SELECT tx_hash, "index" FROM {table} WHERE address = $1',
            (address,))
        pending = await self._pending_filter(rows, check_pending_txs)
        return [(r["tx_hash"], r["index"]) for r in rows
                if (r["tx_hash"], r["index"]) not in pending]

    async def get_delegates_voting_power(self, address: str,
                                         check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        return await self._outpoint_listing(
            "delegates_voting_power", address, check_pending_txs)

    async def get_inode_registration_outputs(self, address: str,
                                             check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        return await self._outpoint_listing(
            "inode_registration_output", address, check_pending_txs)

    async def get_validators_voting_power(self, address: str,
                                          check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        return await self._outpoint_listing(
            "validators_voting_power", address, check_pending_txs)

    async def get_multiple_address_stakes(
            self, addresses: Iterable[str],
            check_pending_txs: bool = False,
            pending: Optional[set] = None) -> Dict[str, Decimal]:
        """Batch stake query (database.py:1208-1290)."""
        addresses = list(set(addresses))
        if not addresses:
            return {}
        out: Dict[str, Decimal] = {a: Decimal(0) for a in addresses}
        placeholders = ",".join(f"${i + 1}" for i in range(len(addresses)))
        rows = await self.drv.afetch(
            'SELECT u.tx_hash, u."index", u.address, t.outputs_amounts'
            " FROM unspent_outputs u JOIN transactions t"
            " ON t.tx_hash = u.tx_hash"
            f" WHERE u.is_stake = ${len(addresses) + 1}"
            f" AND u.address IN ({placeholders})",
            list(addresses) + [True])
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        for r in await self._amounts_for(rows):
            if (r["tx_hash"], r["index"]) in pending:
                continue
            out[r["address"]] += Decimal(r["amount"]) / SMALLEST
        if check_pending_txs:
            want = set(addresses)
            for tx in (await self._pending_decoded()).values():
                for o in tx.outputs:
                    if o.is_stake and o.address in want:
                        out[o.address] += Decimal(o.amount) / SMALLEST
        return out

    async def get_outputs_by_address(self, table: str, address: str,
                                     check_pending_txs: bool = False,
                                     is_stake: Optional[bool] = None) -> List[dict]:
        sql = (f'SELECT g.tx_hash, g."index", g.address, t.outputs_amounts'
               + (", g.is_stake" if table == "unspent_outputs" else "")
               + f" FROM {table} g JOIN transactions t"
               " ON t.tx_hash = g.tx_hash WHERE g.address = $1")
        params: list = [address]
        if is_stake is not None and table == "unspent_outputs":
            sql += " AND g.is_stake = $2"
            params.append(bool(is_stake))
        rows = await self.drv.afetch(sql, params)
        pending = await self._pending_filter(rows, check_pending_txs)
        return [
            {"tx_hash": r["tx_hash"], "index": r["index"],
             "amount": r["amount"]}
            for r in await self._amounts_for(rows)
            if (r["tx_hash"], r["index"]) not in pending
        ]

    async def get_ballots(self, table: str, recipient: Optional[str] = None,
                          offset: int = 0, limit: int = 100) -> List[dict]:
        """Paged ballot listing (storage.py get_ballots contract)."""
        if recipient is not None:
            rows = await self.drv.afetch(
                f'SELECT g.tx_hash, g."index", g.address,'
                f" t.outputs_amounts, t.inputs_addresses FROM {table} g"
                f" JOIN transactions t ON t.tx_hash = g.tx_hash"
                f' WHERE g.address = $1 ORDER BY g.tx_hash, g."index"'
                f" LIMIT $2 OFFSET $3",
                (recipient, limit, offset))
        else:
            rows = await self.drv.afetch(
                f'SELECT g.tx_hash, g."index", g.address,'
                f" t.outputs_amounts, t.inputs_addresses FROM {table} g"
                f" JOIN transactions t ON t.tx_hash = g.tx_hash"
                f' ORDER BY g.tx_hash, g."index" LIMIT $1 OFFSET $2',
                (limit, offset))
        out = []
        for r in rows:
            addrs = list(r["inputs_addresses"])
            amounts = list(r["outputs_amounts"])
            idx = r["index"]
            out.append({
                "tx_hash": r["tx_hash"], "index": idx,
                "voter": addrs[idx] if idx < len(addrs) else None,
                "recipient": r["address"],
                "vote": Decimal(amounts[idx] if idx < len(amounts) else 0)
                / SMALLEST,
            })
        return out

    async def get_transaction_block_timestamp(self,
                                              tx_hash: str) -> Optional[int]:
        rows = await self.drv.afetch(
            "SELECT b.timestamp AS ts FROM transactions t JOIN blocks b ON"
            " b.hash = t.block_hash WHERE t.tx_hash = $1", (tx_hash,))
        if not rows and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                b = await self.archive.block_by_height(hit[1])
                return b[7] if b else None
        return _epoch(rows[0]["ts"]) if rows else None

    # ---------------------------------------------------- explorer views --

    async def get_nice_transaction(self, tx_hash: str,
                                   address: Optional[str] = None) -> Optional[dict]:
        """Explorer-style decoded transaction (storage.py
        get_nice_transaction contract; reference database.py:1606-1654)."""
        rows = await self.drv.afetch(
            "SELECT t.tx_hash, t.tx_hex, t.inputs_addresses, t.block_hash,"
            " b.id AS block_no, b.timestamp AS block_ts FROM"
            " transactions t JOIN blocks b ON b.hash = t.block_hash"
            " WHERE t.tx_hash = $1", (tx_hash,))
        is_confirm = bool(rows)
        if not rows:
            rows = await self.drv.afetch(
                "SELECT tx_hash, tx_hex, inputs_addresses FROM"
                " pending_transactions WHERE tx_hash = $1", (tx_hash,))
        if not rows and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                t, height = hit
                b = await self.archive.block_by_height(height)
                # plain dict stands in for the driver row (_row_keys
                # handles both; _epoch passes int timestamps through)
                rows = [{"tx_hash": t[1], "tx_hex": t[2],
                         "inputs_addresses": t[3], "block_hash": t[0],
                         "block_no": height,
                         "block_ts": b[7] if b else 0}]
                is_confirm = True
        if not rows:
            return None
        r = rows[0]
        keys = _row_keys(r)
        tx = tx_from_hex(r["tx_hex"], check_signatures=False)
        inputs_addresses = list(r["inputs_addresses"])

        def coins(amount: int) -> float:
            return float(Decimal(amount) / SMALLEST)

        block_ts = _epoch(r["block_ts"]) if "block_ts" in keys else None
        if tx.is_coinbase:
            out = {
                "is_coinbase": True, "hash": r["tx_hash"],
                "block_hash": r["block_hash"] if "block_hash" in keys else None,
                "block_no": r["block_no"] if "block_no" in keys else None,
                "datetime": block_ts,
            }
        else:
            delta = None
            if address is not None:
                delta = 0
                for i, tx_input in enumerate(tx.inputs):
                    if i < len(inputs_addresses) and inputs_addresses[i] == address:
                        amt = await self.get_output_amount(
                            tx_input.tx_hash, tx_input.index)
                        delta -= amt or 0
                for o in tx.outputs:
                    if o.address == address:
                        delta += o.amount
                delta = coins(delta)
            inputs = []
            for i, tx_input in enumerate(tx.inputs):
                amt = await self.get_output_amount(
                    tx_input.tx_hash, tx_input.index)
                inputs.append({
                    "index": tx_input.index,
                    "tx_hash": tx_input.tx_hash,
                    "address": (inputs_addresses[i]
                                if i < len(inputs_addresses) else None),
                    "amount": coins(amt or 0),
                })
            out = {
                "is_coinbase": False, "hash": r["tx_hash"],
                "block_hash": r["block_hash"] if "block_hash" in keys else None,
                "block_no": r["block_no"] if "block_no" in keys else None,
                "datetime": block_ts,
                "message": tx.message.hex() if tx.message is not None else None,
                "transaction_type": tx.transaction_type.name,
                "is_confirm": is_confirm,
                "inputs": inputs,
                "delta": delta,
                "fees": coins(await self.tx_fees(tx)),
            }
        out["outputs"] = [
            {"address": o.address, "amount": coins(o.amount),
             "type": o.output_type.name}
            for o in tx.outputs
        ]
        return out

    async def get_block_transaction_hashes(self, block_hash: str) -> List[str]:
        rows = await self.drv.afetch(
            "SELECT tx_hash FROM transactions WHERE block_hash = $1",
            (block_hash,))
        if not rows and self.archive is not None:
            atxs = await self.archive.txs_for_block(block_hash)
            if atxs:
                return [t[1] for t in atxs]
        return [r["tx_hash"] for r in rows]

    async def get_address_pending_transactions(self, address: str) -> List[Tx]:
        rows = await self.drv.afetch(
            "SELECT tx_hex, inputs_addresses FROM pending_transactions")
        out = []
        for r in rows:
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            if address in list(r["inputs_addresses"]) or \
                    any(o.address == address for o in tx.outputs):
                out.append(tx)
        return out

    async def get_address_pending_spent_outpoints(
            self, address: str) -> List[Tuple[str, int]]:
        rows = await self.drv.afetch(
            "SELECT tx_hex, inputs_addresses FROM pending_transactions")
        out = []
        for r in rows:
            addrs = list(r["inputs_addresses"])
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            for i, tx_input in enumerate(tx.inputs):
                if i < len(addrs) and addrs[i] == address:
                    out.append((tx_input.tx_hash, tx_input.index))
        return out

    # ----------------------------------------------------------- rebuild --

    async def rebuild_utxos(self) -> None:
        """Full-chain replay of every output table from the transactions
        log (reference create_unspent_outputs.py + database.py:846-862)."""
        async with self._txn():
            for table in ("unspent_outputs",) + _GOV_TABLES:
                await self.drv.aexecute(f"DELETE FROM {table}")
            rows = await self.drv.afetch(
                "SELECT t.tx_hex FROM transactions t JOIN blocks b ON"
                " b.hash = t.block_hash ORDER BY b.id")
            txs = [tx_from_hex(r["tx_hex"], check_signatures=False)
                   for r in rows]
            for tx in txs:
                await self.add_transaction_outputs([tx])
                await self.remove_outputs([tx])
        if not self._owns_txn():
            # inside a replay transaction the owning scope resyncs the
            # index after its rollback; here, resync under the writer
            # lock so a concurrent commit can't be clobbered by a stale
            # snapshot swap
            async with self._writer():
                await self._aindex_rebuild()


    # ---------------------------------------------------------- snapshots --
    # Canonical positional row shapes shared with the sqlite backend
    # (docs/SNAPSHOT.md).  This schema has no amount columns on the
    # UTXO tables — amounts travel in the canonical rows anyway (joined
    # from transactions on export, dropped on restore) so one payload
    # restores on either backend.

    async def export_snapshot_rows(self, table: str) -> List[list]:
        if table not in ("unspent_outputs",) + _GOV_TABLES:
            raise ValueError(f"not a snapshot table: {table}")
        if table == "unspent_outputs":
            rows = await self.drv.afetch(
                'SELECT u.tx_hash, u."index", u.address, u.is_stake,'
                " t.outputs_amounts FROM unspent_outputs u"
                " JOIN transactions t ON t.tx_hash = u.tx_hash"
                ' ORDER BY u.tx_hash, u."index"')
            out = []
            for r in rows:
                amounts = list(r["outputs_amounts"] or [])
                idx = r["index"]
                out.append([r["tx_hash"], idx, r["address"],
                            int(amounts[idx]) if idx < len(amounts) else 0,
                            int(bool(r["is_stake"]))])
            return out
        rows = await self.drv.afetch(
            f'SELECT g.tx_hash, g."index", g.address, t.outputs_amounts'
            f" FROM {table} g JOIN transactions t ON t.tx_hash = g.tx_hash"
            ' ORDER BY g.tx_hash, g."index"')
        out = []
        for r in rows:
            amounts = list(r["outputs_amounts"] or [])
            idx = r["index"]
            out.append([r["tx_hash"], idx, r["address"],
                        int(amounts[idx]) if idx < len(amounts) else 0])
        return out

    async def export_snapshot_txs(self, tail: int) -> List[list]:
        """Witness transactions (see the sqlite twin): every tx still
        referenced by an exported outpoint plus the block tail's txs."""
        union = " UNION ".join(
            f"SELECT tx_hash FROM {t}"
            for t in ("unspent_outputs",) + _GOV_TABLES)
        rows = await self.drv.afetch(
            "SELECT block_hash, tx_hash, tx_hex, inputs_addresses,"
            " outputs_addresses, outputs_amounts, fees FROM transactions"
            f" WHERE tx_hash IN ({union}) OR block_hash IN"
            " (SELECT hash FROM blocks ORDER BY id DESC LIMIT $1)"
            " ORDER BY tx_hash", (tail,))
        return [[r["block_hash"], r["tx_hash"], r["tx_hex"],
                 list(r["inputs_addresses"] or []),
                 list(r["outputs_addresses"] or []),
                 [int(a) for a in (r["outputs_amounts"] or [])],
                 _units(r["fees"])] for r in rows]

    async def export_snapshot_blocks(self, tail: int) -> List[list]:
        rows = await self.drv.afetch(
            "SELECT id, hash, content, address, random, difficulty,"
            " reward, timestamp FROM blocks ORDER BY id DESC LIMIT $1",
            (tail,))
        return [[r["id"], r["hash"], r["content"], r["address"],
                 r["random"], str(r["difficulty"]), _units(r["reward"]),
                 _epoch(r["timestamp"])] for r in reversed(rows)]

    async def restore_snapshot(self, tables: Dict[str, List[list]],
                               txs: List[list], blocks: List[list]) -> None:
        """Wholesale replace of chain state with verified snapshot rows
        (one transaction; see the sqlite twin for the contract, the
        index rebuild inside it included).  Witness txs from blocks
        older than the carried tail dangle their block_hash foreign key,
        so on real PostgreSQL the restore runs under
        ``session_replication_role = replica`` (needs a superuser/owner
        role); the SET is best-effort because the sqlite-backed mock
        driver cannot parse it."""
        for name in tables:
            if name not in ("unspent_outputs",) + _GOV_TABLES:
                raise ValueError(f"not a snapshot table: {name}")
        async with self.atomic():
            try:
                await self.drv.aexecute(
                    "SET session_replication_role = replica")
            except Exception as e:
                log.debug("replica role unavailable (%s); witness-tx "
                          "FKs must hold on their own", e)
            for table in ("unspent_outputs",) + _GOV_TABLES:
                await self.drv.aexecute(f"DELETE FROM {table}")
            for table in ("pending_spent_outputs", "pending_transactions",
                          "transactions", "blocks"):
                await self.drv.aexecute(f"DELETE FROM {table}")
            await self.drv.aexecutemany(
                "INSERT INTO blocks (id, hash, content, address, random,"
                " difficulty, reward, timestamp)"
                " VALUES ($1,$2,$3,$4,$5,$6,$7,$8)",
                [(r[0], r[1], r[2], r[3], r[4], Decimal(r[5]),
                  _coins(r[6]), _utc(r[7])) for r in blocks])
            await self.drv.aexecutemany(
                "INSERT INTO transactions (block_hash, tx_hash, tx_hex,"
                " inputs_addresses, outputs_addresses, outputs_amounts,"
                " fees) VALUES ($1,$2,$3,$4,$5,$6,$7)",
                [(r[0], r[1], r[2], list(r[3]), list(r[4]),
                  [int(a) for a in r[5]], _coins(r[6])) for r in txs])
            await self.drv.aexecutemany(
                'INSERT INTO unspent_outputs (tx_hash, "index", address,'
                " is_stake) VALUES ($1,$2,$3,$4)",
                [(r[0], r[1], r[2], bool(r[4]))
                 for r in tables.get("unspent_outputs", [])])
            for table in _GOV_TABLES:
                await self.drv.aexecutemany(
                    f'INSERT INTO {table} (tx_hash, "index", address)'
                    " VALUES ($1,$2,$3)",
                    [(r[0], r[1], r[2]) for r in tables.get(table, [])])
            try:
                await self.drv.aexecute(
                    "SET session_replication_role = DEFAULT")
            except Exception as e:
                log.debug("could not reset replication role: %s", e)
            if self._dev_index is not None:
                try:
                    fresh = await self._aindex_fresh()
                except Exception as e:
                    raise IndexRearmError(
                        f"resident index not rebuilt after the restore:"
                        f" {type(e).__name__}: {e}") from e
                # under the writer lock, before the commit: a failed
                # commit rolls back and rebuilds from the old tables
                self._dev_index = fresh
                self._index_mutations += 1
        self._bump_fees_gen()

    # ------------------------------------------------------------- archive --
    # Compactor seam (archive/compactor.py, docs/ARCHIVE.md); same
    # contract as the sqlite twin.

    async def archive_export_span(self, lo: int, hi: int):
        """Canonical rows for heights [lo, hi]: (block rows ascending,
        {block_hash: [tx rows in acceptance order]}).  Within-block tx
        order relies on insertion order, the same assumption
        get_block_transactions already makes on this schema."""
        rows = await self.drv.afetch(
            "SELECT id, hash, content, address, random, difficulty,"
            " reward, timestamp FROM blocks WHERE id BETWEEN $1 AND $2"
            " ORDER BY id", (lo, hi))
        blocks = [[r["id"], r["hash"], r["content"], r["address"],
                   r["random"], str(r["difficulty"]), _units(r["reward"]),
                   _epoch(r["timestamp"])] for r in rows]
        txs_by_block: Dict[str, list] = {}
        if blocks:
            txs = await self.drv.afetch(
                "SELECT block_hash, tx_hash, tx_hex, inputs_addresses,"
                " outputs_addresses, outputs_amounts, fees FROM"
                " transactions WHERE block_hash = ANY($1)",
                ([b[1] for b in blocks],))
            for t in txs:
                txs_by_block.setdefault(t["block_hash"], []).append(
                    [t["block_hash"], t["tx_hash"], t["tx_hex"],
                     list(t["inputs_addresses"] or []),
                     list(t["outputs_addresses"] or []),
                     [int(a) for a in (t["outputs_amounts"] or [])],
                     _units(t["fees"])])
        return blocks, txs_by_block

    async def archive_prune_span(self, lo: int, hi: int) -> dict:
        """Delete hot blocks in [lo, hi] whose ENTIRE tx set is outside
        the snapshot witness closure, plus those blocks' txs (see the
        sqlite twin).  Doomed txs have no UTXO/governance references by
        construction, so the explicit deletes never trip a foreign
        key."""
        union = " UNION ".join(
            f"SELECT tx_hash FROM {t}"
            for t in ("unspent_outputs",) + _GOV_TABLES)
        async with self._txn():
            rows = await self.drv.afetch(
                "SELECT hash FROM blocks b WHERE b.id BETWEEN $1 AND $2"
                " AND NOT EXISTS (SELECT 1 FROM transactions t WHERE"
                f" t.block_hash = b.hash AND t.tx_hash IN ({union}))",
                (lo, hi))
            doomed = [r["hash"] for r in rows]
            n_txs = 0
            if doomed:
                counted = await self.drv.afetch(
                    "SELECT COUNT(*) AS n FROM transactions WHERE"
                    " block_hash = ANY($1)", (doomed,))
                n_txs = int(counted[0]["n"] or 0)
                await self.drv.aexecute(
                    "DELETE FROM transactions WHERE block_hash = ANY($1)",
                    (doomed,))
                await self.drv.aexecute(
                    "DELETE FROM blocks WHERE hash = ANY($1)", (doomed,))
            self._bump_fees_gen()  # memos may hold pruned-source rows
        return {"blocks": len(doomed), "txs": n_txs}

    async def archive_hot_row_counts(self) -> dict:
        b = await self.drv.afetch("SELECT COUNT(*) AS n FROM blocks")
        t = await self.drv.afetch("SELECT COUNT(*) AS n FROM transactions")
        return {"blocks": int(b[0]["n"] or 0), "txs": int(t[0]["n"] or 0)}


def _row_keys(r) -> set:
    """Column names of a driver row (asyncpg Record or mock dict)."""
    return set(r.keys())
