"""Chain state storage: the role of the reference's ``Database`` singleton.

The port's copy of the JAX package's ``state/storage.py``, cut to what
block acceptance and its rule checks read and write: same schema, same
SQL, same fingerprints, so a chain database written by either package
opens in the other.  ``device_index=True`` (or ``enable_device_index()``)
mirrors every UTXO-class table into a resident
:class:`~.device_index.DeviceUtxoIndex` on the ChainState's device (the
card unless ``device="cpu"``), kept in step with every UTXO write; it
then answers ``outpoints_exist`` and the accept's fused scan.  Without
it membership checks take the SQL path, as in the JAX package by
default.  The mempool journal and the block and transaction reads serve
the node's routes, the address and governance views the wallet's
builders, the snapshot methods (``export_snapshot_*``,
``restore_snapshot``) the snapshot builder and bootstrap, and the
archive seam (``archive_export_span``, ``archive_prune_span``,
``archive_hot_row_counts``) the archive compactor.  With an
:class:`~..archive.reader.ArchiveReader` attached as ``self.archive``
(the node attaches one when ``archive.dir`` is set), every block and
transaction read that misses the hot tables falls through to the
archive's segments, so a pruned state answers as an unpruned one does.
``sole_writer=False`` (the wallet CLI beside a node writing the same
file) checks for other connections' commits on every memo read.

The reference couples all chain state to asyncpg/PostgreSQL through an
~80-method ``Database`` class (database.py, 1654 LoC).  This keeps the
same *logical* schema (schema.sql: blocks, transactions, six UTXO-class
tables, pending tables) but:

* backs it with stdlib ``sqlite3`` (file or ``:memory:``),
* keeps amounts as **int smallest-units** end to end (the reference's
  NUMERIC/Decimal appears only in governance ratio math, which is
  Decimal-exact here too — core/rewards.py),
* avoids the reference's LIKE-'%hex%' address scans (database.py:864-937)
  by materializing an ``address`` column on outputs and a JSON address
  array on transactions,
* exposes the *state-view* callbacks the pure consensus kernel needs
  (core/tx.py ``AddressResolver``) instead of letting codecs import the
  database.

All methods are ``async def`` to slot into the asyncio accept path;
sqlite calls are short and synchronous under one connection with WAL.
Block acceptance is wrapped in one transaction (``atomic``) — the
serializable-retry loop the reference hand-rolls (database.py:640-672)
comes for free from sqlite's locking.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time as _time
from collections import OrderedDict
from contextlib import asynccontextmanager
from decimal import Decimal
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .. import trace
from ..core.codecs import OutputType, TransactionType
from ..core.clock import timestamp as now_ts
from ..core.constants import MAX_BLOCK_SIZE_HEX, SMALLEST
from ..core.tx import CoinbaseTx, Tx, TxInput, tx_from_hex
from ..device import DeviceLike, resolve
from .device_index import DeviceUtxoIndex, IndexRearmError

AnyTx = Union[Tx, CoinbaseTx]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
    id INTEGER PRIMARY KEY,
    hash TEXT UNIQUE NOT NULL,
    content TEXT NOT NULL,
    address TEXT NOT NULL,
    random INTEGER NOT NULL,
    difficulty TEXT NOT NULL,
    reward INTEGER NOT NULL,
    timestamp INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS transactions (
    block_hash TEXT NOT NULL,
    tx_hash TEXT UNIQUE NOT NULL,
    tx_hex TEXT NOT NULL,
    inputs_addresses TEXT NOT NULL,
    outputs_addresses TEXT NOT NULL,
    outputs_amounts TEXT NOT NULL,
    fees INTEGER NOT NULL
);
CREATE INDEX IF NOT EXISTS tx_block_hash_idx ON transactions (block_hash);
CREATE TABLE IF NOT EXISTS pending_transactions (
    tx_hash TEXT UNIQUE NOT NULL,
    tx_hex TEXT NOT NULL,
    inputs_addresses TEXT NOT NULL,
    fees INTEGER NOT NULL,
    propagation_time INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS pending_spent_outputs (
    tx_hash TEXT NOT NULL,
    idx INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS unspent_outputs (
    tx_hash TEXT NOT NULL,
    idx INTEGER NOT NULL,
    address TEXT,
    amount INTEGER NOT NULL,
    is_stake INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (tx_hash, idx)
);
CREATE INDEX IF NOT EXISTS unspent_address_idx ON unspent_outputs (address);
"""

# The governance tables share one row shape (outpoint + address).
_GOV_TABLES = (
    "inode_registration_output",
    "validator_registration_output",
    "validators_voting_power",
    "delegates_voting_power",
    "inodes_ballot",
    "validators_ballot",
)

for _t in _GOV_TABLES:
    _SCHEMA += f"""
CREATE TABLE IF NOT EXISTS {_t} (
    tx_hash TEXT NOT NULL,
    idx INTEGER NOT NULL,
    address TEXT,
    amount INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (tx_hash, idx)
);
CREATE INDEX IF NOT EXISTS {_t}_address_idx ON {_t} (address);
"""

# OutputType -> table routing (reference database.py:524-580)
_OUTPUT_TABLE = {
    OutputType.REGULAR: "unspent_outputs",
    OutputType.STAKE: "unspent_outputs",
    OutputType.UN_STAKE: "unspent_outputs",
    OutputType.INODE_REGISTRATION: "inode_registration_output",
    OutputType.VALIDATOR_REGISTRATION: "validator_registration_output",
    OutputType.VALIDATOR_VOTING_POWER: "validators_voting_power",
    OutputType.DELEGATE_VOTING_POWER: "delegates_voting_power",
    OutputType.VOTE_AS_VALIDATOR: "inodes_ballot",
    OutputType.VOTE_AS_DELEGATE: "validators_ballot",
}

# TransactionType -> which table its *inputs* spend from
# (reference database.py:589-622 remove_outputs partitioning)
_INPUT_TABLE = {
    TransactionType.INODE_DE_REGISTRATION: "inode_registration_output",
    TransactionType.VOTE_AS_VALIDATOR: "validators_voting_power",
    TransactionType.VOTE_AS_DELEGATE: "delegates_voting_power",
    TransactionType.REVOKE_AS_VALIDATOR: "inodes_ballot",
    TransactionType.REVOKE_AS_DELEGATE: "validators_ballot",
}


from .views import StateViews


class ChainState(StateViews):
    """One chain's durable state.  ``path=None`` -> in-memory (tests).

    The backend-independent consensus views (stake aggregation, the
    active-inode cascade, fee math, fingerprints) live in
    :class:`StateViews`; this class implements the sqlite storage
    primitives under them."""

    def __init__(self, path: Optional[str] = None,
                 device_index: bool = False, device: DeviceLike = None,
                 sole_writer: bool = True):
        self.path = path or ":memory:"
        # sole_writer=False (a wallet CLI reading a file the node is
        # writing) checks sqlite's data_version on every memo read
        # instead of once per 50 ms, so a secondary reader never serves
        # stale amounts or addresses into fee and coinbase computation
        self.sole_writer = sole_writer
        self.db = sqlite3.connect(self.path)
        self.db.row_factory = sqlite3.Row
        if path:
            self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA foreign_keys=OFF")
        self.db.executescript(_SCHEMA)
        self.db.commit()
        # emission audit sidecar (reference: emission_details.json pickledb)
        self.emission_path = (
            os.path.splitext(path)[0] + ".emission.json" if path else None
        )
        # decoded-mempool cache: the stake rule checks walk every pending
        # tx; decode the pending hex once per change, not once per call
        # (the reference's O(mempool) anti-pattern, database.py:1138-1205)
        self._pending_cache: Optional[Dict[str, Tx]] = None
        self._pending_stamp: tuple = (-1, -1, -1)
        self._pending_gen = 0  # bumped on every LOCAL mempool mutation
        self._amount_cache: "OrderedDict[tuple, object]" = OrderedDict()
        # reorg mempool re-injection: off at the library level, as in the
        # JAX package; the node turns it on from mempool.reinject_on_reorg
        self.reinject_reorg_txs = False
        # reorg notification: called with the first removed block id
        # after a remove_blocks rollback commits
        self.on_blocks_removed = None
        # cold-block archive fallthrough (archive/): the node attaches an
        # ArchiveReader when archive.dir is set; None keeps every read
        # path exactly on its hot-only query
        self.archive = None
        self._data_version = self._db_data_version()
        self._data_version_checked = 0.0
        # the resident UTXO index, one per UTXO-class table, on
        # ``device`` (the card unless "cpu"); None when not armed
        self.device = device
        self._dev_index: Optional[Dict[str, DeviceUtxoIndex]] = None
        if device_index:
            self.enable_device_index()

    def _db_data_version(self) -> int:
        return self.db.execute("PRAGMA data_version").fetchone()[0]

    def _amount_cache_get(self, key):
        """Cached output amount/address, guarded against writes from
        OTHER connections on the same db file: sqlite's data_version
        counter bumps whenever a different connection commits, and any
        such commit may have deleted source txs — so the whole memo is
        dropped then.  The check is rate-limited to one PRAGMA per 50 ms
        (at ~25k lookups per 8k-tx block a pragma per hit halves the
        accept rate) unless ``sole_writer`` is False; this connection's
        own deletions invalidate explicitly."""
        now = _time.monotonic()
        if not self.sole_writer or now - self._data_version_checked >= 0.05:
            self._data_version_checked = now
            version = self._db_data_version()
            if version != self._data_version:
                self._data_version = version
                self._amount_cache.clear()
                return None
        return self._amount_cache.get(key)

    def _amount_cache_put(self, key, value) -> None:
        self._amount_cache[key] = value
        while len(self._amount_cache) > (1 << 16):
            self._amount_cache.popitem(last=False)

    def _amount_cache_drop(self, tx_hashes) -> None:
        """Forget cached output amounts for deleted txs (see
        get_output_amount: existence must not depend on cache warmth)."""
        gone = set(tx_hashes)
        if gone:
            for key in [k for k in self._amount_cache if k[0] in gone]:
                del self._amount_cache[key]

    async def _pending_decoded(self) -> Dict[str, Tx]:
        # (count, max rowid) detects writes from OTHER connections on the
        # same file: inserts bump max rowid, deletes drop the count.  The
        # local generation counter covers the one combination they miss.
        r = self.db.execute(
            "SELECT COUNT(*) AS c, COALESCE(MAX(rowid), 0) AS m"
            " FROM pending_transactions").fetchone()
        stamp = (r["c"], r["m"], self._pending_gen)
        if self._pending_cache is None or self._pending_stamp != stamp:
            rows = self.db.execute(
                "SELECT tx_hash, tx_hex FROM pending_transactions").fetchall()
            self._pending_cache = {
                row["tx_hash"]: tx_from_hex(row["tx_hex"], check_signatures=False)
                for row in rows
            }
            self._pending_stamp = stamp
        return self._pending_cache

    # ------------------------------------------------------ device index --

    def enable_device_index(self) -> None:
        """Mirror every UTXO-class table into a :class:`DeviceUtxoIndex`
        on this state's device, maintained by the UTXO write paths and
        rebuilt when a transaction rolls back.  Raises where the JAX
        package disables the index and carries on with SQL: without a
        card (unless the device is the CPU), or when the index cannot be
        built, a node that asked for it does not start."""
        self._dev_index = self._build_index()

    def _build_index(self) -> Dict[str, DeviceUtxoIndex]:
        """One index per UTXO-class table from the tables as this
        connection sees them (a restore's uncommitted rows included)."""
        device = resolve(self.device)
        index = {}
        for table in ("unspent_outputs",) + _GOV_TABLES:
            rows = self.db.execute(
                f"SELECT tx_hash, idx, amount, address FROM {table}"
            ).fetchall()
            index[table] = DeviceUtxoIndex(
                [(r["tx_hash"], r["idx"]) for r in rows],
                values=[(r["amount"], r["address"] or "", 0) for r in rows],
                device=device)
        return index

    def _index_add(self, table: str, outpoints, values=None) -> None:
        if self._dev_index is not None:
            self._dev_index[table].add(outpoints, values)

    def _index_remove(self, table: str, outpoints) -> None:
        if self._dev_index is not None:
            self._dev_index[table].remove(outpoints)

    def _index_rebuild(self) -> None:
        if self._dev_index is not None:
            self.enable_device_index()

    def resident_indexes(self) -> Optional[Dict[str, DeviceUtxoIndex]]:
        """The per-table index map when armed, else None: the accept
        path's gate for the fused resident scan (verify/block.py)."""
        return self._dev_index

    def index_stats(self) -> Optional[dict]:
        """The indexes' entries, resident bytes, probes, shadow consults
        and twin fingerprints summed over the tables; None when not
        armed.  What the node's ``utxo_index_*`` gauges on ``/metrics``
        read."""
        if not self._dev_index:
            return None
        agg = {"entries": 0, "resident_bytes": 0, "probes": 0,
               "shadow_consults": 0, "twin_fingerprints": 0}
        for index in self._dev_index.values():
            s = index.stats()
            for k in agg:
                agg[k] += s[k]
        return agg

    def close(self):
        self.db.close()

    @asynccontextmanager
    async def atomic(self):
        """One transaction around a whole block acceptance.  While it is
        open, the per-method ``_commit()`` calls inside are no-ops — a
        partial block must never become durable."""
        self._in_atomic = True
        try:
            self.db.execute("BEGIN")
            yield
            self.db.commit()
        except BaseException:
            self.db.rollback()
            self._amount_cache.clear()  # may hold rolled-back rows
            self._bump_fees_gen()
            self._index_rebuild()  # undo the index updates the txn made
            raise
        finally:
            self._in_atomic = False

    def _commit(self) -> None:
        if not getattr(self, "_in_atomic", False):
            self.db.commit()

    # ------------------------------------------------------------- blocks --

    async def add_block(self, block_id: int, block_hash: str, content: str,
                        address: str, nonce: int, difficulty, reward: int,
                        ts: int) -> None:
        self.db.execute(
            "INSERT INTO blocks (id, hash, content, address, random, difficulty,"
            " reward, timestamp) VALUES (?,?,?,?,?,?,?,?)",
            (block_id, block_hash, content, address, nonce, str(difficulty),
             reward, ts),
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
            "reward": Decimal(r["reward"]) / SMALLEST,
            "timestamp": r["timestamp"],
        }

    @staticmethod
    def _archive_block_dict(b: list) -> dict:
        """Canonical archive block row -> the same dict _block_dict
        builds from a hot row (difficulty is archived as str, reward as
        int smallest-units — identical to the hot column encodings)."""
        return {
            "id": b[0],
            "hash": b[1],
            "content": b[2],
            "address": b[3],
            "random": b[4],
            "difficulty": Decimal(b[5]),
            "reward": Decimal(b[6]) / SMALLEST,
            "timestamp": b[7],
        }

    async def get_block_by_id(self, block_id: int) -> Optional[dict]:
        r = self.db.execute("SELECT * FROM blocks WHERE id = ?", (block_id,)).fetchone()
        if r is None and self.archive is not None:
            b = await self.archive.block_by_height(block_id)
            return self._archive_block_dict(b) if b else None
        return self._block_dict(r) if r else None

    async def get_last_block(self) -> Optional[dict]:
        r = self.db.execute("SELECT * FROM blocks ORDER BY id DESC LIMIT 1").fetchone()
        return self._block_dict(r) if r else None

    async def get_block(self, block_hash: str) -> Optional[dict]:
        r = self.db.execute("SELECT * FROM blocks WHERE hash = ?", (block_hash,)).fetchone()
        if r is None and self.archive is not None:
            b = await self.archive.block_by_hash(block_hash)
            return self._archive_block_dict(b) if b else None
        return self._block_dict(r) if r else None

    async def get_next_block_id(self) -> int:
        r = self.db.execute("SELECT MAX(id) AS m FROM blocks").fetchone()
        return (r["m"] or 0) + 1

    async def get_blocks(self, offset: int, limit: int,
                         tx_details: bool = False,
                         size_capped: bool = False) -> List[dict]:
        """Blocks with embedded full transaction hexes, ordered by id
        (reference database.py:380-408's get_blocks).  One transactions
        query per 900-block chunk of the page, grouped host-side.
        ``tx_details`` swaps each hex for the explorer's decoded tx (a tx
        gone under a concurrent reorg is dropped).  ``size_capped``
        truncates the page once the accumulated hex passes 8 full
        blocks' worth (the HTTP layer passes it; the reference caps
        inside Database.get_blocks unconditionally).  With an archive
        attached, archived blocks are laid into the page where the hot
        rows have gaps."""
        rows = self.db.execute(
            "SELECT * FROM blocks WHERE id >= ? ORDER BY id LIMIT ?",
            (offset, limit),
        ).fetchall()
        by_hash: dict = {r["hash"]: [] for r in rows}
        hashes = list(by_hash)
        for lo in range(0, len(hashes), 900):
            chunk = hashes[lo:lo + 900]
            marks = ",".join("?" * len(chunk))
            for t in self.db.execute(
                    f"SELECT block_hash, tx_hash, tx_hex FROM transactions"
                    f" WHERE block_hash IN ({marks})", chunk):
                by_hash[t["block_hash"]].append((t["tx_hash"], t["tx_hex"]))
        entries = [(r["id"], self._block_dict(r), by_hash[r["hash"]])
                   for r in rows]
        if self.archive is not None:
            cov = await self.archive.coverage()
            if cov is not None and offset <= cov[1]:
                # the page reaches into the archived span: overlay
                # archived blocks (hot wins on overlap — same content
                # either way; witness blocks stay hot below the archive
                # horizon, so hot gaps can appear anywhere in the page)
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
        for _bid, block, txs in entries:
            size += sum(len(h) for _th, h in txs)
            if size_capped and size > MAX_BLOCK_SIZE_HEX * 8:
                break
            block["difficulty"] = float(block["difficulty"])
            block["reward"] = str(block["reward"])
            if tx_details:
                nice = [await self.get_nice_transaction(th) for th, _h in txs]
                tx_list = [t for t in nice if t is not None]
            else:
                tx_list = [h for _th, h in txs]
            out.append({"block": block, "transactions": tx_list})
        return out

    async def remove_blocks(self, from_block_id: int) -> None:
        """Reorg rollback: restore outputs spent by the removed blocks, drop
        the blocks and everything their transactions created
        (reference database.py:146-169), in one commit."""
        rows = self.db.execute(
            "SELECT t.tx_hex FROM transactions t JOIN blocks b ON t.block_hash = b.hash"
            " WHERE b.id >= ?", (from_block_id,),
        ).fetchall()
        txs = [tx_from_hex(r["tx_hex"], check_signatures=False) for r in rows]
        trace.event("reorg", from_block=from_block_id,
                    removed_txs=len(txs))
        # drop outputs created by removed txs (from whichever table)
        created = [tx.hash() for tx in txs]
        for table in ("unspent_outputs",) + _GOV_TABLES:
            self.db.executemany(
                f"DELETE FROM {table} WHERE tx_hash = ?", [(h,) for h in created]
            )
        # the index as a delta: the removed txs' outputs by class (spent
        # ones are absent, a no-op as the SQL DELETE), before the
        # restores below add back through the same hooks
        if self._dev_index is not None:
            doomed: Dict[str, list] = {}
            for tx in txs:
                h = tx.hash()
                for index, out in enumerate(tx.outputs):
                    doomed.setdefault(_OUTPUT_TABLE[out.output_type],
                                      []).append((h, index))
            for table, outpoints in doomed.items():
                self._index_remove(table, outpoints)
        # restore outputs their inputs had spent, but not outputs of txs
        # that are themselves being removed (reference database.py
        # remove_blocks filters `tx_input.tx_hash not in transactions_hashes`;
        # restoring those would leave orphaned UTXO rows after a reorg of
        # dependent txs and diverge the UTXO fingerprint)
        created_set = set(created)
        restore = [
            tx_input for tx in txs if not tx.is_coinbase
            for tx_input in tx.inputs if tx_input.tx_hash not in created_set
        ]
        await self._restore_spent_outputs(restore)
        self.db.executemany(
            "DELETE FROM transactions WHERE tx_hash = ?", [(h,) for h in created]
        )
        self.db.execute("DELETE FROM blocks WHERE id >= ?", (from_block_id,))
        self._amount_cache_drop(created)
        if self.reinject_reorg_txs:
            # txs the losing fork confirmed go back into the pending
            # journal (their spent outputs were just restored) so the
            # winning fork can mine them; skipped: txs that spend an
            # output of another removed tx, or conflict with the pending
            # overlay
            for tx in txs:
                if tx.is_coinbase or any(
                        i.tx_hash in created_set for i in tx.inputs):
                    continue
                await self._reinject_pending(tx)
        self._bump_fees_gen()
        self._pending_gen += 1
        self._commit()
        if self.on_blocks_removed is not None:
            self.on_blocks_removed(from_block_id)

    async def _reinject_pending(self, tx) -> bool:
        """INSERT-OR-IGNORE a reorged-out tx back into the journal.
        Returns True when the row (and its spent-output overlay rows)
        actually landed."""
        outpoints = [i.outpoint for i in tx.inputs]
        if await self.get_pending_spent_outpoints(outpoints):
            return False  # conflicts with a live pending tx
        try:
            inputs_addresses = [
                await self.resolve_output_address(i.tx_hash, i.index) or ""
                for i in tx.inputs
            ]
            fees = await self.tx_fees(tx)
        except (ValueError, KeyError, IndexError):
            return False  # source txs unresolvable after the rollback
        cur = self.db.execute(
            "INSERT OR IGNORE INTO pending_transactions (tx_hash, tx_hex,"
            " inputs_addresses, fees, propagation_time) VALUES (?,?,?,?,?)",
            (tx.hash(), tx.hex(), json.dumps(inputs_addresses), fees,
             now_ts()),
        )
        if cur.rowcount == 0:
            return False  # already pending
        self.db.executemany(
            "INSERT INTO pending_spent_outputs (tx_hash, idx) VALUES (?,?)",
            [(i.tx_hash, i.index) for i in tx.inputs],
        )
        trace.inc("mempool.reinjected")
        return True

    async def _restore_spent_outputs(self, inputs: List[TxInput]) -> None:
        """Re-materialize spent outputs by decoding their source txs
        (INSERT OR IGNORE: a whitelisted historical double-spend may
        restore one outpoint twice).  The index adds an outpoint only when
        its INSERT took a row, so it never runs a duplicate ahead of the
        table, and adds them in one splice per table at the end (the JAX
        package splices one at a time, a copy of the index per input)."""
        restored: Dict[str, list] = {}
        for tx_input in inputs:
            src = await self.get_transaction(tx_input.tx_hash, include_pending=False)
            if src is None:
                continue
            out = src.outputs[tx_input.index]
            table = _OUTPUT_TABLE[out.output_type]
            if table == "unspent_outputs":
                cur = self.db.execute(
                    "INSERT OR IGNORE INTO unspent_outputs (tx_hash, idx, address,"
                    " amount, is_stake) VALUES (?,?,?,?,?)",
                    (tx_input.tx_hash, tx_input.index, out.address, out.amount,
                     int(out.is_stake)),
                )
            else:
                cur = self.db.execute(
                    f"INSERT OR IGNORE INTO {table} (tx_hash, idx, address, amount)"
                    " VALUES (?,?,?,?)",
                    (tx_input.tx_hash, tx_input.index, out.address, out.amount),
                )
            if cur.rowcount > 0:
                restored.setdefault(table, []).append(
                    ((tx_input.tx_hash, tx_input.index),
                     (out.amount, out.address or "", 0)))
        for table, rows in restored.items():
            self._index_add(table, [o for o, _v in rows],
                            values=[v for _o, v in rows])

    # ------------------------------------------------------- transactions --

    async def add_transactions(self, txs: Sequence[AnyTx], block_hash: str) -> None:
        rows = []
        for tx in txs:
            inputs_addresses = [] if tx.is_coinbase else [
                await self.resolve_output_address(i.tx_hash, i.index) or ""
                for i in tx.inputs
            ]
            fees = 0 if tx.is_coinbase else await self.tx_fees(tx)
            rows.append((
                block_hash, tx.hash(), tx.hex(),
                json.dumps(inputs_addresses),
                json.dumps([o.address for o in tx.outputs]),
                json.dumps([o.amount for o in tx.outputs]),
                fees,
            ))
        self.db.executemany(
            "INSERT OR REPLACE INTO transactions (block_hash, tx_hash, tx_hex,"
            " inputs_addresses, outputs_addresses, outputs_amounts, fees)"
            " VALUES (?,?,?,?,?,?,?)", rows,
        )

    async def get_transaction(self, tx_hash: str,
                              include_pending: bool = False) -> Optional[AnyTx]:
        r = self.db.execute(
            "SELECT tx_hex FROM transactions WHERE tx_hash = ?", (tx_hash,)
        ).fetchone()
        if r is None and include_pending:
            r = self.db.execute(
                "SELECT tx_hex FROM pending_transactions WHERE tx_hash = ?",
                (tx_hash,),
            ).fetchone()
        if r is None and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                return tx_from_hex(hit[0][2], check_signatures=False)
        return tx_from_hex(r["tx_hex"], check_signatures=False) if r else None

    async def get_transaction_info(self, tx_hash: str) -> Optional[dict]:
        r = self.db.execute(
            "SELECT * FROM transactions WHERE tx_hash = ?", (tx_hash,)
        ).fetchone()
        if r is None:
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
        return {
            "block_hash": r["block_hash"],
            "tx_hash": r["tx_hash"],
            "tx_hex": r["tx_hex"],
            "inputs_addresses": json.loads(r["inputs_addresses"]),
            "outputs_addresses": json.loads(r["outputs_addresses"]),
            "outputs_amounts": json.loads(r["outputs_amounts"]),
            "fees": r["fees"],
        }

    async def resolve_output_address(self, tx_hash: str, index: int) -> Optional[str]:
        """AddressResolver for the codec's ambiguous-signature relink
        (core/tx.py tx_from_hex).  Memoized with the same
        content-addressed + dropped-on-tx-deletion discipline as
        :func:`get_output_amount` (shared cache, misses not cached)."""
        key = (tx_hash, -1 - index)  # distinct key space from amounts
        addr = self._amount_cache_get(key)
        if addr is not None:
            return addr
        r = self.db.execute(
            "SELECT outputs_addresses FROM transactions WHERE tx_hash = ?",
            (tx_hash,),
        ).fetchone()
        if r is None:
            r = self.db.execute(
                "SELECT tx_hex FROM pending_transactions WHERE tx_hash = ?",
                (tx_hash,),
            ).fetchone()
            if r is None:
                if self.archive is not None:
                    hit = await self.archive.tx_by_hash(tx_hash)
                    if hit is not None:
                        addresses = hit[0][4]
                        addr = (addresses[index]
                                if index < len(addresses) else None)
                        if addr is not None:
                            self._amount_cache_put(key, addr)
                        return addr
                return None
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            addr = (tx.outputs[index].address
                    if index < len(tx.outputs) else None)
        else:
            addresses = json.loads(r["outputs_addresses"])
            addr = addresses[index] if index < len(addresses) else None
        if addr is not None:
            self._amount_cache_put(key, addr)
        return addr

    async def get_output_amount(self, tx_hash: str, index: int) -> Optional[int]:
        # content-addressed (tx_hash = sha256(full tx hex), so a hash's
        # outputs can never change), but existence matters: tx_fees
        # returns 0 when the source tx is GONE, and that decision must
        # not depend on cache warmth (consensus-adjacent — it feeds the
        # coinbase miner_amount).  Every path that deletes txs drops the
        # affected entries.
        key = (tx_hash, index)
        amount = self._amount_cache_get(key)
        if amount is not None:
            return amount
        r = self.db.execute(
            "SELECT outputs_amounts FROM transactions WHERE tx_hash = ?",
            (tx_hash,),
        ).fetchone()
        if r is not None:
            amounts = json.loads(r["outputs_amounts"])
            amount = amounts[index] if index < len(amounts) else None
        else:
            r = self.db.execute(
                "SELECT tx_hex FROM pending_transactions WHERE tx_hash = ?",
                (tx_hash,),
            ).fetchone()
            if r is None:
                if self.archive is not None:
                    hit = await self.archive.tx_by_hash(tx_hash)
                    if hit is not None:
                        amounts = hit[0][5]
                        amount = (amounts[index]
                                  if index < len(amounts) else None)
                        if amount is not None:
                            self._amount_cache_put(key, amount)
                        return amount
                return None
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            amount = (tx.outputs[index].amount
                      if index < len(tx.outputs) else None)
        if amount is not None:
            self._amount_cache_put(key, amount)
        return amount

    async def get_block_transactions(self, block_hash: str,
                                     hex_only: bool = False) -> List:
        rows = self.db.execute(
            "SELECT tx_hex FROM transactions WHERE block_hash = ?", (block_hash,)
        ).fetchall()
        if not rows and self.archive is not None:
            # pruned blocks lose their ENTIRE tx set (never split), so
            # an empty hot read is the only case needing fallthrough
            atxs = await self.archive.txs_for_block(block_hash)
            if atxs:
                if hex_only:
                    return [t[2] for t in atxs]
                return [tx_from_hex(t[2], check_signatures=False)
                        for t in atxs]
        if hex_only:
            return [r["tx_hex"] for r in rows]
        return [tx_from_hex(r["tx_hex"], check_signatures=False) for r in rows]

    async def get_block_transaction_hashes(self, block_hash: str) -> List[str]:
        rows = self.db.execute(
            "SELECT tx_hash FROM transactions WHERE block_hash = ?",
            (block_hash,),
        ).fetchall()
        if not rows and self.archive is not None:
            atxs = await self.archive.txs_for_block(block_hash)
            if atxs:
                return [t[1] for t in atxs]
        return [r["tx_hash"] for r in rows]

    async def get_nice_transaction(self, tx_hash: str,
                                   address: Optional[str] = None) -> Optional[dict]:
        """Explorer-style decoded transaction (reference
        database.py:1606-1654), confirmed or pending.  Amounts are
        coin-denominated floats like the reference's JSON; with
        ``address``, ``delta`` is what the tx moved into (or out of) it."""
        r = self.db.execute(
            "SELECT t.*, b.id AS block_no, b.timestamp AS block_ts FROM"
            " transactions t JOIN blocks b ON b.hash = t.block_hash"
            " WHERE t.tx_hash = ?", (tx_hash,),
        ).fetchone()
        is_confirm = r is not None
        if r is None:
            r = self.db.execute(
                "SELECT tx_hash, tx_hex, inputs_addresses FROM"
                " pending_transactions WHERE tx_hash = ?", (tx_hash,),
            ).fetchone()
        if r is None and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                t, height = hit
                b = await self.archive.block_by_height(height)
                # a plain dict stands in for the sqlite Row (same keys;
                # inputs_addresses json-encoded like the hot column)
                r = {"tx_hash": t[1], "tx_hex": t[2],
                     "inputs_addresses": json.dumps(t[3]),
                     "block_hash": t[0], "block_no": height,
                     "block_ts": b[7] if b else None}
                is_confirm = True
        if r is None:
            return None
        keys = r.keys()
        tx = tx_from_hex(r["tx_hex"], check_signatures=False)
        inputs_addresses = json.loads(r["inputs_addresses"])

        def coins(amount: int) -> float:
            return float(Decimal(amount) / SMALLEST)

        def column(name):
            return r[name] if name in keys else None

        out = {"is_coinbase": tx.is_coinbase, "hash": r["tx_hash"],
               "block_hash": column("block_hash"),
               "block_no": column("block_no"),
               "datetime": column("block_ts")}
        if not tx.is_coinbase:
            delta = None
            if address is not None:
                delta = 0
                for i, tx_input in enumerate(tx.inputs):
                    if i < len(inputs_addresses) and inputs_addresses[i] == address:
                        amt = await self.get_output_amount(
                            tx_input.tx_hash, tx_input.index)
                        delta -= amt or 0
                delta += sum(o.amount for o in tx.outputs
                             if o.address == address)
                delta = coins(delta)
            inputs = []
            for i, tx_input in enumerate(tx.inputs):
                amt = await self.get_output_amount(tx_input.tx_hash,
                                                   tx_input.index)
                inputs.append({
                    "index": tx_input.index,
                    "tx_hash": tx_input.tx_hash,
                    "address": (inputs_addresses[i]
                                if i < len(inputs_addresses) else None),
                    "amount": coins(amt or 0),
                })
            out.update({
                "message": tx.message.hex() if tx.message is not None else None,
                "transaction_type": tx.transaction_type.name,
                "is_confirm": is_confirm,
                "inputs": inputs,
                "delta": delta,
                "fees": coins(await self.tx_fees(tx)),
            })
        out["outputs"] = [
            {"address": o.address, "amount": coins(o.amount),
             "type": o.output_type.name}
            for o in tx.outputs
        ]
        return out

    # ------------------------------------------------------------ mempool --

    async def add_pending_transaction(self, tx: Tx) -> int:
        """Insert one journal row; returns its journal sequence (the
        sqlite rowid): with no interleaved foreign writer, the stamp's
        MAX(rowid) after this call equals the returned value, which is
        what lets the mempool intake predict the stamp its own batch
        should produce (Mempool.reconcile)."""
        inputs_addresses = [
            await self.resolve_output_address(i.tx_hash, i.index) or ""
            for i in tx.inputs
        ]
        fees = await self.tx_fees(tx)
        cur = self.db.execute(
            "INSERT INTO pending_transactions (tx_hash, tx_hex, inputs_addresses,"
            " fees, propagation_time) VALUES (?,?,?,?,?)",
            (tx.hash(), tx.hex(), json.dumps(inputs_addresses), fees, now_ts()),
        )
        seq = cur.lastrowid
        self.db.executemany(
            "INSERT INTO pending_spent_outputs (tx_hash, idx) VALUES (?,?)",
            [(i.tx_hash, i.index) for i in tx.inputs],
        )
        self._commit()
        self._pending_gen += 1
        return seq

    async def pending_transaction_exists(self, tx_hash: str) -> bool:
        r = self.db.execute(
            "SELECT 1 FROM pending_transactions WHERE tx_hash = ?", (tx_hash,)
        ).fetchone()
        return r is not None

    async def get_pending_transactions_limit(
        self, limit_hex_chars: int = MAX_BLOCK_SIZE_HEX, hex_only: bool = False
    ) -> List:
        """Fee-rate-ordered mempool slice capped by total hex size
        (reference database.py:171-186 ORDER BY fees/LENGTH(tx_hex) DESC,
        cap MAX_BLOCK_SIZE_HEX), breaking at the first overflow."""
        rows = self.db.execute(
            "SELECT tx_hex FROM pending_transactions ORDER BY"
            " CAST(fees AS REAL)/LENGTH(tx_hex) DESC, tx_hash"
        ).fetchall()
        out, total = [], 0
        for r in rows:
            if total + len(r["tx_hex"]) > limit_hex_chars:
                break
            total += len(r["tx_hex"])
            out.append(r["tx_hex"])
        if hex_only:
            return out
        return [tx_from_hex(h, check_signatures=False) for h in out]

    async def get_pending_transactions_by_hash(self, hashes: List[str]) -> List[str]:
        """Chunked ``IN (...)`` lookups; found hexes come back in request
        order (push_block resolves up to a whole block's txs here)."""
        found: Dict[str, str] = {}
        for i in range(0, len(hashes), 500):
            chunk = hashes[i:i + 500]
            ph = ",".join("?" * len(chunk))
            for r in self.db.execute(
                    "SELECT tx_hash, tx_hex FROM pending_transactions"
                    f" WHERE tx_hash IN ({ph})", chunk):
                found[r["tx_hash"]] = r["tx_hex"]
        return [found[h] for h in hashes if h in found]

    async def get_pending_transactions_count(self) -> int:
        return self.db.execute(
            "SELECT COUNT(*) AS c FROM pending_transactions").fetchone()["c"]

    async def remove_pending_transactions(self) -> None:
        self.db.execute("DELETE FROM pending_transactions")
        self.db.execute("DELETE FROM pending_spent_outputs")
        self._amount_cache.clear()
        self._commit()
        self._pending_gen += 1

    # The pending_transactions table doubles as the mempool's write-behind
    # journal (mempool/): the in-memory pool is the read authority, this
    # table gives restart recovery and interop with other writers.  The
    # stamp is how the pool detects journal movement it did not make
    # itself: the (count, max rowid, local generation) triple that
    # _pending_decoded uses.

    async def pending_journal_stamp(self) -> tuple:
        """Cheap change detector for the mempool journal."""
        r = self.db.execute(
            "SELECT COUNT(*) AS c, COALESCE(MAX(rowid), 0) AS m"
            " FROM pending_transactions").fetchone()
        return (r["c"], r["m"], self._pending_gen)

    async def load_pending_journal(self) -> List[dict]:
        """Every journal row the pool needs to rebuild itself."""
        rows = self.db.execute(
            "SELECT tx_hash, tx_hex, fees FROM pending_transactions"
        ).fetchall()
        return [{"tx_hash": r["tx_hash"], "tx_hex": r["tx_hex"],
                 "fees": r["fees"]} for r in rows]

    async def get_need_propagate_transactions(self, older_than: int = 300) -> List[str]:
        """Journal txs last gossiped more than ``older_than`` seconds ago:
        the re-propagation queue (reference database.py:188-207)."""
        rows = self.db.execute(
            "SELECT tx_hex FROM pending_transactions WHERE propagation_time < ?",
            (now_ts() - older_than,),
        ).fetchall()
        return [r["tx_hex"] for r in rows]

    async def update_pending_transaction_propagation(self, tx_hash: str) -> None:
        self.db.execute(
            "UPDATE pending_transactions SET propagation_time = ? WHERE tx_hash = ?",
            (now_ts(), tx_hash),
        )
        self._commit()

    async def get_address_pending_transactions(self, address: str) -> List[Tx]:
        """Journal txs touching the address (an input's spender or an
        output's recipient)."""
        rows = self.db.execute(
            "SELECT tx_hex, inputs_addresses FROM pending_transactions"
        ).fetchall()
        out = []
        for r in rows:
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            if address in json.loads(r["inputs_addresses"]) or any(
                    o.address == address for o in tx.outputs):
                out.append(tx)
        return out

    async def get_address_pending_spent_outpoints(
            self, address: str) -> List[Tuple[str, int]]:
        """Outpoints of the address that journal txs spend."""
        rows = self.db.execute(
            "SELECT tx_hex, inputs_addresses FROM pending_transactions"
        ).fetchall()
        out = []
        for r in rows:
            addrs = json.loads(r["inputs_addresses"])
            tx = tx_from_hex(r["tx_hex"], check_signatures=False)
            for i, tx_input in enumerate(tx.inputs):
                if i < len(addrs) and addrs[i] == address:
                    out.append((tx_input.tx_hash, tx_input.index))
        return out

    async def get_pending_spent_outpoints(self, outpoints=None) -> set:
        """Pending-spent overlay; with ``outpoints`` only the matching
        subset is fetched (the reference's get_pending_spent_outputs
        filters the same way, database.py:126-133 caller)."""
        if outpoints is None:
            rows = self.db.execute(
                "SELECT tx_hash, idx FROM pending_spent_outputs").fetchall()
            return {(r["tx_hash"], r["idx"]) for r in rows}
        want = {tuple(o) for o in outpoints}
        if not want:
            return set()
        hashes = list({h for h, _ in want})
        marks = ",".join("?" * len(hashes))
        rows = self.db.execute(
            f"SELECT tx_hash, idx FROM pending_spent_outputs"
            f" WHERE tx_hash IN ({marks})", hashes).fetchall()
        return {(r["tx_hash"], r["idx"]) for r in rows} & want

    async def remove_pending_transactions_by_hash(self, hashes: List[str]) -> None:
        """Drop the accepted txs from the pending tables, in chunks: the
        spent-output overlay rows only ever exist alongside a live
        pending_transactions row, so one SELECT per chunk finds every tx
        whose overlay needs cleanup."""
        to_drop: List[str] = []
        for i in range(0, len(hashes), 500):
            chunk = hashes[i:i + 500]
            ph = ",".join("?" * len(chunk))
            rows = self.db.execute(
                "SELECT tx_hex FROM pending_transactions"
                f" WHERE tx_hash IN ({ph})", chunk).fetchall()
            spent = []
            for r in rows:
                tx = tx_from_hex(r["tx_hex"], check_signatures=False)
                if not tx.is_coinbase:
                    spent.extend((inp.tx_hash, inp.index) for inp in tx.inputs)
            if spent:
                self.db.executemany(
                    "DELETE FROM pending_spent_outputs"
                    " WHERE tx_hash = ? AND idx = ?", spent)
            self.db.execute(
                f"DELETE FROM pending_transactions WHERE tx_hash IN ({ph})",
                chunk)
            confirmed = {r["tx_hash"] for r in self.db.execute(
                f"SELECT tx_hash FROM transactions WHERE tx_hash IN ({ph})",
                chunk).fetchall()}
            to_drop.extend(h for h in chunk if h not in confirmed)
        self._amount_cache_drop(to_drop)
        self._commit()
        self._pending_gen += 1

    # --------------------------------------------------------------- UTXO --

    async def add_transaction_outputs(self, txs: Sequence[AnyTx]) -> None:
        """Route every output into its UTXO-class table
        (reference database.py:524-580), one executemany per table."""
        by_table: Dict[str, list] = {}
        for tx in txs:
            h = tx.hash()
            for index, out in enumerate(tx.outputs):
                table = _OUTPUT_TABLE[out.output_type]
                by_table.setdefault(table, []).append((h, index, out))
        for table, entries in by_table.items():
            if table == "unspent_outputs":
                self.db.executemany(
                    "INSERT OR REPLACE INTO unspent_outputs (tx_hash, idx,"
                    " address, amount, is_stake) VALUES (?,?,?,?,?)",
                    [(h, i, o.address, o.amount, int(o.is_stake))
                     for h, i, o in entries],
                )
            else:
                self.db.executemany(
                    f"INSERT OR REPLACE INTO {table} (tx_hash, idx, address,"
                    " amount) VALUES (?,?,?,?)",
                    [(h, i, o.address, o.amount) for h, i, o in entries],
                )
            self._index_add(table, [(h, i) for h, i, _ in entries],
                            values=[(o.amount, o.address or "", 0)
                                    for _h, _i, o in entries])

    async def remove_outputs(self, txs: Sequence[AnyTx]) -> None:
        """Spend inputs from the table their tx type targets
        (reference database.py:589-622), one DELETE executemany per
        UTXO class."""
        by_table: Dict[str, list] = {}
        for tx in txs:
            if tx.is_coinbase:
                continue
            table = _INPUT_TABLE.get(tx.transaction_type, "unspent_outputs")
            by_table.setdefault(table, []).extend(
                (i.tx_hash, i.index) for i in tx.inputs)
        for table, outpoints in by_table.items():
            self.db.executemany(
                f"DELETE FROM {table} WHERE tx_hash = ? AND idx = ?",
                outpoints,
            )
            self._index_remove(table, outpoints)

    async def outpoints_exist(self, outpoints: List[Tuple[str, int]],
                              table: str = "unspent_outputs") -> List[bool]:
        """Batched membership test.  With the resident index armed, one
        exact ``contains_batch`` probe; otherwise one row-value IN query
        per 400 outpoints instead of a query per outpoint — an 8k-input
        block is ~20 queries.  (The reference does a set-diff against a
        full-column fetch, manager.py:531-615.)"""
        if not outpoints:
            return []
        if self._dev_index is not None and table in self._dev_index:
            present = self._dev_index[table].contains_batch(
                [tuple(o) for o in outpoints])
            return [bool(p) for p in present]
        found: set = set()
        CHUNK = 400
        for off in range(0, len(outpoints), CHUNK):
            chunk = outpoints[off:off + CHUNK]
            placeholders = ",".join(["(?,?)"] * len(chunk))
            params = [v for o in chunk for v in o]
            rows = self.db.execute(
                f"SELECT tx_hash, idx FROM {table} WHERE (tx_hash, idx)"
                f" IN (VALUES {placeholders})", params,
            ).fetchall()
            found.update((r["tx_hash"], r["idx"]) for r in rows)
        return [tuple(o) in found for o in outpoints]

    async def get_unspent_outpoints(self, table: str = "unspent_outputs") -> set:
        rows = self.db.execute(f"SELECT tx_hash, idx FROM {table}").fetchall()
        return {(r["tx_hash"], r["idx"]) for r in rows}

    async def get_table_outpoints_hash(self, table: str) -> str:
        import hashlib

        rows = self.db.execute(
            f"SELECT tx_hash, idx FROM {table} ORDER BY tx_hash, idx"
        ).fetchall()
        h = hashlib.sha256()
        for r in rows:
            h.update(f"{r['tx_hash']}{r['idx']}".encode())
        return h.hexdigest()

    # ------------------------------------------------------ address views --

    async def _pending_filter(self, rows, check_pending_txs: bool) -> set:
        """Pending-spent overlay narrowed to these rows' outpoints; above
        256 rows one full-overlay fetch is cheaper (and bounds the
        IN-clause parameter count)."""
        if not check_pending_txs or not rows:
            return set()
        if len(rows) > 256:
            return await self.get_pending_spent_outpoints()
        return await self.get_pending_spent_outpoints(
            [(r["tx_hash"], r["idx"]) for r in rows])

    async def _outputs(self, address: str, is_stake: int,
                       check_pending_txs: bool) -> List[TxInput]:
        rows = self.db.execute(
            "SELECT tx_hash, idx, amount FROM unspent_outputs"
            " WHERE address = ? AND is_stake = ?", (address, is_stake),
        ).fetchall()
        pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["idx"]) in pending:
                continue
            i = TxInput(r["tx_hash"], r["idx"])
            i.amount = r["amount"]
            out.append(i)
        return out

    async def get_spendable_outputs(self, address: str,
                                    check_pending_txs: bool = False) -> List[TxInput]:
        """REGULAR/UN_STAKE outputs owned by the address, minus anything in
        the pending-spent overlay when requested."""
        return await self._outputs(address, 0, check_pending_txs)

    async def get_stake_outputs(self, address: str,
                                check_pending_txs: bool = False) -> List[TxInput]:
        return await self._outputs(address, 1, check_pending_txs)

    async def get_address_transactions(self, address: str, limit: int = 50,
                                       offset: int = 0) -> List[dict]:
        """Confirmed txs naming the address, newest block first."""
        if self.archive is None:
            rows = self.db.execute(
                "SELECT t.*, b.id AS block_id, b.timestamp AS block_ts FROM transactions t"
                " JOIN blocks b ON b.hash = t.block_hash"
                " WHERE t.inputs_addresses LIKE ? OR t.outputs_addresses LIKE ?"
                " ORDER BY b.id DESC LIMIT ? OFFSET ?",
                (f'%"{address}"%', f'%"{address}"%', limit, offset),
            ).fetchall()
            return [dict(r) for r in rows]
        # archived history has to be merged in before paginating: fetch
        # the hot prefix deep enough to cover the requested page, then
        # overlay archive matches (dedup by tx_hash — witness txs below
        # the archive horizon exist in both tiers) and re-slice.  Any
        # hot row beyond the prefix sorts after >= offset+limit rows,
        # so it can never land inside the page.
        rows = self.db.execute(
            "SELECT t.*, b.id AS block_id, b.timestamp AS block_ts FROM transactions t"
            " JOIN blocks b ON b.hash = t.block_hash"
            " WHERE t.inputs_addresses LIKE ? OR t.outputs_addresses LIKE ?"
            " ORDER BY b.id DESC LIMIT ?",
            (f'%"{address}"%', f'%"{address}"%', offset + limit),
        ).fetchall()
        merged = [dict(r) for r in rows]
        seen = {r["tx_hash"] for r in merged}
        for b, t in await self.archive.address_history(address):
            if t[1] in seen:
                continue
            merged.append({
                "block_hash": t[0], "tx_hash": t[1], "tx_hex": t[2],
                "inputs_addresses": json.dumps(t[3]),
                "outputs_addresses": json.dumps(t[4]),
                "outputs_amounts": json.dumps(t[5]), "fees": t[6],
                "block_id": b[0], "block_ts": b[7],
            })
        merged.sort(key=lambda r: -r["block_id"])
        return merged[offset:offset + limit]

    async def get_outputs_by_address(self, table: str, address: str,
                                     check_pending_txs: bool = False,
                                     is_stake: Optional[bool] = None) -> List[dict]:
        """One UTXO-class table's outputs of the address as {tx_hash,
        index, amount} rows (the address-info sections)."""
        sql = f"SELECT tx_hash, idx, amount FROM {table} WHERE address = ?"
        params: list = [address]
        if is_stake is not None and table == "unspent_outputs":
            sql += " AND is_stake = ?"
            params.append(int(is_stake))
        rows = self.db.execute(sql, params).fetchall()
        pending = await self._pending_filter(rows, check_pending_txs)
        return [
            {"tx_hash": r["tx_hash"], "index": r["idx"], "amount": r["amount"]}
            for r in rows if (r["tx_hash"], r["idx"]) not in pending
        ]

    # --------------------------------------------------------- governance --

    async def get_registered(self, table: str,
                             check_pending_txs: bool = False,
                             pending: Optional[set] = None) -> List[Tuple[str, int]]:
        """(address, registered_at block timestamp) per registration output."""
        rows = self.db.execute(
            f"SELECT g.tx_hash, g.idx, g.address FROM {table} g").fetchall()
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["idx"]) in pending:
                continue
            ts = await self.get_transaction_block_timestamp(r["tx_hash"])
            out.append((r["address"], ts if ts is not None else now_ts()))
        return out

    async def _all_ballot_rows(self, table: str,
                               check_pending_txs: bool = False,
                               pending: Optional[set] = None) -> List[dict]:
        """Every standing ballot row with its voter resolved, in one
        join.  A ballot row is a vote *output*: its address column holds
        the vote RECIPIENT; the VOTER is the vote transaction's
        ``inputs_addresses[output_index]`` (reference database.py:939-1063)
        and the vote count is the output's amount."""
        rows = self.db.execute(
            f"SELECT g.tx_hash, g.idx, g.address AS recipient, g.amount,"
            f" t.inputs_addresses FROM {table} g"
            f" JOIN transactions t ON t.tx_hash = g.tx_hash"
        ).fetchall()
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["idx"]) in pending:
                continue
            addrs = json.loads(r["inputs_addresses"])
            voter = addrs[r["idx"]] if r["idx"] < len(addrs) else None
            out.append({
                "tx_hash": r["tx_hash"], "index": r["idx"],
                "recipient": r["recipient"], "voter": voter,
                "vote": Decimal(r["amount"]) / SMALLEST,
            })
        return out

    async def get_transaction_block_timestamp(self, tx_hash: str) -> Optional[int]:
        r = self.db.execute(
            "SELECT b.timestamp AS ts FROM transactions t JOIN blocks b ON"
            " b.hash = t.block_hash WHERE t.tx_hash = ?", (tx_hash,),
        ).fetchone()
        if r is None and self.archive is not None:
            hit = await self.archive.tx_by_hash(tx_hash)
            if hit is not None:
                b = await self.archive.block_by_height(hit[1])
                return b[7] if b else None
        return r["ts"] if r else None

    async def _table_outpoints(self, table: str, address: str,
                               check_pending_txs: bool) -> List[Tuple[str, int]]:
        rows = self.db.execute(
            f"SELECT tx_hash, idx FROM {table} WHERE address = ?", (address,),
        ).fetchall()
        pending = await self._pending_filter(rows, check_pending_txs)
        return [(r["tx_hash"], r["idx"]) for r in rows
                if (r["tx_hash"], r["idx"]) not in pending]

    async def get_delegates_voting_power(self, address: str,
                                         check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        return await self._table_outpoints(
            "delegates_voting_power", address, check_pending_txs)

    async def get_validators_voting_power(self, address: str,
                                          check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        """Unspent VALIDATOR_VOTING_POWER outputs owned by the address."""
        return await self._table_outpoints(
            "validators_voting_power", address, check_pending_txs)

    async def get_inode_registration_outputs(self, address: str,
                                             check_pending_txs: bool = False) -> List[Tuple[str, int]]:
        return await self._table_outpoints(
            "inode_registration_output", address, check_pending_txs)

    async def get_multiple_address_stakes(
            self, addresses: Iterable[str],
            check_pending_txs: bool = False,
            pending: Optional[set] = None) -> Dict[str, Decimal]:
        """Batch stake query (reference database.py:1208-1290): one pass over
        unspent stake outputs + one pass over the mempool for all addresses."""
        addresses = list(set(addresses))
        if not addresses:
            return {}
        out: Dict[str, Decimal] = {a: Decimal(0) for a in addresses}
        placeholders = ",".join("?" * len(addresses))
        rows = self.db.execute(
            f"SELECT tx_hash, idx, address, amount FROM unspent_outputs"
            f" WHERE is_stake = 1 AND address IN ({placeholders})", addresses,
        ).fetchall()
        if pending is None:
            pending = await self._pending_filter(rows, check_pending_txs)
        for r in rows:
            if (r["tx_hash"], r["idx"]) in pending:
                continue
            out[r["address"]] += Decimal(r["amount"]) / SMALLEST
        if check_pending_txs:
            want = set(addresses)
            for tx in (await self._pending_decoded()).values():
                for o in tx.outputs:
                    if o.is_stake and o.address in want:
                        out[o.address] += Decimal(o.amount) / SMALLEST
        return out

    def _voter(self, info: Optional[dict], idx: int) -> Optional[str]:
        """A ballot row's voter: its vote tx's ``inputs_addresses[idx]``."""
        if info is not None and idx < len(info["inputs_addresses"]):
            return info["inputs_addresses"][idx]
        return None

    async def get_ballot_by_recipient(self, table: str, recipient: str,
                                      check_pending_txs: bool = False) -> List[dict]:
        """Standing votes FOR ``recipient`` (a ballot row's address is
        the recipient, reference database.py:939-1063), each with its
        voter and vote count."""
        rows = self.db.execute(
            f"SELECT g.tx_hash, g.idx, g.amount FROM {table} g WHERE g.address = ?",
            (recipient,),
        ).fetchall()
        pending = await self._pending_filter(rows, check_pending_txs)
        out = []
        for r in rows:
            if (r["tx_hash"], r["idx"]) in pending:
                continue
            info = await self.get_transaction_info(r["tx_hash"])
            out.append({
                "tx_hash": r["tx_hash"], "index": r["idx"],
                "voter": self._voter(info, r["idx"]),
                "vote": Decimal(r["amount"]) / SMALLEST,
            })
        return out

    async def get_ballots(self, table: str, recipient: Optional[str] = None,
                          offset: int = 0, limit: int = 100) -> List[dict]:
        """A page of a ballot table for the validators and delegates info
        routes (reference get_inode_ballot / get_validator_ballot): rows
        of {tx_hash, index, voter, recipient, vote}."""
        if recipient is not None:
            rows = self.db.execute(
                f"SELECT tx_hash, idx, address, amount FROM {table}"
                f" WHERE address = ? LIMIT ? OFFSET ?",
                (recipient, limit, offset),
            ).fetchall()
        else:
            rows = self.db.execute(
                f"SELECT tx_hash, idx, address, amount FROM {table}"
                f" LIMIT ? OFFSET ?", (limit, offset),
            ).fetchall()
        out = []
        for r in rows:
            info = await self.get_transaction_info(r["tx_hash"])
            out.append({
                "tx_hash": r["tx_hash"], "index": r["idx"],
                "voter": self._voter(info, r["idx"]),
                "recipient": r["address"],
                "vote": Decimal(r["amount"]) / SMALLEST,
            })
        return out

    # ----------------------------------------------------------- rebuild --

    async def rebuild_utxos(self) -> None:
        """Full-chain replay of every output table from the transactions log
        (reference create_unspent_outputs.py + database.py:846-862) — the
        consensus-bug detector: any divergence from live tables is a bug."""
        for table in ("unspent_outputs",) + _GOV_TABLES:
            self.db.execute(f"DELETE FROM {table}")
        rows = self.db.execute(
            "SELECT t.tx_hex FROM transactions t JOIN blocks b ON"
            " b.hash = t.block_hash ORDER BY b.id"
        ).fetchall()
        txs = [tx_from_hex(r["tx_hex"], check_signatures=False) for r in rows]
        for tx in txs:
            await self.add_transaction_outputs([tx])
            await self.remove_outputs([tx])
        self._commit()
        self._index_rebuild()  # replay rewrote the tables wholesale

    # ---------------------------------------------------------- snapshots --
    # Canonical positional row shapes shared with the pg backend (the
    # snapshot payload is backend-neutral, docs/SNAPSHOT.md):
    #   unspent_outputs  [tx_hash, idx, address|null, amount, is_stake]
    #   governance       [tx_hash, idx, address|null, amount]
    #   tx               [block_hash, tx_hash, tx_hex, inputs_addresses,
    #                     outputs_addresses, outputs_amounts, fees]
    #   block            [id, hash, content, address, random,
    #                     str(difficulty), reward, timestamp]
    # Amounts/fees/rewards are int smallest-units everywhere; lists are
    # real JSON arrays (this backend stores them json-encoded).

    async def export_snapshot_rows(self, table: str) -> List[list]:
        if table not in ("unspent_outputs",) + _GOV_TABLES:
            raise ValueError(f"not a snapshot table: {table}")
        if table == "unspent_outputs":
            rows = self.db.execute(
                "SELECT tx_hash, idx, address, amount, is_stake FROM"
                " unspent_outputs ORDER BY tx_hash, idx").fetchall()
            return [[r["tx_hash"], r["idx"], r["address"], r["amount"],
                     r["is_stake"]] for r in rows]
        rows = self.db.execute(
            f"SELECT tx_hash, idx, address, amount FROM {table}"
            " ORDER BY tx_hash, idx").fetchall()
        return [[r["tx_hash"], r["idx"], r["address"], r["amount"]]
                for r in rows]

    async def export_snapshot_txs(self, tail: int) -> List[list]:
        """Witness transactions: every tx still referenced by an
        exported outpoint (the pg schema resolves amounts through — and
        foreign-keys onto — the transactions table, so UTXO rows alone
        cannot restore there) plus all txs of the carried block tail."""
        union = " UNION ".join(
            f"SELECT tx_hash FROM {t}"
            for t in ("unspent_outputs",) + _GOV_TABLES)
        rows = self.db.execute(
            "SELECT block_hash, tx_hash, tx_hex, inputs_addresses,"
            " outputs_addresses, outputs_amounts, fees FROM transactions"
            f" WHERE tx_hash IN ({union}) OR block_hash IN"
            " (SELECT hash FROM blocks ORDER BY id DESC LIMIT ?)"
            " ORDER BY tx_hash", (tail,)).fetchall()
        return [[r["block_hash"], r["tx_hash"], r["tx_hex"],
                 json.loads(r["inputs_addresses"]),
                 json.loads(r["outputs_addresses"]),
                 json.loads(r["outputs_amounts"]), r["fees"]] for r in rows]

    async def export_snapshot_blocks(self, tail: int) -> List[list]:
        rows = self.db.execute(
            "SELECT id, hash, content, address, random, difficulty,"
            " reward, timestamp FROM blocks ORDER BY id DESC LIMIT ?",
            (tail,)).fetchall()
        return [[r["id"], r["hash"], r["content"], r["address"],
                 r["random"], str(r["difficulty"]), r["reward"],
                 r["timestamp"]] for r in reversed(rows)]

    async def restore_snapshot(self, tables: Dict[str, List[list]],
                               txs: List[list], blocks: List[list]) -> None:
        """Wholesale replace of chain state with verified snapshot rows.
        Callers verify every chunk hash AND the recomputed UTXO
        fingerprint against the manifest BEFORE calling.  One
        transaction, and an armed resident index is rebuilt on its
        device inside it: a crash, or an index that cannot arm
        (:class:`IndexRearmError`), leaves the previous tables and index
        intact."""
        for name in tables:
            if name not in ("unspent_outputs",) + _GOV_TABLES:
                raise ValueError(f"not a snapshot table: {name}")
        old_index = self._dev_index
        self.db.execute("BEGIN")
        try:
            for table in ("unspent_outputs",) + _GOV_TABLES:
                self.db.execute(f"DELETE FROM {table}")
            for table in ("pending_spent_outputs", "pending_transactions",
                          "transactions", "blocks"):
                self.db.execute(f"DELETE FROM {table}")
            self.db.executemany(
                "INSERT INTO blocks (id, hash, content, address, random,"
                " difficulty, reward, timestamp) VALUES (?,?,?,?,?,?,?,?)",
                [tuple(r) for r in blocks])
            self.db.executemany(
                "INSERT INTO transactions (block_hash, tx_hash, tx_hex,"
                " inputs_addresses, outputs_addresses, outputs_amounts,"
                " fees) VALUES (?,?,?,?,?,?,?)",
                [(r[0], r[1], r[2], json.dumps(r[3]), json.dumps(r[4]),
                  json.dumps(r[5]), r[6]) for r in txs])
            self.db.executemany(
                "INSERT INTO unspent_outputs (tx_hash, idx, address,"
                " amount, is_stake) VALUES (?,?,?,?,?)",
                [tuple(r) for r in tables.get("unspent_outputs", [])])
            for table in _GOV_TABLES:
                self.db.executemany(
                    f"INSERT INTO {table} (tx_hash, idx, address, amount)"
                    " VALUES (?,?,?,?)",
                    [tuple(r) for r in tables.get(table, [])])
            if old_index is not None:
                try:
                    self._dev_index = self._build_index()
                except Exception as e:
                    raise IndexRearmError(
                        f"resident index not rebuilt after the restore:"
                        f" {type(e).__name__}: {e}") from e
            self.db.commit()
        except BaseException:
            self.db.rollback()
            self._dev_index = old_index
            raise
        self._amount_cache.clear()
        self._bump_fees_gen()

    # ------------------------------------------------------------- archive --
    # Compactor seam (archive/compactor.py, docs/ARCHIVE.md).  Export
    # gives the canonical positional row shapes of the snapshot payload;
    # prune evaluates the witness closure live, at delete time, so
    # re-running after a crash is an idempotent no-op for already-pruned
    # rows.  A prune deletes block and transaction rows only, never a
    # UTXO-class row, so an armed resident index does not move.

    async def archive_export_span(self, lo: int, hi: int):
        """Canonical rows for heights [lo, hi]: (block rows ascending,
        {block_hash: [tx rows in acceptance order]})."""
        rows = self.db.execute(
            "SELECT id, hash, content, address, random, difficulty,"
            " reward, timestamp FROM blocks WHERE id BETWEEN ? AND ?"
            " ORDER BY id", (lo, hi)).fetchall()
        blocks = [[r["id"], r["hash"], r["content"], r["address"],
                   r["random"], str(r["difficulty"]), r["reward"],
                   r["timestamp"]] for r in rows]
        txs_by_block: Dict[str, list] = {}
        hashes = [b[1] for b in blocks]
        for i in range(0, len(hashes), 900):
            chunk = hashes[i:i + 900]
            marks = ",".join("?" * len(chunk))
            for t in self.db.execute(
                    "SELECT block_hash, tx_hash, tx_hex,"
                    " inputs_addresses, outputs_addresses,"
                    " outputs_amounts, fees FROM transactions WHERE"
                    f" block_hash IN ({marks}) ORDER BY rowid", chunk):
                txs_by_block.setdefault(t["block_hash"], []).append(
                    [t["block_hash"], t["tx_hash"], t["tx_hex"],
                     json.loads(t["inputs_addresses"]),
                     json.loads(t["outputs_addresses"]),
                     json.loads(t["outputs_amounts"]), t["fees"]])
        return blocks, txs_by_block

    async def archive_prune_span(self, lo: int, hi: int) -> dict:
        """Delete hot blocks in [lo, hi] whose ENTIRE tx set is outside
        the snapshot witness closure, plus those blocks' txs.  A block
        with even one witness tx keeps ALL its rows hot, so a block's
        txs are never split across the hot/archive seam and every hot
        join stays intact."""
        union = " UNION ".join(
            f"SELECT tx_hash FROM {t}"
            for t in ("unspent_outputs",) + _GOV_TABLES)
        doomed = [r["hash"] for r in self.db.execute(
            "SELECT hash FROM blocks b WHERE b.id BETWEEN ? AND ?"
            " AND NOT EXISTS (SELECT 1 FROM transactions t WHERE"
            f" t.block_hash = b.hash AND t.tx_hash IN ({union}))",
            (lo, hi)).fetchall()]
        tx_hashes: List[str] = []
        for i in range(0, len(doomed), 900):
            chunk = doomed[i:i + 900]
            marks = ",".join("?" * len(chunk))
            tx_hashes.extend(r["tx_hash"] for r in self.db.execute(
                "SELECT tx_hash FROM transactions WHERE block_hash IN"
                f" ({marks})", chunk))
            self.db.execute(
                f"DELETE FROM transactions WHERE block_hash IN ({marks})",
                chunk)
            self.db.execute(
                f"DELETE FROM blocks WHERE hash IN ({marks})", chunk)
        self._amount_cache_drop(tx_hashes)
        self._commit()
        return {"blocks": len(doomed), "txs": len(tx_hashes)}

    async def archive_hot_row_counts(self) -> dict:
        b = self.db.execute(
            "SELECT COUNT(*) AS n FROM blocks").fetchone()["n"]
        t = self.db.execute(
            "SELECT COUNT(*) AS n FROM transactions").fetchone()["n"]
        return {"blocks": b, "txs": t}
