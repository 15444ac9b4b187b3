"""In-memory fee-priority transaction pool (the port's copy of the JAX
package's ``mempool/pool.py``).

The pool is the in-process authority for pending transactions.  Its
ordering reproduces the reference query exactly (database.py:171-186,
mirrored by ``ChainState.get_pending_transactions_limit``)::

    ORDER BY CAST(fees AS REAL) / LENGTH(tx_hex) DESC, tx_hash

Python's ``int / int`` is the same IEEE-754 double division sqlite's
``CAST .. AS REAL`` performs, so the in-memory key ``(-fees/len(hex),
tx_hash)`` sorts bit-identically to the SQL — pinned by the
differential tests in tests/test_mempool.py (JAX package) and
tests/test_torch_mempool.py (this copy against it).

The SQL ``pending_transactions`` table remains as a write-behind
journal: accepted txs are written through to it (restart durability),
but reads on the hot path come from here.  :meth:`Mempool.sync`
reconciles pool against journal by stamp — cheap when nothing changed
(one COUNT/MAX query), incremental when another writer (the wallet
CLI's direct insert, block acceptance, reorg re-injection) moved it.
"""

from __future__ import annotations

import logging
import time
from bisect import bisect_left, insort
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .. import trace
from ..core.tx import Tx, tx_from_hex

log = logging.getLogger("upow_tpu_torch.mempool")

Outpoint = Tuple[str, int]


@dataclass
class MempoolEntry:
    tx_hash: str
    tx_hex: str
    fees: int
    outpoints: Tuple[Outpoint, ...] = ()
    tx: Optional[Tx] = None          # parsed form when the caller has it
    added_mono: float = field(default_factory=time.monotonic)

    @property
    def fee_rate(self) -> float:
        return self.fees / len(self.tx_hex)

    @property
    def sort_key(self) -> tuple:
        # ascending sort == reference "rate DESC, tx_hash ASC"
        return (-self.fee_rate, self.tx_hash)

    @property
    def size_hex(self) -> int:
        return len(self.tx_hex)

    @classmethod
    def from_row(cls, tx_hash: str, tx_hex: str, fees: int) -> "MempoolEntry":
        """Entry from a journal row (recovery / external-writer sync)."""
        tx = tx_from_hex(tx_hex, check_signatures=False)
        outpoints = () if tx.is_coinbase else tuple(
            i.outpoint for i in tx.inputs)
        return cls(tx_hash=tx_hash, tx_hex=tx_hex, fees=fees,
                   outpoints=outpoints, tx=tx)


class Mempool:
    """Fee-rate priority pool + outpoint conflict map + byte cap + TTL.

    Pure data structure apart from :meth:`sync` (which reads the
    journal through a ChainState).  Every content mutation bumps
    :attr:`generation` — the mining-info cache key (template.py), so an
    idle miner polling an unchanged pool costs a dict lookup, not a
    re-sort/re-hash/re-merkle of the whole pending set.
    """

    def __init__(self, max_bytes_hex: int = 64 * 1024 * 1024,
                 tx_ttl: float = 0.0, allow_rbf: bool = False):
        self.max_bytes_hex = max_bytes_hex
        self.tx_ttl = tx_ttl
        self.allow_rbf = allow_rbf
        self.generation = 0
        self._entries: Dict[str, MempoolEntry] = {}
        self._order: List[tuple] = []           # sorted entry sort_keys
        self._spends: Dict[Outpoint, str] = {}  # outpoint -> tx_hash
        self._bytes = 0
        self._journal_stamp: Optional[tuple] = None

    # ------------------------------------------------------------ reads ---

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, tx_hash: str) -> bool:
        return tx_hash in self._entries

    def get(self, tx_hash: str) -> Optional[MempoolEntry]:
        return self._entries.get(tx_hash)

    def spender_of(self, outpoint: Outpoint) -> Optional[str]:
        """tx_hash of the pooled tx spending this outpoint, if any."""
        return self._spends.get(tuple(outpoint))

    @property
    def total_bytes_hex(self) -> int:
        return self._bytes

    @property
    def journal_stamp(self) -> Optional[tuple]:
        """Last reconciled journal stamp (None before the first sync)."""
        return self._journal_stamp

    def ordered(self) -> List[MempoolEntry]:
        """Entries in reference priority order (rate DESC, hash ASC)."""
        return [self._entries[key[1]] for key in self._order]

    def select_hex(self, limit_hex_chars: int) -> List[str]:
        """Reference-exact capped slice: walk priority order, stop at
        the FIRST tx that would overflow the byte budget (the reference
        breaks rather than skips, database.py:171-186)."""
        out, total = [], 0
        for key in self._order:
            tx_hex = self._entries[key[1]].tx_hex
            if total + len(tx_hex) > limit_hex_chars:
                break
            total += len(tx_hex)
            out.append(tx_hex)
        return out

    # ------------------------------------------------------- mutations ----

    def add(self, entry: MempoolEntry) -> str:
        """Insert; returns ``added`` | ``duplicate`` | ``conflict`` |
        ``replaced``.

        A conflict (an outpoint already claimed by a pooled tx) is
        rejected unless RBF is enabled AND the newcomer pays a strictly
        higher fee rate than the worst of the txs it conflicts with, in
        which case every one of them is evicted first.  The intake's
        rule checks refuse a conflicting ``push_tx`` before it reaches
        the pool, so the wire behaviour stays the reference reject; the
        reader RBF serves is :meth:`sync` of the journal (a wallet CLI's
        direct insert of a higher-fee spend of a pooled outpoint).
        """
        if entry.tx_hash in self._entries:
            return "duplicate"
        losers = []
        for op in entry.outpoints:
            holder = self._spends.get(op)
            if holder is not None and holder != entry.tx_hash:
                losers.append(holder)
        if losers:
            if not self.allow_rbf:
                return "conflict"
            worst = min(self._entries[h].fee_rate for h in losers)
            if entry.fee_rate <= worst:
                return "conflict"
            for h in dict.fromkeys(losers):
                self._remove_one(h)
            trace.inc("mempool.rbf", len(set(losers)))
        self._entries[entry.tx_hash] = entry
        insort(self._order, entry.sort_key)
        for op in entry.outpoints:
            self._spends[op] = entry.tx_hash
        self._bytes += entry.size_hex
        self.generation += 1
        return "replaced" if losers else "added"

    def _remove_one(self, tx_hash: str) -> Optional[MempoolEntry]:
        entry = self._entries.pop(tx_hash, None)
        if entry is None:
            return None
        i = bisect_left(self._order, entry.sort_key)
        if i < len(self._order) and self._order[i] == entry.sort_key:
            del self._order[i]
        for op in entry.outpoints:
            if self._spends.get(op) == tx_hash:
                del self._spends[op]
        self._bytes -= entry.size_hex
        self.generation += 1
        return entry

    def remove(self, tx_hashes: Iterable[str]) -> List[MempoolEntry]:
        """Drop entries (block acceptance, GC); missing hashes ignored."""
        removed = []
        for h in tx_hashes:
            entry = self._remove_one(h)
            if entry is not None:
                removed.append(entry)
        return removed

    def clear(self) -> None:
        self._entries.clear()
        self._order.clear()
        self._spends.clear()
        self._bytes = 0
        self.generation += 1

    def expire(self, now_mono: Optional[float] = None) -> List[str]:
        """Evict entries older than ``tx_ttl`` (monotonic age — TTL is
        operational policy, not consensus time)."""
        if not self.tx_ttl:
            return []
        now = time.monotonic() if now_mono is None else now_mono
        stale = [h for h, e in self._entries.items()
                 if now - e.added_mono > self.tx_ttl]
        for h in stale:
            self._remove_one(h)
        if stale:
            trace.inc("mempool.expired", len(stale))
        return stale

    def evict_over_cap(self) -> List[str]:
        """Shed lowest-fee-rate entries until under the byte cap."""
        evicted = []
        while self._bytes > self.max_bytes_hex and self._order:
            victim = self._order[-1][1]
            self._remove_one(victim)
            evicted.append(victim)
        if evicted:
            trace.inc("mempool.evicted", len(evicted))
        return evicted

    # -------------------------------------------------- journal reconcile --

    async def sync(self, state, _stamp: Optional[tuple] = None) -> bool:
        """Reconcile pool content against the write-behind journal.

        Cheap no-op when the journal stamp is unchanged.  On change
        (wallet CLI insert, block acceptance removing txs, reorg
        re-injection, another process), the diff is applied: journal
        rows absent from the pool are parsed and added, pool entries
        gone from the journal are dropped.  Returns True when pool
        content changed (generation advanced)."""
        stamp = _stamp if _stamp is not None \
            else await state.pending_journal_stamp()
        if stamp == self._journal_stamp:
            return False
        gen0 = self.generation
        rows = await state.load_pending_journal()
        journal = {r["tx_hash"]: r for r in rows}
        for h in [h for h in self._entries if h not in journal]:
            self._remove_one(h)
        for h, r in journal.items():
            if h in self._entries:
                continue
            try:
                entry = MempoolEntry.from_row(h, r["tx_hex"], r["fees"])
            except (ValueError, KeyError, IndexError) as e:
                log.warning("journal row %s undecodable, skipped: %s", h, e)
                continue
            if self.add(entry) == "conflict":
                # two journal rows claim one outpoint (possible only via
                # external writers / reorg re-injection); priority order
                # decides nothing here — first reconciled row wins, the
                # loser stays journal-only until the mempool GC clears it
                trace.inc("mempool.sync_conflicts")
        self._journal_stamp = stamp
        return self.generation != gen0

    async def reconcile(self, state,
                        expected_stamp: Optional[tuple]) -> bool:
        """Post-write-through stamp update that cannot absorb a foreign
        journal mutation.  The caller predicts the stamp its OWN writes
        should have produced (``expected_stamp``); when the observed
        stamp matches exactly, it is recorded without reloading the
        journal.  On ANY deviation — or when the caller could not
        predict (``None``) — the full :meth:`sync` diff runs, so a
        concurrent external write (block acceptance deleting mined txs,
        a wallet-CLI insert) is diffed in rather than silently stamped
        over.  Returns True when pool content changed."""
        observed = await state.pending_journal_stamp()
        if expected_stamp is not None and observed == expected_stamp:
            self._journal_stamp = observed
            return False
        return await self.sync(state, _stamp=observed)

    async def enforce_limits(self, state) -> List[str]:
        """TTL + byte cap, with write-through to the journal so evicted
        txs do not resurrect on the next stamp reconcile.  The journal
        removal ends with a full :meth:`sync` rather than a blind stamp
        write: an external journal mutation landing between the DELETE
        and the stamp read must be diffed in, not absorbed.  Evictions
        only fire past the cap/TTL, so the reload stays off the common
        path."""
        dropped = self.expire()
        dropped += self.evict_over_cap()
        if dropped:
            await state.remove_pending_transactions_by_hash(dropped)
            await self.sync(state)
        return dropped


class TTLSet:
    """Bounded, TTL'd membership set for push_tx dedup.

    Replaces the reference's 100-entry deque (a few milliseconds of
    traffic at target load): capacity- and age-bounded, O(1) adds and
    lookups, expired entries purged from the insertion-ordered front.
    ``append`` is kept as an alias so call sites read like the deque
    they replaced.
    """

    def __init__(self, maxlen: int = 1 << 16, ttl: float = 600.0):
        self.maxlen = maxlen
        self.ttl = ttl
        self._items: Dict[str, float] = {}  # key -> monotonic deadline

    def _purge(self, now: float) -> None:
        # insertion order == ascending deadline (fixed ttl), so the
        # front of the dict is always the oldest entry
        while self._items:
            key = next(iter(self._items))
            if self.ttl and self._items[key] <= now:
                del self._items[key]
                continue
            break
        while len(self._items) > self.maxlen:
            del self._items[next(iter(self._items))]

    def add(self, key: str) -> None:
        now = time.monotonic()
        self._items.pop(key, None)  # re-add refreshes age and order
        self._items[key] = now + self.ttl
        self._purge(now)

    append = add

    def __contains__(self, key: str) -> bool:
        now = time.monotonic()
        self._purge(now)
        deadline = self._items.get(key)
        return deadline is not None and (not self.ttl or deadline > now)

    def __len__(self) -> int:
        self._purge(time.monotonic())
        return len(self._items)
