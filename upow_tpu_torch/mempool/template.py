"""Block-template assembly + the mining-info cache (the port's copy of
the JAX package's ``mempool/template.py``).

``select_reference`` reproduces the reference mempool slice bit-for-bit
(fee-rate DESC, tx_hash tiebreak, running byte cap that BREAKS at the
first overflow — database.py:171-186).  ``assemble_template`` layers a
dependency guard on top: a tx spending another pooled tx's output is
only packed after its parent, and orphaned children (parent missed the
cut) are skipped instead of breaking the scan.  With no in-pool
dependencies — the common case, since intake's ``inputs_unspent`` rule
rejects spends of unconfirmed outputs — its output equals the
reference slice exactly, which is what the differential test pins.

:class:`MiningInfoCache` memoizes the expensive part of
``get_mining_info`` (sort + per-tx sha256 + merkle root over the whole
pending set) behind a key of (pool generation, chain tip, difficulty):
idle miner polling against an unchanged pool is a dict hit instead of
an O(mempool) rebuild per request.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .pool import MempoolEntry


def select_reference(entries: List[MempoolEntry],
                     limit_hex_chars: int) -> List[MempoolEntry]:
    """Reference-exact capped selection from priority-ordered entries."""
    out, total = [], 0
    for entry in entries:
        if total + entry.size_hex > limit_hex_chars:
            break
        total += entry.size_hex
        out.append(entry)
    return out


def assemble_template(entries: List[MempoolEntry],
                      limit_hex_chars: int) -> List[MempoolEntry]:
    """Greedy fee-rate packing under the byte cap, dependency-aware.

    ``entries`` must already be in priority order (Mempool.ordered()).
    A child is deferred until every in-pool parent has been packed; if
    a parent never makes the block, the child is dropped from this
    template rather than packed unspendable.  The byte cap keeps the
    reference break-at-first-overflow semantics.
    """
    in_pool = {e.tx_hash for e in entries}
    packed: List[MempoolEntry] = []
    packed_set: set = set()
    waiting: Dict[str, List[MempoolEntry]] = {}  # parent -> children
    total = 0
    capped = False

    def try_pack(entry: MempoolEntry) -> bool:
        nonlocal total, capped
        if capped:
            return False
        if total + entry.size_hex > limit_hex_chars:
            capped = True
            return False
        total += entry.size_hex
        packed.append(entry)
        packed_set.add(entry.tx_hash)
        # unblock children whose last missing parent was this tx, in
        # the priority order they were deferred in; a child with MORE
        # unpacked parents moves to its next missing parent's queue
        # (dropping it here would strand it even when every parent
        # eventually packs)
        for child in waiting.pop(entry.tx_hash, []):
            missing = [h for h, _ in child.outpoints
                       if h in in_pool and h not in packed_set]
            if missing:
                waiting.setdefault(missing[0], []).append(child)
            else:
                try_pack(child)
        return True

    for entry in entries:
        if capped:
            break
        if entry.tx_hash in packed_set:
            continue
        missing = [h for h, _ in entry.outpoints
                   if h in in_pool and h not in packed_set]
        if missing:
            waiting.setdefault(missing[0], []).append(entry)
            continue
        try_pack(entry)
    return packed


class MiningInfoCache:
    """Single-slot memo for the heavy half of get_mining_info.

    One slot suffices: every key component (pool generation, tip hash,
    difficulty) moves forward monotonically with chain/pool state, so a
    stale entry can never become valid again — and miner polling only
    ever asks for "now"."""

    def __init__(self):
        self._key: Optional[tuple] = None
        self._value: Optional[dict] = None
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> Optional[dict]:
        if self._key == key:
            self.hits += 1
            return self._value
        self.misses += 1
        return None

    def put(self, key: tuple, value: dict) -> None:
        self._key = key
        self._value = value

    def invalidate(self) -> None:
        self._key = None
        self._value = None
