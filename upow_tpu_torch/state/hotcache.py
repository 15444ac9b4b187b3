"""Generation-anchored hot-state read cache.

The port's copy of the JAX package's ``state/hotcache.py``, unchanged in
what it stores, serves and counts.

Chain state is immutable between writes: between two block accepts (or
pending-journal changes) every read-endpoint answer is a pure function
of ``(tip_block_hash, pending_journal_seq)``.  This cache keys every
entry by an integer *epoch* that stands in for that tuple: the node
bumps the epoch synchronously after each committed write (block accept,
reorg, pending add/remove — the ``BlockManager.on_pending_removed``
hook pattern generalized to ``on_state_committed`` and
``ChainState.on_blocks_removed``), so invalidation is O(1) and precise.
A cached entry is served only on an exact epoch match, which makes
responses byte-identical to the uncached path *by construction* — no
TTL guessing, no staleness window from the writer's own perspective.

Multi-worker deployments share state through SQL, where another
worker's write bumps nothing in this process.  For that, the epoch is
re-anchored at most every ``revalidate_interval`` seconds against the
real validator tuple ``(tip hash, pending_journal_stamp())`` (the same
journal-stamp reconciliation the mempool already uses), and any
observed change bumps the epoch (``foreign_bumps``).  Interval 0 means
revalidate on every read (used by tests and correct-but-slow shared-DB
setups); a negative interval disables foreign revalidation entirely
(sole-writer processes).

What is cached is the *encoded response body* (bytes), not the Python
object: the handler's dumps function runs once per (entry, generation)
and the stored bytes are fanned out verbatim, so a cache hit costs a
dict lookup instead of SQL + JSON encoding.

Entries are grouped into classes (``address``, ``blocks``, ``tx``,
``supply``, ...) each with its own LRU byte cap, so one scan of cold
block history cannot evict the hot wallet set.  Concurrent misses for
the same ``(class, key, epoch)`` coalesce through a singleflight table:
one producer runs, everyone else awaits its future
(``singleflight_coalesced``).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Awaitable, Callable, Dict, Optional, Tuple

__all__ = ["HotStateCache"]


class _ClassCache:
    """One LRU byte-capped entry class."""

    __slots__ = ("entries", "bytes", "cap")

    def __init__(self, cap: int):
        # key -> (epoch, body)
        self.entries: "OrderedDict[tuple, Tuple[int, bytes]]" = OrderedDict()
        self.bytes = 0
        self.cap = cap


class HotStateCache:
    def __init__(self, state, config=None):
        from ..config import CacheConfig

        self.state = state
        self.config = config or CacheConfig()
        self.enabled = bool(self.config.enabled)
        self._classes: Dict[str, _ClassCache] = {}
        self._class_caps = self.config.parsed_class_caps()
        self._inflight: Dict[tuple, asyncio.Future] = {}
        self._epoch = 0
        self._epoch_changed_at = time.monotonic()
        # validator tuple observed at the last foreign revalidation;
        # None right after a local bump (re-anchored lazily)
        self._anchor: Optional[tuple] = None
        self._last_revalidate = float("-inf")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.singleflight_coalesced = 0
        self.bumps = 0
        self.foreign_bumps = 0

    # ------------------------------------------------------- generation ---
    def bump(self, reason: str = "") -> None:
        """Advance the generation after a local committed write.  O(1):
        entries are not scanned or dropped here — stale ones simply stop
        matching and age out through the LRU."""
        self._epoch += 1
        self._anchor = None  # re-anchor lazily on the next revalidation
        self._epoch_changed_at = time.monotonic()
        self.bumps += 1

    async def generation(self) -> int:
        """Current epoch, re-anchored against the shared database when
        the revalidation interval says it is due."""
        interval = self.config.revalidate_interval
        if interval < 0:
            return self._epoch
        now = time.monotonic()
        if now - self._last_revalidate < interval:
            return self._epoch
        # claim the slot before awaiting so concurrent readers don't
        # pile duplicate anchor reads (single-threaded up to this point)
        self._last_revalidate = now
        epoch0 = self._epoch
        anchor = await self._read_anchor()
        if self._epoch != epoch0:
            # a local bump landed mid-read; its invalidation supersedes
            # whatever snapshot this anchor read saw
            return self._epoch
        if self._anchor is None:
            self._anchor = anchor
        elif anchor != self._anchor:
            self._anchor = anchor
            self._epoch += 1
            self._epoch_changed_at = time.monotonic()
            self.foreign_bumps += 1
        return self._epoch

    async def _read_anchor(self) -> tuple:
        last = await self.state.get_last_block()
        stamp = await self.state.pending_journal_stamp()
        return ((last or {}).get("hash"), tuple(stamp))

    # ------------------------------------------------------------ reads ---
    async def get_bytes(self, entry_class: str, key: tuple,
                        produce: Callable[[], Awaitable[bytes]]) -> bytes:
        """Read-through: serve ``(entry_class, key)`` at the current
        generation, calling ``produce()`` (which must return the encoded
        body bytes) on a miss.  Concurrent misses for the same key and
        generation share one ``produce()`` call."""
        gen = await self.generation()
        cc = self._class(entry_class)
        hit = cc.entries.get(key)
        if hit is not None and hit[0] == gen:
            self.hits += 1
            cc.entries.move_to_end(key)
            return hit[1]
        self.misses += 1
        flight_key = (entry_class, key, gen)
        fut = self._inflight.get(flight_key)
        if fut is not None:
            self.singleflight_coalesced += 1
            return await asyncio.shield(fut)
        fut = asyncio.get_event_loop().create_future()
        # retrieve the outcome even if no follower ever awaits it
        fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        self._inflight[flight_key] = fut
        try:
            body = await produce()
        except BaseException as e:
            if not fut.done():
                if isinstance(e, asyncio.CancelledError):
                    fut.cancel()
                else:
                    fut.set_exception(e)
            raise
        else:
            if not fut.done():
                fut.set_result(body)
            self._store(cc, key, gen, body)
            return body
        finally:
            self._inflight.pop(flight_key, None)

    def _class(self, name: str) -> _ClassCache:
        cc = self._classes.get(name)
        if cc is None:
            cap = self._class_caps.get(name, self.config.class_cap_bytes)
            cc = self._classes[name] = _ClassCache(cap)
        return cc

    def _store(self, cc: _ClassCache, key: tuple, gen: int,
               body: bytes) -> None:
        size = len(body)
        if size > min(cc.cap, self.config.max_entry_bytes):
            return  # would evict the whole class for one oversized body
        old = cc.entries.pop(key, None)
        if old is not None:
            cc.bytes -= len(old[1])
        cc.entries[key] = (gen, body)
        cc.bytes += size
        while cc.bytes > cc.cap and cc.entries:
            _, (_, evicted) = cc.entries.popitem(last=False)
            cc.bytes -= len(evicted)
            self.evictions += 1

    # ------------------------------------------------------------ stats ---
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "enabled": self.enabled,
            "generation": self._epoch,
            "generation_age_seconds": round(
                time.monotonic() - self._epoch_changed_at, 3),
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": round(self.hits / total, 4) if total else 0.0,
            "evictions": self.evictions,
            "singleflight_coalesced": self.singleflight_coalesced,
            "bumps": self.bumps,
            "foreign_bumps": self.foreign_bumps,
            "classes": {
                name: {"entries": len(cc.entries), "bytes": cc.bytes,
                       "cap_bytes": cc.cap}
                for name, cc in sorted(self._classes.items())
            },
        }
