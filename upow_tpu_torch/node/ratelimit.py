"""Per-IP endpoint rate limiting (reference slowapi limits, main.py:55
and the @limiter.limit decorators); the port's copy of the JAX package's
``node/ratelimit.py``, with its whole limit table (routes the port's
node does not serve yet never match).

Sliding-window counters keyed by (ip, endpoint); limits are the
reference's strings ("15/second", "30/minute").  Exceeding answers HTTP
429 like slowapi.  Windows are pruned lazily, so memory is bounded by
active (ip, endpoint) pairs within the largest window.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

# endpoint -> reference limit (main.py:267-1056 decorator per route)
DEFAULT_LIMITS = {
    "/": "3/minute",
    "/sync_blockchain": "10/minute",
    "/get_mining_info": "30/minute",
    "/get_address_info": "15/second",
    "/add_node": "10/minute",
    "/get_transaction": "2/second",
    "/get_block": "30/minute",
    "/get_block_details": "10/minute",
    "/get_blocks": "40/minute",
    "/get_blocks_details": "10/minute",
    "/dobby_info": "20/minute",
    "/get_supply_info": "20/minute",
    # snapshot sync surface (docs/SNAPSHOT.md): served straight from
    # on-disk chunk files, so the budgets are about network fairness,
    # not database load — a restoring peer pulls many chunks back to
    # back, a manifest poll is one small JSON read
    "/snapshot/manifest": "30/minute",
    "/snapshot/chunk": "20/second",
    # archive serving (docs/ARCHIVE.md): same fairness stance — every
    # /archive/segment/{i} collapses into ONE "/archive/segment"
    # bucket, so per-index windows cannot multiply the budget
    "/archive/manifest": "30/minute",
    "/archive/segment": "10/second",
}

_PERIODS = {"second": 1.0, "minute": 60.0, "hour": 3600.0}


def parse_limit(spec: str) -> Tuple[int, float]:
    count, _, period = spec.partition("/")
    return int(count), _PERIODS[period]


class RateLimiter:
    def __init__(self, limits: Optional[Dict[str, str]] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.limits = {
            path: parse_limit(spec)
            for path, spec in (limits or DEFAULT_LIMITS).items()
        }
        self._hits: Dict[Tuple[str, str], Deque[float]] = {}
        self._calls = 0

    def _bucket(self, endpoint: str) -> str:
        """Collapse a dynamic-suffix path onto its registered limit:
        ``/snapshot/chunk/17`` shares ``/snapshot/chunk``'s window (one
        budget for the whole chunk space — per-index windows would let
        a scanner multiply its allowance by the chunk count)."""
        probe = endpoint
        while probe and probe not in self.limits:
            probe = probe.rsplit("/", 1)[0]
        return probe or endpoint

    def allow(self, ip: str, endpoint: str) -> bool:
        """True if this request is within the endpoint's budget."""
        if not self.enabled:
            return True
        endpoint = self._bucket(endpoint)
        if endpoint not in self.limits:
            return True
        count, period = self.limits[endpoint]
        now = time.monotonic()
        self._calls += 1
        if self._calls % 4096 == 0:
            self._sweep(now)
        window = self._hits.setdefault((ip, endpoint), deque())
        while window and now - window[0] > period:
            window.popleft()
        if len(window) >= count:
            return False
        window.append(now)
        return True

    def _sweep(self, now: float) -> None:
        """Drop fully-expired windows so a scan from many source IPs
        cannot grow the dict unboundedly."""
        for key in list(self._hits):
            window = self._hits[key]
            _, period = self.limits.get(key[1], (0, 3600.0))
            while window and now - window[0] > period:
                window.popleft()
            if not window:
                del self._hits[key]
