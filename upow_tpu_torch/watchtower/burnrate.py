"""Multi-window multi-burn-rate SLO evaluation (SRE-workbook style).

Burn rate is the observed error ratio divided by the SLO's error
budget: burn 1.0 consumes exactly the whole budget over the SLO
period, burn 14.4 exhausts 2% of a 30-day budget in one hour.  The
canonical pairing — page when both the 5 m and 1 h windows burn at
>= 14.4×, ticket when both the 30 m and 6 h windows burn at >= 6× —
balances detection speed against false positives: the short window
makes the alert resolve quickly, the long window keeps a blip from
paging.

The evaluator is fed cumulative per-route request/error counts (from
the scope's ``slo.http.<route>.requests`` / ``.errors`` counters) at
each evaluation tick and answers burn rates over trailing windows by
diffing against a ring of retained snapshots.  Retention is
time-bounded by the longest configured window (the slow pair's 6 h
long window at the current ``window_scale``) rather than
count-bounded, so the long-window baseline always survives no matter
the feed cadence; ``max_snapshots`` is only an optional hard backstop
against pathologically fast feeders.  ``window_scale`` compresses the
canonical windows so tests and seeded scenarios can exercise the math
in milliseconds; production keeps 1.0.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

# Canonical (short, long) window pairs, seconds, at scale 1.0.
WINDOWS = {
    "fast": (5 * 60.0, 60 * 60.0),        # page: 5 m AND 1 h
    "slow": (30 * 60.0, 6 * 60 * 60.0),   # ticket: 30 m AND 6 h
}


class BurnRateEvaluator:
    """Trailing-window burn rates over cumulative route counters."""

    def __init__(self, slo_target: float = 0.999,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 window_scale: float = 1.0,
                 max_snapshots: Optional[int] = None) -> None:
        if not 0.0 < slo_target < 1.0:
            raise ValueError(f"slo_target out of range: {slo_target}")
        self.slo_target = float(slo_target)
        self.budget = 1.0 - self.slo_target
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.window_scale = float(window_scale)
        # ring of (ts, {route: (requests, errors)}); time-pruned in
        # record(), maxlen only as an optional overflow backstop
        self._snaps: deque = deque(maxlen=max_snapshots)

    def window(self, pair: str) -> Tuple[float, float]:
        short, long_ = WINDOWS[pair]
        return short * self.window_scale, long_ * self.window_scale

    def retention(self) -> float:
        """Longest trailing window, seconds — the slow pair's long
        window at the current scale.  Snapshots older than this (bar
        one baseline) can never be read by burn()."""
        return max(long_ for _, long_ in WINDOWS.values()) * self.window_scale

    def record(self, now: float,
               counts: Dict[str, Tuple[float, float]]) -> None:
        """Retain one snapshot of cumulative (requests, errors) by route."""
        now = float(now)
        self._snaps.append((now, dict(counts)))
        # Prune by age, not count: always keep exactly one snapshot
        # at-or-before the longest window's start so the 6 h baseline
        # survives regardless of feed cadence (a count cap at a 5 s
        # cadence retains ~43 min and the slow pair never evaluates).
        horizon = now - self.retention()
        while len(self._snaps) >= 2 and self._snaps[1][0] <= horizon:
            self._snaps.popleft()

    def _at_or_before(self, ts: float) -> Optional[Tuple[float, dict]]:
        """Newest retained snapshot with snap_ts <= ts (window start)."""
        best = None
        for snap in self._snaps:
            if snap[0] <= ts:
                best = snap
            else:
                break
        return best

    def burn(self, route: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Burn rate for ``route`` over the trailing ``window_s`` seconds.

        None when there is no baseline snapshot old enough or no
        requests happened inside the window (no traffic is not an SLO
        violation).
        """
        if not self._snaps:
            return None
        if now is None:
            now = self._snaps[-1][0]
        start = self._at_or_before(now - window_s)
        if start is None:
            return None
        cur = self._snaps[-1][1]
        base = start[1]
        req0, err0 = base.get(route, (0.0, 0.0))
        req1, err1 = cur.get(route, (0.0, 0.0))
        dreq, derr = req1 - req0, err1 - err0
        if dreq <= 0:
            return None
        ratio = max(0.0, derr) / dreq
        return ratio / self.budget

    def evaluate(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Evaluate every route seen in the newest snapshot.

        Returns {route: {"fast_short", "fast_long", "slow_short",
        "slow_long", "page", "ticket", "budget_remaining"}} where the
        burn fields may be None (insufficient data) and page/ticket are
        booleans requiring *both* windows of the pair to burn hot.
        """
        if not self._snaps:
            return {}
        if now is None:
            now = self._snaps[-1][0]
        out: Dict[str, dict] = {}
        for route in sorted(self._snaps[-1][1]):
            fs, fl = self.window("fast")
            ss, sl = self.window("slow")
            b_fs = self.burn(route, fs, now)
            b_fl = self.burn(route, fl, now)
            b_ss = self.burn(route, ss, now)
            b_sl = self.burn(route, sl, now)
            page = (b_fs is not None and b_fl is not None
                    and b_fs >= self.fast_burn and b_fl >= self.fast_burn)
            ticket = (b_ss is not None and b_sl is not None
                      and b_ss >= self.slow_burn and b_sl >= self.slow_burn)
            out[route] = {
                "fast_short": b_fs, "fast_long": b_fl,
                "slow_short": b_ss, "slow_long": b_sl,
                "page": page, "ticket": ticket,
                "budget_remaining": self.budget_remaining(route, now),
            }
        return out

    def budget_remaining(self, route: str,
                         now: Optional[float] = None) -> Optional[float]:
        """Fraction of error budget left over the slow long window.

        1.0 = untouched budget, 0.0 = exactly exhausted, negative =
        overspent; None without enough data.
        """
        _, sl = self.window("slow")
        b = self.burn(route, sl, now)
        if b is None:
            return None
        return 1.0 - b
