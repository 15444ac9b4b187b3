"""Flat metric registries: spans, counters, histograms.

The port's copy of the JAX package's ``telemetry/metrics.py``, unchanged
in what it records and renders.

This is the aggregation layer the old ``trace.py`` module provided,
extracted so the tracing layer (trace trees) and the exposition layer
(/metrics rendering) can grow around it without every consumer
changing its import.  All registries are name -> aggregate dicts and
are safe to update from executor threads (a single lock guards every
mutation; reads snapshot under the same lock).

Registries live in a ``MetricsRegistry`` instance.  The module-level
functions keep the historical flat API but resolve the target
registry per call: the one bound to the current telemetry scope
(``scope.current()`` — one registry per swarm node) or the process
global when no scope is active (the single-node path, unchanged).

Cardinality is bounded: at most ``max_names`` *distinct* names may
exist per registry kind (span / counter / histogram).  A name beyond
the cap is dropped with one warning per kind — a bug that derives
metric names from request data cannot grow the registries without
limit under heavy traffic.  ``telemetry.dropped_names`` counts the
drops (that counter itself is exempt from the cap).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from ..logger import get_logger
from . import scope

log = get_logger("telemetry")

# Default buckets suit sub-second latencies; size-like metrics (batch
# sizes, queue depths) pass their own buckets on first observe.
_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: counter tracking names dropped by the cardinality cap; exempt from
#: the cap itself so the signal survives the overflow it reports.
DROPPED = "telemetry.dropped_names"


class MetricsRegistry:
    """One instance's span/counter/histogram aggregates."""

    def __init__(self, max_names: int = 1024):
        self._lock = threading.Lock()
        self._stats: Dict[str, dict] = {}
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, dict] = {}
        self._max_names = max(1, int(max_names))
        self._warned: set = set()

    def set_max_names(self, n: int) -> None:
        self._max_names = max(1, int(n))

    def _admit(self, registry: dict, name: str, kind: str) -> bool:
        """True if ``name`` may create a new entry in ``registry``."""
        if name in registry or name == DROPPED:
            return True
        if len(registry) < self._max_names:
            return True
        self._counters[DROPPED] = self._counters.get(DROPPED, 0) + 1
        if kind not in self._warned:
            self._warned.add(kind)
            log.warning(
                "metric cardinality cap (%d) reached for %s registry; "
                "dropping new name %r (and any further new names)",
                self._max_names, kind, name)
        return False

    # --------------------------------------------------------- spans ---

    def record_span(self, name: str, seconds: float) -> None:
        with self._lock:
            if not self._admit(self._stats, name, "span"):
                return
            agg = self._stats.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += seconds
            agg["max_s"] = max(agg["max_s"], seconds)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    # ------------------------------------------------------ counters ---

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            if not self._admit(self._counters, name, "counter"):
                return
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # ---------------------------------------------------- histograms ---

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Record ``value`` into histogram ``name``.

        Bucket bounds are fixed by the first observe (or an earlier
        ``ensure_histogram``); later ``buckets=`` arguments are
        ignored.  ``counts`` is per-bucket with the +Inf overflow LAST
        — not cumulative; the exposition layer accumulates into
        Prometheus ``le`` semantics.
        """
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if not self._admit(self._hists, name, "histogram"):
                    return
                h = self._new_hist(name, buckets)
            h["count"] += 1
            h["sum"] += value
            for i, bound in enumerate(h["bounds"]):
                if value <= bound:
                    h["counts"][i] += 1
                    break
            else:
                h["counts"][-1] += 1  # +Inf overflow bucket

    def observe_exemplar(self, name: str, value: float,
                         trace_id: str) -> None:
        """Attach an exemplar trace id to the bucket ``value`` lands in.

        Exemplars link a histogram bucket to a concrete trace
        (OpenMetrics ``# {trace_id="..."} value``).  Storage is bounded
        by construction — at most one exemplar per bucket, newest wins
        with a preference for slower samples within the bucket so the
        worst representative survives.  No-op for unknown histograms
        (exemplars never create series).
        """
        if not trace_id:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                return
            for i, bound in enumerate(h["bounds"]):
                if value <= bound:
                    idx = i
                    break
            else:
                idx = len(h["bounds"])  # +Inf overflow bucket
            ex = h.setdefault("exemplars", {})
            prev = ex.get(idx)
            if prev is None or value >= prev["value"]:
                ex[idx] = {"trace_id": str(trace_id), "value": float(value)}

    def ensure_histogram(self, name: str,
                         buckets: Optional[Sequence[float]] = None) -> None:
        """Register an empty histogram so it exports before first use."""
        with self._lock:
            if name not in self._hists and \
                    self._admit(self._hists, name, "histogram"):
                self._new_hist(name, buckets)

    def ensure_counter(self, name: str) -> None:
        with self._lock:
            if name not in self._counters and \
                    self._admit(self._counters, name, "counter"):
                self._counters[name] = 0

    def _new_hist(self, name: str,
                  buckets: Optional[Sequence[float]]) -> dict:
        bounds = tuple(sorted(buckets)) if buckets else _DEFAULT_BUCKETS
        h = {"bounds": bounds, "counts": [0] * (len(bounds) + 1),
             "count": 0, "sum": 0.0}
        self._hists[name] = h
        return h

    def histograms(self) -> Dict[str, dict]:
        """Snapshot: {name: {bounds, counts (per-bucket, +Inf last),
        sum, count[, exemplars]}} — the shape the original trace.py
        exported, plus per-bucket exemplars when any were attached."""
        with self._lock:
            out = {}
            for k, v in self._hists.items():
                row = {"bounds": v["bounds"], "counts": list(v["counts"]),
                       "count": v["count"], "sum": v["sum"]}
                if v.get("exemplars"):
                    row["exemplars"] = {i: dict(e)
                                        for i, e in v["exemplars"].items()}
                out[k] = row
            return out

    # --------------------------------------------------------- reset ---

    def reset(self) -> None:
        """Clear every registry (tests)."""
        with self._lock:
            self._stats.clear()
            self._counters.clear()
            self._hists.clear()
            self._warned.clear()


_global = MetricsRegistry()


def _reg() -> MetricsRegistry:
    sc = scope.current()
    return sc.metrics if sc is not None else _global


def set_max_names(n: int) -> None:
    _reg().set_max_names(n)


def record_span(name: str, seconds: float) -> None:
    _reg().record_span(name, seconds)


def stats() -> Dict[str, dict]:
    return _reg().stats()


def inc(name: str, n: int = 1) -> None:
    _reg().inc(name, n)


def counters() -> Dict[str, int]:
    return _reg().counters()


def observe(name: str, value: float,
            buckets: Optional[Sequence[float]] = None) -> None:
    _reg().observe(name, value, buckets)


def observe_exemplar(name: str, value: float, trace_id: str) -> None:
    _reg().observe_exemplar(name, value, trace_id)


def ensure_histogram(name: str,
                     buckets: Optional[Sequence[float]] = None) -> None:
    _reg().ensure_histogram(name, buckets)


def ensure_counter(name: str) -> None:
    _reg().ensure_counter(name)


def histograms() -> Dict[str, dict]:
    return _reg().histograms()


def reset() -> None:
    _reg().reset()
