"""Structured event ring buffer for the /debug/events surface.

The port's copy of the JAX package's ``telemetry/events.py``, unchanged
in what it records and renders.

Rare-but-important state changes — reorgs, breaker trips, degrade
transitions, fault injections, firing alerts — are worth keeping
verbatim rather than only as counters: when a node misbehaves, the
sequence and the trace IDs matter.  ``emit()`` stamps each record
with wall-clock time, the current trace ID (None when emitted outside
a traced context, e.g. from an executor thread), and a monotonic
per-ring sequence number so consumers (the watchtower engine,
``/debug/events?since=<seq>`` pollers) can read the ring
incrementally: records with ``seq`` beyond the cursor are new, and a
cursor older than the oldest retained record means the gap rotated
away unseen — counted in ``telemetry.events.rotated_unseen``.

The ring lives in an ``EventRing`` instance; the module functions
resolve the target per call — the ring of the active telemetry scope
(one per swarm node) or the process-global ring when no scope is
bound (single-node path, unchanged)."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional

from . import scope, tracing

ROTATED_UNSEEN = "telemetry.events.rotated_unseen"


class EventRing:
    """Bounded oldest-evicting ring of structured event records."""

    def __init__(self, maxlen: int = 256):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, int(maxlen)))
        self._seq = 0               # seq of the newest emitted record

    def configure(self, maxlen: int = 256) -> None:
        with self._lock:
            self._events = deque(self._events, maxlen=max(1, int(maxlen)))

    def emit(self, kind: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 6), "kind": kind,
               "trace_id": tracing.current_trace_id()}
        for k, v in fields.items():
            rec[k] = v if isinstance(v, (str, int, float, bool)) \
                or v is None else str(v)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._events.append(rec)

    def snapshot(self, limit: Optional[int] = None,
                 kind: Optional[str] = None) -> List[dict]:
        """Events oldest-first; optionally last ``limit`` of one kind."""
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if limit is not None:
            out = out[-max(0, int(limit)):]
        return out

    def since(self, seq: int, limit: Optional[int] = None,
              kind: Optional[str] = None) -> dict:
        """Incremental read: records with ``seq`` strictly beyond the
        cursor, oldest-first.

        Returns ``{"events", "next_seq", "missed"}`` — pass ``next_seq``
        back as the cursor of the following poll.  ``missed`` counts
        records that rotated out of the ring before this cursor saw
        them (0 when the cursor kept up)."""
        seq = max(0, int(seq))
        with self._lock:
            out = list(self._events)
            last = self._seq
        oldest = last - len(out) + 1 if out else last + 1
        missed = max(0, min(oldest - 1, last) - seq)
        out = [e for e in out if e["seq"] > seq]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if limit is not None:
            out = out[-max(0, int(limit)):]
        return {"events": out, "next_seq": last, "missed": missed}

    def reset(self) -> None:
        """Drop retained records; ``_seq`` stays monotonic.  Zeroing it
        would strand consumers holding a cursor (the watchtower engine,
        ``?since=`` pollers): post-reset events re-use already-consumed
        sequence numbers, so ``since()`` filters them out silently until
        the cursor happens to catch up again."""
        with self._lock:
            self._events.clear()


_global = EventRing()


def _ring() -> EventRing:
    sc = scope.current()
    return sc.events if sc is not None else _global


def configure(maxlen: int = 256) -> None:
    _ring().configure(maxlen)


def emit(kind: str, **fields: Any) -> None:
    _ring().emit(kind, **fields)


def snapshot(limit: Optional[int] = None,
             kind: Optional[str] = None) -> List[dict]:
    return _ring().snapshot(limit, kind)


def since(seq: int, limit: Optional[int] = None,
          kind: Optional[str] = None) -> dict:
    """Incremental scoped read; rotated-away records the cursor never
    saw are counted into the scope's ``telemetry.events.rotated_unseen``
    counter (silent loss becomes a visible metric)."""
    out = _ring().since(seq, limit, kind)
    if out["missed"]:
        from . import metrics
        metrics.inc(ROTATED_UNSEEN, out["missed"])
    return out


def reset() -> None:
    _ring().reset()
