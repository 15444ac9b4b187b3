"""Flight recorder: bounded per-node black box for post-hoc diagnosis
(the port's copy of the JAX package's ``fleet/recorder.py``).

Chaos and soak scenarios fail rarely and asynchronously; by the time
the assertion fires, the interesting state is gone.  The recorder
keeps, per node, a small ring of *frames* — each frame holds the
counter DELTAS since the previous mark, the tail of new events, and
the traces in flight at mark time (tracing.TraceBuffer open roots).
Scenario drivers ``mark()`` at phase boundaries; on any core
assertion failure, injected fault, or SLO breach the ``dump()`` is
attached to the scenario artifact, so the black box lands next to the
failure it explains.

Everything is bounded: frames per node, events per frame, open-trace
snapshots per buffer — a recorder left armed for a long soak cannot
grow without limit.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    """Per-node frame rings over a swarm's telemetry scopes."""

    def __init__(self, frames: int = 8, event_tail: int = 64):
        self._max_frames = max(1, int(frames))
        self._event_tail = max(1, int(event_tail))
        self._frames: Dict[str, deque] = {}
        self._counter_base: Dict[str, Dict[str, int]] = {}
        self._event_mark: Dict[str, float] = {}
        self.marks = 0

    def mark(self, swarm, label: str = "") -> None:
        """Snapshot one frame per node: deltas since the last mark."""
        now = round(time.time(), 6)
        for i, node in enumerate(swarm.nodes):
            sc = getattr(node, "telemetry_scope", None)
            if sc is None:
                continue
            key = f"node{i}"
            counters = sc.metrics.counters()
            base = self._counter_base.get(key, {})
            deltas = {k: v - base.get(k, 0) for k, v in counters.items()
                      if v != base.get(k, 0)}
            watermark = self._event_mark.get(key, 0.0)
            tail = [e for e in sc.events.snapshot()
                    if (e.get("ts") or 0) > watermark][-self._event_tail:]
            frame = {
                "label": label,
                "ts": now,
                "counter_deltas": deltas,
                "events": tail,
                "open_traces": sc.traces.open_snapshot(),
            }
            self._frames.setdefault(
                key, deque(maxlen=self._max_frames)).append(frame)
            self._counter_base[key] = counters
            if tail:
                self._event_mark[key] = tail[-1].get("ts") or watermark
        self.marks += 1

    def dump(self, reason: str) -> dict:
        return {
            "kind": "flight_recorder",
            "reason": reason,
            "marks": self.marks,
            "nodes": {k: list(v) for k, v in self._frames.items()},
        }


def trigger_reason(core_ok: bool, events: List[dict],
                   slo_rows: Optional[Dict[str, dict]] = None,
                   p99_budget_ms: Optional[float] = None) -> Optional[str]:
    """Why (if at all) the black box should land in the artifact.

    Precedence: a failed core assertion explains everything else; a
    watchtower alert that reached *firing* outranks the raw fault that
    (usually) provoked it — the alert is the judged incident, the fault
    the mechanism; an injected fault outranks a soft SLO breach."""
    if not core_ok:
        return "core_assertion_failed"
    for e in events:
        if e.get("kind") == "alert" and e.get("state") == "firing":
            return f"alert:{e.get('rule')}"
    for e in events:
        if e.get("kind") == "fault_injected":
            return "fault_injected"
    if p99_budget_ms is not None and slo_rows:
        for name, row in sorted(slo_rows.items()):
            p99 = row.get("p99_ms")
            if isinstance(p99, (int, float)) and p99 > p99_budget_ms:
                return f"slo_breach:{name}:p99_ms={p99}"
    return None
