"""Alert state machine: pending → firing → resolved.

``AlertManager.observe(rule, active, now, ...)`` is the single entry
point: the engine calls it once per rule (or per dedup key for
per-route rules) on every evaluation tick with the rule's boolean
condition.  The machine applies the rule's ``for``-duration (a
condition must hold continuously before it pages), dedups by key,
tracks severity and exemplar trace ids, and keeps a bounded history
ring of firing/resolved transitions.  Silence and ack are operator
knobs surfaced on /debug/alerts: a silenced alert still tracks state
but suppresses emission; ack just annotates a firing alert.

Timestamps are injected (``now``) so scenarios and golden tests drive
transitions deterministically.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"

SEVERITIES = ("info", "warning", "critical")


@dataclass(frozen=True)
class AlertRule:
    """Static description of one alert rule."""
    name: str
    severity: str = "warning"
    for_s: float = 0.0
    description: str = ""

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity: {self.severity!r}")


@dataclass
class Alert:
    """Live state for one dedup key."""
    rule: AlertRule
    key: str
    state: str
    since: float                  # when the condition first went active
    fired_at: Optional[float] = None
    value: Optional[float] = None
    exemplars: List[str] = field(default_factory=list)
    fields: dict = field(default_factory=dict)
    acked: bool = False

    def to_dict(self) -> dict:
        return {
            "rule": self.rule.name,
            "key": self.key,
            "severity": self.rule.severity,
            "state": self.state,
            "since": round(self.since, 6),
            "fired_at": (round(self.fired_at, 6)
                         if self.fired_at is not None else None),
            "for_s": self.rule.for_s,
            "value": self.value,
            "exemplars": list(self.exemplars),
            "fields": dict(self.fields),
            "acked": self.acked,
        }


class AlertManager:
    """Dedup'd alert states with a bounded transition history."""

    MAX_EXEMPLARS = 4

    def __init__(self, history: int = 64,
                 emit: Optional[Callable[[str, Alert], None]] = None) -> None:
        self._states: Dict[str, Alert] = {}
        self._history: deque = deque(maxlen=max(1, int(history)))
        self._silenced: Dict[str, float] = {}   # key -> silence expiry ts
        self._emit = emit
        self.fired_total = 0
        self.resolved_total = 0

    # -- evaluation -------------------------------------------------

    def observe(self, rule: AlertRule, active: bool, now: float,
                value: Optional[float] = None,
                exemplars: Sequence[str] = (),
                fields: Optional[dict] = None,
                key: Optional[str] = None) -> Optional[Alert]:
        """Feed one rule condition sample; returns the live Alert or None."""
        k = key or rule.name
        st = self._states.get(k)
        if not active:
            if st is None:
                return None
            if st.state == FIRING:
                self._transition(st, RESOLVED, now)
                self.resolved_total += 1
            # pending that never fired just evaporates
            del self._states[k]
            return None

        if st is None:
            st = Alert(rule=rule, key=k, state=PENDING, since=now)
            self._states[k] = st
        st.value = value
        if fields:
            st.fields.update(fields)
        for tid in exemplars:
            if tid and tid not in st.exemplars:
                st.exemplars.append(tid)
        del st.exemplars[:-self.MAX_EXEMPLARS]
        if st.state == PENDING and (now - st.since) >= rule.for_s:
            st.fired_at = now
            self._transition(st, FIRING, now)
            self.fired_total += 1
        return st

    def _transition(self, st: Alert, state: str, now: float) -> None:
        st.state = state
        rec = st.to_dict()
        rec["ts"] = round(now, 6)
        self._history.append(rec)
        if self._emit is not None and not self.is_silenced(st.key, now):
            self._emit(state, st)

    # -- operator knobs ---------------------------------------------

    def silence(self, key: str, until: float) -> None:
        self._silenced[key] = float(until)

    def unsilence(self, key: str) -> None:
        self._silenced.pop(key, None)

    def is_silenced(self, key: str, now: float) -> bool:
        until = self._silenced.get(key)
        if until is None:
            return False
        if now >= until:
            del self._silenced[key]
            return False
        return True

    def ack(self, key: str) -> bool:
        st = self._states.get(key)
        if st is None or st.state != FIRING:
            return False
        st.acked = True
        return True

    # -- introspection ----------------------------------------------

    def counts(self, now: float) -> dict:
        firing = pending = silenced = with_exemplars = 0
        for st in self._states.values():
            if self.is_silenced(st.key, now):
                silenced += 1
                continue
            if st.state == FIRING:
                firing += 1
                if st.exemplars:
                    with_exemplars += 1
            elif st.state == PENDING:
                pending += 1
        return {"firing": firing, "pending": pending,
                "silenced": silenced, "firing_with_exemplars": with_exemplars}

    def active(self) -> List[Alert]:
        return sorted(self._states.values(), key=lambda s: s.key)

    def history(self) -> List[dict]:
        return list(self._history)
