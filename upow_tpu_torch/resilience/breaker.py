"""Per-peer circuit breakers and health scores (the port's copy of the
JAX package's ``resilience/breaker.py``).

A breaker per peer URL: **closed** lets requests through, and
``failure_threshold`` consecutive failures open it; **open** refuses
them locally (:class:`CircuitOpenError`) for ``open_secs``; then
**half-open** lets ``half_open_max`` trial calls through, one success
closing it and one failure opening it again.  Beside the state each
breaker keeps an EWMA health score in [0, 1], which the peer book reads
to rank peers for gossip and sync.  The clock is injectable.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from .. import trace

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_SCORE_ALPHA = 0.3  # EWMA weight of the newest observation


class CircuitOpenError(ConnectionError):
    """Raised locally instead of contacting a peer whose circuit is open."""

    def __init__(self, key: str):
        super().__init__(f"circuit open for {key}")
        self.key = key


class CircuitBreaker:
    """One peer's breaker state and health score."""

    def __init__(self, failure_threshold: int = 5, open_secs: float = 30.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 key: str = ""):
        self.failure_threshold = failure_threshold
        self.open_secs = open_secs
        self.half_open_max = half_open_max
        self._clock = clock
        self.key = key  # the peer URL when the registry owns it
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_trials = 0
        self.score = 1.0
        self.transitions: List[str] = [CLOSED]

    @property
    def state(self) -> str:
        """The state, after the time-based move from open to half-open."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.open_secs:
            self._set_state(HALF_OPEN)
            self._half_open_trials = 0
        return self._state

    def _set_state(self, state: str) -> None:
        if state != self._state:
            previous = self._state
            self._state = state
            self.transitions.append(state)
            trace.event("breaker", peer=self.key or None, state=state,
                        previous=previous,
                        failures=self._consecutive_failures)

    def available(self) -> bool:
        """May a request be sent now?  Half-open admits up to
        ``half_open_max`` trials (a refused call takes no slot)."""
        state = self.state
        if state == CLOSED:
            return True
        if state == HALF_OPEN and self._half_open_trials < self.half_open_max:
            self._half_open_trials += 1
            return True
        return False

    def usable(self) -> bool:
        """For peer selection: not open.  Takes no half-open slot."""
        return self.state != OPEN

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self.score += _SCORE_ALPHA * (1.0 - self.score)
        if self.state == HALF_OPEN:
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        self.score -= _SCORE_ALPHA * self.score
        state = self.state
        if state == HALF_OPEN or (
                state == CLOSED and
                self._consecutive_failures >= self.failure_threshold):
            self._set_state(OPEN)
            self._opened_at = self._clock()

    def snapshot(self) -> dict:
        """State, score, consecutive failures and the count of state
        changes, as ``/debug/breakers`` shows them."""
        return {"state": self.state, "score": round(self.score, 4),
                "consecutive_failures": self._consecutive_failures,
                "flips": len(self.transitions) - 1}


class BreakerRegistry:
    """Breakers keyed by peer URL, made on first touch.  A peer with no
    breaker reads as healthy (score 1.0, available)."""

    def __init__(self, failure_threshold: int = 5, open_secs: float = 30.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self._kw = dict(failure_threshold=failure_threshold,
                        open_secs=open_secs, half_open_max=half_open_max)
        self._clock = clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = CircuitBreaker(clock=self._clock, key=key,
                                         **self._kw)
                self._breakers[key] = breaker
            return breaker

    def peek(self, key: str) -> Optional[CircuitBreaker]:
        return self._breakers.get(key)

    def available(self, key: str) -> bool:
        breaker = self.peek(key)
        return True if breaker is None else breaker.available()

    def usable(self, key: str) -> bool:
        breaker = self.peek(key)
        return True if breaker is None else breaker.usable()

    def score(self, key: str) -> float:
        breaker = self.peek(key)
        return 1.0 if breaker is None else breaker.score

    def record_success(self, key: str) -> None:
        self.get(key).record_success()

    def record_failure(self, key: str) -> None:
        self.get(key).record_failure()

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {key: b.snapshot() for key, b in items}

    def state_counts(self) -> Dict[str, int]:
        counts = {CLOSED: 0, OPEN: 0, HALF_OPEN: 0}
        for snap in self.snapshot().values():
            counts[snap["state"]] += 1
        return counts
