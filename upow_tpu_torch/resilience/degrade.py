"""Device-health state machine of the verify hot path (the port's copy of
the JAX package's ``resilience/degrade.py``).

:class:`DegradeManager` has three states:

* **ok**: device dispatches flow.
* **degraded**: after ``failure_limit`` consecutive *raised* errors the
  device path is benched; after ``cooldown`` seconds ONE dispatch is let
  through as a re-probe: success restores **ok**, failure re-benches for
  another cooldown.
* **poisoned**: a *hang* (a boxed call past its deadline) is not
  recoverable, since the stuck thread may hold the card; the device path
  stays off for the life of the process.

What a benched dispatch becomes is the caller's rule
(``verify/txverify.py``): on the CPU the native host batch serves it; on
a card it raises :class:`DeviceBlocked`, where the JAX package serves it
on the host.

Every transition and every blocked dispatch is counted through
``trace.inc`` under the JAX names (``resilience.device_error``,
``resilience.device_degraded``, ``resilience.device_reprobe``,
``resilience.device_recovered``, ``resilience.device_fallback``,
``resilience.device_poisoned``) and logged at warning.

Beyond the JAX manager, :meth:`snapshot` carries ``errors`` (failures
recorded since the last :meth:`reset`) and ``last_error`` (the repr of
the latest), so a run can fail on any failure that the degrade absorbed,
even one a later success cleared from ``consecutive_failures``.

All state moves under one lock: the verify dispatch runs on the device
runtime's drainer and on executor threads.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from .. import trace

log = logging.getLogger("upow_tpu_torch.degrade")

OK = "ok"
DEGRADED = "degraded"
POISONED = "poisoned"

_STATE_GAUGE = {OK: 0, DEGRADED: 1, POISONED: 2}


class DeviceBlocked(RuntimeError):
    """A card's device dispatch refused by a degraded or poisoned path."""


class DegradeManager:
    """Device-health state machine feeding the verify backend router."""

    def __init__(self, failure_limit: int = 3, cooldown: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_limit = failure_limit
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._state = OK
        self._consecutive_failures = 0
        self._degraded_at = 0.0
        self._probe_in_flight = False
        self._errors = 0
        self._last_error: Optional[str] = None

    def configure(self, failure_limit: int, cooldown: float) -> None:
        """Apply the config's knobs (node startup); state is kept."""
        with self._lock:
            self.failure_limit = failure_limit
            self.cooldown = cooldown

    def reset(self) -> None:
        """Back to ``ok`` with no failure recorded (tests, and a run that
        injected faults on purpose)."""
        with self._lock:
            self._state = OK
            self._consecutive_failures = 0
            self._degraded_at = 0.0
            self._probe_in_flight = False
            self._errors = 0
            self._last_error = None

    # ------------------------------------------------------------ gates ---
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def state_gauge(self) -> int:
        """0 = ok, 1 = degraded, 2 = poisoned."""
        return _STATE_GAUGE[self.state]

    def allow(self) -> bool:
        """May the next verify batch go to the device?

        In ``degraded`` this is False until ``cooldown`` has elapsed,
        then True (the re-probe) until that probe resolves through
        :meth:`record_success` or :meth:`record_failure`: the backend
        resolver asks more than once a dispatch (the cached and uncached
        layers), so an in-flight probe keeps answering True.  Each
        refusal counts under the JAX name ``resilience.device_fallback``
        (a blocked dispatch; on a card it raises).
        """
        with self._lock:
            if self._state == OK:
                return True
            if self._state == POISONED:
                trace.inc("resilience.device_fallback")
                return False
            if self._probe_in_flight:
                return True
            if self._clock() - self._degraded_at < self.cooldown:
                trace.inc("resilience.device_fallback")
                log.warning("device verify path degraded; dispatch "
                            "blocked until the cooldown's re-probe")
                return False
            self._probe_in_flight = True
            trace.inc("resilience.device_reprobe")
            log.warning("device cooldown elapsed; re-probing the device "
                        "verify path")
            return True

    # --------------------------------------------------------- outcomes ---
    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state == DEGRADED:
                self._state = OK
                trace.inc("resilience.device_recovered")
                trace.event("degrade", state=OK, previous=DEGRADED)
                log.warning("device verify path recovered; leaving "
                            "degraded mode")

    def record_failure(self, error: Optional[BaseException] = None) -> None:
        with self._lock:
            trace.inc("resilience.device_error")
            self._errors += 1
            self._last_error = repr(error) if error is not None \
                else "unspecified device failure"
            self._consecutive_failures += 1
            self._probe_in_flight = False
            if self._state == DEGRADED:
                self._degraded_at = self._clock()  # failed probe: re-bench
                log.warning("device verify re-probe failed (%s); benched "
                            "for another %.0fs", error, self.cooldown)
                return
            if self._state == OK and \
                    self._consecutive_failures >= self.failure_limit:
                self._state = DEGRADED
                self._degraded_at = self._clock()
                trace.inc("resilience.device_degraded")
                trace.event("degrade", state=DEGRADED, previous=OK,
                            failures=self._consecutive_failures,
                            error=str(error) if error else None)
                log.warning(
                    "device verify path degraded after %d consecutive "
                    "errors (%s); re-probe in %.0fs",
                    self._consecutive_failures, error, self.cooldown)

    def poison(self, reason: str = "") -> None:
        """A hang: the stuck thread cannot be reclaimed, so the device
        path is off for the life of the process."""
        with self._lock:
            self._errors += 1
            self._last_error = reason or "device hang"
            if self._state != POISONED:
                prev = self._state
                self._state = POISONED
                trace.inc("resilience.device_poisoned")
                trace.event("degrade", state=POISONED, previous=prev,
                            reason=reason or None)
                log.warning("device verify path poisoned%s; it stays off "
                            "for the rest of this process",
                            f" ({reason})" if reason else "")

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "cooldown": self.cooldown,
                    "failure_limit": self.failure_limit,
                    "errors": self._errors,
                    "last_error": self._last_error}
