"""Stdlib-only streaming anomaly detectors.

Every detector is a small pure-python state machine fed one sample at a
time with an explicit timestamp where time matters, so golden tests can
replay hand-built series and assert the exact fire points.  Nothing
here imports jax, aiohttp or even the telemetry package — the engine
wires detectors to registries; the detectors only see numbers.
"""

from __future__ import annotations

import math
from typing import Optional


class RateTracker:
    """Turn a cumulative counter into a per-second rate.

    ``update(now, value)`` returns the rate over the interval since the
    previous sample, or ``None`` on the first sample / when the counter
    went backwards (registry reset) / when no time elapsed.
    """

    def __init__(self) -> None:
        self._last_t: Optional[float] = None
        self._last_v: Optional[float] = None

    def update(self, now: float, value: float) -> Optional[float]:
        last_t, last_v = self._last_t, self._last_v
        self._last_t, self._last_v = now, value
        if last_t is None or last_v is None:
            return None
        dt = now - last_t
        if dt <= 0 or value < last_v:
            return None
        return (value - last_v) / dt


class EwmaZScore:
    """EWMA mean/variance z-score detector.

    Keeps an exponentially-weighted mean and variance of the series and
    scores each new sample against the *previous* estimate (the sample
    never judges itself).  Fires when ``|z| >= z_threshold`` in the
    configured direction after at least ``min_samples`` samples have
    seeded the baseline.

    direction: "both" | "spike" (only z >= +t) | "drop" (only z <= -t).
    """

    def __init__(self, alpha: float = 0.3, z_threshold: float = 6.0,
                 min_samples: int = 8, direction: str = "both",
                 min_sigma: float = 1e-6) -> None:
        if direction not in ("both", "spike", "drop"):
            raise ValueError(f"bad direction: {direction!r}")
        self.alpha = float(alpha)
        self.z_threshold = float(z_threshold)
        self.min_samples = int(min_samples)
        self.direction = direction
        self.min_sigma = float(min_sigma)
        self.mean = 0.0
        self.var = 0.0
        self.samples = 0

    def update(self, value: float) -> dict:
        """Feed one sample; returns {"fire", "z", "mean", "sigma"}."""
        value = float(value)
        fire = False
        z = 0.0
        sigma = math.sqrt(self.var) if self.var > 0 else 0.0
        if self.samples >= self.min_samples:
            z = (value - self.mean) / max(sigma, self.min_sigma)
            if self.direction == "spike":
                fire = z >= self.z_threshold
            elif self.direction == "drop":
                fire = z <= -self.z_threshold
            else:
                fire = abs(z) >= self.z_threshold
        out = {"fire": fire, "z": z, "mean": self.mean, "sigma": sigma}
        # Standard EWMA mean/variance recursion (West 1979 flavour).
        if self.samples == 0:
            self.mean = value
            self.var = 0.0
        else:
            delta = value - self.mean
            incr = self.alpha * delta
            self.mean += incr
            self.var = (1.0 - self.alpha) * (self.var + delta * incr)
        self.samples += 1
        return out


class StuckGauge:
    """Fire when a must-move signal stops moving past a deadline.

    Arms only after the gauge has moved at least once (an idle node
    whose height never advanced is not "stuck", it just never started).
    After arming, fires when ``now - last_movement >= deadline_s`` while
    the value has not moved by more than ``min_delta``.  Resolves as
    soon as the value moves again.
    """

    def __init__(self, deadline_s: float, min_delta: float = 0.0) -> None:
        self.deadline_s = float(deadline_s)
        self.min_delta = float(min_delta)
        self._last_value: Optional[float] = None
        self._last_move_t: Optional[float] = None
        self._armed = False

    def update(self, now: float, value: float) -> bool:
        value = float(value)
        if self._last_value is None:
            self._last_value = value
            self._last_move_t = now
            return False
        if abs(value - self._last_value) > self.min_delta:
            self._armed = True
            self._last_value = value
            self._last_move_t = now
            return False
        if not self._armed or self._last_move_t is None:
            return False
        return (now - self._last_move_t) >= self.deadline_s


class SpikeDetector:
    """Rate-of-change spike: value >> its own recent baseline.

    Fires when a sample exceeds both an absolute ``floor`` and
    ``ratio ×`` the EWMA baseline built from at least ``min_samples``
    prior samples.  Firing samples still update the baseline, so a
    sustained plateau stops firing once the baseline catches up —
    this detector flags the *transition*, the alert machine's
    for-duration decides whether the transition matters.
    """

    def __init__(self, ratio: float = 8.0, floor: float = 0.0,
                 alpha: float = 0.3, min_samples: int = 4) -> None:
        self.ratio = float(ratio)
        self.floor = float(floor)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.baseline = 0.0
        self.samples = 0

    def update(self, value: float) -> dict:
        value = float(value)
        fire = False
        baseline = self.baseline
        if self.samples >= self.min_samples:
            fire = (value > 0 and value >= self.floor
                    and value >= self.ratio * baseline)
        if self.samples == 0:
            self.baseline = value
        else:
            self.baseline += self.alpha * (value - self.baseline)
        self.samples += 1
        return {"fire": fire, "baseline": baseline, "value": value}
