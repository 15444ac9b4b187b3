"""Watchtower — in-process streaming judgment over the telemetry stack.

The telemetry registries (metrics, events, tracing, SLO histograms)
record everything but judge nothing: a verify-throughput collapse or a
breaker flip storm is only visible if an operator stares at /metrics.
Watchtower closes that loop in-process:

- ``detectors``  — stdlib-only streaming primitives (EWMA z-score,
  stuck-gauge, rate-of-change spike) with deterministic fire points.
- ``burnrate``   — multi-window multi-burn-rate SLO evaluation over the
  per-route latency histograms and error counters.
- ``alerts``     — pending→firing→resolved state machine with
  for-durations, dedup keys, severity, silence/ack and a bounded
  history ring; every firing alert captures exemplar trace ids.
- ``engine``     — one background task per node evaluating the default
  rule pack on a cadence, scoped per TelemetryScope so nodes in one
  process alert independently.

The port's copy of the JAX package's ``watchtower/``: the same rules,
thresholds, state machine and surfaces.
"""

from .alerts import Alert, AlertManager, AlertRule
from .burnrate import BurnRateEvaluator, WINDOWS
from .detectors import EwmaZScore, RateTracker, SpikeDetector, StuckGauge
from .engine import WatchtowerEngine

__all__ = [
    "Alert",
    "AlertManager",
    "AlertRule",
    "BurnRateEvaluator",
    "EwmaZScore",
    "RateTracker",
    "SpikeDetector",
    "StuckGauge",
    "WatchtowerEngine",
    "WINDOWS",
]
