"""Instance scoping for the telemetry registries.

The port's copy of the JAX package's ``telemetry/scope.py``, unchanged
in what it records and renders.

Historically every registry in this package was module-global: one
process, one node, one set of metrics/events/traces.  Several nodes in
one interpreter (the JAX package's swarm simulator, the port's tests)
break that assumption: their gauges and histograms would clobber each
other.  A ``TelemetryScope`` bundles one
node's private registries; ``activate()`` binds it to the current
async context so the module-level functions in ``metrics`` /
``events`` / ``tracing`` transparently write to the scoped registries
instead of the process globals.

Design constraints:

- This module is a LEAF: no sibling imports at module level, so
  ``metrics``/``events``/``tracing`` may import it without cycles.
  ``TelemetryScope.__init__`` defers its sibling imports.
- The default path (no scope active) is unchanged — single-node
  processes keep the module globals and pay one contextvar read.
- Scope is carried by a contextvar, so tasks spawned inside an active
  scope (``ensure_future`` copies contextvars) inherit it — a node's
  gossip/ws/sync tasks report into that node's registries.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

_active: contextvars.ContextVar[Optional["TelemetryScope"]] = \
    contextvars.ContextVar("upow_telemetry_scope", default=None)


def current() -> Optional["TelemetryScope"]:
    """The scope bound to the current context, or None (globals)."""
    return _active.get()


@contextlib.contextmanager
def activate(sc: Optional["TelemetryScope"]) -> Iterator[
        Optional["TelemetryScope"]]:
    """Bind ``sc`` for the duration of the block (None rebinds globals)."""
    token = _active.set(sc)
    try:
        yield sc
    finally:
        _active.reset(token)


class TelemetryScope:
    """One instance's private metrics + events + trace registries."""

    def __init__(self, name: str = "", *, max_metric_names: int = 1024,
                 events_buffer: int = 256, trace_recent: int = 32,
                 trace_slowest: int = 16, max_trace_spans: int = 512):
        from .events import EventRing
        from .metrics import MetricsRegistry
        from .tracing import TraceBuffer
        self.name = name
        self.metrics = MetricsRegistry(max_names=max_metric_names)
        self.events = EventRing(maxlen=events_buffer)
        self.traces = TraceBuffer(recent=trace_recent, slowest=trace_slowest)
        self.max_trace_spans = max(1, int(max_trace_spans))

    @classmethod
    def from_config(cls, cfg, name: str = "") -> "TelemetryScope":
        """Build from a ``TelemetryConfig`` (same knobs as the globals)."""
        return cls(name,
                   max_metric_names=cfg.max_metric_names,
                   events_buffer=cfg.events_buffer,
                   trace_recent=cfg.trace_recent,
                   trace_slowest=cfg.trace_slowest,
                   max_trace_spans=cfg.max_trace_spans)

    def activate(self):
        return activate(self)

    def reset(self) -> None:
        self.metrics.reset()
        self.events.reset()
        self.traces.reset()
