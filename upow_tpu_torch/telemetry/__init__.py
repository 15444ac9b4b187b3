"""Telemetry subsystem: spans → trace trees, metrics, events, /metrics.

The port's copy of the JAX package's ``telemetry`` package (the
``trace`` module is a thin shim re-exporting this one).  Layers:

* :mod:`.metrics` — flat process-wide aggregates (span stats, counters,
  fixed-bucket histograms) with a cardinality cap.
* :mod:`.tracing` — contextvar-based request-scoped trace trees with a
  bounded ring buffer (recent + slowest) and cross-node trace-ID
  propagation via the ``X-Upow-Trace`` header.
* :mod:`.events` — structured event ring buffer (reorgs, breaker
  trips, degrade transitions, fault injections) for ``/debug/events``.
* :mod:`.device` — kernel telemetry: batch occupancy, dispatch
  latency, build hit/miss, card memory gauges.
* :mod:`.exposition` — Prometheus 0.0.4 text rendering + the format
  validator.
* :mod:`.slo` — per-route request latency histograms.

The module-level functions below are the stable API every other
subsystem imports (usually via the ``trace`` shim).  :func:`profile`
captures with ``torch.profiler`` where the JAX package uses
``jax.profiler``."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

from ..logger import get_logger
from . import device, events, exposition, metrics, scope, slo, tracing
from .events import emit as event
from .metrics import (counters, ensure_counter, ensure_histogram,  # noqa: F401
                      histograms, inc, observe, stats)
from .scope import TelemetryScope  # noqa: F401
from .tracing import (add_span, attached, child_span, current_span,  # noqa: F401
                      current_trace_id, finish_child, new_trace_id,
                      open_traces, request_trace, span, traces,
                      valid_trace_id)

log = get_logger("telemetry")

#: HTTP header carrying the trace ID across gossip hops.
TRACE_HEADER = "X-Upow-Trace"

__all__ = [
    "TRACE_HEADER", "TelemetryScope", "add_span", "attached",
    "child_span", "configure", "counters", "current_span",
    "current_trace_id", "device", "ensure_counter", "ensure_histogram",
    "event", "events", "exposition", "finish_child", "histograms",
    "inc", "metrics", "new_trace_id", "observe", "open_traces",
    "profile", "request_trace", "reset", "scope", "slo", "span",
    "stats", "traces", "tracing", "valid_trace_id",
]


def configure(cfg=None) -> None:
    """Apply a TelemetryConfig (config.py) and pre-register the metric
    families a scrape must carry from its first read (occupancy and
    build-cache series of the batch kernels, the runtime, the index,
    the mesh miner, the pipeline stages and the dispatch front)."""
    if cfg is not None:
        metrics.set_max_names(cfg.max_metric_names)
        tracing.configure(recent=cfg.trace_recent,
                          slowest=cfg.trace_slowest,
                          max_spans=cfg.max_trace_spans)
        events.configure(cfg.events_buffer)
    # incremental event-cursor loss counter (events.since): exported
    # all-zero from scrape #1
    metrics.ensure_counter(events.ROTATED_UNSEEN)
    device.preregister("p256_verify")
    device.preregister("sha256_txid")
    device.preregister_runtime()
    device.preregister_index()
    device.preregister_mine()
    for stage in ("block_decode", "block_sig_wait", "accept_probe"):
        device.preregister_stage(stage)
    # shared sig dispatch front (verify/dispatch.py) — deferred import:
    # telemetry must stay importable without the verify package
    try:
        from ..verify.dispatch import preregister as _front_preregister

        _front_preregister()
    except Exception as e:  # pragma: no cover - import-cycle guard
        log.debug("dispatch front preregister skipped: %s", e)


def reset() -> None:
    """Clear every registry and buffer (tests)."""
    metrics.reset()
    tracing.reset()
    events.reset()
    device.reset()


@contextmanager
def profile(trace_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace (CPU and, with a card, CUDA
    activities) into ``trace_dir`` as a Chrome trace.

    No-op when trace_dir is falsy or the profiler is unavailable.  Only
    profiler SETUP/TEARDOWN failures are swallowed — exceptions raised
    by the caller's body must propagate untouched (a yield inside a
    try/except would eat them and then crash contextlib)."""
    if not trace_dir:
        yield
        return
    from .. import profiling

    session = None
    try:
        session = profiling.open_session()
    except Exception as e:  # profiling must never break the caller
        log.warning("torch profiler unavailable: %s", e)
    try:
        yield
    finally:
        if session is not None:
            try:
                profiling.close_session(session, trace_dir)
            except Exception as e:
                log.warning("torch profiler teardown failed: %s", e)
