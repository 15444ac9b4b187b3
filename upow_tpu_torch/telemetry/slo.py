"""SLO latency capture: per-endpoint request histograms + quantiles.

The port's copy of the JAX package's ``telemetry/slo.py``, unchanged
in what it records and renders.

The node's HTTP middleware records request latencies here, into the flat
:mod:`.metrics` registries — so the new series ride the existing
``/metrics`` exposition loop for free:

- ``slo.http.<endpoint>.latency_seconds``  fixed-bucket histogram
- ``slo.http.<endpoint>.requests``         counter
- ``slo.http.<endpoint>.errors``           counter (status >= 500)

Endpoint names come from the node's *registered route table* (never
from raw request paths), so the cardinality cap can't be consumed by
request-derived garbage.

Quantiles are estimated from the histogram by linear interpolation
within the bucket that crosses the target rank — the standard
Prometheus ``histogram_quantile`` estimate.  The +Inf overflow bucket
clamps to the top finite bound (there is nothing to interpolate
toward), which is also what Prometheus does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from . import metrics, tracing

#: HTTP buckets: finer than the span default at the fast end (an
#: in-process cached read answers in tens of microseconds) while still
#: covering multi-second tail stalls.
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_PREFIX = "slo.http."
_SUFFIX = ".latency_seconds"


def _safe(endpoint: str) -> str:
    return endpoint.strip("/").replace("/", "_") or "root"


def preregister(endpoints: Iterable[str]) -> None:
    """Create the SLO families for a fixed endpoint set so /metrics
    exports them (all-zero) from scrape #1."""
    for ep in endpoints:
        ep = _safe(ep)
        metrics.ensure_histogram(_PREFIX + ep + _SUFFIX, LATENCY_BUCKETS)
        metrics.ensure_counter(_PREFIX + ep + ".requests")
        metrics.ensure_counter(_PREFIX + ep + ".errors")


def observe_request(endpoint: str, seconds: float, status: int = 200,
                    trace_id: Optional[str] = None) -> None:
    """Record one served request against ``endpoint``'s SLO series.

    When the request ran under a trace, the trace id is attached as a
    bucket exemplar — /metrics then links the latency bucket to the
    concrete (possibly cross-node) trace that produced it, and firing
    alerts pick the same ids up as incident exemplars.  Callers that
    measure *after* their trace context closed (the node middleware
    times the full handler) pass the id explicitly; inside a live
    trace the ambient id is picked up automatically."""
    ep = _safe(endpoint)
    name = _PREFIX + ep + _SUFFIX
    metrics.observe(name, seconds, LATENCY_BUCKETS)
    tid = trace_id or tracing.current_trace_id()
    if tid:
        metrics.observe_exemplar(name, seconds, tid)
    metrics.inc(_PREFIX + ep + ".requests")
    if status >= 500:
        metrics.inc(_PREFIX + ep + ".errors")


def quantile(hist: dict, q: float) -> Optional[float]:
    """Estimate the ``q``-quantile (0 < q < 1) of a snapshot histogram
    ``{bounds, counts (per-bucket, +Inf last), count, sum}``."""
    total = hist.get("count", 0)
    if total <= 0:
        return None
    bounds = list(hist["bounds"])
    counts = list(hist["counts"])
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum < rank or c == 0:
            continue
        if i >= len(bounds):          # +Inf bucket: clamp to top bound
            return float(bounds[-1]) if bounds else None
        lo = float(bounds[i - 1]) if i > 0 else 0.0
        hi = float(bounds[i])
        return lo + (hi - lo) * (rank - prev_cum) / c
    return float(bounds[-1]) if bounds else None


def summary() -> Dict[str, dict]:
    """Per-endpoint snapshot: requests/errors plus histogram-estimated
    p50/p95/p99 in milliseconds (None until the first observation)."""
    counters = metrics.counters()
    out: Dict[str, dict] = {}
    for name, hist in metrics.histograms().items():
        if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
            continue
        ep = name[len(_PREFIX):-len(_SUFFIX)]
        row = {"requests": counters.get(_PREFIX + ep + ".requests", 0),
               "errors": counters.get(_PREFIX + ep + ".errors", 0)}
        for label, q in (("p50_ms", 0.5), ("p95_ms", 0.95),
                         ("p99_ms", 0.99)):
            est = quantile(hist, q)
            row[label] = round(est * 1000.0, 4) if est is not None else None
        out[ep] = row
    return out
