"""Fleet scraper: one merged snapshot over every node's telemetry.

The port's copy of the JAX package's ``fleet/scrape.py``.

Two collection paths, same fleet:

* :func:`scrape` goes through the front door — each node's /metrics,
  /debug/traces and /debug/events over the loopback hub, exactly what
  an external Prometheus + trace collector would see (including the
  per-node middleware scope binding that keeps 50 in-process nodes
  from serving each other's registries).
* :func:`local_snapshot` reads each node's ``telemetry_scope``
  directly — no HTTP, no shaped-link latency — for scenario
  assertions and the flight recorder.

:func:`render_fleet` folds a scrape into the ``upow_fleet_*``
exposition families (validated by ``make metrics-check``).
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

from .. import telemetry
from ..telemetry.exposition import Exposition
from . import propagation

#: bucket bounds for fleet propagation histograms — wider than request
#: latency buckets: cross-continent gossip legitimately takes ~100ms.
PROPAGATION_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _scope(node):
    return getattr(node, "telemetry_scope", None)


# ------------------------------------------------------- HTTP scrape ----

async def scrape(swarm) -> dict:
    """Collect every node's observability surface via the hub."""
    nodes: Dict[str, dict] = {}
    for i, url in enumerate(swarm.urls):
        ms, mbody = await swarm.hub.request(
            swarm.driver, url, "GET", "/metrics")
        _, tbody = await swarm.hub.request(
            swarm.driver, url, "GET", "/debug/traces")
        _, ebody = await swarm.hub.request(
            swarm.driver, url, "GET", "/debug/events")
        nodes[f"node{i}"] = {
            "url": url,
            "metrics_status": ms,
            "metrics_text": mbody.decode(),
            "traces": json.loads(tbody.decode()).get("result", {}),
            "events": json.loads(ebody.decode()).get("result", []),
        }
    return {"kind": "fleet_snapshot", "nodes": nodes}


# ------------------------------------------------------ direct reads ----

def local_snapshot(swarm) -> dict:
    """Direct per-scope reads (no HTTP): registries + in-flight traces."""
    nodes: Dict[str, dict] = {}
    for i, node in enumerate(swarm.nodes):
        sc = _scope(node)
        if sc is None:
            continue
        nodes[f"node{i}"] = {
            "url": swarm.urls[i],
            "counters": sc.metrics.counters(),
            "stats": sc.metrics.stats(),
            "histograms": sc.metrics.histograms(),
            "traces": sc.traces.snapshot(),
            "open_traces": sc.traces.open_snapshot(),
            "events": sc.events.snapshot(),
        }
    return {
        "kind": "fleet_local_snapshot",
        # the driver context (scenario code itself) runs unscoped
        "driver": {"traces": telemetry.traces(),
                   "events": telemetry.events.snapshot()},
        "nodes": nodes,
    }


def events_by_node(swarm, kind: Optional[str] = None) -> Dict[str, list]:
    """{node label: events oldest-first}, driver ring under "driver"."""
    out: Dict[str, list] = {"driver": telemetry.events.snapshot(kind=kind)}
    for i, node in enumerate(swarm.nodes):
        sc = _scope(node)
        if sc is not None:
            out[f"node{i}"] = sc.events.snapshot(kind=kind)
    return out


def merged_events(swarm, kind: Optional[str] = None) -> List[dict]:
    """All nodes' + driver events, globally ordered by timestamp."""
    out: List[dict] = []
    for recs in events_by_node(swarm, kind=kind).values():
        out.extend(recs)
    out.sort(key=lambda e: e.get("ts") or 0)
    return out


def traces_by_node(swarm) -> Dict[str, dict]:
    """{node label: TraceBuffer snapshot}, driver buffer included."""
    out: Dict[str, dict] = {"driver": telemetry.traces()}
    for i, node in enumerate(swarm.nodes):
        sc = _scope(node)
        if sc is not None:
            out[f"node{i}"] = sc.traces.snapshot()
    return out


def merged_trace_roots(swarm, trace_id: Optional[str] = None) -> List[dict]:
    """Recent trace roots across the fleet, optionally one trace id."""
    out: List[dict] = []
    for label, buf in traces_by_node(swarm).items():
        for root in buf.get("recent", []):
            if trace_id is None or root.get("trace_id") == trace_id:
                out.append({**root, "node": label})
    out.sort(key=lambda t: t.get("start_ts") or 0)
    return out


# -------------------------------------------------- fleet exposition ----

def _gauge_value(text: str, family: str) -> Optional[float]:
    for ln in text.splitlines():
        if ln.startswith(family + " "):
            try:
                return float(ln.split()[1])
            except ValueError:
                return None
    return None


def _hist_shape(values_s: List[float], bounds) -> dict:
    counts = [0] * (len(bounds) + 1)
    for v in values_s:
        for i, bound in enumerate(bounds):
            if v <= bound:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
    return {"bounds": bounds, "counts": counts,
            "count": len(values_s), "sum": float(sum(values_s))}


def render_fleet(snapshot: dict, prop: Optional[dict] = None) -> str:
    """Render the merged ``upow_fleet_*`` families from a scrape.

    ``prop`` is a propagation report (propagation.report); when
    omitted it is derived from the scraped event rings."""
    nodes = snapshot.get("nodes", {})
    if prop is None:
        prop = propagation.report(
            {label: rec.get("events", []) for label, rec in nodes.items()},
            n_nodes=len(nodes))

    e = Exposition(prefix="upow")
    e.gauge("fleet.nodes", len(nodes),
            "nodes aggregated into this fleet snapshot")
    heights = [h for h in
               (_gauge_value(rec.get("metrics_text", ""),
                             "upow_block_height")
                for rec in nodes.values()) if h is not None]
    if heights:
        e.gauge("fleet.height_min", min(heights))
        e.gauge("fleet.height_max", max(heights))
        e.gauge("fleet.height_spread", max(heights) - min(heights),
                "max-min chain height across nodes (0 = converged)")
    pools = [p for p in
             (_gauge_value(rec.get("metrics_text", ""),
                           "upow_mempool_transactions")
              for rec in nodes.values()) if p is not None]
    if pools:
        e.gauge("fleet.mempool_total", sum(pools))
    e.counter("fleet.events",
              sum(len(rec.get("events", [])) for rec in nodes.values()),
              "events retained across all node rings")
    e.counter("fleet.traces",
              sum(len(rec.get("traces", {}).get("recent", []))
                  for rec in nodes.values()),
              "completed traces retained across all node buffers")

    for family, rep in (("fleet.block_propagation", prop["blocks"]),
                        ("fleet.tx_propagation", prop["txs"])):
        e.gauge(family + "_p50_ms", rep["p50_ms"])
        e.gauge(family + "_p95_ms", rep["p95_ms"])
        e.gauge(family + "_p99_ms", rep["p99_ms"])
        spreads = [s for s in rep.get("spreads_ms", [])
                   if not math.isnan(s)]
        h = _hist_shape([s / 1000.0 for s in spreads],
                        PROPAGATION_BUCKETS)
        e.histogram(family + "_seconds", h["bounds"], h["counts"],
                    h["count"], h["sum"])
    return e.render()
