"""Fleet propagation tracker: first-seen stamps → p50/p95/p99.

The port's copy of the JAX package's ``fleet/propagation.py``.

Every node emits ``block_seen`` (on commit, both accept paths) and
``tx_seen`` (on mempool accept) into its own event ring.  With one
ring per node (telemetry/scope.py) the fleet-wide first-seen matrix
falls out of the merged snapshot:

* **block spread** (per block hash): time from the FIRST node that
  committed it to the moment 90% of nodes (``coverage``) have — the
  paper's propagation question, "how long until the fleet agrees".
* **tx-to-mempool** (per tx hash): first acceptance to the last
  node's acceptance among the nodes that saw it.

Quantiles run over the per-hash spreads; a hash seen by fewer nodes
than the coverage threshold is excluded from block quantiles (it
never propagated — that is a convergence failure for the scenario
core to flag, not a latency number).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

#: labels in an events-by-node mapping that are not nodes
_NON_NODE_LABELS = ("driver",)


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear interpolation on sorted values; NaN when empty."""
    if not sorted_vals:
        return math.nan
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


def first_seen(events_by_node: Dict[str, List[dict]],
               kind: str) -> Dict[str, Dict[str, float]]:
    """{hash: {node: first-seen ts}} for one event kind."""
    out: Dict[str, Dict[str, float]] = {}
    for node, recs in events_by_node.items():
        if node in _NON_NODE_LABELS:
            continue
        for rec in recs:
            if rec.get("kind") != kind:
                continue
            h = rec.get("hash")
            ts = rec.get("ts")
            if not h or ts is None:
                continue
            seen = out.setdefault(h, {})
            if node not in seen or ts < seen[node]:
                seen[node] = ts
    return out


def _spread_stats(seen: Dict[str, Dict[str, float]], n_nodes: int,
                  coverage: float) -> dict:
    need = max(1, math.ceil(coverage * n_nodes))
    spreads_ms: List[float] = []
    covered = 0
    for stamps in seen.values():
        times = sorted(stamps.values())
        if len(times) < need:
            continue
        covered += 1
        spreads_ms.append((times[need - 1] - times[0]) * 1000.0)
    ordered = sorted(spreads_ms)
    return {
        "hashes": len(seen),
        "covered": covered,
        "coverage_nodes": need,
        "p50_ms": round(_quantile(ordered, 0.50), 3),
        "p95_ms": round(_quantile(ordered, 0.95), 3),
        "p99_ms": round(_quantile(ordered, 0.99), 3),
        "max_ms": round(max(spreads_ms), 3) if spreads_ms else math.nan,
        "spreads_ms": [round(s, 3) for s in spreads_ms],
    }


def report(events_by_node: Dict[str, List[dict]],
           n_nodes: Optional[int] = None,
           coverage: float = 0.9) -> dict:
    """Fleet propagation report over merged event rings.

    Block quantiles measure first-commit → coverage-th node; tx
    quantiles measure first-accept → full fan-out among seen nodes
    (tx gossip has no coverage contract — a tx mined quickly may
    legally never reach laggards)."""
    if n_nodes is None:
        n_nodes = len([k for k in events_by_node
                       if k not in _NON_NODE_LABELS])
    blocks = first_seen(events_by_node, "block_seen")
    txs = first_seen(events_by_node, "tx_seen")
    rep_blocks = _spread_stats(blocks, n_nodes, coverage)
    # per-tx spread across however many nodes saw it (min 2)
    tx_spreads = []
    for stamps in txs.values():
        times = sorted(stamps.values())
        if len(times) >= 2:
            tx_spreads.append((times[-1] - times[0]) * 1000.0)
    ordered = sorted(tx_spreads)
    rep_txs = {
        "hashes": len(txs),
        "covered": len(tx_spreads),
        "p50_ms": round(_quantile(ordered, 0.50), 3),
        "p95_ms": round(_quantile(ordered, 0.95), 3),
        "p99_ms": round(_quantile(ordered, 0.99), 3),
        "max_ms": round(max(tx_spreads), 3) if tx_spreads else math.nan,
        "spreads_ms": [round(s, 3) for s in tx_spreads],
    }
    return {"kind": "fleet_propagation", "n_nodes": n_nodes,
            "coverage": coverage, "blocks": rep_blocks, "txs": rep_txs}


def gate_rows(prop: dict, prefix: str = "fleet") -> Dict[str, dict]:
    """Propagation quantiles in the gate's slo-endpoint row shape
    (loadgen/gate.py flatten: slo.{name}.{p50_ms,p95_ms,p99_ms})."""
    rows: Dict[str, dict] = {}
    for name, rep in (("block_prop", prop["blocks"]),
                      ("tx_prop", prop["txs"])):
        if rep["covered"] and not math.isnan(rep["p50_ms"]):
            rows[f"{prefix}.{name}"] = {
                "requests": rep["covered"],
                "p50_ms": rep["p50_ms"],
                "p95_ms": rep["p95_ms"],
                "p99_ms": rep["p99_ms"],
            }
    return rows
