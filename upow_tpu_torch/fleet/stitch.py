"""Cross-node trace stitcher: per-node span trees → one fleet trace.

The port's copy of the JAX package's ``fleet/stitch.py``.

A push_tx or block propagation carries ONE trace id across nodes
(``X-Upow-Trace``: the middleware adopts inbound ids, gossip clients
attach the current id outbound).  Each node records its own root span
tree into its own buffer; this module joins the trees that share a
trace id into a single fleet trace ordered by wall-clock start, with
per-hop latencies (start-to-start between consecutive hops on
different nodes).

Wall clocks in the swarm are one process clock, so hop latencies are
exact; on real deployments they carry the usual NTP caveat.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _roots(traces_by_node: Dict[str, dict]) -> List[dict]:
    out = []
    for label, buf in traces_by_node.items():
        for root in buf.get("recent", []):
            if root.get("trace_id"):
                out.append({**root, "node": label})
    out.sort(key=lambda t: (t.get("start_ts") or 0, t.get("node") or ""))
    return out


def _span_count(root: dict) -> int:
    return 1 + sum(_span_count(c) for c in root.get("spans", []))


def stitch(traces_by_node: Dict[str, dict],
           trace_id: Optional[str] = None) -> Dict[str, dict]:
    """{trace_id: fleet trace} over every id (or just ``trace_id``).

    A fleet trace:

    * ``hops`` — every root sharing the id, start-ordered, labelled
      with its node, name, start_ts, duration_ms and span count;
    * ``nodes`` — distinct nodes in hop order;
    * ``hop_latencies_ms`` — start-to-start deltas between
      consecutive hops that changed node (the wire+queue cost of
      each fan-out edge);
    * ``duration_ms`` — first hop start to last hop end.
    """
    grouped: Dict[str, List[dict]] = {}
    for root in _roots(traces_by_node):
        tid = root["trace_id"]
        if trace_id is not None and tid != trace_id:
            continue
        grouped.setdefault(tid, []).append(root)

    fleet: Dict[str, dict] = {}
    for tid, roots in grouped.items():
        nodes: List[str] = []
        for r in roots:
            if r["node"] not in nodes:
                nodes.append(r["node"])
        hops = [{
            "node": r["node"],
            "name": r.get("name"),
            "start_ts": r.get("start_ts"),
            "duration_ms": r.get("duration_ms"),
            "spans": _span_count(r),
            "error": r.get("error"),
        } for r in roots]
        hop_latencies = []
        for prev, cur in zip(roots, roots[1:]):
            if cur["node"] != prev["node"]:
                hop_latencies.append({
                    "from": prev["node"], "to": cur["node"],
                    "latency_ms": round(
                        (cur["start_ts"] - prev["start_ts"]) * 1000.0, 3),
                })
        t0 = roots[0].get("start_ts") or 0
        t_end = max((r.get("start_ts") or 0)
                    + (r.get("duration_ms") or 0) / 1000.0 for r in roots)
        fleet[tid] = {
            "trace_id": tid,
            "nodes": nodes,
            "node_count": len(nodes),
            "hops": hops,
            "hop_latencies_ms": hop_latencies,
            "duration_ms": round((t_end - t0) * 1000.0, 3),
        }
    return fleet


def stitch_one(traces_by_node: Dict[str, dict],
               trace_id: str) -> Optional[dict]:
    return stitch(traces_by_node, trace_id=trace_id).get(trace_id)
