"""Fleet observatory: cross-node observability over the swarm (the
port's copy of the JAX package's ``fleet/``).

Per-node telemetry (instance-scoped registries, telemetry/scope.py)
stays meaningful at fleet scale only with a layer that merges it:

* :mod:`.scrape` — collect every node's /metrics + /debug/traces +
  events ring into one snapshot; render the merged ``upow_fleet_*``
  exposition families.
* :mod:`.propagation` — first-seen stamps (``block_seen``/``tx_seen``
  events) folded into fleet-wide propagation p50/p95/p99:
  block-to-90%-of-nodes and tx-to-mempool.
* :mod:`.stitch` — join per-node span trees sharing one trace id
  (``X-Upow-Trace``) into a single fleet trace with hop latencies.
* :mod:`.recorder` — bounded per-node black-box (event tails, counter
  deltas, in-flight traces) dumped into scenario artifacts on
  failure, fault injection, or SLO breach.
* :mod:`.geosoak` — the seeded asymmetric-latency geo soak scenario
  whose rows feed the observatory gate (imported lazily: it pulls in
  the swarm scenario registry).

``python -m upow_tpu_torch.fleet`` is the CLI; its swarm runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

from . import propagation, recorder, scrape, stitch  # noqa: F401
from .recorder import FlightRecorder  # noqa: F401

__all__ = ["FlightRecorder", "propagation", "recorder", "scrape",
           "stitch"]
