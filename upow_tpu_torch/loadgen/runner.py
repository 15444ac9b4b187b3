"""Schedule execution + per-endpoint SLO summary.

The runner replays a :func:`..population.build_schedule` event list
against an *executor* — any ``async callable(LoadEvent) -> ExecResult``.
Events sharing a timestamp (push bursts) run concurrently under one
``asyncio.gather``; distinct timestamps run in order.  There is no
wall-clock pacing: the run is closed-loop, so throughput numbers mean
"as fast as the target serves", not "as fast as we asked".

The port's copy of the JAX package's ``loadgen/runner.py``.  Its
executor here is :class:`MockBackend`: latency derived purely from
(seed, event); same seed → byte-identical summary regardless of
scheduling order.  This is what the determinism test pins, and it feeds
the same ``telemetry.slo`` histograms the real middleware does so
exposition tests don't need a node.  The JAX package's second executor,
``harness.HttpExecutor`` on a real in-process node, reads ``benchutil``
and comes with it (ROADMAP A13g).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..logger import get_logger
from ..telemetry import slo
from .population import LoadEvent, PopulationSpec, build_schedule

log = get_logger("loadgen")


@dataclass(frozen=True)
class ExecResult:
    endpoint: str
    status: int
    ok: bool
    latency: float            # seconds


async def run_schedule(events: Sequence[LoadEvent],
                       executor) -> List[Optional[ExecResult]]:
    """Execute every event; a failed executor call becomes a synthetic
    status-599 result rather than aborting the run."""

    async def one(ev: LoadEvent) -> ExecResult:
        try:
            return await executor(ev)
        except Exception as e:  # keep the population running; count it
            log.debug("executor failed on %s#%d: %s", ev.kind, ev.seq, e)
            return ExecResult(endpoint=ev.endpoint, status=599, ok=False,
                              latency=0.0)

    results: List[Optional[ExecResult]] = []
    i = 0
    while i < len(events):
        j = i
        while j < len(events) and events[j].at == events[i].at:
            j += 1
        wave = events[i:j]
        if len(wave) == 1:
            results.append(await one(wave[0]))
        else:
            results.extend(await asyncio.gather(*(one(ev) for ev in wave)))
        i = j
    return results


def _exact_quantile(sorted_lat: List[float], q: float) -> float:
    """Nearest-rank quantile over the runner's own measurements (exact,
    unlike the bucket-interpolated server-side estimate)."""
    idx = min(len(sorted_lat) - 1, max(0, int(q * len(sorted_lat))))
    return sorted_lat[idx]


def summarize_latencies(values: Sequence[float]) -> dict:
    """Exact quantile summary over raw latency samples (seconds) — the
    per-endpoint shape above, minus req/s; the swarm harness uses it
    for per-node client-side SLO summaries."""
    ordered = sorted(values)
    return {
        "requests": len(ordered),
        "p50_ms": round(_exact_quantile(ordered, 0.50) * 1000, 4),
        "p95_ms": round(_exact_quantile(ordered, 0.95) * 1000, 4),
        "p99_ms": round(_exact_quantile(ordered, 0.99) * 1000, 4),
    }


def summarize(events: Sequence[LoadEvent],
              results: Sequence[Optional[ExecResult]],
              elapsed: float) -> dict:
    """Client-side per-endpoint req/s + exact p50/p95/p99 (ms)."""
    lat: Dict[str, List[float]] = {}
    errors: Dict[str, int] = {}
    for res in results:
        if res is None:
            continue
        lat.setdefault(res.endpoint, []).append(res.latency)
        if not res.ok:
            errors[res.endpoint] = errors.get(res.endpoint, 0) + 1
    endpoints = {}
    for ep, values in sorted(lat.items()):
        values.sort()
        endpoints[ep.strip("/") or "root"] = {
            "requests": len(values),
            "errors": errors.get(ep, 0),
            "req_s": round(len(values) / elapsed, 3) if elapsed else None,
            "p50_ms": round(_exact_quantile(values, 0.50) * 1000, 4),
            "p95_ms": round(_exact_quantile(values, 0.95) * 1000, 4),
            "p99_ms": round(_exact_quantile(values, 0.99) * 1000, 4),
        }
    return {
        "events": len(events),
        "elapsed_s": round(elapsed, 4),
        "endpoints": endpoints,
    }


class MockBackend:
    """Deterministic synthetic target: latency is a pure function of
    (seed, event seq/kind), so neither asyncio scheduling nor host
    speed can perturb the summary."""

    BASE_LATENCY = {
        "balance": 0.004, "utxo": 0.006, "history": 0.008,
        "mining_info": 0.002, "push_tx": 0.012,
        "ws_connect": 0.003, "ws_ping": 0.001, "ws_close": 0.001,
    }

    def __init__(self, seed: int, record_slo: bool = True):
        self.seed = seed
        self.record_slo = record_slo

    def _latency(self, ev: LoadEvent) -> float:
        digest = hashlib.sha256(
            f"{self.seed}:{ev.seq}:{ev.kind}".encode()).digest()
        jitter = int.from_bytes(digest[:8], "big") / 2.0 ** 64
        return self.BASE_LATENCY[ev.kind] * (0.5 + jitter)

    async def __call__(self, ev: LoadEvent) -> ExecResult:
        latency = self._latency(ev)
        if self.record_slo and ev.endpoint.startswith("/"):
            # same series the node middleware feeds, so exposition
            # tests exercise the slo histograms without booting a node
            slo.observe_request(ev.endpoint, latency, 200)
        return ExecResult(endpoint=ev.endpoint, status=200, ok=True,
                          latency=latency)


def run_mock(spec: PopulationSpec, record_slo: bool = True) -> dict:
    """Build + execute the schedule against the mock backend.  The
    summary's elapsed is the spec's virtual duration (deterministic);
    wall time is reported separately for the curious."""
    events = build_schedule(spec)
    backend = MockBackend(spec.seed, record_slo=record_slo)
    t0 = time.perf_counter()
    results = asyncio.run(run_schedule(events, backend))
    wall = time.perf_counter() - t0
    summary = summarize(events, results, elapsed=spec.duration)
    summary["wall_s"] = round(wall, 4)
    summary["backend"] = "mock"
    return summary
