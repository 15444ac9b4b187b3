"""Watchtower engine: the default rule pack on a cadence.

The port's copy of the JAX package's ``watchtower/engine.py``.  One
``WatchtowerEngine`` per node evaluates the standing rule pack over
that node's telemetry registries: the scope's ``MetricsRegistry`` /
``EventRing`` / ``TraceBuffer`` when the node runs under a
``TelemetryScope`` (several nodes in one process), the process globals
otherwise.  The engine never relies on the ambient scope contextvar:
it holds direct registry references, so the background task needs no
scope activation and nodes alert strictly independently.

Inputs:

- **probes** — named callables (sync or async) the node registers at
  wiring time for live gauges the registry does not store (block
  height, mempool depth, sync lag, cumulative ws drops).  A probe
  raising is counted, never fatal.
- **counters** — registry counter snapshots turned into rates
  (``pipeline.front.submissions`` → verify throughput).
- **events** — consumed incrementally via the ring's ``since`` cursor
  (breaker trips, degrade transitions, and on the port a device
  runtime's failed arm, ``arm_failed``); rotated-away records the
  cursor missed are counted into ``telemetry.events.rotated_unseen``.
- **SLO counters** — ``slo.http.<route>.requests`` / ``.errors`` fed
  to the burn-rate evaluator.

Timestamps are injectable (``evaluate_once(now=...)``) so scenarios
drive for-durations and window aging deterministically; production
runs ``run()`` from the node's background task set.
"""

from __future__ import annotations

import asyncio
import inspect
import math
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..logger import get_logger
from ..telemetry import events as events_mod
from ..telemetry import metrics as metrics_mod
from ..telemetry import tracing as tracing_mod
from ..telemetry.events import ROTATED_UNSEEN
from .alerts import AlertManager, AlertRule
from .burnrate import WINDOWS, BurnRateEvaluator
from .detectors import EwmaZScore, RateTracker, SpikeDetector, StuckGauge
from . import benchlog

log = get_logger("watchtower")

_SLO_PREFIX = "slo.http."

#: event kinds that feed the device arm-flap rule
_ARM_FLAP_KINDS = ("degrade", "bench_arm_failed", "arm_failed")


class WatchtowerEngine:
    """Streaming rule evaluation over one node's telemetry registries."""

    def __init__(self, cfg, scope=None, name: str = "node") -> None:
        self.cfg = cfg
        self.name = name
        if scope is not None:
            self._metrics = scope.metrics
            self._events = scope.events
            self._traces = scope.traces
        else:
            self._metrics = metrics_mod._global
            self._events = events_mod._global
            self._traces = tracing_mod._buffer
        self._probes: Dict[str, Callable] = {}
        self._mgr = AlertManager(history=cfg.history,
                                 emit=self._on_transition)
        # Snapshot backstop sized from the windows: one snapshot per
        # tick across the longest (6 h) window plus slack.  The
        # evaluator prunes by age; the cap only guards a runaway feeder
        # and must never undercut the long-window baseline (a fixed 512
        # cap at the 5 s default retained ~43 min, so the slow burn
        # pair — and paging — could never evaluate in production).
        retention = (max(l for _, l in WINDOWS.values())
                     * cfg.window_scale)
        self._burn = BurnRateEvaluator(
            slo_target=cfg.slo_target, fast_burn=cfg.fast_burn,
            slow_burn=cfg.slow_burn, window_scale=cfg.window_scale,
            max_snapshots=math.ceil(
                retention / max(cfg.interval, 1e-6)) + 16)
        # streaming detector state
        self._verify_rate = RateTracker()
        # min_sigma floors the z denominator: a perfectly steady rate
        # must not page on a 1% wobble just because its variance is ~0
        self._verify_z = EwmaZScore(z_threshold=cfg.verify_z,
                                    direction="drop", min_sigma=0.25)
        self._mempool_spike = SpikeDetector(ratio=cfg.mempool_spike_ratio,
                                            floor=cfg.mempool_spike_floor)
        self._ws_rate = RateTracker()
        self._stuck_height = StuckGauge(cfg.stuck_height_deadline,
                                        min_delta=0.0)
        # event-window state: (ts, trace_id) per family, pruned by window
        self._breaker_opens: deque = deque(maxlen=1024)
        self._arm_flaps: deque = deque(maxlen=1024)
        self._cursor = 0
        self._last_burn: Dict[str, dict] = {}
        self.evaluations = 0
        self.probe_errors = 0
        self.eval_errors = 0
        self._last_eval_ts: Optional[float] = None
        self._last_lag = 0.0
        self.on_fire: List[Callable] = []
        self._rules = self._build_rules()
        # the rotated-unseen counter exports from scrape #1 even if the
        # cursor never falls behind
        self._metrics.ensure_counter(ROTATED_UNSEEN)

    # ------------------------------------------------------- rule pack ---

    def _build_rules(self) -> Dict[str, AlertRule]:
        c = self.cfg
        rules = [
            AlertRule("verify_throughput_collapse", "critical", c.for_fast,
                      "verify submission rate collapsed vs its own EWMA "
                      f"baseline (z <= -{c.verify_z}, baseline >= "
                      f"{c.verify_min_rate}/s)"),
            AlertRule("mempool_depth_spike", "warning", c.for_fast,
                      f"mempool depth >= {c.mempool_spike_ratio}x its EWMA "
                      f"baseline and >= {c.mempool_spike_floor}"),
            AlertRule("sync_lag", "warning", c.for_slow,
                      f"node tip >= {c.sync_lag_limit}s behind wall clock"),
            AlertRule("breaker_flip_storm", "critical", c.for_fast,
                      f">= {c.breaker_storm_opens} breaker open transitions "
                      f"within {c.breaker_storm_window}s"),
            AlertRule("ws_drop_rate", "warning", c.for_fast,
                      f"ws hub dropping >= {c.ws_drop_limit} msgs/s"),
            AlertRule("arm_flaps", "warning", c.for_slow,
                      f">= {c.arm_flaps} device degrade/arm-failure events "
                      f"within {c.arm_flap_window}s"),
            AlertRule("stuck_height", "critical", 0.0,
                      "block height stopped moving for "
                      f"{c.stuck_height_deadline}s after having moved"),
            AlertRule("slo_burn_fast", "critical", 0.0,
                      f"route error-budget burn >= {c.fast_burn}x over both "
                      "fast windows (page)"),
            AlertRule("slo_burn_slow", "warning", 0.0,
                      f"route error-budget burn >= {c.slow_burn}x over both "
                      "slow windows (ticket)"),
        ]
        return {r.name: r for r in rules}

    @property
    def rules(self) -> Dict[str, AlertRule]:
        return dict(self._rules)

    @property
    def alerts(self) -> AlertManager:
        return self._mgr

    def register_probe(self, name: str, fn: Callable) -> None:
        """Register a live gauge source; ``fn`` may be sync or async."""
        self._probes[name] = fn

    # ------------------------------------------------------ evaluation ---

    async def run(self) -> None:
        """Cadence loop for the node's background task set."""
        while True:
            await asyncio.sleep(self.cfg.interval)
            try:
                await self.evaluate_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the sentry must outlive any single bad tick
                self.eval_errors += 1
                log.exception("watchtower evaluation failed")

    async def _read_probes(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, fn in self._probes.items():
            try:
                v = fn()
                if inspect.isawaitable(v):
                    v = await v
                out[name] = float(v)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a dead probe degrades one rule, never the engine
                self.probe_errors += 1
                log.debug("watchtower probe %s failed: %s", name, e)
        return out

    async def evaluate_once(self, now: Optional[float] = None) -> dict:
        """One evaluation tick; ``now`` injectable for determinism."""
        if now is None:
            now = time.time()
        t0 = time.monotonic()
        self.evaluations += 1
        probes = await self._read_probes()
        counters = self._metrics.counters()
        self._consume_events(now)
        self._eval_streaming(now, probes, counters)
        self._eval_burnrate(now, counters)
        self._last_eval_ts = now
        self._last_lag = time.monotonic() - t0
        return self._mgr.counts(now)

    def _consume_events(self, now: float) -> None:
        got = self._events.since(self._cursor)
        self._cursor = got["next_seq"]
        if got["missed"]:
            self._metrics.inc(ROTATED_UNSEEN, got["missed"])
        for e in got["events"]:
            kind = e.get("kind")
            if kind == "breaker" and e.get("state") == "open":
                self._breaker_opens.append((e["ts"], e.get("trace_id")))
            elif kind in _ARM_FLAP_KINDS:
                self._arm_flaps.append((e["ts"], e.get("trace_id")))
        _prune(self._breaker_opens, now - self.cfg.breaker_storm_window)
        _prune(self._arm_flaps, now - self.cfg.arm_flap_window)

    def _eval_streaming(self, now: float, probes: Dict[str, float],
                        counters: Dict[str, int]) -> None:
        c = self.cfg
        mgr, rules = self._mgr, self._rules

        # verify throughput collapse: counter -> rate -> z-score drop
        rate = self._verify_rate.update(
            now, float(counters.get("pipeline.front.submissions", 0)))
        if rate is not None:
            r = self._verify_z.update(rate)
            collapsed = (r["fire"] and r["mean"] >= c.verify_min_rate
                         and rate <= 0.5 * r["mean"])
            mgr.observe(rules["verify_throughput_collapse"], collapsed,
                        now, value=rate, fields={"z": round(r["z"], 3)})

        # mempool depth spike
        if "mempool_depth" in probes:
            r = self._mempool_spike.update(probes["mempool_depth"])
            mgr.observe(rules["mempool_depth_spike"], r["fire"], now,
                        value=probes["mempool_depth"],
                        fields={"baseline": round(r["baseline"], 3)})

        # sync lag threshold
        if "sync_lag" in probes:
            mgr.observe(rules["sync_lag"],
                        probes["sync_lag"] >= c.sync_lag_limit,
                        now, value=probes["sync_lag"])

        # breaker flip storm (event window); exemplars are the trace ids
        # the breaker transitions fired under — i.e. the guilty requests
        opens = len(self._breaker_opens)
        exemplars = [tid for _, tid in self._breaker_opens if tid]
        mgr.observe(rules["breaker_flip_storm"],
                    opens >= c.breaker_storm_opens, now,
                    value=float(opens), exemplars=exemplars[-4:])

        # ws drop rate
        if "ws_dropped" in probes:
            wrate = self._ws_rate.update(now, probes["ws_dropped"])
            if wrate is not None:
                mgr.observe(rules["ws_drop_rate"],
                            wrate >= c.ws_drop_limit, now, value=wrate)

        # device arm flaps (event window)
        flaps = len(self._arm_flaps)
        mgr.observe(rules["arm_flaps"], flaps >= c.arm_flaps, now,
                    value=float(flaps),
                    exemplars=[t for _, t in self._arm_flaps if t][-4:])

        # stuck block height
        if "block_height" in probes:
            stuck = self._stuck_height.update(now, probes["block_height"])
            mgr.observe(rules["stuck_height"], stuck, now,
                        value=probes["block_height"])

    def _eval_burnrate(self, now: float, counters: Dict[str, int]) -> None:
        counts = {}
        for name, v in counters.items():
            if name.startswith(_SLO_PREFIX) and name.endswith(".requests"):
                route = name[len(_SLO_PREFIX):-len(".requests")]
                err = counters.get(_SLO_PREFIX + route + ".errors", 0)
                counts[route] = (float(v), float(err))
        self._burn.record(now, counts)
        self._last_burn = self._burn.evaluate(now)
        for route, res in self._last_burn.items():
            ex = self._route_exemplars(route)
            self._mgr.observe(
                self._rules["slo_burn_fast"], res["page"], now,
                value=res["fast_short"], exemplars=ex,
                fields={"route": route}, key=f"slo_burn_fast:{route}")
            self._mgr.observe(
                self._rules["slo_burn_slow"], res["ticket"], now,
                value=res["slow_short"], exemplars=ex,
                fields={"route": route}, key=f"slo_burn_slow:{route}")

    def _route_exemplars(self, route: str) -> List[str]:
        """Trace ids of the slowest/erroring requests for ``route`` from
        the tracing slowest-ring (erroring first, then slowest)."""
        try:
            slowest = self._traces.snapshot().get("slowest", [])
        except Exception as e:
            log.debug("exemplar lookup failed: %s", e)  # best-effort
            return []
        hits = []
        for t in slowest:
            nm = t.get("name", "")
            if not nm.startswith("http."):
                continue
            if nm[len("http."):].replace("/", "_") != route:
                continue
            tid = t.get("trace_id")
            if tid:
                hits.append((bool(t.get("error")),
                             t.get("duration_ms", 0.0), tid))
        hits.sort(key=lambda h: (not h[0], -h[1]))
        out = []
        for _, _, tid in hits:
            if tid not in out:
                out.append(tid)
        return out[:4]

    # -------------------------------------------------------- emission ---

    def _on_transition(self, state: str, alert) -> None:
        exemplar = alert.exemplars[0] if alert.exemplars else None
        self._events.emit(
            "alert", rule=alert.rule.name, state=state,
            severity=alert.rule.severity, key=alert.key,
            value=alert.value, exemplar=exemplar, node=self.name)
        if state == "firing":
            if self.cfg.bench_events:
                benchlog.record(self.cfg.bench_events, alert)
            for cb in self.on_fire:
                try:
                    cb(alert)
                except Exception:
                    # observer bugs must not break alerting
                    log.exception("on_fire callback failed")

    # --------------------------------------------------- introspection ---

    def silence(self, key: str, seconds: float,
                now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        self._mgr.silence(key, now + max(0.0, seconds))

    def ack(self, key: str) -> bool:
        return self._mgr.ack(key)

    def stats(self) -> dict:
        return {
            "evaluations": self.evaluations,
            "eval_errors": self.eval_errors,
            "probe_errors": self.probe_errors,
            "fired_total": self._mgr.fired_total,
            "resolved_total": self._mgr.resolved_total,
            "eval_lag_seconds": round(self._last_lag, 6),
        }

    def metric_rows(self, now: Optional[float] = None) -> dict:
        """The upow_alert_* family values for /metrics."""
        now = time.time() if now is None else now
        c = self._mgr.counts(now)
        return {
            "firing": c["firing"], "pending": c["pending"],
            "silenced": c["silenced"],
            "firing_with_exemplars": c["firing_with_exemplars"],
            "evaluations": self.evaluations,
            "fired_total": self._mgr.fired_total,
            "resolved_total": self._mgr.resolved_total,
            "eval_lag_seconds": self._last_lag,
        }

    def snapshot(self, now: Optional[float] = None) -> dict:
        """/debug/alerts payload."""
        now = time.time() if now is None else now
        return {
            "node": self.name,
            "interval": self.cfg.interval,
            "counts": self._mgr.counts(now),
            "stats": self.stats(),
            "rules": [{"name": r.name, "severity": r.severity,
                       "for_s": r.for_s, "description": r.description}
                      for r in self._rules.values()],
            "active": [a.to_dict() for a in self._mgr.active()],
            "history": self._mgr.history(),
            "burnrate": self._last_burn,
        }


def _prune(dq: deque, cutoff: float) -> None:
    while dq and dq[0][0] < cutoff:
        dq.popleft()
