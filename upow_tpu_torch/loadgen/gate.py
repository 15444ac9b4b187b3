"""Bench regression gate (stdlib only — runs without jax/aiohttp); the
port's copy of the JAX package's ``loadgen/gate.py``.

    python -m upow_tpu_torch.loadgen.gate --against BENCH_r05.json \\
        [--current observatory.json] [--tolerance 0.25] [--report-only]

Flattens both sides into ``{metric: value}`` — understanding the
bench harness's BENCH capture wrapper (``{n, cmd, rc, tail, parsed}``),
bench.py single lines (with nested ``verify`` / ``native_cpu_allcores``
sub-metrics), bench_suite JSON-line streams, and observatory artifacts
(``slo.endpoints`` + ``kernels``) — then compares every metric present
on BOTH sides.

Direction: a metric entry may carry an explicit
``"direction": "higher" | "lower"`` in the artifact (kernel entries and
bench lines), which always wins.  Otherwise direction is inferred from
the name: latency-like metrics (``*_ms``, ``p50/p95/p99``,
``*latency*``, ``*seconds*``) regress upward, throughput metrics
regress downward — name inference is ambiguous for names like
``verify_pipeline_speedup`` vs ``dispatch_seconds``, which is exactly
what the explicit override exists for.  A metric regresses when it is
worse than baseline by more than ``--tolerance`` (relative).

``--metric-tolerance NAME=TOL`` (repeatable) pins an exact flattened
metric name to its own tolerance; ``--enforce SUBSTR`` (repeatable)
promotes matching metrics from report-only to enforced — a regression
on one fails the gate even under ``--report-only`` (how ``make
perf-smoke`` keeps its advisory report while hard-gating the verify
pipeline and resident accept kernels).

``--trend PROGRESS.jsonl`` switches to trend-report mode: every
``perf_observatory`` line in the trajectory file (the harness's records with
other kinds are skipped) becomes one sample per metric, and the report
carries direction-aware per-metric trend lines (first → last, best /
worst, improving / regressing / flat).  Trend mode never fails the
build — it is a trajectory report, not a gate.

Exit codes: 0 ok / report-only / trend, 1 regression(s), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

DEFAULT_TOLERANCE = 0.25

_LOWER_BETTER_TOKENS = ("_ms", "latency", "p50", "p95", "p99",
                        "seconds", "_errors")


def lower_is_better(metric: str) -> bool:
    m = metric.lower()
    return any(tok in m for tok in _LOWER_BETTER_TOKENS)


def _note_direction(directions: Optional[Dict[str, str]], name: str,
                    entry) -> None:
    """Record an entry's explicit ``direction`` field, if present and
    well-formed (anything else keeps name inference)."""
    if directions is None or not isinstance(entry, dict):
        return
    d = entry.get("direction")
    if d in ("higher", "lower"):
        directions[name] = d


def _num(value) -> Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value)


def flatten(doc: dict, prefix: str = "",
            directions: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """Extract comparable metrics from any of the known artifact
    shapes.  Unknown keys are ignored, never guessed at.  When a
    ``directions`` dict is passed, explicit per-metric ``direction``
    fields found in the artifact are collected into it."""
    out: Dict[str, float] = {}
    if not isinstance(doc, dict):
        return out

    # bench capture wrapper: the real content lives under "parsed"
    if isinstance(doc.get("parsed"), dict):
        out.update(flatten(doc["parsed"], prefix, directions))

    # bench.py / bench_suite line: {"metric": ..., "value": ...}
    metric, value = doc.get("metric"), _num(doc.get("value"))
    if isinstance(metric, str) and value is not None:
        out[prefix + metric] = value
        _note_direction(directions, prefix + metric, doc)
    for key in ("verify", "native_cpu_allcores"):
        sub = doc.get(key)
        if isinstance(sub, dict):
            sub_metric = sub.get("metric", key)
            sub_value = _num(sub.get("value"))
            if sub_value is not None:
                out[prefix + str(sub_metric)] = sub_value
                _note_direction(directions, prefix + str(sub_metric), sub)

    # observatory artifact
    slo = doc.get("slo")
    if isinstance(slo, dict):
        for ep, row in (slo.get("endpoints") or {}).items():
            if not isinstance(row, dict):
                continue
            for field in ("req_s", "p50_ms", "p95_ms", "p99_ms"):
                v = _num(row.get(field))
                if v is not None:
                    out[f"{prefix}slo.{ep}.{field}"] = v
    kernels = doc.get("kernels")
    if isinstance(kernels, dict):
        for name, entry in kernels.items():
            if name == "last_good_tpu":
                continue  # stale snapshots must not gate a live run
            v = _num(entry.get("value")) if isinstance(entry, dict) \
                else _num(entry)
            if v is not None:
                out[f"{prefix}kernel.{name}"] = v
                _note_direction(directions, f"{prefix}kernel.{name}", entry)
    return out


def load_metrics(path: str,
                 directions: Optional[Dict[str, str]] = None
                 ) -> Dict[str, float]:
    """Flatten a file that is one JSON document or a JSON-line stream
    (bench_suite output); later lines win on metric collisions."""
    with open(path) as f:
        text = f.read()
    try:
        return flatten(json.loads(text), directions=directions)
    except ValueError:
        out: Dict[str, float] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.update(flatten(json.loads(line), directions=directions))
            except ValueError:
                continue  # interleaved log noise
        return out


def compare(baseline: Dict[str, float], current: Dict[str, float],
            tolerance: float,
            directions: Optional[Dict[str, str]] = None,
            metric_tolerances: Optional[Dict[str, float]] = None
            ) -> List[dict]:
    """Per-common-metric verdicts, regressions first.  ``directions``
    carries the artifacts' explicit per-metric overrides; metrics
    without one fall back to name inference.  ``metric_tolerances``
    maps exact metric names to a tolerance that replaces the global one
    for that metric (``--metric-tolerance NAME=TOL``)."""
    directions = directions or {}
    metric_tolerances = metric_tolerances or {}
    rows = []
    for metric in sorted(set(baseline) & set(current)):
        base, cur = baseline[metric], current[metric]
        tol = metric_tolerances.get(metric, tolerance)
        override = directions.get(metric)
        lower = (override == "lower") if override \
            else lower_is_better(metric)
        if base == 0:
            regressed = lower and cur > 0 and tol < 1
            ratio = None
        else:
            ratio = cur / base
            regressed = (ratio > 1 + tol if lower
                         else ratio < 1 - tol)
        rows.append({"metric": metric, "baseline": base, "current": cur,
                     "ratio": round(ratio, 4) if ratio is not None else None,
                     "direction": "lower" if lower else "higher",
                     "direction_source": "artifact" if override
                     else "inferred",
                     "tolerance": tol,
                     "regressed": regressed})
    rows.sort(key=lambda r: (not r["regressed"], r["metric"]))
    return rows


def _flatten_progress_line(line: dict) -> Dict[str, float]:
    """Flatten one PROGRESS.jsonl ``perf_observatory`` line (its slo
    block is ``{ep: row}`` without the artifact's ``endpoints``
    wrapper, and its kernels are plain values)."""
    out: Dict[str, float] = {}
    for ep, row in (line.get("slo") or {}).items():
        if not isinstance(row, dict):
            continue
        for field in ("req_s", "p50_ms", "p95_ms", "p99_ms"):
            v = _num(row.get(field))
            if v is not None:
                out[f"slo.{ep}.{field}"] = v
    for name, value in (line.get("kernels") or {}).items():
        if name == "last_good_tpu":
            continue
        v = _num(value)
        if v is not None:
            out[f"kernel.{name}"] = v
    return out


def trend_report(path: str) -> dict:
    """Direction-aware per-metric trajectory over a PROGRESS.jsonl
    history.  Non-observatory lines (the bench harness's records share the
    file) are skipped by ``kind``."""
    samples: List[Dict[str, float]] = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            try:
                line = json.loads(raw)
            except ValueError:
                continue  # interleaved log noise
            if not isinstance(line, dict) \
                    or line.get("kind") != "perf_observatory":
                continue
            flat = _flatten_progress_line(line)
            if flat:
                samples.append(flat)

    series: Dict[str, List[float]] = {}
    for flat in samples:
        for metric, value in flat.items():
            series.setdefault(metric, []).append(value)

    rows = []
    for metric in sorted(series):
        vals = series[metric]
        first, last = vals[0], vals[-1]
        lower = lower_is_better(metric)
        if first == 0:
            change_pct = None
            verdict = "flat" if last == 0 else (
                "regressing" if lower else "improving")
        else:
            change = (last - first) / abs(first)
            change_pct = round(change * 100.0, 2)
            if abs(change) < 0.02:
                verdict = "flat"
            elif (change > 0) != lower:
                verdict = "improving"
            else:
                verdict = "regressing"
        rows.append({
            "metric": metric,
            "samples": len(vals),
            "first": first, "last": last,
            "best": min(vals) if lower else max(vals),
            "worst": max(vals) if lower else min(vals),
            "direction": "lower" if lower else "higher",
            "change_pct": change_pct,
            "trend": verdict,
        })
    order = {"regressing": 0, "flat": 1, "improving": 2}
    rows.sort(key=lambda r: (order[r["trend"]], r["metric"]))
    return {"kind": "trend_report", "progress": path,
            "observatory_lines": len(samples), "metrics": rows}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.loadgen.gate",
        description="Fail when a metric regresses beyond tolerance.")
    ap.add_argument("--against",
                    help="baseline artifact (BENCH_r*.json, bench_suite "
                         "stream, or observatory.json)")
    ap.add_argument("--trend", metavar="PROGRESS_JSONL",
                    help="report per-metric trend lines over a "
                         "PROGRESS.jsonl history instead of gating "
                         "(always exits 0)")
    ap.add_argument("--current", default="observatory.json",
                    help="current artifact (default: observatory.json)")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="relative band before a worse value fails "
                         f"(default {DEFAULT_TOLERANCE})")
    ap.add_argument("--report-only", action="store_true",
                    help="print verdicts but always exit 0 (except for "
                         "--enforce'd metrics)")
    ap.add_argument("--metric-tolerance", action="append", default=[],
                    metavar="NAME=TOL",
                    help="per-metric tolerance overriding --tolerance "
                         "(exact flattened name, repeatable)")
    ap.add_argument("--enforce", action="append", default=[],
                    metavar="SUBSTR",
                    help="metrics whose flattened name contains SUBSTR "
                         "fail the gate even under --report-only "
                         "(repeatable)")
    args = ap.parse_args(argv)

    if args.trend:
        try:
            report = trend_report(args.trend)
        except OSError as e:
            print(f"gate: cannot read progress file: {e}",
                  file=sys.stderr)
            return 2
        print(json.dumps(report, indent=1, sort_keys=True))
        for r in report["metrics"]:
            if r["trend"] != "flat":
                pct = f"{r['change_pct']:+}%" \
                    if r["change_pct"] is not None else "n/a"
                print(f"trend: {r['trend']:>10} {r['metric']} "
                      f"{r['first']} -> {r['last']} ({pct}, "
                      f"{r['direction']} is better)", file=sys.stderr)
        return 0

    if not args.against:
        ap.error("--against is required (unless --trend)")

    metric_tolerances: Dict[str, float] = {}
    for spec in args.metric_tolerance:
        name, sep, tol = spec.partition("=")
        if not sep or not name:
            print(f"gate: bad --metric-tolerance {spec!r} "
                  "(want NAME=TOL)", file=sys.stderr)
            return 2
        try:
            metric_tolerances[name] = float(tol)
        except ValueError:
            print(f"gate: bad --metric-tolerance value {tol!r}",
                  file=sys.stderr)
            return 2

    # direction overrides merge across both artifacts; the current one
    # wins (it carries the newest metadata for renamed/retyped metrics)
    directions: Dict[str, str] = {}
    try:
        baseline = load_metrics(args.against, directions)
        current = load_metrics(args.current, directions)
    except OSError as e:
        print(f"gate: cannot read artifact: {e}", file=sys.stderr)
        return 2
    if not baseline or not current:
        print("gate: no metrics found in "
              + (args.against if not baseline else args.current),
              file=sys.stderr)
        return 2

    rows = compare(baseline, current, args.tolerance, directions,
                   metric_tolerances)
    regressions = [r for r in rows if r["regressed"]]
    enforced = [r for r in regressions
                if any(s in r["metric"] for s in args.enforce)]
    report = {
        "against": args.against, "current": args.current,
        "tolerance": args.tolerance,
        "metric_tolerances": metric_tolerances,
        "enforce": args.enforce,
        "compared": len(rows), "regressions": len(regressions),
        "enforced_regressions": len(enforced),
        "verdicts": rows,
    }
    print(json.dumps(report, indent=1, sort_keys=True))
    if not rows:
        print("gate: WARNING no overlapping metrics between artifacts",
              file=sys.stderr)
        return 0
    failing = enforced if args.report_only else regressions
    if failing:
        for r in failing:
            print(f"gate: REGRESSION {r['metric']}: "
                  f"{r['baseline']} -> {r['current']} "
                  f"({r['direction']} is better, tol {r['tolerance']})"
                  + (" [enforced]" if r in enforced else ""),
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
