"""One run of one cell: ``python -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; the configuration names the driver (``kind``: the module
``portbench/drivers/<kind>.py`` and its ``run``) that sets the system
up, holds the window and gathers what the reference judges.  The
run prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number the reference compared, with its limit.  The same numbers
end its standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from . import card, guard, registry
from .reference import Check

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Run:
    root: Path
    work: Path
    workload: str
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str                    # "cuda"; the tests drive "cpu"
    t_entry: float
    sampler: card.Sampler
    sm_count: int = 0


@dataclass
class Obs:
    """What a run observed: the window, the end-to-end numbers, the
    reference's checks, and what the per-layer readers read."""

    t0: float = 0.0                # the window on the monotonic clock
    t1: float = 0.0
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Check] = field(default_factory=dict)
    prof: Optional[Tuple[float, float]] = None   # traced span, epoch s
    traces: Dict[str, list] = field(default_factory=dict)
    scrapes: Dict[str, Tuple[dict, dict]] = field(default_factory=dict)
    card: dict = field(default_factory=dict)
    extra: Dict[str, object] = field(default_factory=dict)


def driver(kind: str) -> Callable[[Run], Obs]:
    """The ``run`` of ``portbench/drivers/<kind>.py``."""
    if not registry.NAME.match(kind):
        raise ValueError(f"bad driver kind {kind!r}")
    return importlib.import_module(f"portbench.drivers.{kind}").run


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def per_layer_values(bench: dict, workload: str, obs: Obs,
                     base: Optional[Path] = None) -> Dict[str, dict]:
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, workload):
            continue
        value = registry.metric_reader(m["name"], base).read(obs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, run: Run, obs: Obs, device: dict) -> dict:
    if run.trace:
        metrics = per_layer_values(bench, run.workload, obs)
    else:
        metrics = {m["name"]: {"value": obs.e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if applies(m, run.workload) and m["name"] in obs.e2e}
    out = {"correct": all(c.ok for c in obs.checks.values()) and bool(obs.checks),
           "attempted": obs.attempted, "failed": obs.failed,
           "metrics": metrics, "device": device}
    if run.trace and "breakdown" in obs.extra:
        out["breakdown"] = obs.extra["breakdown"]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in obs.checks.values()}
    return out


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(root: Path, args, device: str, t_entry: float,
            bench: dict, base: Optional[Path] = None) -> Run:
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    work = root / ".portbench" / "work" / args.workload
    shutil.rmtree(work, ignore_errors=True)
    (work / "logs").mkdir(parents=True)
    return Run(root, work, args.workload, cell,
               registry.config(cell["config"], base),
               registry.traffic(cell["traffic"], base), args.seed, args.seconds,
               bool(args.trace), device, t_entry, card.Sampler())


def execute(run: Run, bench: dict, device_info: dict) -> Tuple[dict, Obs]:
    obs = driver(run.cfg["kind"])(run)
    device_info = dict(device_info)
    device_info["memory_peak_bytes"] = obs.card.get("memory_used_bytes_max") or 0
    if run.trace:
        device_info["busy_s"] = obs.extra.get("busy_s", 0.0)
        device_info["window_s"] = obs.extra.get("window_s", 0.0)
    return result_line(bench, run, obs, device_info), obs


def main(argv=None) -> int:
    t_entry = time.monotonic()
    args = parse_args(argv)
    bench_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "upow_tpu_torch" / "__init__.py").exists():
        print("portbench: the program (upow_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    with open(bench_path) as f:
        bench = json.load(f)
    run = prepare(ROOT, args, "cuda", t_entry, bench)
    try:
        device_info = card.require(run.cell["chips"])
    except card.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    import torch

    run.sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    run.sampler.start()
    try:
        result, obs = execute(run, bench, device_info)
    finally:
        run.sampler.stop()
    return report(result, obs)


def forbidden_modules(obs: Obs) -> Dict[str, object]:
    """What each process held of JAX or the JAX package once the window
    had closed: this one's ``sys.modules``, and what the node and the
    miner reported (None where a process did not report)."""
    found = {"harness": guard.loaded_forbidden()}
    found.update(obs.extra.get("modules", {}))
    return {name: mods for name, mods in found.items() if mods != []}


def report(result: dict, obs: Obs) -> int:
    """Print the checks and the result line, or, where a process held
    JAX or the JAX package or did not report, name it and exit 4."""
    found = forbidden_modules(obs)
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded, or "
              f"a process did not report them: {found}", file=sys.stderr)
        return 4
    print(f"card: {json.dumps(obs.card, sort_keys=True)}", file=sys.stderr)
    for c in obs.checks.values():
        for note in c.notes:
            print(f"  {c.name}: {note}", file=sys.stderr)
    for c in obs.checks.values():
        print(f"check {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
