"""What the drivers share: the miner process, the warm-up, the window's
close, the traced window's captures and what is read from them."""

from __future__ import annotations

import json
import os
import sys
import time
from decimal import Decimal
from typing import Dict, List, Optional

from .. import minerlog, procs, reference, sha, tracefile
from ..harness import Obs, Run

#: seconds a first run in a fresh checkout may spend building kernels
BUILD_GRACE = 900.0
B2_KERNEL = "sha256_search_kernel"


def start_miner(run: Run, address: str, node_url: str,
                variant: str = "") -> procs.Proc:
    env = procs.base_env(run.root, run.work)
    # no supervisor: the shim's process is the miner (miner.py's child)
    env["UPOW_MINER_CHILD"] = "1"
    if run.trace:
        (run.work / "profile").mkdir(exist_ok=True)
        env["PORTBENCH_PROFILE_DIR"] = str(run.work / "profile")
    if variant:
        env["PORTBENCH_VARIANT"] = variant
    env["PORTBENCH_CLOSE"] = str(procs.close_path(run.work))
    # the configuration's search device; the tests' host runs the host's
    device = run.cfg.get("miner_device", "cuda") if run.device == "cuda" \
        else run.device
    argv = [sys.executable, "-m", "portbench.miner_shim", address,
            "--node", node_url, "--device", device,
            "--batch", str(run.cfg["miner_batch"])]
    return procs.Proc("miner", argv, env, run.work)


def close_window(obs: Obs, run: Run, miner: procs.Proc,
                 others: Dict[str, procs.Proc],
                 timeout: float = 120.0) -> dict:
    """Tell the processes that the window has closed: each reports the
    forbidden modules it holds (``obs.extra["modules"]``, None for one
    that did not report), and the miner mines a seeded sample of the
    window's rounds again at a lower difficulty.  Returns that plan."""
    log = minerlog.parse(list(miner.lines), run.cfg["miner_batch"])
    plan = reference.plan_rechecks(log, obs.t0, obs.t1,
                                   run.cfg["miner_batch"],
                                   run.cfg["reference_rounds"], run.seed)
    path = procs.close_path(run.work)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(plan))
    os.replace(tmp, path)
    watched = dict(others, miner=miner)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reported = {name: _modules(p) for name, p in watched.items()}
        if all(m is not None for m in reported.values()) and \
                any(line == "portbench-closed" for _t, line in list(miner.lines)):
            break
        if not all(p.alive() for p in watched.values()):
            break
        time.sleep(0.05)
    obs.extra["modules"] = {name: _modules(p) for name, p in watched.items()}
    return plan


def _modules(proc: procs.Proc) -> Optional[List[str]]:
    for _t, line in list(proc.lines):
        if line.startswith("portbench-modules "):
            return json.loads(line.split(" ", 1)[1])
    return None


def wait_templates(miner: procs.Proc, n: int, deadline: float) -> float:
    """Until the miner has begun its ``n``-th template (so the first,
    which loads and warms the kernel, is behind it); the time it began."""
    while time.monotonic() < deadline:
        starts = [t for t, line in list(miner.lines)
                  if line.startswith("portbench-template ")]
        if len(starts) >= n:
            return starts[n - 1]
        if not miner.alive():
            raise RuntimeError(f"miner exited:\n{miner.tail()}")
        time.sleep(0.05)
    raise RuntimeError(f"miner did not reach template {n}:\n{miner.tail()}")


class Captures:
    """The traced window: the miner's capture (files the shim polls) and
    each node's ``/debug/profile``."""

    def __init__(self, run: Run, nodes: Dict[str, str]):
        self.run, self.nodes = run, nodes
        self.dir = run.work / "profile"

    def prime(self) -> None:
        """One capture on each node during set-up, so that the window's
        own start is quick."""
        for url in self.nodes.values():
            procs.get_json(url + "debug/profile?action=start", timeout=120)
            procs.get_json(url + "debug/profile?action=stop", timeout=120)
        for name in self.nodes:
            for f in (self.dir / name).glob("*.json"):
                f.unlink()

    def start(self) -> None:
        (self.dir / "start").touch()
        for url in self.nodes.values():
            procs.get_json(url + "debug/profile?action=start", timeout=60)

    def stop(self) -> None:
        (self.dir / "stop").touch()
        for url in self.nodes.values():
            procs.get_json(url + "debug/profile?action=stop", timeout=120)

    def wait_miner(self, miner: procs.Proc, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and miner.alive():
            if any(line.startswith("portbench-profile stopped")
                   for _t, line in list(miner.lines)):
                return
            time.sleep(0.1)
        raise RuntimeError(f"the miner's capture did not end:\n{miner.tail()}")

    def load(self) -> Dict[str, List[tracefile.Event]]:
        out = {"miner": tracefile.load(self.dir / "miner_trace.json")}
        for name in self.nodes:
            found = sorted((self.dir / name).glob("*.json"))
            if found:
                out[name] = tracefile.load(found[-1])
        return out


def node_env(run: Run, name: str) -> Dict[str, str]:
    if not run.trace:
        return {}
    return {"UPOW_PROFILE_ENABLED": "1",
            "UPOW_PROFILE_TRACE_DIR": str(run.work / "profile" / name)}


def wall(mono: float) -> float:
    """A time of this process's monotonic clock on the wall clock."""
    return mono + (time.time() - time.monotonic())


def miner_marks(lines) -> List[tuple]:
    """What the miner's host did, as (wall-clock time, what): each
    template it fetched and built, each block it pushed."""
    out = []
    for t, line in lines:
        if line.startswith("portbench-template "):
            out.append((wall(t), "miner fetches and builds a template"))
        elif line.startswith("found nonce"):
            out.append((wall(t), "miner pushes a block"))
    return out


def traced(obs: Obs, run: Run, traces: Dict[str, List[tracefile.Event]],
           span: tuple, marks: List[tuple], prefix: bytes, prev_hash: str,
           difficulty: Decimal) -> None:
    """Busy and idle over the traced span (every process's device events
    merged on the wall clock), the breakdown, and B2's numbers."""
    a, b = span
    obs.prof = span
    obs.traces = traces
    dev = [e for ev in traces.values() for e in tracefile.device(ev)]
    obs.extra["busy_s"] = tracefile.busy_seconds(dev, a, b)
    obs.extra["window_s"] = b - a
    obs.extra["breakdown"] = tracefile.breakdown(dev, marks, a, b)
    obs.extra["b2"] = {
        "clocks_per_nonce": sha.clocks_per_nonce(prefix, prev_hash, difficulty),
        "batch": run.cfg["miner_batch"],
        "sm_clock_mhz": obs.card.get("sm_clock_mhz_max"),
        "sm_count": run.sm_count,
        "kernel": B2_KERNEL,
    }


def profile_span(miner_lines) -> Optional[tuple]:
    """The miner's capture as (start, stop) on the wall clock."""
    marks = {}
    for _t, line in miner_lines:
        if line.startswith("portbench-profile "):
            _, what, wall = line.split()
            marks[what] = float(wall)
    if "started" in marks and "stopped" in marks:
        return marks["started"], marks["stopped"]
    return None
