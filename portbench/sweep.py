"""The wallets' knee, found once on the card by a sweep of offered rates.

``python3 -m portbench.sweep --rates 100,200,400 --seconds 20`` runs the
``solo_miner.wallets`` cell at each rate (its configuration and mix,
with the rate replaced) and prints, a line a rate, what was offered in
the window, what completed in it, the admission latency's median and
95th percentile and how the backlog moved.  The knee is the highest
rate whose completions keep up with its offers with no growing backlog;
the cell's data file offers four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
from pathlib import Path

from . import registry, wallets
from .tests import cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2**35 + 1)
    args = ap.parse_args(argv)
    cell = next(w for w in cells.bench()["workloads"]
                if w["name"] == "solo_miner.wallets")
    mix = registry.traffic(cell["traffic"])
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(mix, rate=rate)
        with tempfile.TemporaryDirectory(dir=cells.ROOT / ".portbench") as d:
            result, obs = cells.run_cell(
                Path(d), cell["config"], {}, mix, args.seconds, args.seed,
                "cuda", name="solo_miner.wallets")
        reqs = obs.extra["sender"]
        start = obs.extra["start_at"]
        due = [r for r in reqs if obs.t0 <= start + r.due <= obs.t1]
        done = [r for r in reqs if r.done is not None and obs.t0 <= r.done <= obs.t1]
        half = obs.t0 + args.seconds / 2
        lat1 = [v for r, v in zip(due, wallets.latencies(due, start, obs.t0, obs.t1))
                if start + r.due < half]
        lat2 = [v for r, v in zip(due, wallets.latencies(due, start, obs.t0, obs.t1))
                if start + r.due >= half]
        print(json.dumps({
            "rate": rate, "offered_per_s": len(due) / args.seconds,
            "completed_per_s": len(done) / args.seconds,
            "p95_ms_first_half": _ms(wallets.p95(lat1)),
            "p95_ms_second_half": _ms(wallets.p95(lat2)),
            "late": obs.extra["wallets"]["late"],
            "correct": result["correct"], "checks": result["checks"]}),
            flush=True)
    return 0


def _ms(v):
    return None if v is None or not math.isfinite(v) else 1000.0 * v


if __name__ == "__main__":
    raise SystemExit(main())
