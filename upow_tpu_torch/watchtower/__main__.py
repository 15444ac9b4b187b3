"""CLI entry: alert smoke, the golden units and the storm scenario.

    python -m upow_tpu_torch.watchtower                      # all legs
    python -m upow_tpu_torch.watchtower --units-only         # skip the swarm leg
    python -m upow_tpu_torch.watchtower --check-determinism  # scenario twice, cmp fp

The port's copy of the JAX package's ``watchtower/__main__.py``.  Three
legs, and any failure exits non-zero:

1. **Detector goldens**: hand-built series through the streaming
   detectors (rate, EWMA z-score, stuck gauge, spike) with the exact
   fire points asserted.
2. **Burn-rate worked examples**: the SRE-workbook multi-window pairing
   fed synthetic counter snapshots: a 100% error burst pages the fast
   pair, a slow 0.8% drizzle tickets the slow pair, and a route with no
   traffic is not judged.  Plus the alert state machine: for-duration,
   dedup, resolve, silence expiry.
3. **Scenario**: the ``watchtower_storm`` swarm scenario (injected
   gossip faults must page ``breaker_flip_storm`` with a cross-node
   exemplar trace and a flight-recorder dump whose trigger is the
   alert), on the swarm's ``--device`` (``cuda`` by default, raising
   without a card; ``cpu`` the host); with ``--check-determinism`` it
   runs twice and the core fingerprints must match byte-identically.
"""

from __future__ import annotations

import argparse
import sys

from .alerts import AlertManager, AlertRule
from .burnrate import BurnRateEvaluator
from .detectors import EwmaZScore, RateTracker, SpikeDetector, StuckGauge


def _check(failures: list, cond: bool, label: str) -> None:
    if not cond:
        failures.append(label)


def _detector_goldens() -> list:
    failures: list = []

    r = RateTracker()
    _check(failures, r.update(0.0, 100.0) is None, "rate: first sample")
    _check(failures, r.update(10.0, 150.0) == 5.0, "rate: 50/10s = 5/s")
    _check(failures, r.update(20.0, 40.0) is None, "rate: counter reset")
    _check(failures, r.update(30.0, 60.0) == 2.0, "rate: recovers post-reset")

    z = EwmaZScore(alpha=0.3, z_threshold=6.0, min_samples=8,
                   direction="drop", min_sigma=0.25)
    for _ in range(10):
        out = z.update(10.0)
        _check(failures, not out["fire"], "zscore: steady series quiet")
    out = z.update(0.0)
    _check(failures, out["fire"] and out["z"] <= -6.0,
           "zscore: collapse to 0 fires drop")
    spike_only = EwmaZScore(min_samples=2, direction="spike")
    for v in (5.0, 5.0, 0.0):
        out = spike_only.update(v)
    _check(failures, not out["fire"], "zscore: drop ignored in spike mode")

    g = StuckGauge(deadline_s=60.0)
    _check(failures, not g.update(0.0, 5.0), "stuck: first sample unarmed")
    _check(failures, not g.update(1000.0, 5.0), "stuck: never moved != stuck")
    _check(failures, not g.update(1010.0, 6.0), "stuck: movement arms")
    _check(failures, not g.update(1069.0, 6.0), "stuck: 59s < deadline")
    _check(failures, g.update(1070.0, 6.0), "stuck: 60s hits deadline")
    _check(failures, not g.update(1071.0, 7.0), "stuck: movement resolves")

    s = SpikeDetector(ratio=8.0, floor=100.0, min_samples=4)
    for v in (10.0, 10.0, 10.0, 10.0):
        out = s.update(v)
        _check(failures, not out["fire"], "spike: baseline build quiet")
    _check(failures, not s.update(50.0)["fire"], "spike: 5x under floor")
    _check(failures, s.update(900.0)["fire"], "spike: 8x over floor fires")
    idle = SpikeDetector(ratio=8.0, floor=0.0, min_samples=4)
    for _ in range(6):
        out = idle.update(0.0)
    _check(failures, not out["fire"], "spike: all-zero series quiet")
    return failures


def _burnrate_goldens() -> list:
    failures: list = []
    # window_scale 1/300: fast pair (1s, 12s), slow pair (6s, 72s) —
    # the worked example runs in simulated seconds, same math
    ev = BurnRateEvaluator(slo_target=0.999, window_scale=1.0 / 300.0)
    # 100 req/s clean for 80s, then 50% errors for 13s: both fast
    # windows blow past 14.4x (0.5/0.001 = 500x burn), pages
    req = err = 0.0
    t = 0.0
    for _ in range(80):
        t += 1.0
        req += 100.0
        ev.record(t, {"push_tx": (req, err)})
    res = ev.evaluate(t)["push_tx"]
    _check(failures, res["fast_short"] == 0.0 and not res["page"],
           "burn: clean traffic burns 0")
    _check(failures, res["budget_remaining"] == 1.0,
           "burn: clean budget untouched")
    for _ in range(13):
        t += 1.0
        req += 100.0
        err += 50.0
        ev.record(t, {"push_tx": (req, err)})
    res = ev.evaluate(t)["push_tx"]
    _check(failures, res["page"] and res["fast_short"] >= 14.4
           and res["fast_long"] >= 14.4, "burn: 50% errors page fast pair")
    _check(failures, res["budget_remaining"] is not None
           and res["budget_remaining"] < 0.0,
           "burn: error burst overspends the budget")

    # 0.5% drizzle = 5x burn stays under slow_burn 6.0; a 0.8% drizzle
    # = 8x does ticket while never reaching the 14.4x page line
    ev2 = BurnRateEvaluator(slo_target=0.999, window_scale=1.0 / 300.0)
    req = err = 0.0
    t = 0.0
    for _ in range(80):
        t += 1.0
        req += 1000.0
        err += 8.0
        ev2.record(t, {"sync": (req, err)})
    res = ev2.evaluate(t)["sync"]
    _check(failures, res["ticket"] and not res["page"],
           "burn: 0.8% drizzle tickets, never pages")
    # no traffic inside the window is not an SLO violation
    ev3 = BurnRateEvaluator(slo_target=0.999, window_scale=1.0 / 300.0)
    for tick in range(40):
        ev3.record(float(tick), {"idle": (100.0, 0.0)})
    _check(failures, ev3.burn("idle", 12.0, 39.0) is None,
           "burn: zero traffic in window -> None")
    return failures


def _state_machine_goldens() -> list:
    failures: list = []
    seen: list = []
    mgr = AlertManager(history=8, emit=lambda st, a: seen.append((st, a.key)))
    rule = AlertRule("r", severity="critical", for_s=10.0)

    st = mgr.observe(rule, True, 100.0, value=1.0)
    _check(failures, st is not None and st.state == "pending" and not seen,
           "sm: active goes pending, no emission")
    mgr.observe(rule, True, 109.0)
    _check(failures, mgr.counts(109.0)["firing"] == 0, "sm: 9s < for 10s")
    mgr.observe(rule, True, 110.0, exemplars=["t1", "t1", "t2"])
    c = mgr.counts(110.0)
    _check(failures, c["firing"] == 1 and c["firing_with_exemplars"] == 1
           and seen == [("firing", "r")], "sm: fires at the for-duration")
    _check(failures, mgr.active()[0].exemplars == ["t1", "t2"],
           "sm: exemplars dedup'd")
    _check(failures, mgr.ack("r") and mgr.active()[0].acked, "sm: ack")
    mgr.observe(rule, False, 120.0)
    _check(failures, seen[-1] == ("resolved", "r")
           and mgr.counts(120.0)["firing"] == 0
           and mgr.fired_total == 1 and mgr.resolved_total == 1,
           "sm: inactive resolves")

    # pending that never fired evaporates silently
    mgr.observe(rule, True, 200.0)
    mgr.observe(rule, False, 205.0)
    _check(failures, mgr.resolved_total == 1 and len(mgr.active()) == 0,
           "sm: pending evaporates without resolve")

    # dedup keys: one rule, two routes, independent state
    burn = AlertRule("burn", for_s=0.0)
    mgr.observe(burn, True, 300.0, key="burn:a")
    mgr.observe(burn, True, 300.0, key="burn:b")
    _check(failures, mgr.counts(300.0)["firing"] == 2
           and [a.key for a in mgr.active()] == ["burn:a", "burn:b"],
           "sm: per-key dedup")

    # silence suppresses emission but keeps state; expires on its own
    mgr.silence("burn:a", until=400.0)
    before = len(seen)
    mgr.observe(burn, False, 350.0, key="burn:a")
    _check(failures, len(seen) == before
           and mgr.counts(350.0)["silenced"] == 0,
           "sm: silenced resolve suppressed")
    mgr.silence("burn:b", until=360.0)
    _check(failures, mgr.counts(355.0)["silenced"] == 1
           and mgr.counts(365.0)["silenced"] == 0,
           "sm: silence expires")
    return failures


def _print_scenario(artifact: dict) -> bool:
    from ..swarm.scenarios import core_ok

    core = artifact["core"]
    good = core_ok(core)
    print(f"{'ok  ' if good else 'FAIL'} {artifact['scenario']:>16} "
          f"n={artifact['nodes']} seed={artifact['seed']} "
          f"{artifact['observed']['elapsed_s']:.2f}s "
          f"fp={artifact['fingerprint'][:16]}")
    if not good:
        for key, val in sorted(core.items()):
            if isinstance(val, bool) and not val:
                print(f"     core failed: {key}", file=sys.stderr)
    print(f"     rule={core.get('storm_rule')} "
          f"opens={artifact['observed'].get('breaker_opens_windowed')} "
          f"stitched={artifact['observed'].get('stitched_nodes')} "
          f"recorder={artifact.get('flight_recorder', {}).get('reason')}")
    return good


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.watchtower",
        description="alert smoke: detector/burn-rate/state-machine "
                    "goldens and the watchtower_storm scenario")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--units-only", action="store_true",
                        help="skip the swarm scenario leg")
    parser.add_argument("--check-determinism", action="store_true",
                        help="run the scenario twice with the same seed "
                             "and fail unless the core fingerprints are "
                             "identical")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the scenario's swarm runs "
                             "(default cuda)")
    args = parser.parse_args(argv)

    ok = True
    for label, leg in (("detectors", _detector_goldens),
                       ("burnrate", _burnrate_goldens),
                       ("state-machine", _state_machine_goldens)):
        failures = leg()
        print(f"{'ok  ' if not failures else 'FAIL'} {label} goldens")
        for f in failures:
            print(f"     {f}", file=sys.stderr)
        ok = ok and not failures

    if not args.units_only:
        from ..swarm.scenarios import run_scenario

        artifact = run_scenario("watchtower_storm", seed=args.seed,
                                device=args.device)
        ok = _print_scenario(artifact) and ok
        if args.check_determinism:
            again = run_scenario("watchtower_storm", seed=args.seed,
                                 device=args.device)
            same = again["fingerprint"] == artifact["fingerprint"]
            print(f"{'ok  ' if same else 'FAIL'} determinism "
                  f"fp1={artifact['fingerprint'][:16]} "
                  f"fp2={again['fingerprint'][:16]}")
            ok = ok and same

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
