"""CLI entry: run one scenario or the whole matrix, emit the artifact.

    python -m upow_tpu_torch.swarm --scenario partition_heal --nodes 10
    python -m upow_tpu_torch.swarm --matrix fast --out swarm.json

Exit status is non-zero when any scenario's core assertions failed
(a core flag came back False), so CI can gate on the run directly.  The
port's copy of the JAX package's ``swarm/__main__.py``; ``--device``
picks where the nodes run (``cuda`` by default, raising without a card;
``cpu`` the plain versions on the host).
"""

from __future__ import annotations

import argparse
import json
import sys

from .scenarios import SCENARIOS, run_matrix, run_scenario


def _core_ok(core: dict) -> bool:
    """Every boolean in core is an assertion; False means the scenario
    observed a violation the asserts upstream didn't already raise on."""
    return all(v for v in core.values() if isinstance(v, bool))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.swarm",
        description="deterministic multi-node swarm scenarios")
    parser.add_argument("--scenario", choices=sorted(SCENARIOS),
                        help="run one scenario")
    parser.add_argument("--matrix", choices=("fast", "all"),
                        help="run every (fast) scenario")
    parser.add_argument("--nodes", type=int, default=None,
                        help="override the scenario's default swarm size")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--out", help="write the JSON artifact here")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the swarm's nodes run (default cuda)")
    args = parser.parse_args(argv)
    if bool(args.scenario) == bool(args.matrix):
        parser.error("pass exactly one of --scenario / --matrix")

    if args.scenario:
        artifact = run_scenario(args.scenario, nodes=args.nodes,
                                seed=args.seed, device=args.device)
        runs = [artifact]
    else:
        artifact = run_matrix(args.matrix, seed=args.seed,
                              device=args.device)
        runs = artifact["runs"]

    if args.out:
        from ..loadgen.observatory import write_artifact

        write_artifact(artifact, args.out)

    ok = True
    for run in runs:
        good = _core_ok(run["core"])
        ok = ok and good
        print(f"{'ok  ' if good else 'FAIL'} {run['scenario']:>16} "
              f"n={run['nodes']} seed={run['seed']} "
              f"{run['observed']['elapsed_s']:.2f}s "
              f"fp={run['fingerprint'][:16]}")
    print(json.dumps({"kind": artifact["kind"],
                      "fingerprint": artifact["fingerprint"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
