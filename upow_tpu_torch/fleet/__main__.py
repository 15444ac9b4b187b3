"""CLI entry: run the geo-soak, print the fleet view, gate or merge.

    python -m upow_tpu_torch.fleet                          # geo-soak, print rows
    python -m upow_tpu_torch.fleet --check-determinism      # two runs, compare fp
    python -m upow_tpu_torch.fleet --merge-observatory observatory.json
    python -m upow_tpu_torch.fleet --out fleet.json --trace

Exit status is non-zero when a core assertion failed, the stitched
push_tx trace did not cross three nodes, or (under
``--check-determinism``) the two same-seed fingerprints differ — so
CI's ``fleet-smoke`` job can gate on the run directly.  The port's copy
of the JAX package's ``fleet/__main__.py``; ``--device`` picks where the
swarm runs (``cuda`` by default, raising without a card; ``cpu`` the
plain versions on the host).
"""

from __future__ import annotations

import argparse
import json
import sys

from .geosoak import (GEO_NODES, GEO_SEED, fleet_rows, merge_into_observatory,
                      run_geo_artifact)


def _core_ok(core: dict) -> bool:
    return all(v for v in core.values() if isinstance(v, bool))


def _print_run(artifact: dict) -> bool:
    core = artifact["core"]
    good = _core_ok(core)
    print(f"{'ok  ' if good else 'FAIL'} {artifact['scenario']:>16} "
          f"n={artifact['nodes']} seed={artifact['seed']} "
          f"{artifact['observed']['elapsed_s']:.2f}s "
          f"fp={artifact['fingerprint'][:16]}")
    if not good:
        for key, val in sorted(core.items()):
            if isinstance(val, bool) and not val:
                print(f"     core failed: {key}", file=sys.stderr)
    return good


def _print_propagation(artifact: dict) -> None:
    prop = artifact["observed"].get("propagation") or {}
    for family in ("blocks", "txs"):
        row = prop.get(family)
        if not row:
            continue
        print(f"     {family:>6}: hashes={row['hashes']} "
              f"covered={row['covered']} "
              f"p50={row['p50_ms']}ms p95={row['p95_ms']}ms "
              f"p99={row['p99_ms']}ms")


def _print_trace(artifact: dict) -> None:
    stitched = artifact["observed"].get("stitched_push_tx")
    if not stitched:
        print("     no stitched push_tx trace", file=sys.stderr)
        return
    print(f"     trace {stitched['trace_id'][:16]} crossed "
          f"{stitched['node_count']} nodes in "
          f"{stitched['duration_ms']}ms:")
    for hop in stitched["hops"]:
        print(f"       {hop['node']:>8} {hop['name']:<28} "
              f"{hop['duration_ms']}ms spans={hop['spans']}"
              + (" ERROR" if hop.get("error") else ""))
    for edge in stitched["hop_latencies_ms"]:
        print(f"       edge {edge['from']} -> {edge['to']}: "
              f"{edge['latency_ms']}ms")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.fleet",
        description="fleet observatory: deterministic geo-soak, "
                    "propagation percentiles, stitched traces")
    parser.add_argument("--nodes", type=int, default=GEO_NODES,
                        help=f"swarm size (default {GEO_NODES})")
    parser.add_argument("--seed", type=int, default=GEO_SEED)
    parser.add_argument("--out", help="write the JSON artifact here")
    parser.add_argument("--trace", action="store_true",
                        help="print the stitched push_tx fleet trace")
    parser.add_argument("--check-determinism", action="store_true",
                        help="run twice with the same seed and fail "
                             "unless the core fingerprints are identical")
    parser.add_argument("--merge-observatory", metavar="PATH",
                        help="merge the fleet kernel/SLO rows into an "
                             "existing observatory artifact (the "
                             "perf-smoke baseline)")
    parser.add_argument("--gate-against", metavar="PATH",
                        help="after the run, gate the fleet rows "
                             "against this observatory baseline "
                             "(fleet_core_ok enforced, propagation "
                             "quantiles report-only)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the swarm's nodes run (default cuda)")
    args = parser.parse_args(argv)

    if args.merge_observatory:
        merged = merge_into_observatory(args.merge_observatory,
                                        nodes=args.nodes, seed=args.seed,
                                        device=args.device)
        fleet = merged["section"]
        good = bool(fleet["core_ok"])
        print(f"{'ok  ' if good else 'FAIL'} merged fleet rows into "
              f"{args.merge_observatory} "
              f"(fp={fleet['fingerprint'][:16]})")
        return 0 if good else 1

    artifact = run_geo_artifact(nodes=args.nodes, seed=args.seed,
                                device=args.device)
    ok = _print_run(artifact)
    _print_propagation(artifact)
    if args.trace:
        _print_trace(artifact)

    stitched = artifact["observed"].get("stitched_push_tx") or {}
    if (stitched.get("node_count") or 0) < 3:
        print("fleet: stitched push_tx trace crossed "
              f"{stitched.get('node_count', 0)} nodes (< 3)",
              file=sys.stderr)
        ok = False

    if args.check_determinism:
        again = run_geo_artifact(nodes=args.nodes, seed=args.seed,
                                 device=args.device)
        if again["fingerprint"] != artifact["fingerprint"]:
            print("fleet: DETERMINISM BROKEN "
                  f"{artifact['fingerprint'][:16]} != "
                  f"{again['fingerprint'][:16]}", file=sys.stderr)
            ok = False
        else:
            print(f"ok   determinism: fp={artifact['fingerprint'][:16]} "
                  "reproduced")

    if args.out:
        from ..loadgen.observatory import write_artifact

        write_artifact(artifact, args.out)

    rows = fleet_rows(artifact)
    print(json.dumps({"kind": "fleet_observatory",
                      "fingerprint": artifact["fingerprint"],
                      "kernels": {k: v["value"]
                                  for k, v in rows["kernels"].items()}},
                     sort_keys=True))

    if args.gate_against:
        import os
        import tempfile

        from ..loadgen import gate

        # shape the fleet rows like an observatory artifact so
        # gate.flatten compares them against the committed baseline
        current = {"kernels": rows["kernels"],
                   "slo": {"endpoints": rows["slo_endpoints"]}}
        fd, tmp = tempfile.mkstemp(prefix="fleet-gate-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(current, f)
            rc = gate.main([
                "--against", args.gate_against, "--current", tmp,
                "--report-only",
                "--enforce", "kernel.fleet_core_ok",
                # wall-clock quantiles on shared CI hosts are noisy;
                # the correctness trip is fleet_core_ok's zeroing,
                # which defeats any tolerance
                "--metric-tolerance", "kernel.fleet_block_prop_p50_ms=3.0",
                "--metric-tolerance", "kernel.fleet_block_prop_p95_ms=3.0",
                "--metric-tolerance", "kernel.fleet_tx_prop_p50_ms=3.0",
                "--metric-tolerance", "kernel.fleet_tx_prop_p95_ms=3.0",
            ])
        finally:
            os.unlink(tmp)
        ok = ok and rc == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
