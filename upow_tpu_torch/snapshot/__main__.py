"""CLI entry: snapshot smoke — round-trip plus the churn scenario.

    python -m upow_tpu_torch.snapshot                     # round-trip + scenario
    python -m upow_tpu_torch.snapshot --check-determinism # scenario twice, cmp fp
    python -m upow_tpu_torch.snapshot --round-trip-only   # skip the swarm scenario

The round-trip boots a two-node loopback swarm, mines a short chain,
publishes a snapshot on node 0, onboards blank node 1 from it, and
requires byte-exact UTXO + full-state fingerprints on the restored
node plus generation rotation (two builds at different heights keep
only ``SnapshotConfig.keep`` generations on disk).  The scenario half
runs ``snapshot_churn`` (docs/SWARM.md): corruption, mid-transfer
partition, journaled resume, replay fallback.  Exit status is
non-zero when any check fails — CI's ``snapshot-smoke`` job gates on
the run directly.  The port's copy of the JAX package's
``snapshot/__main__.py``; ``--device`` picks where the swarms run
(``cuda`` by default, raising without a card; ``cpu`` the host).
"""

from __future__ import annotations

import argparse
import asyncio
import os
import shutil
import sys
import tempfile

from ..swarm.harness import Swarm
from ..swarm.scenarios import (_wallet, core_ok, deterministic_world,
                               run_scenario)
from . import layout


async def _drive_round_trip(seed: int, tmp: str, device=None) -> list:
    failures = []
    swarm = await Swarm(2, seed=seed, device=device).start(
        topology="isolated")
    try:
        _, addr = _wallet(seed, "shared")
        for i in (0, 1):
            scfg = swarm.nodes[i].config.snapshot
            scfg.dir = os.path.join(tmp, f"n{i}")
            scfg.chunk_bytes = 1024
            scfg.blocks_tail = 4
        for _ in range(8):
            assert (await swarm.mine(0, addr, push_to=[0]))["ok"]
        manifest = await swarm.nodes[0].build_snapshot()
        if manifest is None:
            return ["build returned no manifest"]
        res = await swarm.nodes[1].bootstrap_from_snapshot(
            sources=[swarm.urls[0]])
        if not (res.get("ok") and res.get("method") == "snapshot"):
            failures.append(f"restore failed: {res}")
        fp0 = await swarm.nodes[0].state.get_unspent_outputs_hash()
        fp1 = await swarm.nodes[1].state.get_unspent_outputs_hash()
        full0 = await swarm.nodes[0].state.get_full_state_hash()
        full1 = await swarm.nodes[1].state.get_full_state_hash()
        if fp0 != fp1 or full0 != full1:
            failures.append("restored fingerprints diverge")
        if manifest["utxo_fingerprint"] != fp0:
            failures.append("manifest fingerprint != live state")
        # rotation: a second build at a later height must leave at most
        # SnapshotConfig.keep generations and zero staging dirs
        for _ in range(2):
            assert (await swarm.mine(0, addr, push_to=[0]))["ok"]
        second = await swarm.nodes[0].build_snapshot()
        if second is None or second["anchor_height"] <= \
                manifest["anchor_height"]:
            failures.append("second build did not advance the anchor")
        root = swarm.nodes[0].config.snapshot.dir
        gens = layout.list_generations(root)
        keep = swarm.nodes[0].config.snapshot.keep
        if len(gens) > keep:
            failures.append(f"rotation kept {len(gens)} > {keep} gens")
        if any(n.startswith(".staging-") for n in os.listdir(root)):
            failures.append("stale staging dir survived the build")
        if second is not None and \
                layout.current_manifest(root) != second:
            failures.append("CURRENT does not point at the newest build")
        print(f"ok   round-trip height={res.get('height')} "
              f"chunks={res.get('chunks')} rpcs={res.get('rpcs')} "
              f"gens={len(gens)}")
    finally:
        await swarm.close()
    return failures


def _round_trip(seed: int, device=None) -> list:
    tmp = tempfile.mkdtemp(prefix="snapshot-smoke-")
    try:
        with deterministic_world(seed):
            return asyncio.run(_drive_round_trip(seed, tmp, device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _print_scenario(artifact: dict) -> bool:
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
    obs = artifact["observed"]
    print(f"     snapshot_rpcs={obs['snapshot_rpcs']} "
          f"replay_rpcs={obs['replay_rpcs']} "
          f"chunks={obs['manifest_chunks']} "
          f"corrupt_events={obs['corrupt_events']}")
    return good


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.snapshot",
        description="snapshot smoke: build/serve/restore round-trip "
                    "plus the snapshot_churn swarm scenario")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--round-trip-only", action="store_true",
                        help="skip the swarm scenario")
    parser.add_argument("--check-determinism", action="store_true",
                        help="run the scenario twice with the same seed "
                             "and fail unless the core fingerprints are "
                             "identical")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the swarms' nodes run (default cuda)")
    args = parser.parse_args(argv)

    ok = True
    failures = _round_trip(args.seed, args.device)
    for f in failures:
        print(f"FAIL round-trip: {f}", file=sys.stderr)
        ok = False

    if not args.round_trip_only:
        artifact = run_scenario("snapshot_churn", seed=args.seed,
                                device=args.device)
        ok = _print_scenario(artifact) and ok
        if args.check_determinism:
            again = run_scenario("snapshot_churn", seed=args.seed,
                                 device=args.device)
            same = again["fingerprint"] == artifact["fingerprint"]
            print(f"{'ok  ' if same else 'FAIL'} determinism "
                  f"fp1={artifact['fingerprint'][:16]} "
                  f"fp2={again['fingerprint'][:16]}")
            ok = ok and same

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
