"""CLI entry: archive smoke — differential, kill -9 resume, scenario.

    python -m upow_tpu_torch.archive                      # all three legs
    python -m upow_tpu_torch.archive --differential-only  # skip the swarm leg
    python -m upow_tpu_torch.archive --check-determinism  # scenario twice, cmp fp

The port's copy of the JAX package's ``archive/__main__.py``.  Three
legs, any failure exits non-zero:

1. **Differential** — a multi-thousand-block synthetic chain is
   compacted (witness-closure prune into the content-addressed
   archive) and deep-read against an unpruned twin; every block /
   transaction / page / address-history probe must answer
   byte-identically (``parity.storage_differential``).
2. **Kill -9 resume** — an injected error between archive-commit and
   hot-delete aborts a compaction exactly where a crash would; the
   re-run must report ``resumed``, finish the prune, lose zero rows,
   double-delete nothing, and still pass the full differential.
   Determinism ride-along: the same chain compacted in a fresh
   directory must publish byte-identical segment digests.
3. **Scenario** — the ``archive_prune`` swarm scenario (full HTTP
   parity incl. a reorg inside the safety window, peer mirror over
   ``/archive/*``), on the swarm's ``--device`` (``cuda`` by default,
   raising without a card; ``cpu`` the host).  ``--check-determinism``
   runs it twice and the core fingerprints must match.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import tempfile

from ..resilience import faultinject
from ..swarm.scenarios import core_ok, run_scenario
from . import parity


def _differential(seed: int, blocks: int) -> bool:
    res = asyncio.run(parity.storage_differential(blocks, seed=seed))
    comp = res["compaction"]
    good = res["ok"] and comp.get("archived_through", 0) >= 2000
    print(f"{'ok  ' if good else 'FAIL'} differential blocks={blocks} "
          f"archived_through={comp.get('archived_through')} "
          f"pruned={comp.get('pruned_blocks')}/{comp.get('pruned_txs')} "
          f"probes={res['probes']}")
    for m in res["mismatches"]:
        print(f"     diverged: {m}", file=sys.stderr)
    return good


async def _drive_resume(seed: int, blocks: int) -> list:
    """Kill the compactor between publish and prune, then resume."""
    import os

    from ..config import ArchiveConfig
    from ..state.storage import ChainState
    from . import compactor
    from .compactor import _io
    from .reader import ArchiveReader
    from .store import ArchiveStore

    failures = []
    with tempfile.TemporaryDirectory(prefix="archive-resume-") as tmp:
        arch_dir = os.path.join(tmp, "archive")
        snap_dir = os.path.join(tmp, "snapshot")
        os.makedirs(snap_dir, exist_ok=True)
        pruned, twin = ChainState(), ChainState()
        for st in (pruned, twin):
            parity.build_synthetic_chain(st, blocks, seed=seed,
                                         witness_from=blocks - 64)
        tip = await twin.get_block_by_id(blocks)
        parity.publish_fake_snapshot(snap_dir, blocks, tip["hash"])
        cfg = ArchiveConfig(dir=arch_dir, segment_blocks=64,
                            safety_window=32)
        pruned.archive = ArchiveReader(arch_dir)

        # crash EXACTLY between archive-commit and hot-delete: the
        # manifest is published, the journal is written, no row pruned
        faultinject.install("archive.compact:error:key=prune", seed)
        try:
            await compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                    reader=pruned.archive)
            failures.append("injected crash did not fire")
        except faultinject.FaultInjected:
            pass
        finally:
            faultinject.uninstall()
        store = ArchiveStore(arch_dir, cfg.segment_blocks)
        if await _io(store.read_journal) is None:
            failures.append("crash left no journal behind")
        hot_mid = await pruned.archive_hot_row_counts()
        if hot_mid["blocks"] != blocks:
            failures.append(
                f"rows pruned before archive-commit: {hot_mid}")

        stats = await compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                        reader=pruned.archive)
        if not stats.get("ok") or not stats.get("resumed"):
            failures.append(f"resume run did not report resumed: {stats}")
        if await _io(store.read_journal) is not None:
            failures.append("journal survived a completed cycle")
        again = await compactor.compact(pruned, arch_dir, snap_dir, cfg,
                                        reader=pruned.archive)
        if again.get("pruned_blocks") or again.get("segments_built"):
            failures.append(f"re-run was not a no-op: {again}")

        # zero lost rows / zero double-deletes: the resumed store must
        # still pass the entire deep-read differential
        res = await parity.storage_differential(
            blocks, seed=seed, segment_blocks=cfg.segment_blocks,
            safety_window=cfg.safety_window)
        if not res["ok"]:
            failures.append(
                f"post-resume differential diverged: {res['mismatches']}")

        # determinism: the same chain compacted in a FRESH directory
        # must publish byte-identical content-addressed segments
        arch2 = os.path.join(tmp, "archive2")
        twin.archive = ArchiveReader(arch2)
        stats2 = await compactor.compact(twin, arch2, snap_dir, cfg,
                                         reader=twin.archive)
        m1 = await _io(store.current_manifest)
        m2 = await _io(
            ArchiveStore(arch2, cfg.segment_blocks).current_manifest)
        if not stats2.get("ok") or [s["payload_sha256"]
                                    for s in m1["segments"]] != \
                [s["payload_sha256"] for s in m2["segments"]]:
            failures.append("segment digests differ across nodes")
        print(f"ok   resume archived_through={stats.get('archived_through')} "
              f"pruned={stats.get('pruned_blocks')} "
              f"segments={len(m1['segments'])}" if not failures else
              f"FAIL resume: {failures[0]}")
    return failures


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
    print(f"     archived_through={core.get('archived_through')} "
          f"hot_blocks={core.get('hot_blocks_before')}->"
          f"{core.get('hot_blocks_after')} "
          f"probes={artifact['observed'].get('probes')}")
    return good


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m upow_tpu_torch.archive",
        description="archive smoke: pruned-vs-twin differential, "
                    "kill -9 resume, and the archive_prune scenario")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--blocks", type=int, default=2400,
                        help="synthetic chain length for the "
                             "differential leg (>=2k archived)")
    parser.add_argument("--differential-only", action="store_true",
                        help="skip the swarm scenario leg")
    parser.add_argument("--check-determinism", action="store_true",
                        help="run the scenario twice with the same seed "
                             "and fail unless the core fingerprints are "
                             "identical")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the scenario's swarm runs "
                             "(default cuda)")
    args = parser.parse_args(argv)

    ok = _differential(args.seed, args.blocks)
    failures = asyncio.run(_drive_resume(args.seed, 512))
    for f in failures:
        print(f"FAIL resume: {f}", file=sys.stderr)
        ok = False

    if not args.differential_only:
        artifact = run_scenario("archive_prune", seed=args.seed,
                                device=args.device)
        ok = _print_scenario(artifact) and ok
        if args.check_determinism:
            again = run_scenario("archive_prune", seed=args.seed,
                                 device=args.device)
            same = again["fingerprint"] == artifact["fingerprint"]
            print(f"{'ok  ' if same else 'FAIL'} determinism "
                  f"fp1={artifact['fingerprint'][:16]} "
                  f"fp2={again['fingerprint'][:16]}")
            ok = ok and same

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
