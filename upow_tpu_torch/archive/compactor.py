"""Crash-safe two-phase hot-store compactor (docs/ARCHIVE.md): the
port's copy of the JAX package's ``archive/compactor.py``.

Driven entirely by *published* artifacts: the newest snapshot
generation fixes the anchor, and only heights at or below
``anchor_height - safety_window`` are eligible.  Compaction is two
independent, individually-idempotent phases:

1. **Archive-commit** — export eligible height ranges from the hot
   store into content-addressed segments and publish a new archive
   manifest (CURRENT swing = the commit point).  Segment writes verify
   before build, so a re-run after kill -9 reuses every segment that
   already landed.
2. **Hot-delete** — prune hot rows *at or below the published
   ``archived_through``* whose transactions are provably outside the
   snapshot witness closure.  The prune range is derived from the
   published manifest — never from the journal — so a stale or even
   forged journal can at worst re-run a no-op delete; it can never
   widen the range past what the archive durably holds.

The journal (``compact-journal.json``) only records *intent* for
observability and resume accounting: kill -9 between the phases leaves
the journal behind, and the next run logs the resume, re-verifies the
published segments from disk, and re-issues the (idempotent) delete.
Zero lost rows — nothing is deleted above ``archived_through``; zero
double-deletes — the witness-closure ``NOT EXISTS`` predicate is
evaluated against live hot state at delete time, so already-pruned
rows simply don't match.

The closure predicate lives in the backends
(``archive_prune_span``): a block is prunable only when *every* one of
its transactions is outside the witness closure, so a surviving hot tx
always keeps its hot block row and every hot-side join stays intact —
a block's transactions are never split across the hot/archive seam.

All disk and DB work runs off the event loop (executor / backend
seam).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Optional

from .. import telemetry, trace
from ..logger import get_logger
from ..resilience import faultinject
from ..snapshot import layout as snap_layout
from .store import ArchiveStore

log = get_logger("archive")


async def _io(fn, *args, **kwargs):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, functools.partial(fn, *args, **kwargs))


async def _fire(key: str) -> None:
    injector = faultinject.get_injector()
    if injector is not None:
        await injector.fire("archive.compact", key)


async def compact(state, archive_root: str, snapshot_root: str, cfg,
                  reader=None) -> dict:
    """Run one compaction cycle against ``state`` (either backend).

    ``cfg`` is an :class:`~..config.ArchiveConfig`.  Returns a
    stats dict (``ok`` False with a ``reason`` when there is nothing
    to do).  Safe to re-run at any time, including after a kill -9 at
    any point of a previous run."""
    store = ArchiveStore(archive_root, cfg.segment_blocks)

    snap_manifest = await _io(snap_layout.current_manifest, snapshot_root)
    if snap_manifest is None:
        return {"ok": False, "reason": "no_snapshot"}
    anchor_height = int(snap_manifest["anchor_height"])
    cutoff = anchor_height - max(0, int(cfg.safety_window))
    if cutoff <= 1:
        return {"ok": False, "reason": "below_safety_window"}

    journal = await _io(store.read_journal)
    resumed = journal is not None
    if resumed:
        # A previous run died between archive-commit and the end of
        # hot-delete.  Both phases are idempotent and the prune range
        # below is re-derived from the published manifest, so recovery
        # is simply "run the cycle again" — but surface it.
        trace.inc("archive.compact_resumes")
        log.warning("archive compactor resuming interrupted cycle: %s",
                    journal)

    manifest = await _io(store.current_manifest)
    segments = list(manifest["segments"]) if manifest else []
    already_through = segments[-1]["hi"] if segments else 0

    await _fire("closure")

    # Phase 1: archive-commit.  Full fixed-size ranges only, strictly
    # below the cutoff — partial trailing ranges wait for the chain to
    # grow so segment content stays a pure function of chain content.
    built = 0
    lo = already_through + 1
    while lo + cfg.segment_blocks - 1 <= cutoff - 1:
        hi = lo + cfg.segment_blocks - 1
        await _fire(f"segment/{lo}")
        blocks, txs_by_block = await state.archive_export_span(lo, hi)
        if len(blocks) != hi - lo + 1:
            # Hot rows already pruned (or a gap): can't rebuild this
            # range; never publish a hole.
            log.error("archive export [%d, %d] returned %d blocks; "
                      "aborting cycle", lo, hi, len(blocks))
            return {"ok": False, "reason": "export_gap", "lo": lo,
                    "hi": hi}
        record = await _io(store.write_segment, lo, hi, blocks,
                           txs_by_block)
        segments.append(record)
        built += 1
        lo = hi + 1

    archived_through = segments[-1]["hi"] if segments else 0
    if built:
        await _fire("publish")
        await _io(store.publish, segments)  # <- archive commit point
        if reader is not None:
            reader.invalidate()
    if not archived_through:
        return {"ok": False, "reason": "nothing_archived",
                "cutoff": cutoff}

    # Phase 2: hot-delete, gated on the *published* manifest.
    await _io(store.write_journal, {
        "version": 1,
        "phase": "prune",
        "archived_through": archived_through,
        "anchor_height": anchor_height,
        "cutoff": cutoff,
    })
    await _fire("prune")
    pruned = await state.archive_prune_span(1, archived_through)
    await _io(store.clear_journal)

    trace.inc("archive.compactions")
    # named apart from the node's explicit archive_hot_rows_pruned
    # family — a shared name would render duplicate exposition lines
    trace.inc("archive.compact.rows_pruned",
              pruned["blocks"] + pruned["txs"])
    telemetry.event("archive_compact_complete",
                    anchor_height=anchor_height,
                    archived_through=archived_through,
                    segments_built=built,
                    pruned_blocks=pruned["blocks"],
                    pruned_txs=pruned["txs"],
                    resumed=resumed)
    stats = {
        "ok": True,
        "anchor_height": anchor_height,
        "cutoff": cutoff,
        "archived_through": archived_through,
        "segments": len(segments),
        "segments_built": built,
        "pruned_blocks": pruned["blocks"],
        "pruned_txs": pruned["txs"],
        "resumed": resumed,
    }
    log.info("archive compaction: through=%d built=%d pruned=%d/%d%s",
             archived_through, built, pruned["blocks"], pruned["txs"],
             " (resumed)" if resumed else "")
    return stats
