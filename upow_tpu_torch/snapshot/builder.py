"""Snapshot builder: chain state -> published chunked generation (the
port's copy of the JAX package's ``snapshot/builder.py``: for the same
chain, on either backend, the same manifest and the same chunk bytes).

The payload is backend-neutral JSON-lines, one object per row::

    {"t": "<table>", "r": [tx_hash, idx, address, amount(, is_stake)]}
    {"t": "tx",      "r": [block_hash, tx_hash, tx_hex, in_addrs,
                           out_addrs, out_amounts, fees]}
    {"t": "block",   "r": [id, hash, content, address, random,
                           difficulty, reward, timestamp]}

Tables stream in the fixed ``("unspent_outputs",) + _GOV_TABLES``
order with rows already canonically ordered by the state backends
(tx_hash, idx), then witness transactions ordered by tx_hash, then the
block tail ascending — so one chain state always serializes to one
byte stream, and the manifest (canonical JSON, no timestamps) is
byte-identical across rebuilds of the same state.  The byte stream is
cut into fixed ``chunk_bytes`` chunks, each sha256'd into the
manifest, which also commits to the anchor block (hash + height) and
the live ``get_unspent_outputs_hash`` / ``get_full_state_hash``
fingerprints the restore side must reproduce.

Crash safety: everything is written into a ``.staging-*`` dir first;
one ``os.replace`` publishes the generation and a second swings the
CURRENT pointer.  A crash anywhere leaves either the old generation or
the new one — never a torn mix — and the stale staging dir is swept by
:func:`..snapshot.layout.prune_generations` at the next build/boot.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import shutil
import tempfile
from typing import List, Optional

from .. import telemetry, trace
from ..logger import get_logger
from ..state.storage import _GOV_TABLES
from . import layout

log = get_logger("snapshot")

SNAPSHOT_TABLES = ("unspent_outputs",) + _GOV_TABLES


def _line(t: str, r: list) -> bytes:
    return (json.dumps({"t": t, "r": r}, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


async def serialize_payload(state, blocks_tail: int) -> tuple:
    """(payload bytes, per-section row counts) for the current state."""
    parts = []
    counts = {}
    for table in SNAPSHOT_TABLES:
        rows = await state.export_snapshot_rows(table)
        counts[table] = len(rows)
        parts.extend(_line(table, r) for r in rows)
    txs = await state.export_snapshot_txs(blocks_tail)
    counts["tx"] = len(txs)
    parts.extend(_line("tx", r) for r in txs)
    blocks = await state.export_snapshot_blocks(blocks_tail)
    counts["block"] = len(blocks)
    parts.extend(_line("block", r) for r in blocks)
    return b"".join(parts), counts


def _write_generation(staging: str, chunks: List[bytes], manifest: dict,
                      final: str) -> None:
    """Durable half of a build (runs in an executor): fsync'd chunk
    writes into staging, manifest, then the publishing rename."""
    for i, chunk in enumerate(chunks):
        with open(os.path.join(staging, layout.chunk_name(i)),
                  "wb") as fh:
            fh.write(chunk)
            fh.flush()
            os.fsync(fh.fileno())
    layout.write_manifest(os.path.join(staging, layout.MANIFEST_NAME),
                          manifest)
    if os.path.isdir(final):  # same anchor rebuilt: replace wholesale
        shutil.rmtree(final, ignore_errors=True)
    os.replace(staging, final)


async def build_snapshot(state, root: str, chunk_bytes: int = 1 << 20,
                         blocks_tail: int = 64,
                         keep: int = 2) -> Optional[dict]:
    """Build and publish one generation; returns its manifest (None on
    an empty chain — nothing to anchor to)."""
    anchor = await state.get_last_block()
    if anchor is None:
        return None
    os.makedirs(root, exist_ok=True)
    payload, counts = await serialize_payload(state, blocks_tail)
    chunks = [payload[off:off + chunk_bytes]
              for off in range(0, len(payload), chunk_bytes)] or [b""]
    manifest = {
        "version": layout.MANIFEST_VERSION,
        "anchor_height": anchor["id"],
        "anchor_hash": anchor["hash"],
        "utxo_fingerprint": await state.get_unspent_outputs_hash(),
        "full_state_fingerprint": await state.get_full_state_hash(),
        "chunk_bytes": chunk_bytes,
        "payload_bytes": len(payload),
        "payload_sha256": layout.sha256_hex(payload),
        "chunks": [{"i": i, "sha256": layout.sha256_hex(c), "size": len(c)}
                   for i, c in enumerate(chunks)],
        "counts": counts,
    }
    staging = tempfile.mkdtemp(prefix=".staging-", dir=root)
    final = os.path.join(
        root, layout.gen_name(anchor["id"], anchor["hash"]))
    loop = asyncio.get_running_loop()
    try:
        # chunk writes + fsync barriers + the publishing rename are the
        # slow durable half of a build; off the loop thread so a build
        # under load cannot stall gossip/WS for seconds
        await loop.run_in_executor(None, functools.partial(
            _write_generation, staging, chunks, manifest, final))
    except BaseException:
        await loop.run_in_executor(None, functools.partial(
            shutil.rmtree, staging, ignore_errors=True))
        raise
    layout.publish_current(root, os.path.basename(final))
    layout.prune_generations(root, keep=keep)
    trace.inc("snapshot.builds")
    telemetry.event("snapshot_build_complete", height=anchor["id"],
                    anchor=anchor["hash"], chunks=len(manifest["chunks"]),
                    bytes=len(payload))
    log.info("snapshot published: height=%d chunks=%d bytes=%d -> %s",
             anchor["id"], len(manifest["chunks"]), len(payload), final)
    return manifest
