"""Resumable snapshot bootstrap (the restore half of docs/SNAPSHOT.md):
the port's copy of the JAX package's ``snapshot/client.py``.

Trust model: the serving peer is NOT trusted.  The manifest itself is
validated first — strict 64-hex hashes (``payload_sha256`` names the
journal directory, so this is also the path-traversal gate), exact row
``i``/``size`` fields, and resource ceilings (``MAX_CHUNKS`` /
``MAX_CHUNK_BYTES`` / ``MAX_PAYLOAD_BYTES``) rejecting a manifest that
would have the client journal or assemble an unbounded payload.  Every
chunk is verified against the manifest's sha256 AND declared size
before it is journaled; the assembled
payload is verified against ``payload_sha256``; and the UTXO + full
state fingerprints are recomputed CLIENT-SIDE from the parsed rows and
compared to the manifest's anchors before a single database write —
the database only ever ingests a payload that already proved itself.
After the (single-transaction) restore the database's own fingerprints
are cross-checked once more against the manifest.

Crash model: the journal dir is keyed by the manifest's payload hash;
a chunk becomes durable only via write-to-``.part`` + fsync +
``os.replace`` onto ``chunk-NNNNNN.bin`` — the rename IS the commit.
kill -9 between chunks resumes from the last verified chunk with zero
re-downloads; kill -9 mid-chunk-write leaves a ``.part`` that is
simply overwritten.  Journaled chunks are re-verified from disk on
resume, so torn or tampered journal bytes are re-fetched, never
trusted.

Failure ladder: per-chunk integrity retries against one source are
capped (``SnapshotConfig.chunk_retries``), then the next health-ranked
source is tried (verified chunks carry over when it serves the same
payload); when sources or integrity run out, :class:`SnapshotError`
carries a structured reason and the caller (node/app.py) falls back to
full block replay — a bad snapshot peer must never break the join.
One error is not a :class:`SnapshotError`: a restore whose resident
UTXO index cannot be rebuilt on its device raises the state's
:class:`~..state.device_index.IndexRearmError` (tables and index rolled
back to the pre-restore pair, the verified journal kept for a retry),
so the caller neither replays nor serves from SQL.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import json
import os
import re
import shutil
from typing import Dict, List, Optional

from .. import telemetry, trace
from ..logger import get_logger
from ..state.device_index import IndexRearmError
from . import layout
from .builder import SNAPSHOT_TABLES

log = get_logger("snapshot")


async def _io(fn, *args):
    """Run blocking journal/file work off the event loop.

    A restore moves up to MAX_PAYLOAD_BYTES through open/fsync/replace
    and one giant assemble+hash; doing that on the loop thread stalls
    gossip, WS heartbeats, and every other handler for the duration.
    """
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(fn, *args))


class SnapshotError(Exception):
    """Restore could not complete; ``reason`` is the structured code
    surfaced in the ``snapshot_fallback`` telemetry event."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


# Resource ceilings on what a manifest may declare.  Without them a
# malicious peer could make a joining node download, journal and then
# assemble a multi-GB payload in memory — a disk/memory exhaustion DoS
# on the bootstrap path.  Overridable per call (SnapshotConfig wires
# them through Node.bootstrap_from_snapshot).
MAX_CHUNKS = 1 << 14            # 16384 manifest entries
MAX_CHUNK_BYTES = 16 << 20      # 16 MiB per chunk
MAX_PAYLOAD_BYTES = 1 << 30     # 1 GiB assembled payload

_HEX64 = re.compile(r"[0-9a-f]{64}")


def _manifest_error(m: dict, max_chunks: int = MAX_CHUNKS,
                    max_chunk_bytes: int = MAX_CHUNK_BYTES,
                    max_payload_bytes: int = MAX_PAYLOAD_BYTES
                    ) -> Optional[str]:
    """None when the manifest is well-formed and within the resource
    ceilings, else ``"malformed"`` / ``"oversize"``.  ``payload_sha256``
    names the journal directory, so the strict 64-hex check here is
    also the path-traversal gate — an attacker-chosen string must never
    become a path component."""
    try:
        if not (m["version"] == layout.MANIFEST_VERSION
                and isinstance(m["anchor_hash"], str)
                and isinstance(m["anchor_height"], int)
                and m["anchor_height"] > 0
                and isinstance(m["payload_sha256"], str)
                and _HEX64.fullmatch(m["payload_sha256"])
                and isinstance(m["payload_bytes"], int)
                and isinstance(m["utxo_fingerprint"], str)
                and isinstance(m["full_state_fingerprint"], str)
                and isinstance(m["chunks"], list) and m["chunks"]
                and all(isinstance(c["sha256"], str)
                        and _HEX64.fullmatch(c["sha256"])
                        and int(c["i"]) == i
                        and isinstance(c["size"], int) and c["size"] >= 0
                        for i, c in enumerate(m["chunks"]))):
            return "malformed"
        if m["payload_bytes"] != sum(c["size"] for c in m["chunks"]):
            return "malformed"
    except (KeyError, TypeError, ValueError):
        return "malformed"
    if (len(m["chunks"]) > max_chunks
            or m["payload_bytes"] > max_payload_bytes
            or any(c["size"] > max_chunk_bytes for c in m["chunks"])):
        return "oversize"
    return None


_ROW_ARITY = {"tx": 7, "block": 8, "unspent_outputs": 5}


def _row_ok(t: str, r) -> bool:
    """Shape check for one payload row: the exact arity the restore SQL
    binds, plus scalar types on the fields the client itself indexes
    (sort keys, anchor comparison) — so untrusted rows can never raise
    TypeError/IndexError past the SnapshotError ladder."""
    if not isinstance(r, list) or len(r) != _ROW_ARITY.get(t, 4):
        return False
    if t == "tx":
        return isinstance(r[1], str)
    if t == "block":
        return isinstance(r[0], int) and isinstance(r[1], str)
    return isinstance(r[0], str) and isinstance(r[1], int)


def parse_payload(payload: bytes) -> tuple:
    """payload bytes -> (tables dict, tx rows, block rows); raises
    SnapshotError on any malformed line."""
    tables: Dict[str, List[list]] = {t: [] for t in SNAPSHOT_TABLES}
    txs: List[list] = []
    blocks: List[list] = []
    for ln, raw in enumerate(payload.splitlines()):
        try:
            doc = json.loads(raw)
            t, r = doc["t"], doc["r"]
        except (ValueError, KeyError, TypeError):
            raise SnapshotError("payload_malformed", f"line {ln}")
        if t in tables:
            dest = tables[t]
        elif t == "tx":
            dest = txs
        elif t == "block":
            dest = blocks
        else:
            raise SnapshotError("payload_malformed",
                                f"line {ln}: unknown section {t!r}")
        if not _row_ok(t, r):
            raise SnapshotError("payload_malformed",
                                f"line {ln}: bad {t} row shape")
        dest.append(r)
    return tables, txs, blocks


def fingerprint_rows(rows: List[list]) -> str:
    """The table fingerprint recomputed from payload rows — must equal
    the backend's get_table_outpoints_hash (sha256 over the sorted
    outpoint concatenation)."""
    h = hashlib.sha256()
    for r in sorted(rows, key=lambda r: (r[0], r[1])):
        h.update(f"{r[0]}{r[1]}".encode())
    return h.hexdigest()


def full_fingerprint(tables: Dict[str, List[list]]) -> str:
    h = hashlib.sha256()
    for table in SNAPSHOT_TABLES:
        h.update(table.encode())
        h.update(fingerprint_rows(tables.get(table, [])).encode())
    return h.hexdigest()


class _Journal:
    """Verified-chunk journal for one payload identity."""

    def __init__(self, root: str, manifest: dict):
        self.manifest = manifest
        ident = manifest["payload_sha256"][:16]
        base = os.path.realpath(os.path.join(root, "restore"))
        self.dir = os.path.realpath(os.path.join(base, ident))
        # _manifest_error's 64-hex check is the real gate; this is the
        # belt-and-braces containment assert behind it
        if os.path.dirname(self.dir) != base:
            raise SnapshotError("journal_path_escape", ident)
        # prune journals of superseded payload identities (each failed
        # bootstrap against a different anchor would otherwise leak one
        # dir forever); only the identity being restored survives
        try:
            for name in os.listdir(base):
                if name != ident:
                    shutil.rmtree(os.path.join(base, name),
                                  ignore_errors=True)
        except OSError:
            pass
        os.makedirs(self.dir, exist_ok=True)
        layout.write_manifest(os.path.join(self.dir, layout.MANIFEST_NAME),
                              manifest)

    def chunk_path(self, i: int) -> str:
        return os.path.join(self.dir, layout.chunk_name(i))

    def have_verified(self, i: int) -> bool:
        """True when chunk i is journaled AND its bytes still match the
        manifest (re-verified from disk — a torn or tampered journal
        entry is treated as absent)."""
        try:
            with open(self.chunk_path(i), "rb") as fh:
                data = fh.read()
        except OSError:
            return False
        return layout.sha256_hex(data) == \
            self.manifest["chunks"][i]["sha256"]

    def commit_chunk(self, i: int, data: bytes) -> None:
        """Durable-then-rename: the ``os.replace`` is the commit point;
        a crash before it leaves only a ``.part`` the resume ignores."""
        part = self.chunk_path(i) + ".part"
        with open(part, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(part, self.chunk_path(i))

    def assemble(self) -> bytes:
        return b"".join(
            open(self.chunk_path(i), "rb").read()
            for i in range(len(self.manifest["chunks"])))

    def destroy(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


async def bootstrap_from_snapshot(state, sources, root: str,
                                  chunk_retries: int = 2,
                                  progress: Optional[dict] = None,
                                  max_chunks: int = MAX_CHUNKS,
                                  max_chunk_bytes: int = MAX_CHUNK_BYTES,
                                  max_payload_bytes: int = MAX_PAYLOAD_BYTES
                                  ) -> dict:
    """Restore ``state`` from the first healthy source in ``sources``
    (NodeInterface instances, already health-ranked by the caller).

    Returns a result dict (method/height/anchor/chunks/chunks_reused/
    source/rpcs); raises :class:`SnapshotError` with a structured
    reason when every source is exhausted or integrity fails — the
    caller owns the replay fallback.
    """
    if not sources:
        raise SnapshotError("no_sources")
    progress = progress if progress is not None else {}
    progress.update(phase="manifest", verified=0, reused=0, total=0,
                    source="")
    rpcs = 0
    last_error = ""
    journal = None
    for iface in sources:
        src = iface.base_url
        try:
            rpcs += 1
            manifest = await iface.snapshot_manifest()
        except Exception as e:
            last_error = f"{src}: manifest: {e}"
            log.debug("snapshot source %s failed at manifest: %s", src, e)
            telemetry.event("snapshot_source_failed", source=src,
                            stage="manifest", error=str(e))
            continue
        err = "malformed" if not isinstance(manifest, dict) else \
            _manifest_error(manifest, max_chunks=max_chunks,
                            max_chunk_bytes=max_chunk_bytes,
                            max_payload_bytes=max_payload_bytes)
        if err is not None:
            last_error = f"{src}: manifest {err}"
            telemetry.event("snapshot_source_failed", source=src,
                            stage="manifest", error=err)
            continue
        if journal is None or \
                journal.manifest["payload_sha256"] != \
                manifest["payload_sha256"]:
            # new payload identity -> new journal; identical payload
            # from a failover source reuses every verified chunk
            # (construction prunes superseded journal dirs — executor)
            journal = await _io(_Journal, root, manifest)
        chunks = journal.manifest["chunks"]
        # per-pass counters: on failover, "reused" counts the verified
        # chunks the new pass inherited (i.e. not re-downloaded)
        progress.update(phase="chunks", total=len(chunks), source=src,
                        verified=0, reused=0,
                        height=journal.manifest["anchor_height"])
        telemetry.event("snapshot_restore_start", source=src,
                        height=journal.manifest["anchor_height"],
                        chunks=len(chunks))
        source_dead = False
        for i in range(len(chunks)):
            if await _io(journal.have_verified, i):
                progress["verified"] = progress.get("verified", 0) + 1
                progress["reused"] = progress.get("reused", 0) + 1
                trace.inc("snapshot.chunks_reused")
                continue
            ok = False
            for attempt in range(max(1, chunk_retries + 1)):
                try:
                    rpcs += 1
                    data = await iface.snapshot_chunk(i)
                except Exception as e:
                    last_error = f"{src}: chunk {i}: {e}"
                    log.debug("snapshot source %s failed at chunk %d: %s",
                              src, i, e)
                    telemetry.event("snapshot_source_failed", source=src,
                                    stage=f"chunk/{i}", error=str(e))
                    source_dead = True
                    break
                # the size check keeps the journal/assembly bounded by
                # what the (ceiling-checked) manifest declared — a hash
                # match alone would let the peer lie about sizes
                if len(data) == chunks[i]["size"] and \
                        layout.sha256_hex(data) == chunks[i]["sha256"]:
                    await _io(journal.commit_chunk, i, data)
                    ok = True
                    break
                trace.inc("snapshot.chunk_integrity_failures")
                last_error = f"{src}: chunk {i}: hash mismatch"
                telemetry.event("snapshot_chunk_corrupt", source=src,
                                chunk=i, attempt=attempt)
            if source_dead:
                break
            if not ok:
                source_dead = True  # integrity retries exhausted here
                break
            progress["verified"] = progress.get("verified", 0) + 1
            trace.inc("snapshot.chunks_fetched")
        if source_dead:
            continue  # next source; journaled chunks carry over
        return await _finish(state, journal, progress, src, rpcs)
    raise SnapshotError("sources_exhausted", last_error)


async def _finish(state, journal, progress: dict, src: str,
                  rpcs: int) -> dict:
    manifest = journal.manifest
    progress["phase"] = "verify"
    try:
        payload = await _io(journal.assemble)
        if await _io(layout.sha256_hex, payload) != \
                manifest["payload_sha256"]:
            # each chunk verified individually, so this means the
            # manifest itself is inconsistent — poison, not transport
            raise SnapshotError("payload_hash_mismatch", src)
        tables, txs, blocks = parse_payload(payload)
        if not blocks or blocks[-1][1] != manifest["anchor_hash"] or \
                blocks[-1][0] != manifest["anchor_height"]:
            raise SnapshotError("anchor_mismatch", src)
        # prove the payload against the manifest's fingerprints BEFORE
        # any database write — the db never ingests unproven rows
        if fingerprint_rows(tables["unspent_outputs"]) != \
                manifest["utxo_fingerprint"] or \
                full_fingerprint(tables) != \
                manifest["full_state_fingerprint"]:
            raise SnapshotError("fingerprint_mismatch", src)
    except SnapshotError:
        await _io(journal.destroy)
        raise
    except Exception as e:
        # untrusted bytes must never raise past the SnapshotError
        # ladder — the caller's replay fallback catches only that
        await _io(journal.destroy)
        raise SnapshotError("peer_malformed",
                            f"{src}: {type(e).__name__}: {e}")
    progress["phase"] = "restore"
    try:
        await state.restore_snapshot(tables, txs, blocks)
        # and cross-check what the database now reports (catches a
        # broken restore path, not a broken peer)
        mismatch = (await state.get_unspent_outputs_hash() !=
                    manifest["utxo_fingerprint"]
                    or await state.get_full_state_hash() !=
                    manifest["full_state_fingerprint"])
    except IndexRearmError:
        raise  # rolled back; the verified journal stays for a retry
    except Exception as e:
        # atomic() rolled back: the pre-restore state is intact and the
        # replay fallback can proceed on it
        await _io(journal.destroy)
        raise SnapshotError("restore_failed",
                            f"{src}: {type(e).__name__}: {e}")
    if mismatch:
        # the unproven rows are already committed — wipe back to a
        # blank chain so the replay fallback syncs from genesis rather
        # than on top of state that failed its own cross-check
        await _io(journal.destroy)
        try:
            await state.restore_snapshot(
                {t: [] for t in SNAPSHOT_TABLES}, [], [])
        except Exception:
            log.exception("could not reset state after restored-state"
                          " mismatch; replay fallback starts dirty")
        raise SnapshotError("restored_state_mismatch", src)
    await _io(journal.destroy)
    progress["phase"] = "done"
    trace.inc("snapshot.restores")
    telemetry.event("snapshot_restore_complete", source=src,
                    height=manifest["anchor_height"],
                    anchor=manifest["anchor_hash"],
                    chunks=len(manifest["chunks"]),
                    reused=progress.get("reused", 0), rpcs=rpcs)
    return {
        "method": "snapshot",
        "height": manifest["anchor_height"],
        "anchor": manifest["anchor_hash"],
        "chunks": len(manifest["chunks"]),
        "chunks_reused": progress.get("reused", 0),
        "source": src,
        "rpcs": rpcs,
    }
