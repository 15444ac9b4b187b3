"""On-disk cold-block archive layout (docs/ARCHIVE.md): the port's copy
of the JAX package's ``archive/store.py``, byte for byte the same
segments, indexes and manifests, so a JAX node and a port node mirror
each other's archives.

::

    <root>/
      CURRENT                       name of the published manifest file
      manifest-000000512-6fe2a1b09c44.json
      seg-000000001-000000256/      one fixed-height-range segment
        payload.jsonl               canonical JSON-lines blocks + txs
        index.json                  per-segment lookup tables
      .staging-*/                   builder scratch (rename publishes)
      compact-journal.json          two-phase compactor intent record

Segments are *pure functions of chain content*: every block in the
fixed height range — witness or not — plus all of its transactions, in
the canonical positional row shapes of the storage backends'
``archive_export_span``, blocks ascending and each
block's transactions in acceptance order.  Two nodes on the same chain
therefore produce byte-identical payloads, which makes the sha256 in
the manifest a content address a peer can verify after fetching.

Publishing follows ``snapshot/layout.py``: segment dirs are written
into ``.staging-*`` scratch and renamed into place (one ``os.replace``
per segment), then a new manifest file is written (tmp + fsync +
replace) and the CURRENT pointer swung onto it.  A crash anywhere
leaves either the previous manifest or the new one — never a torn mix
— and segments are append-only: once named into the manifest their
bytes never change, so readers may cache them forever.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

from ..logger import get_logger
from ..snapshot import layout as snap_layout

log = get_logger("archive")

MANIFEST_VERSION = 1
CURRENT_NAME = "CURRENT"
PAYLOAD_NAME = "payload.jsonl"
INDEX_NAME = "index.json"
JOURNAL_NAME = "compact-journal.json"


def seg_name(lo: int, hi: int) -> str:
    """Segment dir name: sortable by height range."""
    return f"seg-{int(lo):09d}-{int(hi):09d}"


def manifest_name(through: int, digest: str) -> str:
    return f"manifest-{int(through):09d}-{digest[:12]}.json"


def _line(t: str, r: list) -> bytes:
    return (json.dumps({"t": t, "r": r}, sort_keys=True,
                       separators=(",", ":")) + "\n").encode()


def encode_segment(lo: int, hi: int, blocks: List[list],
                   txs_by_block: Dict[str, List[list]]) -> Tuple[bytes,
                                                                 dict]:
    """(payload bytes, index doc) for one segment.

    ``blocks`` are canonical block rows ascending by id covering
    exactly [lo, hi]; ``txs_by_block`` maps block hash -> canonical tx
    rows in acceptance order.  The payload interleaves each block line
    with its tx lines so one pass reconstructs the whole range."""
    parts = []
    by_hash: Dict[str, int] = {}
    tx_heights: Dict[str, int] = {}
    addr_heights: Dict[str, list] = {}
    n_txs = 0
    for b in blocks:
        height, block_hash = b[0], b[1]
        by_hash[block_hash] = height
        parts.append(_line("block", b))
        for t in txs_by_block.get(block_hash, []):
            parts.append(_line("tx", t))
            tx_heights[t[1]] = height
            n_txs += 1
            for addr in {a for a in (t[3] + t[4]) if a}:
                heights = addr_heights.setdefault(addr, [])
                if not heights or heights[-1] != height:
                    heights.append(height)
    index = {
        "version": MANIFEST_VERSION,
        "lo": lo,
        "hi": hi,
        "blocks": by_hash,
        "txs": tx_heights,
        "addresses": addr_heights,
        "counts": {"blocks": len(blocks), "txs": n_txs},
    }
    return b"".join(parts), index


def decode_segment(payload: bytes) -> Dict[int, tuple]:
    """payload bytes -> {height: (block row, [tx rows])}, acceptance
    order preserved.  Raises ValueError on a malformed line."""
    out: Dict[int, tuple] = {}
    current: Optional[list] = None
    for raw in payload.splitlines():
        if not raw:
            continue
        doc = json.loads(raw)
        if doc["t"] == "block":
            current = doc["r"]
            out[current[0]] = (current, [])
        elif doc["t"] == "tx":
            if current is None:
                raise ValueError("tx line before any block line")
            out[current[0]][1].append(doc["r"])
        else:
            raise ValueError(f"unknown archive line type {doc['t']!r}")
    return out


class ArchiveStore:
    """Write side of the archive root (the compactor's disk half).
    All methods are synchronous disk I/O — callers on the event loop
    run them in an executor (compactor.py does)."""

    def __init__(self, root: str, segment_blocks: int = 256):
        self.root = root
        self.segment_blocks = max(1, int(segment_blocks))

    # ------------------------------------------------------- manifest ---
    def current_manifest(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.root, CURRENT_NAME),
                      encoding="utf-8") as fh:
                name = fh.read().strip()
        except OSError:
            return None
        if not name or "/" in name or name.startswith("."):
            return None
        return snap_layout.read_manifest(os.path.join(self.root, name))

    def archived_through(self) -> int:
        manifest = self.current_manifest()
        return manifest["archived_through"] if manifest else 0

    def publish(self, segments: List[dict]) -> dict:
        """Write a new manifest over ``segments`` (every segment, old +
        new, ascending) and swing CURRENT onto it — THE archive commit
        point.  Older manifest files are swept best-effort."""
        through = segments[-1]["hi"] if segments else 0
        manifest = {
            "version": MANIFEST_VERSION,
            "segment_blocks": self.segment_blocks,
            "archived_through": through,
            "segments": segments,
        }
        digest = snap_layout.sha256_hex(snap_layout.canonical_json(manifest))
        name = manifest_name(through, digest)
        snap_layout.write_manifest(os.path.join(self.root, name), manifest)
        tmp = os.path.join(self.root, CURRENT_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(name + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(self.root, CURRENT_NAME))
        self._sweep(keep=name)
        return manifest

    def _sweep(self, keep: str) -> None:
        """Drop superseded manifest files and abandoned staging dirs.
        Never raises (full-disk housekeeping must not block the
        compactor — same stance as snapshot prune_generations)."""
        try:
            for name in os.listdir(self.root):
                path = os.path.join(self.root, name)
                if name.startswith(".staging-"):
                    shutil.rmtree(path, ignore_errors=True)
                elif (name.startswith("manifest-") and name != keep
                        and name.endswith(".json")):
                    os.unlink(path)
        except OSError:
            pass

    # ------------------------------------------------------- segments ---
    def write_segment(self, lo: int, hi: int, blocks: List[list],
                      txs_by_block: Dict[str, List[list]]) -> dict:
        """Durably write one segment dir (staging + rename) and return
        its manifest record.  Idempotent: an existing valid segment for
        the same range is verified and reused (crash recovery)."""
        payload, index = encode_segment(lo, hi, blocks, txs_by_block)
        record = {
            "name": seg_name(lo, hi),
            "lo": lo,
            "hi": hi,
            "payload_sha256": snap_layout.sha256_hex(payload),
            "payload_bytes": len(payload),
            "index_sha256": snap_layout.sha256_hex(
                snap_layout.canonical_json(index)),
            "blocks": index["counts"]["blocks"],
            "txs": index["counts"]["txs"],
        }
        final = os.path.join(self.root, record["name"])
        if self.verify_segment(record):
            return record  # a previous (possibly killed) run wrote it
        os.makedirs(self.root, exist_ok=True)
        staging = tempfile.mkdtemp(prefix=".staging-", dir=self.root)
        try:
            with open(os.path.join(staging, PAYLOAD_NAME), "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            snap_layout.write_manifest(os.path.join(staging, INDEX_NAME),
                                       index)
            if os.path.isdir(final):  # invalid leftover: replace wholesale
                shutil.rmtree(final, ignore_errors=True)
            os.replace(staging, final)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        return record

    def write_fetched_segment(self, record: dict, payload: bytes) -> None:
        """Persist a peer-fetched segment whose payload already matched
        ``record['payload_sha256']``.  The index is rebuilt locally from
        the payload (it is a pure function of it), so a hostile peer
        cannot plant a lying index next to honest payload bytes."""
        ranged = decode_segment(payload)
        blocks = [b for _h, (b, _t) in sorted(ranged.items())]
        txs_by_block = {b[1]: t for b, t in ranged.values()}
        _payload, index = encode_segment(record["lo"], record["hi"],
                                         blocks, txs_by_block)
        if snap_layout.sha256_hex(_payload) != record["payload_sha256"]:
            raise ValueError("segment payload does not round-trip")
        if snap_layout.sha256_hex(snap_layout.canonical_json(index)) != \
                record["index_sha256"]:
            raise ValueError("segment index does not match manifest")
        os.makedirs(self.root, exist_ok=True)
        staging = tempfile.mkdtemp(prefix=".staging-", dir=self.root)
        try:
            with open(os.path.join(staging, PAYLOAD_NAME), "wb") as fh:
                fh.write(payload)
                fh.flush()
                os.fsync(fh.fileno())
            snap_layout.write_manifest(os.path.join(staging, INDEX_NAME),
                                       index)
            final = os.path.join(self.root, record["name"])
            if os.path.isdir(final):
                shutil.rmtree(final, ignore_errors=True)
            os.replace(staging, final)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    def verify_segment(self, record: dict) -> bool:
        """Re-verify a segment dir against its manifest record straight
        from disk (the kill -9 recovery primitive: nothing is trusted
        that the hashes cannot prove)."""
        path = os.path.join(self.root, record["name"])
        try:
            with open(os.path.join(path, PAYLOAD_NAME), "rb") as fh:
                payload = fh.read()
            with open(os.path.join(path, INDEX_NAME), "rb") as fh:
                index_bytes = fh.read()
        except OSError:
            return False
        return (snap_layout.sha256_hex(payload) == record["payload_sha256"]
                and snap_layout.sha256_hex(index_bytes)
                == record["index_sha256"])

    def read_payload(self, name: str) -> bytes:
        with open(os.path.join(self.root, name, PAYLOAD_NAME), "rb") as fh:
            return fh.read()

    def read_index(self, name: str) -> Optional[dict]:
        return snap_layout.read_manifest(
            os.path.join(self.root, name, INDEX_NAME))

    # -------------------------------------------------------- journal ---
    def read_journal(self) -> Optional[dict]:
        return snap_layout.read_manifest(
            os.path.join(self.root, JOURNAL_NAME))

    def write_journal(self, doc: dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        snap_layout.write_manifest(
            os.path.join(self.root, JOURNAL_NAME), doc)

    def clear_journal(self) -> None:
        try:
            os.unlink(os.path.join(self.root, JOURNAL_NAME))
        except OSError:
            pass
