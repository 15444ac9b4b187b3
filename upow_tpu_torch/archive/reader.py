"""Archive read fallthrough + peer archive fetch (docs/ARCHIVE.md): the
port's copy of the JAX package's ``archive/reader.py``.

:class:`ArchiveReader` is the seam both storage backends consult when
a hot lookup misses: ``state.archive`` is ``None`` by default (zero
cost), and when the node attaches a reader, ``get_block``,
``get_blocks(_details)``, ``get_transaction`` and address history
transparently stitch archived rows back in.  Archived data is
immutable (segments are content-addressed and append-only), so the
fallthrough is *epoch-stable*: hot-cache keys and generations are
untouched — a cached response stays byte-identical whether its rows
came from sqlite/PG or from a segment file.

Disk reads run in the default executor (segment payloads can be tens
of MB; a loop-thread read would stall every other handler — the same
rule ``snapshot/client.py`` follows), and so do a segment's content
hash and parse (the JAX reader hashes and parses on the loop; the rows
are the same), and parsed segments live in a small LRU so repeated
deep-history reads don't re-parse.

:func:`fetch_archive` pulls a peer's manifest + segments over the
``/archive/*`` routes with full integrity checking (payload sha from
the manifest, index rebuilt locally), firing the ``archive.fetch``
fault site so chaos scenarios can corrupt or sever the transfer.
"""

from __future__ import annotations

import asyncio
import functools
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .. import trace
from ..logger import get_logger
from ..resilience import faultinject
from ..snapshot import layout as snap_layout
from . import store as archive_store
from .store import ArchiveStore

log = get_logger("archive")


async def _io(fn, *args, **kwargs):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, functools.partial(fn, *args, **kwargs))


class ArchiveReader:
    """Read side of one archive root.  Safe to attach to either
    storage backend; every public method is async and returns canonical
    positional rows (the backend converts to its own dict shapes)."""

    def __init__(self, root: str, cache_segments: int = 4):
        self.root = root
        self.store = ArchiveStore(root)
        self.cache_segments = max(1, int(cache_segments))
        self._manifest: Optional[dict] = None
        self._indexes: Dict[str, dict] = {}
        # name -> {"by_height": {h: (block, [txs])}, "by_hash": {...}}
        self._segments: "OrderedDict[str, dict]" = OrderedDict()
        self.fallthrough_reads = 0
        self.segment_loads = 0
        self.integrity_failures = 0

    # ---------------------------------------------------------- cache ---
    def invalidate(self) -> None:
        """Forget the cached manifest/indexes (parsed segments stay:
        they are content-addressed and never change).  The compactor
        calls this after publishing new segments."""
        self._manifest = None
        self._indexes = {}

    async def _ensure_manifest(self) -> Optional[dict]:
        if self._manifest is None:
            self._manifest = await _io(self.store.current_manifest)
        return self._manifest

    async def _index(self, record: dict) -> Optional[dict]:
        index = self._indexes.get(record["name"])
        if index is None:
            index = await _io(self.store.read_index, record["name"])
            if index is not None:
                self._indexes[record["name"]] = index
        return index

    async def _segment(self, record: dict) -> Optional[dict]:
        seg = self._segments.get(record["name"])
        if seg is not None:
            self._segments.move_to_end(record["name"])
            return seg
        try:
            by_height = await _io(self._load, record)
        except OSError:
            return None
        if by_height is None:
            # disk corruption (or a tampered fetched segment): refuse to
            # serve silently-wrong history
            self.integrity_failures += 1
            trace.inc("archive.integrity_failures")
            log.error("archive segment %s failed its content hash",
                      record["name"])
            return None
        seg = {
            "by_height": by_height,
            "by_hash": {b[1]: h for h, (b, _t) in by_height.items()},
        }
        self._segments[record["name"]] = seg
        self.segment_loads += 1
        while len(self._segments) > self.cache_segments:
            self._segments.popitem(last=False)
        return seg

    def _load(self, record: dict) -> Optional[Dict[int, tuple]]:
        """A segment's rows by height from disk, or None when its payload
        does not hash to its record (executor side: read, hash, parse)."""
        payload = self.store.read_payload(record["name"])
        if snap_layout.sha256_hex(payload) != record["payload_sha256"]:
            return None
        return archive_store.decode_segment(payload)

    def _record_for_height(self, height: int) -> Optional[dict]:
        manifest = self._manifest
        if not manifest:
            return None
        for record in manifest["segments"]:
            if record["lo"] <= height <= record["hi"]:
                return record
        return None

    def _hit(self) -> None:
        self.fallthrough_reads += 1
        # distinct from the node's explicit archive_fallthrough_reads
        # family — a shared name would render duplicate exposition lines
        trace.inc("archive.reads.fallthrough")

    # ---------------------------------------------------------- reads ---
    async def coverage(self) -> Optional[Tuple[int, int]]:
        manifest = await self._ensure_manifest()
        if not manifest or not manifest["segments"]:
            return None
        return (manifest["segments"][0]["lo"], manifest["archived_through"])

    async def block_by_height(self, height: int) -> Optional[list]:
        await self._ensure_manifest()
        record = self._record_for_height(height)
        if record is None:
            return None
        seg = await self._segment(record)
        entry = seg["by_height"].get(height) if seg else None
        if entry is None:
            return None
        self._hit()
        return entry[0]

    async def block_by_hash(self, block_hash: str) -> Optional[list]:
        manifest = await self._ensure_manifest()
        if not manifest:
            return None
        for record in manifest["segments"]:
            index = await self._index(record)
            if index is None:
                continue
            height = index["blocks"].get(block_hash)
            if height is not None:
                return await self.block_by_height(height)
        return None

    async def txs_for_block(self, block_hash: str) -> Optional[List[list]]:
        """All of an archived block's canonical tx rows in acceptance
        order, or None when the block is not archived."""
        manifest = await self._ensure_manifest()
        if not manifest:
            return None
        for record in manifest["segments"]:
            index = await self._index(record)
            if index is None:
                continue
            height = index["blocks"].get(block_hash)
            if height is None:
                continue
            seg = await self._segment(record)
            entry = seg["by_height"].get(height) if seg else None
            if entry is None:
                return None
            self._hit()
            return entry[1]
        return None

    async def tx_by_hash(self, tx_hash: str) -> Optional[Tuple[list, int]]:
        """(canonical tx row, block height) or None."""
        manifest = await self._ensure_manifest()
        if not manifest:
            return None
        for record in manifest["segments"]:
            index = await self._index(record)
            if index is None:
                continue
            height = index["txs"].get(tx_hash)
            if height is None:
                continue
            seg = await self._segment(record)
            entry = seg["by_height"].get(height) if seg else None
            if entry is None:
                return None
            for t in entry[1]:
                if t[1] == tx_hash:
                    self._hit()
                    return t, height
            return None
        return None

    async def span(self, lo: int,
                   hi: int) -> List[Tuple[list, List[list]]]:
        """(block row, [tx rows]) for every archived height in
        [lo, hi], ascending.  Heights outside the archive are simply
        absent — the caller overlays hot rows on top."""
        manifest = await self._ensure_manifest()
        if not manifest:
            return []
        out: List[Tuple[list, List[list]]] = []
        for record in manifest["segments"]:
            if record["hi"] < lo or record["lo"] > hi:
                continue
            seg = await self._segment(record)
            if seg is None:
                continue
            for height in sorted(seg["by_height"]):
                if lo <= height <= hi:
                    out.append(seg["by_height"][height])
        if out:
            self._hit()
        return out

    async def address_history(self,
                              address: str) -> List[Tuple[list, list]]:
        """(canonical block row, canonical tx row) for every archived
        tx touching ``address`` (as input spender or output recipient),
        ascending by height, acceptance order within a block — the
        order the hot SQL would have returned before pruning."""
        manifest = await self._ensure_manifest()
        if not manifest:
            return []
        out: List[Tuple[list, list]] = []
        for record in manifest["segments"]:
            index = await self._index(record)
            if index is None:
                continue
            heights = index["addresses"].get(address)
            if not heights:
                continue
            seg = await self._segment(record)
            if seg is None:
                continue
            for height in heights:
                entry = seg["by_height"].get(height)
                if entry is None:
                    continue
                for t in entry[1]:
                    if address in t[3] or address in t[4]:
                        out.append((entry[0], t))
        if out:
            self._hit()
        return out

    # ---------------------------------------------------------- stats ---
    def stats(self) -> dict:
        manifest = self._manifest
        segments = manifest["segments"] if manifest else []
        return {
            "root": self.root,
            "segments": len(segments),
            "archived_through": (manifest or {}).get(
                "archived_through", 0),
            "archived_blocks": sum(s["blocks"] for s in segments),
            "archived_txs": sum(s["txs"] for s in segments),
            "payload_bytes": sum(s["payload_bytes"] for s in segments),
            "fallthrough_reads": self.fallthrough_reads,
            "segment_loads": self.segment_loads,
            "segments_cached": len(self._segments),
            "integrity_failures": self.integrity_failures,
        }


# ------------------------------------------------------------ peer fetch --

class ArchiveFetchError(ConnectionError):
    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


async def fetch_archive(iface, root: str, *,
                        max_segment_bytes: int = 256 << 20,
                        max_segments: int = 1 << 12) -> dict:
    """Mirror a peer's archive into ``root``: manifest + every segment
    not already present-and-valid locally, each payload verified
    against its manifest sha before the index is rebuilt locally and
    the segment renamed into place.  Publishes the peer's manifest
    only after every segment verified, so a killed fetch leaves the
    previous manifest live and already-landed segments are reused on
    retry (resumable by construction)."""
    injector = faultinject.get_injector()
    if injector is not None:
        await injector.fire("archive.fetch", "manifest")
    resp = await iface.get("archive/manifest")
    if not resp or not resp.get("ok"):
        raise ArchiveFetchError("manifest_unavailable",
                                str((resp or {}).get("error", "")))
    manifest = resp["result"]
    segments = manifest.get("segments") or []
    if len(segments) > max_segments:
        raise ArchiveFetchError(
            "manifest_oversized", f"{len(segments)} segments")
    store = ArchiveStore(root, manifest.get("segment_blocks", 256))
    fetched = reused = 0
    for i, record in enumerate(segments):
        if record.get("payload_bytes", 0) > max_segment_bytes:
            raise ArchiveFetchError(
                "segment_oversized", f"{record.get('name')}")
        if await _io(store.verify_segment, record):
            reused += 1
            continue
        if injector is not None:
            await injector.fire("archive.fetch", f"segment/{i}")
        resp = await iface.get(f"archive/segment/{i}")
        if not resp or not resp.get("ok"):
            raise ArchiveFetchError("segment_unavailable", f"{i}")
        try:
            payload = bytes.fromhex(resp["result"]["data"])
        except (KeyError, TypeError, ValueError):
            raise ArchiveFetchError("segment_malformed", f"{i}")
        if injector is not None:  # corrupt-kind rules rewrite payloads
            payload = injector.fire_mutate("archive.fetch",
                                           f"segment/{i}", payload)
        if snap_layout.sha256_hex(payload) != record["payload_sha256"]:
            trace.inc("archive.fetch_integrity_failures")
            raise ArchiveFetchError("segment_integrity", f"{i}")
        try:
            await _io(store.write_fetched_segment, record, payload)
        except ValueError as e:
            raise ArchiveFetchError("segment_integrity", f"{i}: {e}")
        fetched += 1
    await _io(store.publish, segments)
    trace.inc("archive.fetches")
    return {"ok": True, "segments": len(segments), "fetched": fetched,
            "reused": reused,
            "archived_through": manifest.get("archived_through", 0)}
