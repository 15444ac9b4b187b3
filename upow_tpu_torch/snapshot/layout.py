"""On-disk snapshot layout shared by builder, server and client: the
port's copy of the JAX package's ``snapshot/layout.py`` (the same
layout, so either package serves and restores the other's generations).

::

    <root>/
      CURRENT                     name of the published generation dir
      gen-000000024-6fe2a1b09c44/ one generation (anchor height + hash)
        manifest.json
        chunk-000000.bin ...
      .staging-*/                 builder scratch (rename publishes it)
      restore/                    client journal (see client.py)

Publishing is one ``os.replace`` of the staging dir onto the
generation name followed by one ``os.replace`` of the CURRENT pointer
file — readers either see the previous complete generation or the new
one, never a half-written mix.  Housekeeping (generation pruning,
stale staging sweep) is best-effort: OSError swallowed, never raised
into the caller — a full disk must degrade snapshot serving, not block
accept.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import List, Optional

from ..logger import get_logger

log = get_logger("snapshot")

MANIFEST_NAME = "manifest.json"
CURRENT_NAME = "CURRENT"
MANIFEST_VERSION = 1


def gen_name(height: int, anchor_hash: str) -> str:
    """Generation dir name: sortable by height, disambiguated by the
    anchor hash prefix (two builds at one height after a reorg must not
    collide)."""
    return f"gen-{int(height):09d}-{anchor_hash[:12]}"


def chunk_name(i: int) -> str:
    return f"chunk-{int(i):06d}.bin"


def canonical_json(doc: dict) -> bytes:
    """The byte form every hash commits to — identical state must
    yield identical manifest bytes (no timestamps in the document)."""
    return (json.dumps(doc, sort_keys=True, separators=(",", ":"))
            + "\n").encode()


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def write_manifest(path: str, manifest: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(canonical_json(manifest))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_manifest(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as fh:
            return json.loads(fh.read())
    except (OSError, ValueError):
        return None


def publish_current(root: str, name: str) -> None:
    """Point CURRENT at a generation dir (atomic pointer swap)."""
    tmp = os.path.join(root, CURRENT_NAME + ".tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(name + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(root, CURRENT_NAME))


def current_gen_dir(root: str) -> Optional[str]:
    """The published generation dir, or None when nothing is live."""
    try:
        with open(os.path.join(root, CURRENT_NAME), encoding="utf-8") as fh:
            name = fh.read().strip()
    except OSError:
        return None
    if not name or "/" in name or name.startswith("."):
        return None
    path = os.path.join(root, name)
    return path if os.path.isdir(path) else None


def current_manifest(root: str) -> Optional[dict]:
    gen = current_gen_dir(root)
    if gen is None:
        return None
    return read_manifest(os.path.join(gen, MANIFEST_NAME))


def snapshot_dir_ready(root: str) -> bool:
    return bool(root) and current_manifest(root) is not None


def list_generations(root: str) -> List[str]:
    """Generation dir names, oldest first (name order == height order)."""
    try:
        names = sorted(n for n in os.listdir(root)
                       if n.startswith("gen-")
                       and os.path.isdir(os.path.join(root, n)))
    except OSError:
        return []
    return names


def prune_generations(root: str, keep: int = 2) -> int:
    """Bound disk use to the newest ``keep`` generations and sweep any
    abandoned ``.staging-*`` scratch dirs (a builder crash between
    mkdtemp and publish leaks one).  Never raises; the published
    CURRENT generation is always retained.  Returns dirs removed."""
    removed = 0
    try:
        current = current_gen_dir(root)
        names = list_generations(root)
        doomed = names[:-keep] if keep > 0 else names
        for name in doomed:
            path = os.path.join(root, name)
            if current is not None and os.path.abspath(path) == \
                    os.path.abspath(current):
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
        for name in os.listdir(root):
            if name.startswith(".staging-"):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
                removed += 1
    except OSError:
        pass
    if removed:
        log.info("snapshot prune: removed %d dirs under %s", removed, root)
    return removed
