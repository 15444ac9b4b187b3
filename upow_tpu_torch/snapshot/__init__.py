"""Crash-safe, block-hash-anchored UTXO snapshots (docs/SNAPSHOT.md): the
port's copy of the JAX package's ``snapshot/``.

Three parts share one on-disk layout (:mod:`.layout`):

* :mod:`.builder` — serialize the UTXO set + witness transactions + a
  block tail into fixed-size sha256'd chunks under a manifest that
  commits to the anchor block (hash, height) and the state
  fingerprints.  Built in a staging dir, published by one rename.
* the node's ``/snapshot/manifest`` + ``/snapshot/chunk/{i}`` handlers
  (node/app.py) — serve the published generation straight from disk.
* :mod:`.client` — resumable bootstrap: download chunks from
  health-ranked peers, verify every chunk hash before it is journaled,
  survive kill -9 at any byte, cross-check the restored fingerprint,
  and degrade to full block replay with a structured reason when
  integrity or sources run out.

The payload and manifest are the JAX package's byte for byte, so a node
of either package restores from the other's.  A restore rebuilds the
resident UTXO index on the state's device when one is armed
(``restore_snapshot`` of both backends); an index that cannot arm
raises, never falling back to SQL.  Not here yet: ``__main__`` (the
smoke CLI, which drives the JAX package's ``swarm/``), with ROADMAP
A13f's swarm; ROADMAP A13d lists it with the archive tier.
"""

from .builder import build_snapshot
from .client import SnapshotError, bootstrap_from_snapshot
from .layout import (current_manifest, prune_generations, read_manifest,
                     snapshot_dir_ready)

__all__ = [
    "build_snapshot",
    "bootstrap_from_snapshot",
    "SnapshotError",
    "current_manifest",
    "prune_generations",
    "read_manifest",
    "snapshot_dir_ready",
]
