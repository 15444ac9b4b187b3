"""Cold-block archival tier (docs/ARCHIVE.md): the port's copy of the
JAX package's ``archive/``.

A fourth storage tier between the hot database and snapshot
generations: append-only, content-addressed segments of canonical
JSON-lines blocks + transactions, pruned out of the hot tables once
the snapshot witness closure proves nothing below
``anchor_height - safety_window`` can still be observed differently.

* :mod:`.store`   — on-disk segment layout + manifest/CURRENT publish
* :mod:`.compactor` — crash-safe two-phase compaction (archive-commit
  first, hot-delete second, resumable journal)
* :mod:`.reader`  — transparent read fallthrough for both storage
  backends + peer archive fetch
* :mod:`.parity`  — the pruned-vs-twin storage differential
"""

from .reader import ArchiveReader  # noqa: F401
from .store import ArchiveStore  # noqa: F401
